"""Criss-cross attention (CCNet), 2D.

Port of `waveformer_tpu/ops/cc_attention.py`. Each position attends to
every position of its row and of its column; the self position appears in
both sets, so its column logit is masked to −inf. Plain einsums and one
softmax on the inputs' device, differentiable by autograd.
"""

from __future__ import annotations

import torch


def criss_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k: (B, H, W, Cqk); v: (B, H, W, Cv) → (B, H, W, Cv). q is scaled
    by Cqk^-0.5."""
    _, h, w, _ = q.shape
    q = q * q.shape[-1] ** -0.5
    row_logits = torch.einsum("bijc,bikc->bijk", q, k)  # (B, H, W, W)
    col_logits = torch.einsum("bijc,bkjc->bijk", q, k)  # (B, H, W, H)
    eye = torch.eye(h, dtype=torch.bool, device=q.device)[None, :, None, :]  # (1, H, 1, H)
    col_logits = col_logits.masked_fill(eye, float("-inf"))
    attn = torch.softmax(torch.cat([row_logits, col_logits], dim=-1), dim=-1)
    attn_row, attn_col = attn[..., :w], attn[..., w:]
    out = torch.einsum("bijk,bikc->bijc", attn_row, v)
    return out + torch.einsum("bijk,bkjc->bijc", attn_col, v)
