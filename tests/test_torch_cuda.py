"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: fp32 sums run in another order (TF32 off); in bf16 both sides
round an fp32 result to bf16 (one ulp, 2^-7 relative), and the attention
probabilities are rounded to bf16 before PV at other points.
"""

import numpy as np
import pytest
import torch

from waveformer_tpu_torch.ops import attention_cuda as tac
from waveformer_tpu_torch.ops import dwconv_cuda as tdc

# the WaveFormer shapes, then every head dim of both kernel paths (bf16 with
# D % 16 == 0 and N <= 512 runs on tensor cores, the rest on FMA loops)
ATTN_SHAPES = [(4, 3, 512, 16), (2, 24, 512, 16), (3, 2, 128, 8), (8, 24, 512, 16),
               (2, 2, 512, 32), (2, 2, 256, 48), (2, 2, 512, 64), (2, 2, 192, 24),
               (1, 2, 1024, 64)]
TOLS = [(torch.float32, 1e-5, 1e-4), (torch.bfloat16, 1.6e-2, 2e-2)]


def _qkvb(bw, h, n, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bw, h, n, d).astype(np.float32) for _ in range(3))
    b = (rng.randn(h, n, n) * 0.5).astype(np.float32)
    return q, k, v, b


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("bw,h,n,d", ATTN_SHAPES)
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_window_attention_matches_plain(self, cuda_device, bw, h, n, d, dtype, rtol, atol):
        q, k, v, b = (torch.from_numpy(a).to(cuda_device) for a in _qkvb(bw, h, n, d))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        got = tac.window_attention(q, k, v, b, d**-0.5)
        want = tac.window_attention_reference(q, k, v, b, d**-0.5)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)

    def test_window_attention_strided_qkv(self, cuda_device):
        bw, n, h, d = 16, 512, 3, 16
        qkv = torch.randn(bw, n, 3, h, d, device=cuda_device).permute(2, 0, 3, 1, 4)
        b = torch.randn(h, n, n, device=cuda_device) * 0.5
        got = tac.window_attention(qkv[0], qkv[1], qkv[2], b, 0.25)
        want = tac.window_attention_reference(qkv[0], qkv[1], qkv[2], b, 0.25)
        assert (got - want).abs().max().item() <= 1e-4

    @pytest.mark.parametrize("shape", [(2, 6, 5, 7, 96), (1, 16, 16, 16, 192), (2, 8, 8, 9, 1536)])
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_dwconv3_matches_plain(self, cuda_device, shape, dtype, rtol, atol):
        x = torch.randn(shape, device=cuda_device).to(dtype)
        w = torch.randn(3, 3, 3, shape[-1], device=cuda_device)
        got = tdc.dwconv3(x, w)
        want = tdc.dwconv3_reference(x.float(), w).to(dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)

    def test_wrappers_raise_on_unsupported_cuda_shapes(self, cuda_device):
        t = torch.zeros(1, 1, 8, 8, device=cuda_device)
        with pytest.raises(ValueError):
            tac.window_attention(t, t, t, torch.zeros(1, 8, 8, device=cuda_device), 1.0)
        with pytest.raises(ValueError):
            tdc.dwconv3(torch.zeros(1, 2, 2, 2, 4, device=cuda_device),
                        torch.zeros(3, 3, 3, 4, device=cuda_device))

    def test_unaligned_views_are_copied(self, cuda_device):
        buf = torch.randn(1 + 2 * 4 * 4 * 4 * 16, device=cuda_device)
        x = buf[1:].view(2, 4, 4, 4, 16)  # 4-byte offset: not 16-byte aligned
        w = torch.randn(3, 3, 3, 16, device=cuda_device)
        torch.testing.assert_close(tdc.dwconv3(x, w), tdc.dwconv3_reference(x, w),
                                   rtol=1e-5, atol=1e-4)
        q, k, v, b = (torch.from_numpy(a).to(cuda_device) for a in _qkvb(2, 2, 128, 8))
        bbuf = torch.empty(b.numel() + 1, device=cuda_device)
        bbuf[1:] = b.reshape(-1)
        bu = bbuf[1:].view_as(b)
        qbuf = torch.empty(q.numel() + 1, device=cuda_device)
        qbuf[1:] = q.reshape(-1)
        torch.testing.assert_close(tac.window_attention(qbuf[1:].view_as(q), k, v, bu, 0.5),
                                   tac.window_attention_reference(q, k, v, b, 0.5),
                                   rtol=1e-5, atol=1e-4)
