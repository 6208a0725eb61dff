"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: fp32 sums run in another order (TF32 off); in bf16 both sides
round an fp32 result to bf16 (one ulp, 2^-7 relative), and the attention
probabilities are rounded to bf16 before PV at other points. The tiled
matmul: int8 → int32 is exact; bf16 → fp32 sums equal products in another
order, and the tensor cores do not round their fp32 sums to nearest: 1e-4 of
Σ|x'||w| + |s0|.
"""

import numpy as np
import pytest
import torch

from waveformer_tpu_torch.models.conv_blocks import UnetResBlock
from waveformer_tpu_torch.models.layers import CCF_FFN
from waveformer_tpu_torch.ops import attention_cuda as tac
from waveformer_tpu_torch.ops import conv_cuda as tcc
from waveformer_tpu_torch.ops import dwconv_cuda as tdc
from waveformer_tpu_torch.ops import ffn_tail_cuda as tft
from waveformer_tpu_torch.ops import fused_conv_cuda as tfc
from waveformer_tpu_torch.ops import tiled_matmul_cuda as ttm

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


# (B, D, H, W), C, O: the JAX tests' shapes, C = 3…6 and O = 4…8 (the K-chunk
# and the n-tile padded on chip only), the flagship's widths at small extents
CONV_SHAPES = [((1, 8, 8, 16), 4, 8), ((1, 4, 16, 8), 6, 5), ((2, 4, 8, 8), 3, 4),
               ((2, 6, 5, 7), 48, 48), ((1, 5, 6, 7), 96, 48), ((1, 4, 4, 4), 192, 192)]


def _conv_inputs(bdhw, cin, cout, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(*bdhw, cin, device=device, generator=g)
    w = torch.randn(3, 3, 3, cin, cout, device=device, generator=g) * (27 * cin) ** -0.5
    return x, w


@pytest.mark.cuda
class TestConvKernelsOnCard:
    @pytest.mark.parametrize("bdhw,cin,cout", CONV_SHAPES)
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_conv3_both_layouts_match_plain(self, cuda_device, bdhw, cin, cout, dtype, rtol,
                                            atol):
        x, w = _conv_inputs(bdhw, cin, cout, cuda_device)
        x = x.to(dtype)
        want = tcc.conv3x3x3_reference(x, w).float()
        for got in (tcc.conv3x3x3_batched(x, w, block_h=bdhw[2]),
                    tcc.conv3x3x3_same_v2(x, w, block_h=bdhw[2]),
                    tcc.conv3x3x3_same(x[0], w, block_h=bdhw[2])[None]):
            torch.cuda.synchronize()
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want[: got.shape[0]], rtol=rtol, atol=atol)

    @pytest.mark.parametrize("bdhw,cin,cout", CONV_SHAPES)
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_fused_matches_plain(self, cuda_device, bdhw, cin, cout, dtype, rtol, atol):
        x, w = _conv_inputs(bdhw, cin, cout, cuda_device, seed=1)
        x = x.to(dtype)
        b = bdhw[0]
        pro = (torch.rand(b, cin, device=cuda_device) - 0.5, torch.rand(b, cin, device=cuda_device) + 0.5)
        for prologue in (None, pro):
            y, st = tfc.conv3x3x3_fused(x, w, prologue=prologue, emit_stats=True)
            wy, wst = tfc.conv3x3x3_fused_reference(x, w, prologue=prologue, emit_stats=True)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), wy.float(), rtol=rtol, atol=atol)
            # fp32 sums of products of equal (rounded) inputs in other orders
            torch.testing.assert_close(st, wst, rtol=1e-4, atol=1e-4 * float(wst.abs().max()))
            y2, st2 = tfc.conv3x3x3_fused(x, w, prologue=prologue, emit_stats=True)
            assert torch.equal(st, st2) and torch.equal(y, y2)

    @pytest.mark.parametrize("cin,cout", [(4, 8), (16, 16)])
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_res_block_fused_matches_module(self, cuda_device, cin, cout, dtype, rtol, atol):
        torch.manual_seed(0)
        block = UnetResBlock(cin, cout).to(cuda_device, dtype)
        x = torch.randn(2, 6, 8, 5, cin, device=cuda_device).to(dtype)
        with torch.no_grad():
            got = tfc.res_block_fused_module(block, x)
            want = block(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=4 * rtol, atol=4 * atol)

    @pytest.mark.parametrize("shape,c_out", [((2, 6, 5, 7, 64), 16), ((1, 8, 8, 8, 192), 48),
                                             ((1, 4, 4, 4, 1536), 384), ((1, 3, 5, 7, 16), 8)])
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_ffn_tail_matches_plain(self, cuda_device, shape, c_out, dtype, rtol, atol):
        torch.manual_seed(1)
        ffn = CCF_FFN(c_out, shape[-1]).to(cuda_device, dtype)
        h1 = torch.randn(shape, device=cuda_device).to(dtype)
        args = (h1, ffn.dwconv.weight[:, 0].permute(1, 2, 3, 0), ffn.dwconv.bias,
                ffn.norm2.weight, ffn.norm2.bias, ffn.fc.weight.t(), ffn.fc.bias)
        with torch.no_grad():
            got = tft.ffn_tail(*args)
            want = tft.ffn_tail_reference(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)

    def test_unsupported_dtype_raises(self, cuda_device):
        x = torch.zeros(1, 2, 8, 4, 8, device=cuda_device, dtype=torch.float16)
        w = torch.zeros(3, 3, 3, 8, 8, device=cuda_device)
        before = (dict(tcc.launches), tfc.launches, tft.launches)
        with pytest.raises(TypeError):
            tcc.conv3x3x3_batched(x, w)
        with pytest.raises(TypeError):
            tfc.conv3x3x3_fused(x, w)
        with pytest.raises(TypeError):
            tft.ffn_tail(x, torch.zeros(3, 3, 3, 8, device=cuda_device),
                         *(torch.zeros(8, device=cuda_device) for _ in range(3)),
                         torch.zeros(8, 8, device=cuda_device), torch.zeros(8, device=cuda_device))
        with pytest.raises(ValueError):  # bf16 tail needs 16-deep K steps
            tft.ffn_tail(x.to(torch.bfloat16), torch.zeros(3, 3, 3, 8, device=cuda_device),
                         *(torch.zeros(8, device=cuda_device) for _ in range(3)),
                         torch.zeros(8, 8, device=cuda_device), torch.zeros(8, device=cuda_device))
        assert (dict(tcc.launches), tfc.launches, tft.launches) == before


# (M, K, N): a ragged row block with N % 16 == 8, a K tail of half a stage,
# and one of the int8 probe's shapes
TM_SHAPES = [(96, 48, 40), (64, 2080, 24), (16384, 2048, 512)]


def _tm_inputs(kind, m, k, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "bf16":
        return (torch.randn(m, k, device=device, generator=g).to(torch.bfloat16),
                torch.randn(k, n, device=device, generator=g).to(torch.bfloat16))
    return (torch.randint(-127, 127, (m, k), device=device, generator=g, dtype=torch.int8),
            torch.randint(-127, 127, (k, n), device=device, generator=g, dtype=torch.int8))


@pytest.mark.cuda
class TestTiledMatmulOnCard:
    @pytest.mark.parametrize("perturb_out", [False, True])
    @pytest.mark.parametrize("kind", ["bf16", "int8"])
    @pytest.mark.parametrize("m,k,n", TM_SHAPES)
    def test_matches_plain(self, cuda_device, m, k, n, kind, perturb_out):
        x, w = _tm_inputs(kind, m, k, n, cuda_device)
        out_dtype = ttm.PAIRS[x.dtype][1]
        for s0 in (0.0, 3.7, -2.5):
            s = torch.zeros(8, device=cuda_device)
            s[0] = s0
            before = dict(ttm.launches)
            got = ttm.tiled_matmul(s, x, w, out_dtype=out_dtype, perturb_out=perturb_out)
            want = ttm.tiled_matmul_reference(s, x, w, out_dtype=out_dtype,
                                              perturb_out=perturb_out)
            torch.cuda.synchronize()
            assert ttm.launches[f"tiled_matmul_{kind}"] == before[f"tiled_matmul_{kind}"] + 1
            assert got.dtype == out_dtype and tuple(got.shape) == (m, n)
            if kind == "int8":
                assert torch.equal(got, want)
            else:
                scale = (x.float().abs() + abs(s0)) @ w.float().abs() + abs(s0)
                assert bool(((got - want).abs() <= 1e-4 * scale).all())

    def test_raises_on_misaligned_k(self, cuda_device):
        s = torch.zeros(8, device=cuda_device)
        x, w = _tm_inputs("bf16", 64, 12, 16, cuda_device)
        before = dict(ttm.launches)
        with pytest.raises(ValueError):
            ttm.tiled_matmul(s, x, w, out_dtype=torch.float32, perturb_out=True)
        x, w = _tm_inputs("int8", 64, 24, 16, cuda_device)
        with pytest.raises(ValueError):
            ttm.tiled_matmul(s, x, w, out_dtype=torch.int32, perturb_out=True)
        assert ttm.launches == before
