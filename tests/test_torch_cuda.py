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

import ctypes

import numpy as np
import pytest
import torch

from waveformer_tpu_torch.models.conv_blocks import UnetResBlock
from waveformer_tpu_torch.models.layers import CCF_FFN
from waveformer_tpu_torch.ops import _build
from waveformer_tpu_torch.ops import attention_cuda as tac
from waveformer_tpu_torch.ops import conv_cuda as tcc
from waveformer_tpu_torch.ops import dwconv_cuda as tdc
from waveformer_tpu_torch.ops import ffn_tail_cuda as tft
from waveformer_tpu_torch.ops import fused_conv_cuda as tfc
from waveformer_tpu_torch.ops import tiled_matmul_cuda as ttm

# the WaveFormer shapes, then every head dim of both kernel designs (bf16 with
# D ∈ {16, 32, 48, 64} and N <= 512 on TMA + wgmma, the rest on FMA loops)
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
        before = dict(tdc.design_launches)
        got = tdc.dwconv3(x, w)
        want = tdc.dwconv3_reference(x.float(), w).to(dtype)
        torch.cuda.synchronize()
        name = "vector" if dtype == torch.float32 else "tma_ring"
        assert tdc.design(dtype, shape[-1]) == name
        assert tdc.design_launches[name] == before[name] + 1
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)

    def test_wrappers_raise_on_unsupported_cuda_shapes(self, cuda_device):
        before = (tac.launches, tdc.launches)
        # what stays refused: N > 1024, D > 64, types other than fp32 and bf16
        for n, d, dtype, exc in ((1025, 16, torch.float32, ValueError),
                                 (64, 72, torch.float32, ValueError),
                                 (64, 16, torch.float16, TypeError)):
            t = torch.zeros(1, 1, n, d, device=cuda_device, dtype=dtype)
            with pytest.raises(exc):
                tac.window_attention(t, t, t, torch.zeros(1, n, n, device=cuda_device), 1.0)
        with pytest.raises(TypeError):
            tdc.dwconv3(torch.zeros(1, 2, 2, 2, 4, device=cuda_device, dtype=torch.float16),
                        torch.zeros(3, 3, 3, 4, device=cuda_device))
        assert (tac.launches, tdc.launches) == before

    @pytest.mark.parametrize("c", [4, 20, 36])
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_dwconv3_odd_channels(self, cuda_device, c, dtype, rtol, atol):
        x = torch.randn(2, 6, 5, 7, c, device=cuda_device).to(dtype)
        w = torch.randn(3, 3, 3, c, device=cuda_device)
        before = tdc.launches
        vector = tdc.design_launches["vector"]
        got = tdc.dwconv3(x, w)
        want = tdc.dwconv3_reference(x.float(), w).to(dtype)
        torch.cuda.synchronize()
        assert tdc.launches == before + 1
        assert tdc.design(dtype, c) == "vector" and tdc.design_launches["vector"] == vector + 1
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)

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


# (B, D, H, W, C): the five shapes of a flagship forward at batch 2, then
# ragged tiles (H, W and C past a whole 8 × 16 × 64 tile, a single voxel)
DW_MAIN = [(2, 64, 64, 64, 192), (2, 32, 32, 32, 384), (2, 16, 16, 16, 768),
           (2, 8, 8, 8, 1536), (2, 64, 64, 64, 96)]
DW_RAGGED = [(2, 5, 6, 7, 64), (1, 1, 1, 1, 64), (1, 3, 17, 9, 200), (2, 9, 8, 8, 96)]


@pytest.mark.cuda
class TestDWConv3Designs:
    @pytest.mark.parametrize("with_bias", [False, True])
    @pytest.mark.parametrize("shape", DW_MAIN + DW_RAGGED)
    def test_tma_ring_matches_plain(self, cuda_device, shape, with_bias):
        g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
        x = torch.randn(shape, device=cuda_device, generator=g).to(torch.bfloat16)
        w = torch.randn(3, 3, 3, shape[-1], device=cuda_device, generator=g)
        b = torch.randn(shape[-1], device=cuda_device, generator=g) if with_bias else None
        before = dict(tdc.design_launches)
        got = tdc.dwconv3(x, w, b)
        want = tdc.dwconv3_reference(x.float(), w, b).to(torch.bfloat16)
        torch.cuda.synchronize()
        assert tdc.design_launches["tma_ring"] == before["tma_ring"] + 1
        assert tdc.design_launches["vector"] == before["vector"]
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=2e-2)

    @pytest.mark.parametrize("dtype,c", [(torch.float32, 96), (torch.float32, 20),
                                         (torch.bfloat16, 20)])
    def test_vector_bias_matches_plain(self, cuda_device, dtype, c):
        g = torch.Generator(device=cuda_device).manual_seed(c)
        x = torch.randn(2, 5, 6, 7, c, device=cuda_device, generator=g).to(dtype)
        w = torch.randn(3, 3, 3, c, device=cuda_device, generator=g)
        b = torch.randn(c, device=cuda_device, generator=g)
        before = tdc.design_launches["vector"]
        got = tdc.dwconv3(x, w, b)
        want = tdc.dwconv3_reference(x.float(), w, b).to(dtype)
        torch.cuda.synchronize()
        assert tdc.design_launches["vector"] == before + 1
        rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (1.6e-2, 2e-2)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)

    def test_design_rule_matches_library(self, cuda_device):
        for dtype in (torch.float32, torch.bfloat16):
            for c in (4, 8, 20, 96, 192, 1536):
                assert tdc.library_design(dtype, c) == tdc.design(dtype, c), (dtype, c)


# the seven calls of a batch-8 flagship forward; ragged windows of the TMA
# design at each of its head dims; ragged windows of the FMA design
ATTN_MAIN = [(512, 3, 512, 16), (64, 3, 512, 16), (8, 3, 512, 16), (64, 6, 512, 16),
             (8, 6, 512, 16), (8, 12, 512, 16), (8, 24, 512, 16)]
TMA_N, TMA_D = [64, 216, 343, 512], [16, 32, 64]
FMA_N, FMA_D = [1, 8, 27, 216, 1000], [4, 8, 12, 24]


@pytest.mark.cuda
class TestWindowAttentionDesigns:
    def _check(self, device, bw, h, n, d, dtype, rtol, atol, strided=False):
        rng = np.random.RandomState(n * 131 + d)
        if strided:  # views of a (BW, N, 3, H, D) projection, as the model passes them
            qkv = torch.from_numpy(rng.randn(bw, n, 3, h, d).astype(np.float32))
            q, k, v = qkv.to(device, dtype).permute(2, 0, 3, 1, 4)
            b = torch.from_numpy((rng.randn(h, n, n) * 0.5).astype(np.float32)).to(device)
        else:
            q, k, v, b = (torch.from_numpy(a).to(device) for a in _qkvb(bw, h, n, d, seed=n + d))
            q, k, v = (t.to(dtype) for t in (q, k, v))
        name = tac.design(dtype, n, d)
        before = dict(tac.design_launches)
        got = tac.window_attention(q, k, v, b, d**-0.5)
        want = tac.window_attention_reference(q, k, v, b, d**-0.5)
        torch.cuda.synchronize()
        assert tac.design_launches[name] == before[name] + 1
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        return name

    @pytest.mark.parametrize("bw,h,n,d", ATTN_MAIN)
    def test_tma_main_path_shapes(self, cuda_device, bw, h, n, d):
        assert self._check(cuda_device, bw, h, n, d, torch.bfloat16, *TOLS[1][1:],
                           strided=True) == "tma_wgmma"

    @pytest.mark.parametrize("strided", [False, True])
    @pytest.mark.parametrize("d", TMA_D)
    @pytest.mark.parametrize("n", TMA_N)
    def test_tma_ragged_windows(self, cuda_device, n, d, strided):
        assert self._check(cuda_device, 3, 2, n, d, torch.bfloat16, *TOLS[1][1:],
                           strided=strided) == "tma_wgmma"

    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    @pytest.mark.parametrize("d", FMA_D)
    @pytest.mark.parametrize("n", FMA_N)
    def test_fma_ragged_windows(self, cuda_device, n, d, dtype, rtol, atol):
        assert self._check(cuda_device, 2, 2, n, d, dtype, rtol, atol) == "fma"

    def test_design_rule_matches_library(self, cuda_device):
        for dtype in (torch.float32, torch.bfloat16):
            for n in (1, 8, 27, 64, 216, 343, 512, 513, 1000, 1024):
                for d in (1, 4, 8, 12, 16, 24, 32, 48, 56, 64):
                    assert tac.library_design(dtype, n, d) == tac.design(dtype, n, d), (n, d)


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


# (Ch, C) of `ln_gelu_dense`: the card tests' narrow widths, then the four
# flagship tails (weight resident at 192 → 48 and 384 → 96, streamed above)
LGD_WIDTHS = [(16, 8), (64, 16), (192, 48), (384, 96), (768, 192), (1536, 384)]


def _lgd_inputs(m, ch, c, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, device=device, generator=g)
    y = (r(m, ch) + 0.3).to(torch.bfloat16)
    return y, 1 + 0.1 * r(ch), 0.1 * r(ch), r(ch, c) * ch**-0.5, 0.1 * r(c)


@pytest.mark.cuda
class TestLnGeluDenseOnCard:
    # M = 420 (the odd tail shape's rows, ragged 64-row blocks) and 4096 + 37
    @pytest.mark.parametrize("m", [420, 4096 + 37])
    @pytest.mark.parametrize("ch,c", LGD_WIDTHS)
    def test_matches_plain(self, cuda_device, m, ch, c):
        args = _lgd_inputs(m, ch, c, cuda_device, seed=ch + c)
        before = tft.ln_gelu_dense_launches
        got = tft.ln_gelu_dense(*args)
        want = tft.ln_gelu_dense_reference(*args)
        torch.cuda.synchronize()
        assert tft.ln_gelu_dense_launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == (m, c)
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=2e-2)

    @pytest.mark.parametrize("ch,c", [(192, 48), (1536, 384)])
    def test_bit_identical(self, cuda_device, ch, c):
        args = _lgd_inputs(4096 + 37, ch, c, cuda_device, seed=1)
        assert torch.equal(tft.ln_gelu_dense(*args), tft.ln_gelu_dense(*args))

    def test_design_rule_matches_library(self, cuda_device):
        for dtype in (torch.float32, torch.bfloat16):
            for ch, c in LGD_WIDTHS + [(24, 8), (48, 40)]:
                assert tft.library_design(dtype, ch, c) == tft.design(dtype, ch, c), (dtype, ch, c)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_tail_counts_its_launches(self, cuda_device, dtype):
        args = _lgd_inputs(4, 64, 16, cuda_device)
        h1 = torch.randn(2, 5, 6, 7, 64, device=cuda_device).to(dtype)
        dw = (torch.randn(3, 3, 3, 64, device=cuda_device) * 0.2, 0.1 * args[2])
        name = tft.design(dtype, 64, 16)
        before = (tft.launches, dict(tft.design_launches), tft.ln_gelu_dense_launches,
                  tdc.design_launches["tma_ring"])
        got = tft.ffn_tail(h1, *dw, *args[1:])
        torch.cuda.synchronize()
        split = int(name == "split_wgmma")
        assert tft.launches == before[0] + 1
        assert tft.design_launches[name] == before[1][name] + 1
        assert tft.ln_gelu_dense_launches == before[2] + split
        assert tdc.design_launches["tma_ring"] == before[3] + split
        want = tft.ffn_tail_reference(h1, *dw, *args[1:])
        rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (1.6e-2, 2e-2)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


# bf16 (D, H, C, W) on the TMA + wgmma design: every flagship W extent, C and
# O, at B = 2 with D = 3 and a one-plane D (H = 5 and 9: ragged row blocks)
TMA_W, TMA_C, TMA_O = [16, 32, 64, 128], [4, 48, 96], [48, 96, 192]
# W % 8 == 0 extents that are no power of two (ragged W tiles), C that is no
# multiple of 16, O that leaves a ragged channel block
TMA_ODD = [(8, 6, 5), (24, 20, 40), (80, 6, 100), (40, 3, 16)]


@pytest.mark.cuda
class TestConvTmaOnCard:
    def _check(self, device, w_extent, c, o):
        for d, h in ((3, 5), (1, 9)):
            x, w = _conv_inputs((2, d, h, w_extent), c, o, device, seed=2)
            x_cw = x.to(torch.bfloat16).transpose(-1, -2).contiguous()
            before = dict(tcc.design_launches)
            got = tcc.conv3x3x3_cw(x_cw, w, block_h=h)
            want = tcc.conv3x3x3_cw_reference(x_cw, w)
            torch.cuda.synchronize()
            assert tcc.design_launches["tma_wgmma"] == before["tma_wgmma"] + 1
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=2e-2)

    @pytest.mark.parametrize("o", TMA_O)
    @pytest.mark.parametrize("c", TMA_C)
    @pytest.mark.parametrize("w_extent", TMA_W)
    def test_dhcw_bf16_matches_plain(self, cuda_device, w_extent, c, o):
        self._check(cuda_device, w_extent, c, o)

    @pytest.mark.parametrize("w_extent,c,o", TMA_ODD)
    def test_dhcw_bf16_ragged_tiles(self, cuda_device, w_extent, c, o):
        self._check(cuda_device, w_extent, c, o)

    def test_design_rule(self, cuda_device):
        bf, f32 = torch.bfloat16, torch.float32
        # the Python rule is the library's, over every dtype, layout, W and C
        for dt in (bf, f32):
            for layout in (tcc.DHWC, tcc.DHCW):
                for w_extent in (7, 8, 16, 128):
                    for c in (3, 4, 6, 8, 24, 48, 96):
                        assert tcc.design(dt, layout, w_extent, c) == tcc.library_design(
                            dt, layout, w_extent, c), (dt, layout, w_extent, c)
        assert tcc.design(bf, tcc.DHCW, 128, 96) == "tma_wgmma"
        assert tcc.design(bf, tcc.DHWC, 128, 48) == "tma_wgmma_cl"
        assert tcc.design(bf, tcc.DHWC, 128, 4) == "halo_mma"
        # W % 8 != 0 runs the plain kernel, and matches
        x, w = _conv_inputs((2, 3, 4, 7), 48, 48, cuda_device)
        x_cw = x.to(bf).transpose(-1, -2).contiguous()
        before = dict(tcc.design_launches)
        got = tcc.conv3x3x3_cw(x_cw, w, block_h=4)
        torch.cuda.synchronize()
        assert tcc.design_launches["plain"] == before["plain"] + 1
        assert tcc.design_launches["tma_wgmma"] == before["tma_wgmma"]
        torch.testing.assert_close(got.float(), tcc.conv3x3x3_cw_reference(x_cw, w).float(),
                                   rtol=1.6e-2, atol=2e-2)


# bf16 channels-last with C % 8 == 0 on the TMA + wgmma design: (B, D, H, W)
# with H and W that no tile divides, W < 8, W = 16; C = 24 leaves the second
# 16-channel chunk half empty
CL_SHAPES = [(2, 3, 9, 13), (1, 4, 5, 6), (2, 3, 16, 16)]
CL_C, CL_O = [8, 24, 48], [8, 40, 48, 96, 192]


def _cl_prologue(b, c, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(b, c, device=device, generator=g) * 0.5,
            torch.rand(b, c, device=device, generator=g) + 0.5)


@pytest.mark.cuda
class TestConvChannelsLastTmaOnCard:
    def _run(self, device, bdhw, c, o, prologue, act, stats):
        x, w = _conv_inputs(bdhw, c, o, device, seed=4)
        x = x.to(torch.bfloat16)
        pro = _cl_prologue(bdhw[0], c, device) if prologue else None
        before = dict(tcc.design_launches)
        got = tfc.conv3x3x3_fused(x, w, prologue=pro, emit_stats=stats, act=act)
        want = tfc.conv3x3x3_fused_reference(x, w, prologue=pro, emit_stats=stats, act=act)
        torch.cuda.synchronize()
        # one launch, on this design
        assert tcc.design_launches == {
            k: v + (k == "tma_wgmma_cl") for k, v in before.items()}
        y, wy = (got[0], want[0]) if stats else (got, want)
        assert y.dtype == torch.bfloat16 and y.shape == wy.shape
        torch.testing.assert_close(y.float(), wy.float(), rtol=1.6e-2, atol=2e-2)
        if stats:
            st, wst = got[1], want[1]
            torch.testing.assert_close(st, wst, rtol=1e-4, atol=1e-4 * float(wst.abs().max()))
        return got

    @pytest.mark.parametrize("o", CL_O)
    @pytest.mark.parametrize("c", CL_C)
    @pytest.mark.parametrize("bdhw", CL_SHAPES)
    def test_matches_plain(self, cuda_device, bdhw, c, o):
        x, w = _conv_inputs(bdhw, c, o, cuda_device)
        x = x.to(torch.bfloat16)
        before = tcc.design_launches["tma_wgmma_cl"]
        got = tcc.conv3x3x3_batched(x, w, block_h=bdhw[2])
        torch.cuda.synchronize()
        assert tcc.design_launches["tma_wgmma_cl"] == before + 1
        torch.testing.assert_close(got.float(), tcc.conv3x3x3_reference(x, w).float(),
                                   rtol=1.6e-2, atol=2e-2)
        self._run(cuda_device, bdhw, c, o, prologue=True, act=True, stats=True)

    @pytest.mark.parametrize("stats", [False, True])
    @pytest.mark.parametrize("act", [False, True])
    @pytest.mark.parametrize("prologue", [False, True])
    def test_prologue_and_statistics_options(self, cuda_device, prologue, act, stats):
        self._run(cuda_device, (2, 3, 9, 13), 24, 40, prologue, act, stats)

    def test_statistics_bit_identical(self, cuda_device):
        x, w = _conv_inputs((2, 4, 16, 16), 48, 48, cuda_device, seed=5)
        x = x.to(torch.bfloat16)
        pro = _cl_prologue(2, 48, cuda_device)
        y, st = tfc.conv3x3x3_fused(x, w, prologue=pro, emit_stats=True)
        y2, st2 = tfc.conv3x3x3_fused(x, w, prologue=pro, emit_stats=True)
        torch.cuda.synchronize()
        assert torch.equal(st, st2) and torch.equal(y, y2)

    def test_prologue_keeps_the_halo_zero(self, cuda_device):
        # a constant input normalised to exactly 0 inside the volume gives 0
        # everywhere only if the padded border is also 0 after normalisation
        x = torch.full((1, 3, 9, 13, 8), 2.0, device=cuda_device, dtype=torch.bfloat16)
        w = torch.ones(3, 3, 3, 8, 16, device=cuda_device)
        pro = (torch.full((1, 8), 2.0, device=cuda_device), torch.ones(1, 8, device=cuda_device))
        before = tcc.design_launches["tma_wgmma_cl"]
        y = tfc.conv3x3x3_fused(x, w, prologue=pro, act=False)
        torch.cuda.synchronize()
        assert tcc.design_launches["tma_wgmma_cl"] == before + 1
        assert float(y.abs().max()) == 0.0

    @pytest.mark.parametrize("kh,kw", [(kh, kw) for kh in range(3) for kw in range(3)])
    def test_tap_shifted_product(self, cuda_device, kh, kw):
        # one m64n16k16 wgmma with A at a tap's offset into a [10][18][16]
        # halo (32-byte voxel rows, 32-byte swizzle) and B from the per-tap
        # packing
        rows, row_cells, cell0 = 10, 18, 8  # M tile (0, 1) of an 8 × 16 block
        rng = np.random.default_rng(kh * 3 + kw)
        halo = rng.standard_normal((rows, row_cells, 16)).astype(np.float32)
        wt = rng.standard_normal((16, 16)).astype(np.float32)  # [n][k]
        halo_t = torch.from_numpy(halo).to(cuda_device, torch.bfloat16).contiguous()
        wt_t = torch.from_numpy(wt).to(cuda_device, torch.bfloat16).contiguous()
        out = torch.empty(64, 16, device=cuda_device)
        cell = cell0 + kh * row_cells + kw
        fn = _build.LIBRARIES.get("conv3").wft_conv3_cl_probe
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        err = fn(halo_t.data_ptr(), wt_t.data_ptr(), out.data_ptr(), rows, row_cells, cell,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "conv3 tap probe")
        torch.cuda.synchronize()
        # row m = 8r + c reads cell (r + kh, c + kw) of the tile, all 16 channels
        cells = halo_t.float().cpu().numpy().reshape(-1, 16)
        a = np.stack([cells[cell + r * row_cells + c] for r in range(8) for c in range(8)])
        want = a @ wt_t.float().cpu().numpy().T
        np.testing.assert_allclose(out.cpu().numpy(), want, rtol=1e-5, atol=1e-4)


# (M, K, N): a ragged row block with N % 16 == 8, a K tail of half a stage,
# and one of the int8 probe's shapes
TM_SHAPES = [(96, 48, 40), (64, 2080, 24), (16384, 2048, 512)]
# M, N and K that are no multiple of the 128 × 256 × 64 (bf16) or 128 × 256
# × 128-byte (int8) tile; int8 keeps K % 16 == 0 and has N % 16 == 8
TM_RAGGED = [(1000, 1024, 512), (300, 200, 264)]
TM_RAGGED_INT8 = [(1000, 1024, 512), (300, 208, 264)]


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
            # int8: one transpose of w per product
            assert ttm.launches["w_kmajor"] == before["w_kmajor"] + (kind == "int8")
            assert got.dtype == out_dtype and tuple(got.shape) == (m, n)
            if kind == "int8":
                assert torch.equal(got, want)
            else:
                scale = (x.float().abs() + abs(s0)) @ w.float().abs() + abs(s0)
                assert bool(((got - want).abs() <= 1e-4 * scale).all())

    @pytest.mark.parametrize("perturb_out", [False, True])
    @pytest.mark.parametrize("m,k,n", TM_RAGGED)
    def test_bf16_ragged_tiles(self, cuda_device, m, k, n, perturb_out):
        x, w = _tm_inputs("bf16", m, k, n, cuda_device, seed=1)
        for s0 in (0.0, 3.7, -2.5):
            s = torch.zeros(8, device=cuda_device)
            s[0] = s0
            got = ttm.tiled_matmul(s, x, w, out_dtype=torch.float32, perturb_out=perturb_out)
            want = ttm.tiled_matmul_reference(s, x, w, out_dtype=torch.float32,
                                              perturb_out=perturb_out)
            torch.cuda.synchronize()
            scale = (x.float().abs() + abs(s0)) @ w.float().abs() + abs(s0)
            assert bool(((got - want).abs() <= 1e-4 * scale).all())

    @pytest.mark.parametrize("perturb_out", [False, True])
    @pytest.mark.parametrize("m,k,n", TM_RAGGED_INT8)
    def test_int8_ragged_tiles(self, cuda_device, m, k, n, perturb_out):
        x, w = _tm_inputs("int8", m, k, n, cuda_device, seed=1)
        x[0, :4] = torch.tensor([126, 125, -127, -126], dtype=torch.int8)  # x ⊕ s wraps
        for s0 in (0.0, 3.7, -2.5):
            s = torch.zeros(8, device=cuda_device)
            s[0] = s0
            before = dict(ttm.launches)
            got = ttm.tiled_matmul(s, x, w, out_dtype=torch.int32, perturb_out=perturb_out)
            want = ttm.tiled_matmul_reference(s, x, w, out_dtype=torch.int32,
                                              perturb_out=perturb_out)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert ttm.launches == {**before, "tiled_matmul_int8": before["tiled_matmul_int8"] + 1,
                                    "w_kmajor": before["w_kmajor"] + 1}
            assert ttm.design(torch.int8) == "tma_wgmma_s8"

    @pytest.mark.parametrize("k,n", [(48, 40), (2080, 24), (1024, 512), (208, 264)])
    def test_w_kmajor_matches_plain(self, cuda_device, k, n):
        _, w = _tm_inputs("int8", 16, k, n, cuda_device, seed=2)
        before = ttm.launches["w_kmajor"]
        got = ttm.w_kmajor(w)
        torch.cuda.synchronize()
        assert ttm.launches["w_kmajor"] == before + 1
        assert got.is_contiguous() and torch.equal(got, ttm.w_kmajor_reference(w))

    def test_designs(self, cuda_device):
        assert ttm.design(torch.bfloat16) == "tma_wgmma"
        assert ttm.design(torch.int8) == "tma_wgmma_s8"

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
