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
                assert tdc.library_design(dtype, c, wgrad=True) == tdc.design(dtype, c)


# the five stencil shapes of a flagship training step at batch 4
DW_TRAIN_B4 = [(4, 64, 64, 64, 192), (4, 64, 64, 64, 96), (4, 32, 32, 32, 384),
               (4, 16, 16, 16, 768), (4, 8, 8, 8, 1536)]


def _stencil_backward_inputs(device, shape, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, device=device, generator=g).to(dtype)
    w = 0.2 * torch.randn(3, 3, 3, shape[-1], device=device, generator=g)
    dout = torch.randn(shape, device=device, generator=g).to(dtype)
    return x, w, dout


def _assert_backward_close(got, x, w, dout):
    """The kernels' (dx, dk, db) against `dwconv3_backward` in fp32 on the
    same inputs. Both sum in fp32 in other orders: within 1e-5 of the sum of
    the terms' magnitudes (that backward on |x|, |w|, |g|). dx is rounded
    once to x's dtype by both sides: in bf16 half an ulp, 2^-8 of |dx|."""
    want = tdc.dwconv3_backward(x, w, dout)
    mag = tdc.dwconv3_backward(x.abs(), w.abs(), dout.abs())
    rtol = 0.0 if x.dtype == torch.float32 else 2.0**-8
    dx, dk, db = got
    assert dx.dtype == x.dtype and dx.shape == x.shape
    assert dk.dtype == db.dtype == torch.float32 and dk.shape == w.shape
    for name, a, ref, m, r in (("dx", dx, want[0], mag[0], rtol), ("dk", dk, want[1], mag[1], 0.0),
                               ("db", db, want[2], mag[2], 0.0)):
        err = (a.float() - ref).abs()
        bound = r * ref.abs() + 1e-5 * m + 1e-30
        worst = float((err / bound).max())
        assert worst <= 1.0, (name, worst, float(err.max()))


@pytest.mark.cuda
class TestDWConv3Backward:
    """The stencil's backward kernels (dgrad on the forward kernel with the
    taps flipped, `wft_dwconv3_wgrad`) against the plain composition."""

    @pytest.mark.parametrize("shape", DW_TRAIN_B4)
    def test_tma_ring_matches_plain(self, cuda_device, shape):
        x, w, dout = _stencil_backward_inputs(cuda_device, shape, torch.bfloat16, 0)
        before = dict(tdc.backward_design_launches)
        got = tdc.backward_kernels(x, w, dout)
        torch.cuda.synchronize()
        assert tdc.backward_design_launches == dict(
            before, dgrad_tma_ring=before["dgrad_tma_ring"] + 1,
            wgrad_tma_ring=before["wgrad_tma_ring"] + 1)
        _assert_backward_close(got, x, w, dout)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("c", [4, 12, 20])
    def test_vector_matches_plain(self, cuda_device, dtype, c):
        x, w, dout = _stencil_backward_inputs(cuda_device, (2, 6, 5, 7, c), dtype, c)
        before = dict(tdc.backward_design_launches)
        got = tdc.backward_kernels(x, w, dout)
        torch.cuda.synchronize()
        assert tdc.backward_design_launches == dict(
            before, dgrad_vector=before["dgrad_vector"] + 1,
            wgrad_vector=before["wgrad_vector"] + 1)
        _assert_backward_close(got, x, w, dout)

    @pytest.mark.parametrize("shape", [(2, 32, 32, 32, 192), (1, 3, 17, 9, 200),
                                       (2, 8, 8, 8, 96), (1, 1, 1, 1, 64)])
    def test_fp32_and_ragged_tiles(self, cuda_device, shape):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dout = _stencil_backward_inputs(cuda_device, shape, dtype, sum(shape))
            _assert_backward_close(tdc.backward_kernels(x, w, dout), x, w, dout)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_halo_slab(self, cuda_device, dtype):
        # a spatial=2 rank's (D/2 + 2)-plane slab: its gradient is zero on the
        # two halo planes, which the model drops after the stencil
        x, w, dout = _stencil_backward_inputs(cuda_device, (1, 34, 64, 64, 192), dtype, 7)
        dout[:, 0] = 0
        dout[:, -1] = 0
        _assert_backward_close(tdc.backward_kernels(x, w, dout), x, w, dout)

    @pytest.mark.parametrize("shape,dtype", [((4, 64, 64, 64, 96), torch.bfloat16),
                                             ((4, 8, 8, 8, 1536), torch.bfloat16),
                                             ((2, 16, 16, 16, 20), torch.float32)])
    def test_bit_identical(self, cuda_device, shape, dtype):
        x, w, dout = _stencil_backward_inputs(cuda_device, shape, dtype, 1)
        first = tdc.backward_kernels(x, w, dout)
        again = tdc.backward_kernels(x, w, dout)
        assert all(torch.equal(a, b) for a, b in zip(first, again))

    @pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 96), (torch.float32, 96),
                                         (torch.bfloat16, 12)])
    @pytest.mark.parametrize("with_bias", [True, False])
    def test_autograd_counts(self, cuda_device, dtype, c, with_bias):
        x, w, dout = _stencil_backward_inputs(cuda_device, (2, 9, 8, 8, c), dtype, 3)
        b = torch.randn(c, device=cuda_device) if with_bias else None
        ins = [t.clone().requires_grad_(True) for t in (x, w) + ((b,) if with_bias else ())]
        y = tdc.dwconv3(*ins)
        fwd = (tdc.launches, dict(tdc.design_launches))
        before = dict(tdc.backward_design_launches)
        y.backward(dout)
        torch.cuda.synchronize()
        name = tdc.design(dtype, c)
        assert (tdc.launches, tdc.design_launches) == fwd
        assert tdc.backward_design_launches == dict(
            before, **{f"dgrad_{name}": before[f"dgrad_{name}"] + 1,
                       f"wgrad_{name}": before[f"wgrad_{name}"] + 1})
        dx, dk, db = tdc.backward_kernels(x, w, dout, with_bias)
        assert torch.equal(ins[0].grad, dx) and torch.equal(ins[1].grad, dk)
        assert (db is None) == (not with_bias)
        assert db is None or torch.equal(ins[2].grad, db)


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


# shifted windows (Swin): N = 343 at every TMA head dim, a ragged 4³ window,
# and N = 343 / 216 on the FMA kernel (D % 16 != 0, and every fp32 call)
MASKED_SHAPES = [(3, 343, 16), (2, 343, 32), (2, 343, 48), (2, 343, 64), (2, 64, 16),
                 (2, 343, 8), (2, 216, 24)]


@pytest.mark.cuda
class TestMaskedWindowAttention:
    """Per-window shift labels (nW, N) uint8 against the plain composition
    with MONAI's −100 mask; windows b take labels b % nW."""

    def _inputs(self, device, nw, h, n, d, dtype, labels=None):
        q, k, v, b = (torch.from_numpy(a).to(device) for a in _qkvb(2 * nw, h, n, d, seed=n + d))
        if labels is None:  # every pair of regions present, far harsher than a shift's
            rng = np.random.RandomState(n * 7 + d)
            labels = rng.randint(0, 27, (nw, n)).astype(np.uint8)
        return (*(t.to(dtype) for t in (q, k, v)), b, torch.as_tensor(labels).to(device))

    def _check(self, q, k, v, b, labels, rtol, atol):
        n, d = q.shape[2], q.shape[3]
        name = tac.design(q.dtype, n, d)
        before, masked = dict(tac.design_launches), tac.masked_launches
        got = tac.window_attention(q, k, v, b, d**-0.5, labels)
        want = tac.window_attention_reference(q, k, v, b, d**-0.5, labels)
        torch.cuda.synchronize()
        assert tac.design_launches[name] == before[name] + 1
        assert tac.masked_launches == masked + 1
        assert got.dtype == q.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        return name

    @pytest.mark.parametrize("h,n,d", MASKED_SHAPES)
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_masked_matches_plain(self, cuda_device, h, n, d, dtype, rtol, atol):
        args = self._inputs(cuda_device, 4, h, n, d, dtype)
        assert self._check(*args, rtol, atol) == tac.design(dtype, n, d)

    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_shift_labels_of_a_padded_stage(self, cuda_device, dtype, rtol, atol):
        """The labels a shifted block passes: 14³ padded from 8³ or 12³, 8 windows."""
        from waveformer_tpu_torch.ops.window import shift_labels

        labels = shift_labels((14, 14, 14), (7, 7, 7), (3, 3, 3))
        args = self._inputs(cuda_device, 8, 3, 343, 16, dtype, labels)
        self._check(*args, rtol, atol)

    @pytest.mark.parametrize("h,n,d", MASKED_SHAPES)
    def test_uniform_labels_equal_the_unmasked_launch(self, cuda_device, h, n, d):
        """No pair differs: the masked kernel adds 0 to every score, so its
        result is the unmasked launch's, bit for bit."""
        q, k, v, b, _ = self._inputs(cuda_device, 4, h, n, d, torch.bfloat16)
        labels = torch.zeros((4, n), dtype=torch.uint8, device=cuda_device)
        got = tac.window_attention(q, k, v, b, d**-0.5, labels)
        assert torch.equal(got, tac.window_attention(q, k, v, b, d**-0.5))

    def test_labels_are_checked(self, cuda_device):
        q, k, v, b, labels = self._inputs(cuda_device, 4, 3, 343, 16, torch.bfloat16)
        with pytest.raises(ValueError, match="do not divide"):
            tac.window_attention(q, k, v, b, 0.25, labels[:3])
        with pytest.raises(ValueError, match="uint8"):
            tac.window_attention(q, k, v, b, 0.25, labels.int())

    def test_masked_gradients(self, cuda_device):
        """The backward is the plain composition's, mask included."""
        q, k, v, b, labels = self._inputs(cuda_device, 4, 3, 343, 16, torch.float32)
        dout = torch.randn_like(q)
        got = _grads(lambda *a: tac.window_attention(*a, 0.25, labels), (q, k, v, b), dout)
        want = _grads(lambda *a: tac.window_attention_reference(*a, 0.25, labels),
                      (q, k, v, b), dout)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


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


# the serving scripts at a small config: the 32³ example network (head dim 4,
# so every attention call runs the `fma` design), two (4, 40, 44, 36) cases
SERVING_NET = """\
network:
  in_channels: 4
  out_channels: 4
  img_size: [32, 32, 32]
  patch_size: 2
  transformer:
    embed_dims: [8, 16, 32, 64]
    depths: [1, 1, 1, 1]
    num_heads: [2, 4, 8, 8]
    decom_levels: [3, 2, 1, 0]
    drop_path_rate: 0.0
"""
SERVING_BBOXES = [((1, 41), (3, 47), (5, 41)), ((2, 42), (4, 48), (6, 42))]


def _serving_tree(root, dtype_name):
    import os

    from waveformer_tpu_torch.config import load_config
    from waveformer_tpu_torch.tools import synthetic_cases

    affine = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
    names = synthetic_cases.write_cases(str(root), np.random.default_rng(0), (46, 50, 42),
                                        SERVING_BBOXES, affine)
    config = os.path.join(str(root), "config.yaml")
    with open(config, "w") as f:
        f.write(f'data_dir: "{root}/fullres"\nlogdir: "{root}/logs/"\n'
                f'raw_data_dir: "{root}/raw"\ndata_list_path: "{root}/data_list"\n'
                f'compute_dtype: "{dtype_name}"\nlogging:\n  enabled: false\n'
                f'prediction:\n  patch_size: [32, 32, 32]\n  sw_batch_size: 8\n'
                f'  overlap: 0.5\n  prediction_save: "{root}/pred"\n' + SERVING_NET)
    cfg = load_config(config)
    synthetic_cases.write_checkpoint(os.path.join(str(root), "logs", "model",
                                                  "best_model_0.0000_card.npz"),
                                     cfg.network.model_kwargs(), seed=0)
    return config, cfg, names


def _zero_counts():
    for counter in (tac, tdc):
        counter.launches = 0
        for k in counter.design_launches:
            counter.design_launches[k] = 0


def _counts():
    return {"attention": dict(tac.design_launches), "dwconv3": dict(tdc.design_launches)}


@pytest.mark.cuda
class TestServingOnCard:
    def test_dice_torch_matches_host(self, cuda_device):
        from waveformer_tpu_torch.metrics import dice, dice_torch

        rng = np.random.default_rng(0)
        p = rng.random((5, 24, 20, 16)) < 0.3
        g = rng.random((5, 24, 20, 16)) < 0.4
        p[3], g[3] = False, False  # both empty → 1
        p[4] = False  # one empty → 0
        got = dice_torch(torch.from_numpy(p).to(cuda_device),
                         torch.from_numpy(g).to(cuda_device)).cpu().double().numpy()
        want = [dice(p[i], g[i]) for i in range(3)] + [1.0, 0.0]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
    def test_predict_script_launches(self, cuda_device, tmp_path, dtype_name):
        """The script's launches per design equal those of `predict_case` on
        the same cases with the same seed-0 model, and its files equal
        `predict_case` + `save_to_nii`."""
        import os
        import pickle

        from waveformer_tpu_torch import bench
        from waveformer_tpu_torch.scripts import predict
        from waveformer_tpu_torch.utils import nifti

        config, cfg, names = _serving_tree(tmp_path, dtype_name)
        model, predictor = bench.setup(cfg, cuda_device)
        _zero_counts()
        refs = []
        for name in names:
            base = os.path.join(str(tmp_path), "fullres", name)
            with open(base + ".pkl", "rb") as f:
                props = pickle.load(f)
            ref = os.path.join(str(tmp_path), name + "_ref.nii.gz")
            predictor.save_to_nii(predictor.predict_case(np.load(base + ".npy"), model, 4, props),
                                  ref, properties=props)
            refs.append(ref)
        want = _counts()
        _zero_counts()
        assert predict.main(["--config", config, "--tta", "8"])["cases"] == len(names)
        assert _counts() == want
        assert want["attention"]["tma_wgmma"] == 0 and want["attention"]["fma"] > 0
        if dtype_name == "float32":
            assert want["dwconv3"]["tma_ring"] == 0 and want["dwconv3"]["vector"] > 0
        else:
            assert want["dwconv3"]["tma_ring"] > 0
        for name, ref in zip(names, refs):
            got = nifti.load(os.path.join(str(tmp_path), "pred", name + ".nii.gz"))
            np.testing.assert_array_equal(got.data, nifti.load(ref).data)
            np.testing.assert_array_equal(got.affine, nifti.load(ref).affine)


# (B·nW, H, N, D) of a batch-2 flagship training forward's attention calls,
# and (B, D, H, W, C) of its depthwise convs
TRAIN_ATTN_SHAPES = [(128, 3, 512, 16), (16, 6, 512, 16), (2, 24, 512, 16)]
TRAIN_DW_SHAPES = [(2, 64, 64, 64, 192), (2, 32, 32, 32, 384), (2, 8, 8, 8, 1536),
                   (2, 64, 64, 64, 96)]
EXAMPLE_32 = dict(img_size=(32, 32, 32), patch_size=2, in_chans=4, out_chans=4,
                  embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8),
                  decom_levels=(3, 2, 1, 0), drop_path_rate=0.0)


def _grads(fn, ins, g):
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    fn(*ins).backward(g)
    return [t.grad.float() for t in ins]


@pytest.mark.cuda
class TestTrainingOnCard:
    """Gradients through the kernels' `autograd.Function`s on the card at the
    batch-2 flagship's shapes, against the plain versions' gradients (fp32
    sums in other orders; bf16: the plain version run in fp32 on the same
    bf16 inputs, one bf16 rounding of each gradient), and one train step of
    the 32³ network, card against CPU."""

    @pytest.mark.parametrize("shape", TRAIN_ATTN_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_window_attention_gradients(self, cuda_device, shape, dtype):
        bw, h, n, d = shape
        g = torch.Generator(device=cuda_device).manual_seed(0)
        q, k, v = (torch.randn(shape, device=cuda_device, generator=g).to(dtype)
                   for _ in range(3))
        bias = 0.5 * torch.randn(h, n, n, device=cuda_device, generator=g)
        dout = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
        before = tac.launches
        got = _grads(lambda *a: tac.window_attention(*a, 0.25), (q, k, v, bias), dout)
        assert tac.launches == before + 1
        want = _grads(lambda *a: tac.window_attention_reference(*a, 0.25),
                      [t.float() for t in (q, k, v)] + [bias], dout.float())
        rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (1.6e-2, 2e-2)
        for a, b in zip(got, want):
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol * max(1.0, scale))

    @pytest.mark.parametrize("shape", TRAIN_DW_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_dwconv3_gradients(self, cuda_device, shape, dtype):
        c = shape[-1]
        g = torch.Generator(device=cuda_device).manual_seed(0)
        x = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
        w = 0.2 * torch.randn(3, 3, 3, c, device=cuda_device, generator=g)
        b = torch.randn(c, device=cuda_device, generator=g)
        dout = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
        before = tdc.launches
        got = _grads(tdc.dwconv3, (x, w, b), dout)
        assert tdc.launches == before + 1
        want = _grads(tdc.dwconv3_reference, (x.float(), w, b), dout.float())
        rtol = 1e-5 if dtype == torch.float32 else 1.6e-2
        for a, ref in zip(got, want):
            # the kernel and bias gradients sum over B·D·H·W voxels
            torch.testing.assert_close(a, ref, rtol=rtol, atol=1e-5 * float(ref.abs().max())
                                       + (0 if dtype == torch.float32 else 2e-2))

    def test_train_step_card_vs_cpu(self, cuda_device):
        from waveformer_tpu_torch.models import create_waveformer
        from waveformer_tpu_torch.training.losses import dice_ce_loss
        from waveformer_tpu_torch.training.state import (
            TrainState, make_optimizer, make_train_step, master_params)

        rng = np.random.default_rng(0)
        data = torch.from_numpy(rng.standard_normal((2, 32, 32, 32, 4)).astype(np.float32))
        seg = torch.from_numpy(rng.integers(0, 4, (2, 32, 32, 32, 1)).astype(np.int32))
        out = {}
        for dev in ("cpu", cuda_device):
            model = create_waveformer(EXAMPLE_32, device=dev, seed=0).train()
            state = TrainState.create(master_params(model), make_optimizer(lr=1e-4))
            _, m = make_train_step(model, dice_ce_loss)(
                state, {"data": data.to(dev), "seg": seg.to(dev)})
            out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                             {k: v.detach().cpu() for k, v in state.params.items()})
        (l0, n0, p0), (l1, n1, p1) = out["cpu"], out[str(cuda_device)]
        assert abs(l1 - l0) <= 1e-4 * abs(l0) and abs(n1 - n0) <= 1e-3 * n0
        assert max(float((p1[k] - p0[k]).abs().max()) for k in p0) <= 1e-5


def _front_end_tree(root, n):
    """`n` raw BraTS-named cases (46, 50, 42) under a non-RAS affine,
    renamed, with the 32³ network's bf16 config and a seed-0 checkpoint."""
    import os

    from waveformer_tpu_torch.config import load_config
    from waveformer_tpu_torch.scripts import rename_data
    from waveformer_tpu_torch.tools import synthetic_cases

    affine = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
    raw = os.path.join(str(root), "raw")
    names = synthetic_cases.write_raw_cases(raw, np.random.default_rng(0), (46, 50, 42),
                                            affine, n, margin=(4, 5, 3))
    rename_data.rename_dataset(raw)
    config = os.path.join(str(root), "config.yaml")
    with open(config, "w") as f:
        f.write(f'data_dir: "{root}/fullres"\nraw_data_dir: "{raw}"\n'
                f'compute_dtype: "bfloat16"\nlogging:\n  enabled: false\n'
                f'prediction:\n  patch_size: [32, 32, 32]\n  sw_batch_size: 8\n'
                f'  overlap: 0.5\n' + SERVING_NET)
    ckpt = os.path.join(str(root), "model.npz")
    synthetic_cases.write_checkpoint(ckpt, load_config(config).network.model_kwargs(), seed=0)
    return raw, config, ckpt, names, affine


@pytest.mark.cuda
class TestFrontEndOnCard:
    """The front end on the card's machine: the deploy wrapper from raw
    BraTS-named NIfTIs through the kernels (launches per design equal to
    its own in-process pipeline's, the file equal to that pipeline's), and
    `scripts.preprocess` with 2 spawn workers equal to its in-process run."""

    def test_deploy_launches_per_design(self, cuda_device, tmp_path):
        import os

        from waveformer_tpu_torch.deploy import process
        from waveformer_tpu_torch.utils import nifti

        raw, config, ckpt, names, affine = _front_end_tree(tmp_path, 1)
        _zero_counts()
        algo = process.main(["--checkpoint", ckpt, "--config", config, "--input-dir", raw,
                             "--output-dir", str(tmp_path / "out")])
        got_counts = _counts()
        assert algo.device.type == "cuda"
        _zero_counts()
        data, _, props = algo.preprocessor.read_data(names[0])
        data, _, props = algo.preprocessor.run_case_npy(data, None, props)
        assert data.shape[1:] != props["shape_before_cropping"]  # a real crop
        seg = algo.predictor.predict_case(data, algo.model, 4, props)
        assert _counts() == got_counts
        assert got_counts["attention"]["tma_wgmma"] == 0 and got_counts["attention"]["fma"] > 0
        assert got_counts["dwconv3"]["tma_ring"] > 0
        ref = str(tmp_path / "ref.nii.gz")
        algo.predictor.save_to_nii(seg, ref, properties=props)
        out = nifti.load(os.path.join(str(tmp_path / "out"), names[0] + ".nii.gz"))
        assert out.data.shape == (46, 50, 42)
        np.testing.assert_array_equal(out.affine, affine)
        np.testing.assert_array_equal(out.data, nifti.load(ref).data)

    def test_preprocess_two_workers(self, cuda_device, tmp_path):
        import os
        import pickle

        from waveformer_tpu_torch.scripts import preprocess

        raw, config, _, names, _ = _front_end_tree(tmp_path, 3)
        done = preprocess.main(["--config", config, "--num-processes", "2"])
        assert done == names
        preprocess.main(["--config", config, "--num-processes", "1",
                         "--out-dir", str(tmp_path / "one")])
        fullres = str(tmp_path / "fullres")
        assert sorted(os.listdir(fullres)) == sorted(os.listdir(str(tmp_path / "one")))
        for name in names:
            with np.load(os.path.join(fullres, name + ".npz")) as a, \
                    np.load(os.path.join(str(tmp_path / "one"), name + ".npz")) as b:
                for k in ("data", "seg"):
                    np.testing.assert_array_equal(a[k], b[k])
            with open(os.path.join(fullres, name + ".pkl"), "rb") as f:
                props = pickle.load(f)
            assert sorted(props["class_locations"]) == [1, 2, 3]


@pytest.mark.cuda
class TestSslOnCard:
    def test_ssl_step_card_vs_cpu(self, cuda_device):
        """One fp32 SSL step of a 32³ SSLViT at batch 2, the card against
        the CPU from the same weights and views: loss 1e-4 relative,
        gradient norm 1e-3 relative, masters 1e-5 absolute (TF32 off)."""
        from waveformer_tpu_torch.models.ssl import create_ssl_vit
        from waveformer_tpu_torch.training.ssl import make_ssl_step, make_two_views
        from waveformer_tpu_torch.training.state import TrainState, make_optimizer

        cfg = dict(img_size=(32, 32, 32), patch_size=8, in_channels=4, hidden_size=64,
                   mlp_dim=256, num_layers=2, num_heads=4, projection_size=16)
        gt = np.random.default_rng(0).standard_normal((2, 32, 32, 32, 4)).astype(np.float32)
        views = make_two_views(gt.transpose(0, 4, 1, 2, 3), np.random.RandomState(0))
        v1, v2 = (np.ascontiguousarray(v.transpose(0, 2, 3, 4, 1)) for v in views)
        weights = create_ssl_vit(device="cpu", seed=0, **cfg).state_dict()
        out = {}
        for dev in ("cpu", cuda_device):
            model = create_ssl_vit(device=dev, **cfg).train()
            model.load_state_dict(weights, strict=True)
            state = TrainState.create(dict(model.named_parameters()), make_optimizer(
                lr=1e-4, weight_decay=1e-5, grad_clip_norm=None))
            _, m = make_ssl_step(model)(state, *(torch.from_numpy(a).to(dev)
                                                 for a in (v1, v2, gt)))
            out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                             {k: v.detach().cpu() for k, v in state.params.items()})
        (l0, n0, p0), (l1, n1, p1) = out["cpu"], out[str(cuda_device)]
        assert np.isfinite(l1) and abs(l1 - l0) <= 1e-4 * abs(l0)
        assert abs(n1 - n0) <= 1e-3 * n0
        assert max(float((p1[k] - p0[k]).abs().max()) for k in p0) <= 1e-5


# the shapes the sharded flagship forward gives the kernels: a tensor rank's
# hidden channels (Ch/3) on a spatial rank's slab of 2 (D/2), and a rank's
# heads of a stage (H/3) at the stage's windows
SLAB_SHAPES = [(1, 64, 64, 64, 64), (1, 32, 32, 32, 128), (1, 8, 8, 8, 512), (2, 8, 6, 7, 20)]
HEAD_SUBSETS = [((512, 3, 512, 16), 1), ((64, 6, 512, 16), 2), ((8, 24, 512, 16), 8)]


@pytest.mark.cuda
class TestModelParallelKernelsOnCard:
    @pytest.mark.parametrize("shape", SLAB_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_stencil_on_halo_slab_equals_whole_volume(self, cuda_device, shape, dtype):
        """Each rank of 2 runs the stencil on its D slab with one plane of
        each neighbour (zeros beyond the volume) and drops the two edge
        planes: the same 27 taps a voxel as the whole volume's call."""
        x = torch.randn(shape, device=cuda_device).to(dtype)
        k = torch.randn(3, 3, 3, shape[-1], device=cuda_device)
        b = torch.randn(shape[-1], device=cuda_device)
        whole = tdc.dwconv3(x, k, b)
        padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
        dl = shape[1] // 2
        for r in range(2):
            got = tdc.dwconv3(padded[:, r * dl:(r + 1) * dl + 2].contiguous(), k, b)[:, 1:-1]
            assert torch.equal(got, whole[:, r * dl:(r + 1) * dl])

    @pytest.mark.parametrize("full,heads", HEAD_SUBSETS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_window_attention_on_head_subset(self, cuda_device, full, heads, dtype):
        """A tensor rank's call on its heads equals those heads of the full
        call (the heads are independent)."""
        bw, h, n, d = full
        q, k, v, b = (torch.from_numpy(a).to(cuda_device) for a in _qkvb(bw, h, n, d))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        whole = tac.window_attention(q, k, v, b, d**-0.5)
        for h0 in range(0, h, heads):
            s = slice(h0, h0 + heads)
            got = tac.window_attention(q[:, s], k[:, s], v[:, s], b[s], d**-0.5)
            assert torch.equal(got, whole[:, s])

    @pytest.mark.parametrize("shape", SLAB_SHAPES)
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_stencil_backward_on_halo_slab_equals_whole_volume(self, cuda_device, shape, dtype,
                                                               rtol, atol):
        """The halo slabs' backwards (the plain 27-tap composition) summed
        over 2 ranks, each halo plane's gradient added to its neighbour's
        edge plane as the halo's backward does: the whole call's input,
        kernel and bias gradients, up to the sums' order."""
        x = torch.randn(shape, device=cuda_device).to(dtype)
        k = torch.randn(3, 3, 3, shape[-1], device=cuda_device)
        b = torch.randn(shape[-1], device=cuda_device)
        g = torch.randn(shape, device=cuda_device).to(dtype)

        def grads(fn):
            leaves = [t.clone().requires_grad_(True) for t in (x, k, b)]
            (fn(*leaves).float() * g.float()).sum().backward()
            return [t.grad.float() for t in leaves]

        def slabs(xx, kk, bb):
            padded = torch.nn.functional.pad(xx, (0, 0, 0, 0, 0, 0, 1, 1))
            dl = shape[1] // 2
            return torch.cat([tdc.dwconv3(padded[:, r * dl:(r + 1) * dl + 2].contiguous(), kk,
                                          bb)[:, 1:-1] for r in range(2)], dim=1)

        for got, want in zip(grads(slabs), grads(tdc.dwconv3)):
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol * float(want.abs().max()))

    @pytest.mark.parametrize("full,heads", HEAD_SUBSETS)
    @pytest.mark.parametrize("dtype,rtol,atol", TOLS)
    def test_window_attention_backward_on_head_subset(self, cuda_device, full, heads, dtype,
                                                      rtol, atol):
        """A tensor rank's backward on its heads (the plain composition)
        equals those heads' gradients of the full call's backward."""
        bw, h, n, d = full
        ins = [torch.from_numpy(a).to(cuda_device) for a in _qkvb(bw, h, n, d)]
        ins = [t.to(dtype) for t in ins[:3]] + [ins[3]]
        g = torch.randn(bw, h, n, d, device=cuda_device).to(dtype)

        def grads(heads_slice):
            leaves = [t[:, heads_slice].clone().requires_grad_(True) for t in ins[:3]]
            leaves.append(ins[3][heads_slice].clone().requires_grad_(True))
            out = tac.window_attention(*leaves, d**-0.5)
            (out.float() * g[:, heads_slice].float()).sum().backward()
            return [t.grad.float() for t in leaves]

        whole = grads(slice(None))
        for h0 in range(0, h, heads):
            s = slice(h0, h0 + heads)
            for got, want in zip(grads(s), [w[:, s] for w in whole[:3]] + [whole[3][s]]):
                torch.testing.assert_close(got, want, rtol=rtol,
                                           atol=atol * float(want.abs().max()))


def _aux_rel(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _aux_cases():
    """(name, fn, args, first) of the auxiliary ops at small sizes: fn runs
    on the args' device and returns a tensor or a tuple of tensors, the
    gradients from position `first` on."""
    from waveformer_tpu_torch.models import legacy2d as tl
    from waveformer_tpu_torch.ops import bilateral as tb
    from waveformer_tpu_torch.ops import cc_attention as tcc
    from waveformer_tpu_torch.ops import gmm as tg
    from waveformer_tpu_torch.ops import spatial as ts
    from waveformer_tpu_torch.ops import wavelet as tw

    g = torch.Generator().manual_seed(0)
    vol = torch.randn(12, 10, 9, 3, generator=g)
    crd = torch.rand(500, 3, generator=g) * 16 - 3
    u = torch.randn(500, 3, generator=g)

    def pull_grads(v, c, uu, order):
        v, c = v.clone().requires_grad_(True), c.clone().requires_grad_(True)
        (ts.grid_pull(v, c, ("reflect", "zero", "clamp"), order) * uu).sum().backward()
        return v.grad, c.grad

    def trainable(x, cot):
        mod = tb.TrainableBilateralFilter(0.8, 0.6).to(x.device)
        x = x.clone().requires_grad_(True)
        y = mod(x)
        (y * cot).sum().backward()
        return y.detach(), x.grad, mod.spatial_sigma.grad, mod.color_sigma.grad

    def cc(q, k, v, cot):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tcc.criss_cross_attention(*leaves)
        (out * cot).sum().backward()
        return (out.detach(), *(t.grad for t in leaves))

    def legacy(img):
        gen = torch.Generator().manual_seed(1)
        embed = tl.OverlapPatchEmbed2D(3, 16, 7, 4, generator=gen).to(img.device).eval()
        pos = tl.PosCNN2D(16, 1, generator=gen).to(img.device).eval()
        mlp = tl.Mlp2D(16, 32, generator=gen).to(img.device).eval()
        with torch.no_grad():
            tokens, h, w = embed(img)
            return tokens, mlp(pos(tokens, h, w))

    def wavelets(x):
        tw.register_wavelet("card_test_rot2", [0.6, 0.8], [-0.8, 0.6], [0.8, 0.6], [0.6, -0.8])
        try:
            coeffs = tw.wavedec3(x, "card_test_rot2", 2)
            return coeffs[0], tw.waverec3(coeffs, "card_test_rot2")
        finally:
            tw._WAVELETS.pop("card_test_rot2")

    vol4 = torch.randn(1, 10, 9, 8, 2, generator=g)
    feats = torch.cat([torch.randn(300, 3, generator=g), 3 + torch.randn(200, 3, generator=g)])
    # more voxels than a class's 4096 fitted rows, so the two fits differ
    seeds = torch.full((16, 16, 24), -1, dtype=torch.int64)
    seeds[:7], seeds[-3:] = 0, 1
    gvol = torch.randn(16, 16, 24, 3, generator=g)
    gvol[8:] += 3
    return [
        ("grid_pull", lambda v, c: tuple(ts.grid_pull(v, c, b, o) for o in range(4)
                                         for b in ts.BOUND_MODES), (vol, crd), None),
        ("grid_push_count", lambda uu, c: (ts.grid_push(uu, c, (12, 10, 9), "zero", 3),
                                           ts.grid_count(c, (12, 10, 9), "reflect", 1)),
         (u, crd), None),
        ("grid_pull_grads", lambda v, c, uu: pull_grads(v, c, uu, 3), (vol, crd, u), 0),
        ("spline_prefilter", lambda v: ts.spline_prefilter(v, 3), (vol,), None),
        ("bilateral", lambda x, gd: (tb.bilateral_filter(x, 1.0, 0.5),
                                     tb.joint_bilateral_filter(x, gd, 1.0, 0.5)),
         (vol4, torch.randn(1, 10, 9, 8, 3, generator=g)), None),
        ("trainable_bilateral", trainable, (vol4, torch.randn(1, 10, 9, 8, 2, generator=g)), 1),
        ("gmm", lambda f, vv, s: (*tg.gmm_fit(f, 2, 20, seed=0), tg.gmm_segment(vv, s)),
         (feats, gvol, seeds), None),
        ("criss_cross", cc, tuple(torch.randn(2, 7, 6, c, generator=g) for c in (4, 4, 5, 5)), 1),
        ("legacy2d", legacy, (torch.randn(2, 32, 28, 3, generator=g),), None),
        ("wavelets", wavelets, (torch.randn(2, 8, 7, 6, 3, generator=g),), None),
    ]


@pytest.mark.cuda
class TestAuxOpsOnCard:
    @pytest.mark.parametrize("index", range(10))
    def test_card_matches_cpu(self, cuda_device, index):
        """Each auxiliary op (no kernel of the port on its path) on CUDA
        tensors against the same call on CPU tensors: outputs on the card,
        forwards and GMM parameters within 1e-4 of each output's largest
        value, gradients within 1e-3 (the CPU tests' limits against JAX
        widened 10× for the card's summation order, as in chip_smoke.py
        phase 16: a bilateral sigma's gradient is a sum that cancels to
        0.0123 at this size, 3.8e-4 apart); GMM labels equal on 99.9% of
        the voxels (a label flips only at a likelihood tie)."""
        name, fn, args, first = _aux_cases()[index]
        want = fn(*args)
        got = fn(*(a.to(cuda_device) for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for i, (gt, wt) in enumerate(zip(got, want)):
            assert gt.is_cuda, name
            if wt.dtype == torch.int64:
                assert float((gt.cpu() == wt).float().mean()) >= 0.999, name
            else:
                limit = 1e-3 if first is not None and i >= first else 1e-4
                assert _aux_rel(gt, wt) <= limit, (name, i, _aux_rel(gt, wt))
