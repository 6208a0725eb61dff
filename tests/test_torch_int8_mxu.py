"""The port's tiled-matmul probe against JAX (`tools/exp_int8_mxu.py::make`).

`tools/exp_int8_mxu.py` runs full-size products when it is imported, so the
test takes its `make` out of the source with `ast` and runs it with Pallas
in interpret mode. On the CPU the port's `make` runs the plain version:
int8 must equal JAX bit for bit; bf16 → fp32 sums the same products in
another order, within 1e-5 of Σ|x'||w| (x' the perturbed input). The port's
profiling utilities and the probe's entry point are run at small sizes.

The CUDA kernel is held against the plain version on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import ast
import functools
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from waveformer_tpu_torch.ops import tiled_matmul_cuda as tmc
from waveformer_tpu_torch.tools import exp_int8_mxu as probe
from waveformer_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
# (M, K, N, BM): an odd N (40) and K = 96, a K of three 16-deep steps (48)
SHAPES = [(128, 96, 40, 64), (256, 128, 64, 64), (64, 48, 24, 32)]
S_VALUES = (0.0, 3.7, -2.5)
KINDS = {"bf16": (torch.bfloat16, jnp.bfloat16, torch.float32, jnp.float32),
         "int8": (torch.int8, jnp.int8, torch.int32, jnp.int32)}


@functools.lru_cache(maxsize=None)
def _jax_make():
    """`make` of tools/exp_int8_mxu.py, its `pallas_call` in interpret mode."""
    path = REPO / "tools" / "exp_int8_mxu.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make")
    ns = {"jax": jax, "jnp": jnp,
          "pl": types.SimpleNamespace(
              BlockSpec=pl.BlockSpec,
              pallas_call=functools.partial(pl.pallas_call, interpret=True))}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["make"]


def _inputs(kind, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.standard_normal((k, n)).astype(np.float32)
    else:
        x = rng.integers(-127, 127, (m, k)).astype(np.int8)
        w = rng.integers(-127, 127, (k, n)).astype(np.int8)
        x[0, :4] = (126, 125, -127, -126)  # x ⊕ s wraps for s = 3.7 and -2.5
    return x, w


class TestMakeMatchesJax:
    @pytest.mark.parametrize("perturb_out", [False, True])
    @pytest.mark.parametrize("kind", list(KINDS))
    @pytest.mark.parametrize("m,k,n,bm", SHAPES)
    def test_variant(self, m, k, n, bm, kind, perturb_out):
        tdt, jdt, tout, jout = KINDS[kind]
        x, w = _inputs(kind, m, k, n)
        jmm = jax.jit(_jax_make()(m, k, n, bm, jout, perturb_out))
        tmm = tmc.make(m, k, n, bm, tout, perturb_out)
        jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
        tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
        before = dict(tmc.launches)
        for s0 in S_VALUES:
            s = np.zeros(8, np.float32)
            s[0] = s0
            want = np.asarray(jmm(jnp.asarray(s), jx, jw))
            got = tmm(torch.from_numpy(s), tx, tw)
            assert got.dtype == tout and tuple(got.shape) == (m, n)
            if kind == "int8":
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                xs = np.abs(tx.float().numpy()) + abs(s0)
                scale = xs @ np.abs(tw.float().numpy()) + abs(s0)
                assert np.all(np.abs(got.numpy() - want) <= 1e-5 * scale)
        assert tmc.launches == before  # CPU tensors take the plain version


class TestRefusals:
    @pytest.mark.parametrize("args", [
        (100, 32, 16, 64, torch.float32),  # M % BM: JAX leaves the tail unwritten
        (128, 12, 16, 64, torch.float32),  # bf16 rows of 24 bytes
        (128, 24, 16, 64, torch.int32),    # int8 rows of 24 bytes
        (128, 32, 20, 64, torch.int32),    # N % 8
        (128, 32, 16, 64, torch.float16),  # no such output type
    ])
    def test_make_raises(self, args):
        with pytest.raises(ValueError):
            tmc.make(*args, perturb_out=True)

    def test_call_raises_on_wrong_inputs(self):
        s = torch.zeros(8)
        x8, w8 = torch.zeros(64, 32, dtype=torch.int8), torch.zeros(32, 16, dtype=torch.int8)
        mm = tmc.make(64, 32, 16, 32, torch.float32, False)
        with pytest.raises(ValueError):  # int8 in, fp32 out
            mm(s, x8, w8)
        with pytest.raises(ValueError):  # not the shapes it was made for
            mm(s, x8[:32].bfloat16(), w8.bfloat16())
        with pytest.raises(ValueError):  # s is (8,) fp32
            tmc.tiled_matmul(torch.zeros(4), x8, w8, out_dtype=torch.int32, perturb_out=True)

    def test_kernel_path_refuses_cpu_tensors(self):
        x, w = torch.zeros(64, 32, dtype=torch.int8), torch.zeros(32, 16, dtype=torch.int8)
        before = dict(tmc.launches)
        with pytest.raises(ValueError, match="CUDA"):
            tmc._launch(torch.zeros(8), x, w, torch.int32, True)
        assert tmc.launches == before

    @pytest.mark.parametrize("k,n", [(48, 40), (96, 24), (2080, 264)])
    def test_w_kmajor_on_cpu_is_the_plain_transpose(self, k, n):
        w = torch.from_numpy(np.random.default_rng(k).integers(-128, 128, (k, n)).astype(np.int8))
        before = dict(tmc.launches)
        wt = tmc.w_kmajor(w)
        assert tmc.launches == before  # the plain version: no launch
        assert wt.is_contiguous() and tuple(wt.shape) == (n, k)
        assert torch.equal(wt, w.t()) and torch.equal(wt, tmc.w_kmajor_reference(w))
        with pytest.raises(ValueError):
            tmc.w_kmajor(w.to(torch.int16))
        with pytest.raises(ValueError):  # K % 16 != 0
            tmc.w_kmajor(w[: k - 8])

    def test_supported(self):
        assert tmc.supported(1024, 512, torch.bfloat16)
        assert tmc.supported(2048, 512, torch.int8)
        assert tmc.supported(48, 40, torch.int8)
        assert not tmc.supported(24, 16, torch.int8)      # 16-byte rows
        assert not tmc.supported(12, 16, torch.bfloat16)
        assert not tmc.supported(32, 12, torch.bfloat16)  # N % 8
        assert not tmc.supported(32, 16, torch.float32)


class TestProfiling:
    def test_device_time_on_cpu_perturbs_the_first_argument(self):
        seen = []

        def fn(v, m):
            seen.append(float(v[0]))
            return v @ m

        v = torch.zeros(8)
        dt = profiling.device_time(fn, v, torch.eye(8), iters=4)
        assert dt > 0
        # one warm-up call on the input itself, then i·1e-6 on call i
        np.testing.assert_allclose(seen, [0.0, 0.0, 1e-6, 2e-6, 3e-6], rtol=1e-5)

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(str(tmp_path)):
            torch.randn(16, 16) @ torch.randn(16, 16)
        files = list(tmp_path.glob("trace_*.json"))
        assert len(files) == 1
        assert "traceEvents" in json.loads(files[0].read_text())


def test_probe_run_on_cpu():
    rows = probe.run(shapes=[(64, 32, 16, 32), (32, 64, 24, 16)], iters=2, device="cpu")
    assert [(r["M"], r["dtype"]) for r in rows] == [(64, "bf16"), (64, "int8"),
                                                    (32, "bf16"), (32, "int8")]
    for r in rows:
        assert r["us"] > 0 and r["top_s"] > 0 and r["bound_us"] > 0
        assert r["library_us"] is None and r["device"] == "cpu"
        assert r["int8_speedup_kernel"] > 0 and r["int8_speedup_library"] is None


@pytest.mark.parametrize("m,k,n,kind,want_us,by", [
    (32768, 1024, 512, "bf16", 40.4, "bytes"), (32768, 1024, 512, "int8", 30.2, "bytes"),
    (16384, 2048, 512, "bf16", 34.7, "operations"), (16384, 2048, 512, "int8", 20.3, "bytes"),
])
def test_probe_bounds(m, k, n, kind, want_us, by):
    us, got_by = probe.bound_us(m, k, n, kind)
    assert got_by == by and abs(us - want_us) < 0.05
