"""Window attention at every window the repository's configurations make,
and the depthwise stencil at channel counts that are no multiple of 8,
against the JAX package on the CPU.

The configurations beside the flagship give other attention shapes: the
abdomen CT config (`examples/abdomen_ct/config.yaml`, 96³ input) has 6³ =
216-token windows with head dim 16, and the 32³ example networks
(`examples/*/run_example.py`) 2³ = 8-token windows with head dims 4 and 8.
The JAX model runs such shapes through its XLA composition
(`waveformer_tpu/models/attention.py:92-104`), the port through its kernel
wrapper, whose plain version runs on the CPU. Forward tolerances are those
of `tests/test_torch_kernels.py` (fp32 scores and softmax summed in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.models import attention as ja
from waveformer_tpu.ops import attention_pallas as jap
from waveformer_tpu.ops import dwconv_pallas as jdp
from waveformer_tpu_torch.models import attention as ta
from waveformer_tpu_torch.ops import attention_cuda as tac
from waveformer_tpu_torch.ops import dwconv_cuda as tdc
from waveformer_tpu_torch.utils import jax_params as jp
from test_torch_kernels import _qkvb
from test_torch_model import random_params

# (B·nW, H, N, D): the abdomen stage-1 call, the 32³ networks' calls at their
# first two stages, a 3³ window and a 1000-token window (N above 512)
RAGGED = [(4, 3, 216, 16), (16, 2, 8, 4), (2, 4, 8, 8), (2, 3, 27, 16), (1, 2, 1000, 16)]


@pytest.mark.parametrize("bw,h,n,d", RAGGED)
def test_ragged_attention_matches_jax(bw, h, n, d):
    q, k, v, b = _qkvb(bw, h, n, d)
    want = jap._reference(*map(jnp.asarray, (q, k, v, b)), d**-0.5)
    before = tac.launches
    got = tac.window_attention(*map(torch.from_numpy, (q, k, v, b)), d**-0.5)
    assert tac.launches == before  # CPU tensors take the plain version
    assert tac.supported(n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dim,heads,window", [(48, 3, 6), (8, 2, 2)])
def test_window_attention_module_matches_jax(dim, heads, window):
    """The abdomen config's stage-1 module (6³ windows) and the 32³
    networks' (2³ windows, head dim 4)."""
    n = window**3
    x = np.random.default_rng(1).standard_normal((3, n, dim)).astype(np.float32)
    jm = ja.WindowAttention(dim=dim, num_heads=heads, window_size=window)
    p = random_params(jm, jnp.asarray(x))
    sd = {}
    jp.window_attention(sd, p["params"], "")
    tm = ta.WindowAttention(dim, heads, window)
    tm.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x))),
                               atol=2e-5)


def test_design_rule():
    bf, f32 = torch.bfloat16, torch.float32
    for n, d in ((512, 16), (216, 16), (27, 16), (1, 16), (512, 32), (343, 48), (64, 64)):
        assert tac.design(bf, n, d) == "tma_wgmma", (n, d)
    for n, d in ((513, 16), (1000, 16), (512, 8), (8, 4), (216, 24), (512, 12)):
        assert tac.design(bf, n, d) == "fma", (n, d)
    for n, d in ((512, 16), (216, 16), (8, 4)):
        assert tac.design(f32, n, d) == "fma", (n, d)
    assert set(tac.design_launches) == set(tac.DESIGNS) == {"fma", "tma_wgmma"}


@pytest.mark.parametrize("c", [4, 20])
def test_dwconv3_odd_channels_matches_jax(c):
    """C % 8 != 0: the JAX model takes the XLA grouped conv here (the
    Pallas gate needs C % 8 == 0 and C ≥ 96, `dwconv_pallas.py:121`)."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 5, 6, 7, c)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, c)).astype(np.float32)
    want = np.asarray(jdp._reference(jnp.asarray(x), jnp.asarray(w)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(tdc.dwconv3_reference(xt, wt).numpy(), want, atol=1e-5)
    before = tdc.launches
    np.testing.assert_allclose(tdc.dwconv3(xt, wt).numpy(), want, atol=1e-5)
    assert tdc.launches == before and tdc.supported(c)
