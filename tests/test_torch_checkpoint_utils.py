"""The reference-checkpoint utilities of the port against the JAX package's.

`models/conv_blocks.py::ProjectionHead` (both `proj` kinds, train and eval
mode) against JAX's from the same weights, carried either way
(`utils/jax_params.py::projection_head_from_jax` from JAX's `model.init`,
`utils/torch_port.py::convert_projection_head` from the port's seeded
module); then `convert_projection_head` and `load_torch_checkpoint` on
`.pth` files that `torch.save` writes from the port's own `state_dict` in
the four layouts the reference reads (`{'model': sd, ...}`, a nested
`module`, `module.` prefixes, a bare state dict), `np.array_equal` to the
JAX converters' output for the same file.

Tolerances: the head's outputs within 1e-6 (L2-normalised, so |y| ≤ 1;
fp32 sums in other orders; flax's BatchNorm folds the scale into the
rsqrt before the multiply); its running statistics within 1e-6; the
converters exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.models.conv_blocks import ProjectionHead as JaxProjectionHead
from waveformer_tpu.utils import torch_port as jport
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.models.conv_blocks import ProjectionHead
from waveformer_tpu_torch.utils import torch_port as tport
from waveformer_tpu_torch.utils.jax_params import projection_head_from_jax

NET = dict(img_size=(32, 32, 32), patch_size=2, in_chans=4, out_chans=4,
           embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8),
           decom_levels=(3, 2, 1, 0))
DIM_IN, PROJ_DIM = 12, 8


def _x(seed=0):
    x = np.random.default_rng(seed).standard_normal((2, 3, 4, 5, DIM_IN)).astype(np.float32)
    return x * 2.0 + 0.5


def _seeded_head(proj):
    torch.manual_seed(1)
    head = ProjectionHead(DIM_IN, PROJ_DIM, proj)
    if proj == "convmlp":  # non-trivial affine and running statistics
        bn = head.proj[1][0]
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.2, 0.2)
            bn.running_mean.uniform_(-0.3, 0.3)
            bn.running_var.uniform_(0.5, 2.0)
    return head


def _tree_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------- #
# ProjectionHead
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("proj", ["convmlp", "linear"])
def test_projection_head_matches_jax(proj, train):
    head = _seeded_head(proj).train(train)
    variables = tport.convert_projection_head(head.state_dict())
    x = _x()
    jhead = JaxProjectionHead(dim_in=DIM_IN, proj_dim=PROJ_DIM, proj=proj)
    if train and proj == "convmlp":
        want, new = jhead.apply(variables, jnp.asarray(x), deterministic=False,
                                mutable=["batch_stats"])
    else:
        want = jhead.apply(variables, jnp.asarray(x), deterministic=not train)
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 4, 5, PROJ_DIM) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    if train and proj == "convmlp":
        bn = head.proj[1][0]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(new["batch_stats"]["bn"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(new["batch_stats"]["bn"]["var"]), atol=1e-6)
        assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("proj", ["convmlp", "linear"])
def test_projection_head_from_jax_init(proj):
    """JAX's own `model.init` weights carried into the port: equal
    outputs, and the round trip back through `convert_projection_head`
    gives JAX's variables bit for bit."""
    x = _x(3)
    jhead = JaxProjectionHead(dim_in=DIM_IN, proj_dim=PROJ_DIM, proj=proj)
    variables = jax.device_get(jax.jit(jhead.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    head = ProjectionHead(DIM_IN, PROJ_DIM, proj).eval()
    head.load_state_dict(projection_head_from_jax(variables), strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jhead.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    _tree_equal(tport.convert_projection_head(head.state_dict()), variables)


def test_projection_head_keys_are_the_reference_keys():
    assert sorted(ProjectionHead(4, 2, "linear").state_dict()) == ["proj.bias", "proj.weight"]
    assert sorted(ProjectionHead(4, 2).state_dict()) == sorted(
        ["proj.0.weight", "proj.0.bias", "proj.1.0.weight", "proj.1.0.bias",
         "proj.1.0.running_mean", "proj.1.0.running_var", "proj.1.0.num_batches_tracked",
         "proj.2.weight", "proj.2.bias"])
    with pytest.raises(ValueError, match="Unknown projection type"):
        ProjectionHead(4, 2, "mlp")


def test_projection_head_bf16_keeps_fp32_statistics():
    head = _seeded_head("convmlp").eval()
    x = torch.from_numpy(_x())
    with torch.no_grad():
        want = head(x)
        head.proj[0].to(torch.bfloat16)
        head.proj[2].to(torch.bfloat16)
        got = head(x.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and head.proj[1][0].running_var.dtype == torch.float32
    # bf16 convs and one bf16 rounding of the normalised output (2^-8 of |y| ≤ 1)
    assert float((got.float() - want).abs().max()) <= 3e-2


# --------------------------------------------------------------------------- #
# convert_projection_head and load_torch_checkpoint
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("proj", ["convmlp", "linear"])
@pytest.mark.parametrize("wrap", ["bare", "module_prefix", "nested_prefix"])
def test_convert_projection_head_equals_jax(proj, wrap):
    sd = _seeded_head(proj).state_dict()
    kw = {}
    if wrap == "module_prefix":
        sd = {"module." + k: v for k, v in sd.items()}
    elif wrap == "nested_prefix":  # the head inside a larger module
        sd = {"module.head." + k: v for k, v in sd.items()}
        sd["module.backbone.weight"] = torch.zeros(3)
        kw = {"prefix": "head"}
    _tree_equal(tport.convert_projection_head(sd, **kw), jport.convert_projection_head(sd, **kw))


def test_convert_projection_head_refuses_extra_keys():
    sd = dict(_seeded_head("linear").state_dict(), stray=torch.zeros(1))
    with pytest.raises(ValueError, match="unconverted"):
        tport.convert_projection_head(sd)


LAYOUTS = {
    "training_dict": lambda sd: {"model": sd, "optimizer": {"state": {}}, "epoch": 7,
                                 "dice_score": 0.5},
    "nested_module": lambda sd: {"module": sd},
    "module_prefix": lambda sd: {"module." + k: v for k, v in sd.items()},
    "bare": lambda sd: sd,
}


@pytest.fixture(scope="module")
def port_state_dict():
    return create_waveformer(NET, device="cpu", seed=0).state_dict()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_load_torch_checkpoint_equals_jax(tmp_path, port_state_dict, layout):
    path = str(tmp_path / f"{layout}.pth")
    torch.save(LAYOUTS[layout](port_state_dict), path)
    got = tport.load_torch_checkpoint(path, depths=NET["depths"])
    want = jport.load_torch_checkpoint(path, depths=NET["depths"])
    _tree_equal(got, want)
    # and it is the port's own weights: back through the converter
    _tree_equal(got, tport.convert_state_dict(port_state_dict, depths=NET["depths"]))
