"""The port's `spatial` and `tensor` mesh axes against the JAX package, on the CPU.

The network is JAX's toy of `tests/test_tensor_sharding.py` (32³, dims
16/32/64/128, depths 1, heads 2/4/8/8, DWT levels 3/2/1/0), fp32, with
seeded parameters carried into the port by `state_dict_from_jax`. Torch
ranks run as child processes over gloo (`tests/torch_dist_child.py`, suite
`model_parallel`), spawned once for the module in two groups: 2 ranks
(tensor=2, then spatial=2) and 4 ranks (data=2 × tensor=2, data=2 ×
spatial=2, spatial=2 × tensor=2). Each rank arms the model with
`shard_model`, runs its rows and D slab (`shard_batch`) and gathers the
logits along D (`gather_depth`); they import no JAX. Every mesh's logits
must match JAX's serial forward of the same batch at JAX's own tolerance
for these tests, atol 2e-4 and rtol 1e-3.

The same children then run the depth primitives on a spatial line of all
their ranks (2 and 4), each on its slab of a seeded input, held here
against the unsharded op: halos exact, the 3³ convs and the stencil on a
slab within 1e-5 (fp32 sums of other orders), the two-pass statistics
within 1e-5, the trilinear resize in both corner modes within 1e-6 of
`F.interpolate` in fp32 (the depth lerp is a separate fp32 step) and, in
bf16, within one bf16 ulp (rtol 2^-7) of the fp32 resize rounded once, as
ATen's CUDA kernel computes it (its CPU kernel on bf16 input does not round
once where align_corners=True), the gather exact.
The rest runs here: the tensor specs against JAX's key for key, the rank
layout against JAX's mesh, the errors and the shard slices.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests.test_torch_parallel import Ranks, seeded_params
from waveformer_tpu.models import Waveformer as JaxWaveformer
from waveformer_tpu.parallel import mesh as jmesh
from waveformer_tpu.parallel.tensor_sharding import tensor_param_specs as jax_specs
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.models.common import ConvCL, InstanceNormAffine, instance_norm
from waveformer_tpu_torch.ops.resize import resize_trilinear
from waveformer_tpu_torch.parallel import (
    AxisShard, Mesh, MeshSpec, Traffic, axis_lines, mesh_coords, shard_batch, shard_model,
    shard_params_tensor, tensor_param_specs)
from waveformer_tpu_torch.training import losses as tl
from waveformer_tpu_torch.training.ssl import SSLTrainer, make_ssl_step
from waveformer_tpu_torch.training.state import make_train_step
from waveformer_tpu_torch.training.trainer import Trainer
from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax

TOY = dict(img_size=(32, 32, 32), patch_size=2, in_chans=2, out_chans=3,
           embed_dims=(16, 32, 64, 128), depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8),
           decom_levels=(3, 2, 1, 0), drop_path_rate=0.0)
# the meshes (data, spatial, tensor) each group of ranks runs, in order
WORLDS = {2: [(1, 1, 2), (1, 2, 1)], 4: [(2, 1, 2), (2, 2, 1), (1, 2, 2)]}
MESHES = [(w, spec) for w, specs in WORLDS.items() for spec in specs]
ATOL, RTOL = 2e-4, 1e-3
# the depth primitives' inputs: D = 8 splits over 2 and 4 ranks
CONVS = {"conv3_dense": (3, 5, 1), "conv3_stencil": (4, 4, 4)}
RESIZES = {"x2": ("a", (8, 6, 10), False), "x4": ("a", (16, 12, 20), False),
           "x8": ("b", (64, 4, 2), False), "x2_corners": ("a", (8, 6, 10), True),
           "x4_corners": ("b", (32, 8, 4), True)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the tier-1 run puts six pytest
    workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x():
    return np.random.default_rng(0).standard_normal((2, 32, 32, 32, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return seeded_params(JaxWaveformer(**TOY), jnp.asarray(_x()))


def primitive_inputs():
    rng = np.random.default_rng(1)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = {"halo_x": f32(2, 8, 5, 4, 3),
           "conv_x": {"conv3_dense": f32(2, 8, 6, 5, 3), "conv3_stencil": f32(2, 8, 6, 5, 4)},
           "resize_x": {"a": f32(1, 4, 3, 5, 2), "b": f32(1, 8, 2, 1, 3)},
           "norm_x": 2.0 * f32(2, 8, 4, 3, 5) + 3.0, "cf_x": f32(2, 3, 8, 4, 4),
           "convs": CONVS, "resizes": RESIZES}
    inp["conv_sd"] = {}
    for i, (name, (cin, cout, groups)) in enumerate(CONVS.items()):
        torch.manual_seed(i)
        inp["conv_sd"][name] = ConvCL(cin, cout, 3, padding=1, groups=groups).state_dict()
    norm = InstanceNormAffine(5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(f32(5)))
        norm.bias.copy_(torch.from_numpy(f32(5)))
    inp["norm_sd"] = norm.state_dict()
    return inp


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, params):
    """Both groups of ranks, started together; {world: Ranks}."""
    base = {"cfg": TOY, "state_dict": state_dict_from_jax(params, TOY["depths"]), "x": _x(),
            **primitive_inputs()}
    ranks = {}
    for world, specs in WORLDS.items():
        workdir = tmp_path_factory.mktemp(f"model_parallel{world}")
        torch.save(dict(base, specs=specs), os.path.join(workdir, "inputs.pt"))
        ranks[world] = Ranks("model_parallel", workdir, world=world)
    yield ranks
    for r in ranks.values():
        r.kill()


@pytest.fixture(scope="module")
def serial_logits(params):
    """JAX's serial forward of the global batch (after the ranks started)."""
    return np.asarray(jax.jit(JaxWaveformer(**TOY).apply)(params, jnp.asarray(_x())))


# --------------------------------------------------------------------------- #
# the sharded forward at 2 and 4 ranks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("world,spec", MESHES)
def test_sharded_forward_matches_jax_serial(spawned, serial_logits, world, spec):
    for r, out in enumerate(spawned[world].results()):
        m = out["meshes"][spec]
        rows = np.split(serial_logits, spec[0])[m["rank"]]
        np.testing.assert_allclose(m["logits"], rows, atol=ATOL, rtol=RTOL)
        b = 2 // spec[0]
        assert m["slab"] == (b, 32 // spec[1], 32, 32, TOY["out_chans"])


@pytest.mark.parametrize("world,spec", MESHES)
def test_ranks_take_jax_layout_and_lines(spawned, world, spec):
    """Rank r sits where JAX's `reshape(data, spatial, tensor)` puts device
    r; its groups are its lines (None on an axis of length 1)."""
    ms = MeshSpec(*spec)
    for r, out in enumerate(spawned[world].results()):
        m = out["meshes"][spec]
        assert m["coords"] == mesh_coords(r, ms)
        assert (m["rank"], m["size"], m["is_main"]) == (m["coords"][0], spec[0], r == 0)
        for axis, n, got in zip(ms.axis_names, spec, m["groups"]):
            want = next(line for line in axis_lines(ms, axis) if r in line) if n > 1 else None
            assert got == want, axis
        if spec[1] > 1:
            assert m["traffic"] > 0


@pytest.mark.parametrize("world,spec", MESHES)
def test_tensor_ranks_hold_their_slices(spawned, world, spec):
    t = spec[2]
    for out in spawned[world].results():
        shapes = out["meshes"][spec]["params"]
        blk = "waveformer_encoder.block1.0"
        assert shapes[f"{blk}.attn.qkv.weight"] == (3 * 16 // t, 16)
        assert shapes[f"{blk}.attn.proj.weight"] == (16, 16 // t)
        assert shapes[f"{blk}.attn.relative_position_bias_table"] == (27, 2)
        assert shapes[f"{blk}.mlp.dwconv.weight"] == (64 // t, 1, 3, 3, 3)
        assert shapes[f"{blk}.mlp.norm2.weight"] == (64 // t,)
        assert shapes[f"{blk}.mlp.fc.weight"] == (16, 64 // t)
        assert shapes["decoder1.conv_block.conv1.conv.weight"] == (16, 32, 3, 3, 3)


# --------------------------------------------------------------------------- #
# the depth primitives on a spatial line of 2 and 4 ranks
# --------------------------------------------------------------------------- #


def _slabs(a, s, axis=1):
    return np.split(np.asarray(a), s, axis)


def _prims(spawned, world):
    return [o["primitives"] for o in spawned[world].results()]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("planes", [1, 2])
def test_halo_takes_neighbours_planes_and_zeros(spawned, world, planes):
    x = primitive_inputs()["halo_x"]
    padded = np.pad(x, [(0, 0), (planes, planes)] + [(0, 0)] * 3)
    dl = x.shape[1] // world
    for r, p in enumerate(_prims(spawned, world)):
        np.testing.assert_array_equal(p["halo"][planes], padded[:, r * dl:r * dl + dl + 2 * planes])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CONVS)
def test_conv_on_slab_equals_whole_volume(spawned, world, name):
    """The dense 3³ conv (edge planes from the halo) and the stencil (on
    the slab with one halo plane a side, cropped)."""
    inp = primitive_inputs()
    cin, cout, groups = CONVS[name]
    conv = ConvCL(cin, cout, 3, padding=1, groups=groups)
    conv.load_state_dict(inp["conv_sd"][name])
    with torch.no_grad():
        want = conv(torch.from_numpy(inp["conv_x"][name])).numpy()
    for p, w in zip(_prims(spawned, world), _slabs(want, world)):
        np.testing.assert_allclose(p[name], w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", RESIZES)
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 0, 1e-6),
                                             (torch.bfloat16, 2**-7, 0)])
def test_resize_on_slab_equals_interpolate(spawned, world, name, dtype, rtol, atol):
    src, size, align = RESIZES[name]
    x = torch.from_numpy(primitive_inputs()["resize_x"][src]).to(dtype)
    want = resize_trilinear(x.float(), size, align_corners=align).to(dtype).float().numpy()
    for p, w in zip(_prims(spawned, world), _slabs(want, world)):
        np.testing.assert_allclose(p["resize"][name, dtype], w, atol=atol, rtol=rtol)


@pytest.mark.parametrize("world", WORLDS)
def test_statistics_over_depth_equal_whole_volume(spawned, world):
    inp = primitive_inputs()
    x = torch.from_numpy(inp["norm_x"])
    norm = InstanceNormAffine(5)
    norm.load_state_dict(inp["norm_sd"])
    with torch.no_grad():
        want = {"instance_norm": instance_norm(x).numpy(), "instance_norm_affine": norm(x).numpy()}
    mean = x.mean(dim=(1, 2, 3)).numpy()
    for p in _prims(spawned, world):
        np.testing.assert_allclose(p["mean_dhw"], mean, atol=1e-6, rtol=0)
    for key, w in want.items():
        for p, ws in zip(_prims(spawned, world), _slabs(w, world)):
            np.testing.assert_allclose(p[key], ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_depth_channels_first(spawned, world):
    x = primitive_inputs()["cf_x"]
    for p in _prims(spawned, world):
        np.testing.assert_array_equal(p["gather_cf"], x)


# --------------------------------------------------------------------------- #
# in this process
# --------------------------------------------------------------------------- #


def _varying_dim(a: np.ndarray):
    """The one dim along which `a` varies, or None where it is constant."""
    dims = [d for d in range(a.ndim) if np.ptp(a, axis=d).max() > 0]
    assert len(dims) <= 1
    return dims[0] if dims else None


def test_tensor_param_specs_match_jax_key_for_key(params):
    """JAX's specs carried through `state_dict_from_jax`: each leaf that
    JAX splits becomes an arange along its split dim (the rest zeros), so
    the converted tensor varies along exactly the dim the port must split."""
    specs = jax_specs(params)

    def marker(leaf, spec):
        a = np.zeros(leaf.shape, np.float32)
        if spec == P():
            return a
        (dim,) = [i for i, s in enumerate(spec) if s == "tensor"]
        shape = [1] * a.ndim
        shape[dim] = a.shape[dim]
        return a + np.arange(a.shape[dim], dtype=np.float32).reshape(shape)

    marked = jax.tree.map(marker, params, specs, is_leaf=lambda x: isinstance(x, P))
    want = {k: None if k.endswith("relative_position_index") else _varying_dim(v.numpy())
            for k, v in state_dict_from_jax(marked, TOY["depths"]).items()}
    got = tensor_param_specs(create_waveformer(TOY, device="cpu"))
    assert got == want
    assert sum(d is not None for d in got.values()) == 4 * 12  # 12 sharded tensors a block


@pytest.mark.parametrize("spec", [(2, 2, 2), (1, 2, 3), (3, 1, 2), (2, 3, 1), (1, 1, 4)])
def test_rank_layout_and_lines_match_jax_mesh(spec):
    ms = MeshSpec(*spec)
    n = ms.size()
    ids = np.vectorize(lambda d: d.id)(
        jmesh.make_mesh(jmesh.MeshSpec(*spec), jax.devices()[:n]).devices)
    for r in range(n):
        assert ids[mesh_coords(r, ms)] == r
    for a, axis in enumerate(ms.axis_names):
        want = np.moveaxis(ids, a, -1).reshape(-1, spec[a]).tolist()
        assert sorted(axis_lines(ms, axis)) == sorted(want)


def _fake_mesh(spec, data_rank=0, spatial_rank=0, tensor_rank=0):
    """A mesh without groups (nothing communicates): for what is decided
    before any collective."""
    shard = lambda n, r: AxisShard(None, r, n, Traffic()) if n > 1 else None
    ms = MeshSpec(*spec)
    return Mesh(ms, data_rank, spatial=shard(ms.spatial, spatial_rank),
                tensor=shard(ms.tensor, tensor_rank))


@pytest.mark.parametrize("spec", [(1, 2, 1), (1, 1, 2), (2, 2, 2)])
@pytest.mark.parametrize("entry", ["Trainer", "SSLTrainer", "make_train_step", "make_ssl_step"])
def test_training_builds_on_model_parallel_meshes(spec, entry, tmp_path):
    """The training entry points take every (data, spatial, tensor) mesh
    that `shard_model` takes (their steps on such meshes:
    tests/test_torch_train_model_parallel.py)."""
    mesh = _fake_mesh(spec)
    model = torch.nn.Linear(2, 2)
    make = {"Trainer": lambda: Trainer(model, logdir=str(tmp_path), mesh=mesh),
            "SSLTrainer": lambda: SSLTrainer(model, logdir=str(tmp_path), mesh=mesh),
            "make_train_step": lambda: make_train_step(
                shard_model(create_waveformer(TOY, device="cpu", seed=0), mesh),
                tl.dice_ce_loss, mesh),
            "make_ssl_step": lambda: make_ssl_step(model, mesh=mesh)}
    built = make[entry]()
    if entry.startswith("make_"):
        assert built.reducer is not None and built.reducer.mesh is mesh
    else:
        assert built.mesh is mesh


def test_data_meshes_still_build_the_trainer_step():
    make_train_step(torch.nn.Linear(2, 2), tl.dice_ce_loss, _fake_mesh((2, 1, 1)))
    make_ssl_step(torch.nn.Linear(2, 2), mesh=_fake_mesh((1, 1, 1)))


@pytest.mark.parametrize("spec,match", [((1, 1, 3), "heads"), ((1, 4, 1), "coarsest grid"),
                                        ((1, 3, 1), "coarsest grid")])
def test_shard_model_refuses_what_does_not_split(spec, match):
    model = create_waveformer(TOY, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=match):
        shard_model(model, _fake_mesh(spec))
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("depth_axis", [1, 2])
def test_shard_batch_splits_rows_then_depth(depth_axis):
    x = np.arange(4 * 3 * 8 * 2).reshape(4, 3, 8, 2) if depth_axis == 2 else \
        np.arange(4 * 8 * 3 * 2).reshape(4, 8, 3, 2)
    for d in range(2):
        for s in range(2):
            got = shard_batch(_fake_mesh((2, 2, 1), d, s), {"x": x}, depth_axis)["x"]
            want = np.split(np.split(x, 2, 0)[d], 2, depth_axis)[s]
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        shard_batch(_fake_mesh((1, 3, 1)), x, depth_axis)


@pytest.mark.parametrize("t", [2, 4])
def test_qkv_split_by_head_rebuilds_the_full_attention(t):
    """Rank r's q, k and v rows are those of heads [r·H/T, (r+1)·H/T) (JAX
    splits the 3C columns in contiguous chunks: same dim, another index
    set); `proj` splits its input features contiguously; the bias table is
    replicated and each rank's `bias()` is its heads' slice."""
    model = create_waveformer(TOY, device="cpu", seed=0)
    sd = model.state_dict()
    key = "waveformer_encoder.block2.0.attn"
    attn = model.waveformer_encoder.block2[0].attn
    c, h = 32, 4
    full_bias = attn.bias()
    qkv = sd[f"{key}.qkv.weight"].reshape(3, h, c // h, c)
    for r in range(t):
        part = shard_params_tensor(_fake_mesh((1, 1, t), tensor_rank=r), sd)
        heads = slice(r * h // t, (r + 1) * h // t)
        assert torch.equal(part[f"{key}.qkv.weight"], qkv[:, heads].reshape(-1, c))
        assert torch.equal(part[f"{key}.qkv.bias"],
                           sd[f"{key}.qkv.bias"].reshape(3, h, -1)[:, heads].reshape(-1))
        assert torch.equal(part[f"{key}.proj.weight"],
                           sd[f"{key}.proj.weight"][:, r * c // t:(r + 1) * c // t])
        assert part[f"{key}.proj.bias"] is sd[f"{key}.proj.bias"]
        attn.tensor_shard = AxisShard(None, r, t, Traffic())
        assert attn.heads() == (r * h // t, h // t)
        assert torch.equal(attn.bias(), full_bias[heads])
