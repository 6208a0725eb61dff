"""Training on the port's `spatial` and `tensor` mesh axes against the JAX package, on the CPU.

The network is JAX's toy of `tests/test_torch_model_parallel.py` (32³, dims
16/32/64/128, heads 2/4/8/8), fp32, with seeded parameters carried into the
port by `state_dict_from_jax`, trained with `dice_ce_loss` on a seeded
batch of 2. Torch ranks run as child processes over gloo
(`tests/torch_dist_child.py`, suite `train_model_parallel`), spawned once
for the module in two groups: 2 ranks (tensor=2, spatial=2) and 4 ranks
(data=2 × tensor=2, data=2 × spatial=2, spatial=2 × tensor=2). On each mesh
every rank takes two steps of `make_train_step` on its rows and D slab of
the batch, after `master_params` and `shard_model`. JAX's reference is
`jax.value_and_grad` of the same loss on the whole batch, compiled once for
the module (a compile a mesh would not fit the suite's time), with
`TrainState.apply_gradients` between the two steps.

Tolerances:
  * the masters' gradients of step 1 (what the step clips), each parameter
    against JAX's and against the port's one-process step: ‖Δg‖ within
    GRAD_TOL, 1e-2 of its ‖g‖ plus 1e-6 of the model's largest |g| times
    √n. fp32 slab gradients differ from the whole volume's by up to 1e-2
    of a parameter's largest element where an InstanceNorm input is near
    constant (in float64 the same steps agree to 1e-7), while a path
    counted S or T times, or a missing share, moves a parameter's whole
    gradient; a float64 step at (1, 2, 2) is held at F64_GRAD_TOL (1e-5);
  * the loss within 1e-5, the unclipped norm within 1e-4 relative, the
    masters after two steps within `ADAM_BOUND` and within 1e-5 on ≥ 99%
    of the elements (the bounds of tests/test_torch_parallel.py: AdamW
    turns a gradient's rounding into ±lr where it is tiny); every rank's
    masters `torch.equal`; the same with drop path on (masks equal across
    a data row, and under activation checkpointing, which replays the
    collectives in the backward), against the one-process step;
  * each differentiable primitive's forward and backward against the
    unsharded op's autograd, on float64 inputs and cotangents at 2 and 4
    ranks: the ops compute in fp32 inside (as the model does), so within
    1e-5 of the largest |value| (halos exact, the tensor line's copy to
    1e-15);
  * the losses on a spatial line against the whole volume's loss: value
    and logits' gradient within 1e-6 of their scale;
  * `Trainer(mesh=...)` at (1, 2, 1) and (1, 1, 2) against the one-process
    `Trainer` from the same seed (ADAM bounds), ranks equal, a periodic
    state that reloads to `torch.equal` masters on every rank;
  * `SSLTrainer(mesh=...)` at (1, 2, 1): every rank's masters
    `torch.equal` to the one-process trainer's (the ranks run the whole
    batch on the whole model, as JAX's replicated SSL step does).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_model_parallel import TOY, WORLDS
from tests.test_torch_parallel import ADAM_BOUND, SSL_TINY, Ranks, seeded_params
from waveformer_tpu.models import Waveformer as JaxWaveformer
from waveformer_tpu.training import losses as jl
from waveformer_tpu.training import state as jstate
from waveformer_tpu_torch.data.dataset import MedicalDataset
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.models.common import ConvCL, instance_norm
from waveformer_tpu_torch.models.ssl import SSLViT
from waveformer_tpu_torch.ops.resize import resize_trilinear
from waveformer_tpu_torch.parallel import tensor_sharding as ts
from waveformer_tpu_torch.tools import synthetic_cases
from waveformer_tpu_torch.training import losses as tl
from waveformer_tpu_torch.training.ssl import SSLTrainer
from waveformer_tpu_torch.training.state import (
    TrainState, make_optimizer, make_train_step, master_params)
from waveformer_tpu_torch.training.trainer import Trainer, step_seed
from waveformer_tpu_torch.utils.jax_params import ssl_state_dict_from_jax, state_dict_from_jax

MESHES = [(w, spec) for w, specs in WORLDS.items() for spec in specs]
DROP = dict(TOY, drop_path_rate=0.3)
# the 2-rank group's extra steps: drop path on a tensor line, and on a
# spatial line under activation checkpointing; both against the one-process
# drop-path step
EXTRA = {"drop": ((1, 1, 2), DROP), "checkpoint": ((1, 2, 1), dict(DROP, use_checkpoint=True))}
TRAINER_NET = dict(TOY, in_chans=4, out_chans=4, embed_dims=(8, 16, 32, 64), drop_path_rate=0.1)
TRAINER_MESHES = [(1, 2, 1), (1, 1, 2)]
SSL_MESHES = [(1, 2, 1)]
# a parameter's gradient error ‖Δg‖ against (its ‖g‖, the model's max |g|·√n):
# fp32, and the float64 step of F64_MESH
GRAD_TOL = (1e-2, 1e-6)
F64_GRAD_TOL = (1e-5, 1e-7)
F64_MESH = (1, 2, 2)
CONVS = {"conv3_dense": (3, 5, 1), "conv3_stencil": (4, 4, 4)}
RESIZES = {"x2": ((16, 10, 8), False), "x2_corners": ((16, 10, 8), True),
           "x4_corners": ((32, 6, 4), True)}
LOSS_CASES = {
    "ce": ("softmax_cross_entropy", {}, "labels"),
    "dice_ce": ("dice_ce_loss", dict(lambda_dice=0.7, lambda_ce=1.3), "labels"),
    "dice_ce_batch": ("dice_ce_loss", dict(batch_dice=True), "labels"),
    "soft_dice_no_bg_squared": ("soft_dice_loss", dict(include_background=False,
                                                       squared_pred=True), "labels"),
    "dice_bce": ("dice_bce_loss", dict(batch_dice=False), "regions"),
    "dice_bce_batch_ignore": ("dice_bce_loss", dict(use_ignore_label=True), "regions_ignore"),
    "topk": ("topk_cross_entropy", dict(k_percent=10.0), "labels"),
    "dice_topk": ("dice_topk_loss", dict(k_percent=20.0), "labels"),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the tier-1 run puts six pytest
    workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((2, 32, 32, 32, 2)).astype(np.float32)
    return data, rng.integers(0, 3, (2, 32, 32, 32, 1)).astype(np.int32)


def _primitive_inputs(world):
    rng = np.random.default_rng(1)
    f64 = lambda *s: rng.standard_normal(s)
    dl = 8 // world
    pr = {"x": f64(2, 8, 5, 4, 3), "cot": f64(2, 8, 5, 4, 3),
          "halo_cot": {p: f64(world, 2, dl + 2 * p, 5, 4, 3) for p in (1, 2)},
          "mean_cot": f64(world, 2, 3), "convs": CONVS, "resizes": RESIZES,
          "conv_x": {n: f64(2, 8, 6, 5, c[0]) for n, c in CONVS.items()},
          "conv_cot": {n: f64(2, 8, 6, 5, c[1]) for n, c in CONVS.items()},
          "resize_cot": {n: f64(2, *size, 3) for n, (size, _) in RESIZES.items()},
          "lin_x": f64(6, 8), "lin_w": f64(5, 8), "lin_b": f64(5), "lin_cot": f64(6, 5),
          "ln_x": 2.0 * f64(6, 8) + 1.0, "ln_w": 1.0 + 0.1 * f64(8), "ln_b": f64(8),
          "ln_cot": f64(6, 8), "copy_x": f64(3), "copy_w": f64(world, 3)}
    pr["conv_sd"] = {}
    for i, (name, (cin, cout, groups)) in enumerate(CONVS.items()):
        torch.manual_seed(i)
        pr["conv_sd"][name] = ConvCL(cin, cout, 3, padding=1, groups=groups).double().state_dict()
    return pr


def _loss_inputs():
    rng = np.random.default_rng(2)
    return {"loss_logits": (2.0 * rng.standard_normal((2, 8, 5, 4, 4))).astype(np.float32),
            "labels": rng.integers(0, 4, (2, 8, 5, 4, 1)).astype(np.int32),
            "regions": (rng.uniform(size=(2, 8, 5, 4, 4)) > 0.6).astype(np.float32),
            "regions_ignore": (rng.uniform(size=(2, 8, 5, 4, 5)) > 0.6).astype(np.float32),
            "loss_cases": LOSS_CASES}


def _ssl_batches():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((2, 16, 16, 16, 2)).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def params():
    return seeded_params(JaxWaveformer(**TOY), jnp.asarray(_batch()[0]))


@pytest.fixture(scope="module")
def ssl_sd():
    gt = _ssl_batches()[0]
    from waveformer_tpu.models.ssl import SSLViT as JaxSSLViT

    return ssl_state_dict_from_jax(seeded_params(JaxSSLViT(**SSL_TINY), jnp.asarray(gt), seed=1))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, params, ssl_sd):
    """Both groups of ranks, started together; {world: Ranks}."""
    base = {"cfg": TOY, "state_dict": state_dict_from_jax(params, TOY["depths"]),
            "batch": _batch(), **_loss_inputs()}
    ranks = {}
    for world, specs in WORLDS.items():
        workdir = str(tmp_path_factory.mktemp(f"train_model_parallel{world}"))
        inp = dict(base, specs=specs, prims=_primitive_inputs(world))
        if F64_MESH in specs:
            inp["f64_spec"] = F64_MESH
        if world == 2:
            synthetic_cases.write_training_cases(os.path.join(workdir, "fullres"), n=4,
                                                 shape=(36, 34, 33), seed=0)
            inp.update(extra_steps=EXTRA, trainer_specs=TRAINER_MESHES,
                       trainer_cfg=TRAINER_NET, ssl_specs=SSL_MESHES, ssl_cfg=SSL_TINY,
                       ssl_sd=ssl_sd, ssl_batches=_ssl_batches())
        torch.save(inp, os.path.join(workdir, "inputs.pt"))
        ranks[world] = Ranks("train_model_parallel", workdir, world=world)
    yield ranks
    for r in ranks.values():
        r.kill()


@pytest.fixture(scope="module")
def jax_steps(spawned, params):
    """JAX's two steps on the whole batch (after the ranks started): step
    1's gradients, each step's loss and unclipped norm, the params after."""
    data, seg = _batch()
    model = JaxWaveformer(**TOY)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: jl.dice_ce_loss(model.apply(p, jnp.asarray(data)), jnp.asarray(seg))))
    # jitted: op by op, the first update compiles each leaf's ops (≈ 37 s)
    update = jax.jit(lambda s, g: (s.apply_gradients(g), optax.global_norm(g)))
    state = jstate.TrainState.create(params, jstate.make_optimizer(lr=1e-4))
    metrics, grads = [], None
    for _ in range(2):
        loss, g = value_and_grad(state.params)
        grads = grads or state_dict_from_jax(jax.device_get(g), TOY["depths"])
        state, norm = update(state, g)
        metrics.append((float(loss), float(norm)))
    return {"grads": grads, "metrics": metrics,
            "params": state_dict_from_jax(jax.device_get(state.params), TOY["depths"])}


def _one_process(cfg, sd, steps=2, dtype=torch.float32):
    """The port's step on the whole batch in this process: step 1's
    gradients (as clipped), the metrics, the masters after."""
    model = create_waveformer(cfg, device="cpu").train()
    model.load_state_dict(sd, strict=True)
    masters = (master_params(model) if dtype == torch.float32 else
               {n: p.detach() for n, p in model.to(dtype).named_parameters()})
    state = TrainState.create(masters, make_optimizer(lr=1e-4))
    step = make_train_step(model, tl.dice_ce_loss)
    grads = []
    apply = state.apply_gradients
    state.apply_gradients = lambda g: (grads.append([t.clone() for t in g]), apply(g))[1]
    data, seg = _batch()
    batch = {"data": torch.from_numpy(data).to(dtype), "seg": torch.from_numpy(seg)}
    gen, metrics = torch.Generator(), []
    for i in range(steps):
        gen.manual_seed(step_seed(0, i))
        state, m = step(state, batch, gen)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"grads": dict(zip(state.params, grads[0])), "metrics": metrics,
            "params": {k: v.detach().clone() for k, v in state.params.items()}}


@pytest.fixture(scope="module")
def one_process(spawned, params):
    sd = state_dict_from_jax(params, TOY["depths"])
    return {"no_drop": _one_process(TOY, sd), "drop": _one_process(DROP, sd),
            "float64": _one_process(TOY, sd, 1, torch.float64)}


def _rank_results(spawned, world, spec):
    return [o["train"][spec] for o in spawned[world].results()]


def _grad_shares(got, want, tol=GRAD_TOL):
    """Each parameter's gradient error ‖g − w‖ as a share of its limit
    tol[0]·‖w‖ + tol[1]·max|w|·√n, max|w| over the model (the parameters
    of `got`: `want` may hold buffers too)."""
    scale = max(float(np.abs(np.asarray(want[k])).max()) for k in got)
    shares = {}
    for k, g in got.items():
        w, g = np.asarray(want[k], np.float64), np.asarray(g, np.float64)
        assert g.shape == w.shape, k
        limit = tol[0] * np.linalg.norm(w) + tol[1] * scale * np.sqrt(w.size)
        shares[k] = float(np.linalg.norm(g - w)) / limit
    return shares


def _grads_close(got, want, tol=GRAD_TOL):
    worst = max(_grad_shares(got, want, tol).items(), key=lambda kv: kv[1])
    assert worst[1] <= 1.0, worst


def _masters_close(got, want):
    err = np.concatenate([np.abs(np.asarray(got[k], np.float64)
                                 - np.asarray(want[k], np.float64)).ravel() for k in got])
    assert err.max() <= ADAM_BOUND, err.max()
    assert np.mean(err <= 1e-5) >= 0.99, np.mean(err <= 1e-5)


def _ranks_agree(dicts):
    return all(torch.equal(d[k], dicts[0][k]) for d in dicts[1:] for k in dicts[0])


# --------------------------------------------------------------------------- #
# two train steps on each mesh
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("world,spec", MESHES)
def test_gradients_match_jax_whole_batch(spawned, jax_steps, world, spec):
    """Every parameter's gradient (the full master's, assembled over the
    lines): a path counted S or T times would be off by (S − 1)× or
    (T − 1)× its share."""
    for out in _rank_results(spawned, world, spec):
        _grads_close(out["grads"], jax_steps["grads"])


@pytest.mark.parametrize("world,spec", MESHES)
def test_loss_norm_and_masters_match_jax(spawned, jax_steps, world, spec):
    outs = _rank_results(spawned, world, spec)
    assert _ranks_agree([o["params"] for o in outs])
    for o in outs:
        for (lt, nt), (lj, nj) in zip(o["metrics"], jax_steps["metrics"]):
            assert abs(lt - lj) <= 1e-5, (lt, lj)
            assert abs(nt - nj) <= 1e-4 * nj, (nt, nj)
    _masters_close(outs[0]["params"], jax_steps["params"])


@pytest.mark.parametrize("world,spec", MESHES)
def test_mesh_step_equals_one_process_step(spawned, one_process, world, spec):
    want = one_process["no_drop"]
    for o in _rank_results(spawned, world, spec):
        _grads_close(o["grads"], want["grads"])
        for (lt, nt), (lw, nw) in zip(o["metrics"], want["metrics"]):
            assert abs(lt - lw) <= 1e-5 and abs(nt - nw) <= 1e-4 * nw, ((lt, nt), (lw, nw))
    _masters_close(_rank_results(spawned, world, spec)[0]["params"], want["params"])


def test_float64_step_equals_one_process_step(spawned, one_process):
    """In float64 (the losses, norms and statistics still sum in fp32
    inside) the assembled gradients of a spatial=2 × tensor=2 step equal
    the one process's to 1e-5 of each parameter's norm: what fp32's
    rounding leaves of the sharded arithmetic."""
    want = one_process["float64"]
    for o in spawned[4].results():
        _grads_close(o["f64"]["grads"], want["grads"], F64_GRAD_TOL)
        (lt, nt), (lw, nw) = o["f64"]["metrics"][0], want["metrics"][0]
        assert abs(lt - lw) <= 1e-6 and abs(nt - nw) <= 1e-6 * nw, ((lt, nt), (lw, nw))


@pytest.mark.parametrize("world,spec", MESHES)
def test_module_holds_its_slices_of_the_masters(spawned, world, spec):
    """After the step each rank's module holds its tensor rank's slices of
    the full masters (`TrainState.copy_to`)."""
    for o in _rank_results(spawned, world, spec):
        t = spec[2]
        for k, m in o["params"].items():
            p = o["module"][k]
            if t > 1 and ts.split_dim(k) is not None:
                dim = ts.split_dim(k)
                m = m.index_select(dim, ts.rows(k, m.shape[dim], o["coords"][2], t))
            assert torch.equal(p, m), k


@pytest.mark.parametrize("world,spec", [m for m in MESHES if m[1][2] > 1])
def test_tensor_replicated_gradients_equal_on_every_tensor_rank(spawned, world, spec):
    """A parameter that every tensor rank holds whole gets the whole
    gradient on each (the row-parallel sums pass the cotangent on, the
    column-parallel inputs and the bias tables sum theirs): the ranks of a
    tensor line hold equal gradients before the assembly."""
    outs = _rank_results(spawned, world, spec)
    for a in outs:
        for b in outs:
            if a["coords"][:2] != b["coords"][:2] or a is b:
                continue
            for k, g in a["local"].items():
                if ts.split_dim(k) is None:
                    assert torch.equal(g, b["local"][k]), k


@pytest.mark.parametrize("world,spec", MESHES)
def test_collectives_count_forward_and_backward_bytes(spawned, world, spec):
    for o in _rank_results(spawned, world, spec):
        assert o["forward_bytes"] > 0 and o["backward_bytes"] > 0
        moved = o["assembly_bytes"]
        assert (moved["spatial"] > 0) == (spec[1] > 1)
        assert (moved["tensor"] > 0) == (spec[2] > 1)
        assert (moved["data"] > 0) == (spec[0] > 1)


@pytest.mark.parametrize("tag", EXTRA)
def test_drop_path_and_checkpointing_equal_one_process(spawned, one_process, tag):
    """Drop path on: every rank of a data row draws the row's masks
    (`shard_drop_path` with the data coordinate and one generator seed);
    under `use_checkpoint` the backward replays the blocks' forwards, their
    collectives and masks included, on every rank alike."""
    spec, _ = EXTRA[tag]
    want = one_process["drop"]
    outs = [o[tag] for o in spawned[2].results()]
    assert _ranks_agree([o["params"] for o in outs])
    for o in outs:
        _grads_close(o["grads"], want["grads"])
        for (lt, nt), (lw, nw) in zip(o["metrics"], want["metrics"]):
            assert abs(lt - lw) <= 1e-5 and abs(nt - nw) <= 1e-4 * nw
    _masters_close(outs[0]["params"], want["params"])
    # the masks drop something: the gradients differ from the no-drop ones
    assert max(_grad_shares(want["grads"], one_process["no_drop"]["grads"]).values()) > 10


# --------------------------------------------------------------------------- #
# the differentiable primitives, float64 inputs, at 2 and 4 ranks
# --------------------------------------------------------------------------- #


def _ref(fn, x, cot, *params):
    x = torch.from_numpy(x).requires_grad_(True)
    y = fn(x)
    (y * torch.as_tensor(cot)).sum().backward()
    return y.detach(), [x.grad] + [p.grad for p in params]


def _prims(spawned, world):
    return [o["primitives"] for o in spawned[world].results()]


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max()) / scale


def _slabs(a, world, axis=1):
    return np.split(np.asarray(a), world, axis)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("planes", [1, 2])
def test_halo_backward_sends_edge_gradients_to_neighbours(spawned, world, planes):
    pr = _primitive_inputs(world)
    x = torch.from_numpy(pr["x"]).requires_grad_(True)
    padded = F.pad(x, (0, 0, 0, 0, 0, 0, planes, planes))
    dl = 8 // world
    loss = sum((padded[:, r * dl:r * dl + dl + 2 * planes] * torch.from_numpy(
        pr["halo_cot"][planes][r])).sum() for r in range(world))
    loss.backward()
    for r, (p, g) in enumerate(zip(_prims(spawned, world), _slabs(x.grad, world))):
        y, (gx,) = p["halo", planes]
        np.testing.assert_array_equal(y, padded.detach()[:, r * dl:r * dl + dl + 2 * planes])
        np.testing.assert_array_equal(gx, g)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_then_own_planes_backward_is_a_reduce_scatter(spawned, world):
    pr = _primitive_inputs(world)
    y, (gx,) = _ref(lambda v: torch.cumsum(v, 1) ** 2, pr["x"], pr["cot"])
    for p, ys, gs in zip(_prims(spawned, world), _slabs(y, world), _slabs(gx, world)):
        _close(p["gather_own"][0], ys)
        _close(p["gather_own"][1][0], gs)


@pytest.mark.parametrize("world", WORLDS)
def test_statistics_backward_equal_whole_volume(spawned, world):
    """InstanceNorm of the slab (each rank's own output) and the DHW mean
    (every rank's copy feeds its own work: its cotangent differs a rank,
    the whole volume's gradient takes their sum)."""
    pr = _primitive_inputs(world)
    y, (gx,) = _ref(lambda v: instance_norm(v), pr["x"], pr["cot"])
    for p, ys, gs in zip(_prims(spawned, world), _slabs(y, world), _slabs(gx, world)):
        _close(p["instance_norm"][0], ys)
        _close(p["instance_norm"][1][0], gs)
    cot = pr["mean_cot"].sum(0)
    y, (gx,) = _ref(lambda v: v.float().mean(dim=(1, 2, 3)).double(), pr["x"], cot)
    for p, gs in zip(_prims(spawned, world), _slabs(gx, world)):
        _close(p["mean_dhw"][0], y)
        _close(p["mean_dhw"][1][0], gs)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CONVS)
def test_conv_on_slab_backward_equals_whole_volume(spawned, world, name):
    """The dense 3³ conv (`conv3_same`, the neighbours' taps added to the
    edge planes in place) and the stencil on a halo slab: the input's
    gradient a slab, the weight's and bias's summed over the ranks."""
    pr = _primitive_inputs(world)
    cin, cout, groups = CONVS[name]
    conv = ConvCL(cin, cout, 3, padding=1, groups=groups).double()
    conv.load_state_dict(pr["conv_sd"][name])
    y, (gx, gw, gb) = _ref(conv, pr["conv_x"][name], pr["conv_cot"][name], conv.weight,
                           conv.bias)
    prims = _prims(spawned, world)
    for p, ys, gs in zip(prims, _slabs(y, world), _slabs(gx, world)):
        _close(p[name][0], ys)
        _close(p[name][1][0], gs)
    _close(sum(p[name][1][1] for p in prims), gw)
    _close(sum(p[name][1][2] for p in prims), gb)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", RESIZES)
def test_resize_on_slab_backward_equals_interpolate(spawned, world, name):
    pr = _primitive_inputs(world)
    size, align = RESIZES[name]
    y, (gx,) = _ref(lambda v: resize_trilinear(v, size, align_corners=align), pr["x"],
                    pr["resize_cot"][name])
    for p, ys, gs in zip(_prims(spawned, world), _slabs(y, world), _slabs(gx, world)):
        _close(p[name][0], ys)
        _close(p[name][1][0], gs)


@pytest.mark.parametrize("world", WORLDS)
def test_row_parallel_linear_and_split_layer_norm_backward(spawned, world):
    """On a tensor line: the row-parallel product (the input's and the
    weight's columns a rank, the replicated bias's whole gradient on every
    rank) and the LayerNorm over a split last dim; `copy`'s backward sums
    the ranks' cotangents."""
    pr = _primitive_inputs(world)
    lin = torch.nn.Linear(8, 5).double()
    norm = torch.nn.LayerNorm(8, eps=1e-5).double()
    with torch.no_grad():
        for m, (w, b) in ((lin, ("lin_w", "lin_b")), (norm, ("ln_w", "ln_b"))):
            m.weight.copy_(torch.from_numpy(pr[w]))
            m.bias.copy_(torch.from_numpy(pr[b]))
    y, (gx, gw, gb) = _ref(lin, pr["lin_x"], pr["lin_cot"], lin.weight, lin.bias)
    cols = lambda a: _slabs(a, world, -1)
    prims = _prims(spawned, world)
    for p, xs, ws in zip(prims, cols(gx), cols(gw)):
        yr, (gxr, gwr, gbr) = p["row_parallel_linear"]
        _close(yr, y)
        _close(gxr, xs)
        _close(gwr, ws)
        _close(gbr, gb)
    y, (gx, gw, gb) = _ref(lambda v: F.layer_norm(v, (8,), norm.weight, norm.bias, 1e-5),
                           pr["ln_x"], pr["ln_cot"], norm.weight, norm.bias)
    for p, ys, xs, ws, bs in zip(prims, cols(y), cols(gx), cols(gw), cols(gb)):
        yr, (gxr, gwr, gbr) = p["layer_norm"]
        for a, b in ((yr, ys), (gxr, xs), (gwr, ws), (gbr, bs)):
            _close(a, b)
    for p in prims:
        np.testing.assert_allclose(p["copy"][1][0], pr["copy_w"].sum(0), rtol=1e-15)


# --------------------------------------------------------------------------- #
# the losses on a spatial line
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", LOSS_CASES)
def test_losses_on_slabs_equal_whole_volume(spawned, world, case):
    """The volume's sums (Dice statistics, CE/BCE voxel sums) summed over
    the line, top-k over the gathered per-voxel CE: every rank holds the
    whole volume's loss, and its slab's share of the logits' gradient."""
    inp = _loss_inputs()
    name, kw, target = LOSS_CASES[case]
    logits = torch.from_numpy(inp["loss_logits"]).requires_grad_(True)
    loss = getattr(tl, name)(logits, torch.from_numpy(inp[target]), **kw)
    loss.backward()
    for r, o in enumerate(spawned[world].results()):
        value, grad = o["losses"][case]
        assert abs(value - float(loss)) <= 1e-6 * max(1.0, abs(float(loss))), (value, loss)
        _close(grad, _slabs(logits.grad, world)[r], 1e-6)


# --------------------------------------------------------------------------- #
# Trainer and SSLTrainer
# --------------------------------------------------------------------------- #


def _trainer_kw(logdir):
    return dict(batch_size=1, val_every=1, num_steps_per_epoch=1, val_patches_per_epoch=1,
                patch_size=TRAINER_NET["img_size"], logdir=logdir, num_workers=0,
                augmentation="noaug", seed=3, full_val_every=1, full_val_cases=1)


@pytest.fixture(scope="module")
def one_process_trainer(spawned, tmp_path_factory):
    fullres = os.path.join(spawned[2].workdir, "fullres")
    names = sorted(f[:-4] for f in os.listdir(fullres) if f.endswith(".npz"))
    trainer = Trainer(create_waveformer(TRAINER_NET, device="cpu", seed=0), max_epochs=2,
                      resume=False, **_trainer_kw(str(tmp_path_factory.mktemp("one_trainer"))))
    trainer.train(MedicalDataset(fullres, names[:3], unpack=False),
                  MedicalDataset(fullres, names[3:], unpack=False))
    return {k: v.detach().clone() for k, v in trainer.state.params.items()}


@pytest.mark.parametrize("spec", TRAINER_MESHES)
def test_trainer_on_model_parallel_mesh(spawned, one_process_trainer, spec):
    outs = [o["trainer", spec] for o in spawned[2].results()]
    assert _ranks_agree([o["first"] for o in outs])
    assert all(o["global_step"] == 2 and np.isfinite(o["best"]) for o in outs)
    assert [o["wrote"] for o in outs] == [True, False]
    _masters_close(outs[0]["first"], one_process_trainer)
    names = os.listdir(os.path.join(spawned[2].workdir, "trainer_" + "_".join(map(str, spec)),
                                    "model"))
    assert sum(n.startswith("final_model_") and n.endswith(".npz") for n in names) == 1


@pytest.mark.parametrize("spec", TRAINER_MESHES)
def test_trainer_checkpoint_reloads_equal_masters_on_every_rank(spawned, spec):
    """Rank (0, 0, 0) writes the periodic state; trainers built from other
    weights on every rank reload it (broadcast over every rank, not only
    the data line) to equal masters and slices, then train on alike."""
    outs = [o["trainer", spec] for o in spawned[2].results()]
    for o in outs:
        assert _ranks_agree([o["reloaded"], outs[0]["first"]])
        assert o["reloaded_step"] == 2 and o["resumed_step"] == 3
        assert o["single_gpu_raised"]
    assert _ranks_agree([o["resumed"] for o in outs])
    assert not _ranks_agree([outs[0]["resumed"], outs[0]["first"]])


def test_ssl_trainer_on_model_parallel_mesh_equals_one_process(spawned, ssl_sd, tmp_path):
    model = SSLViT(**SSL_TINY)
    model.load_state_dict(ssl_sd, strict=True)
    trainer = SSLTrainer(model, num_steps=2, lr=1e-3, warmup_steps=1, eval_every=100,
                         logdir=str(tmp_path), seed=5)
    trainer.train(iter(_ssl_batches()))
    for spec in SSL_MESHES:
        outs = [o["ssl", spec] for o in spawned[2].results()]
        for o in outs:
            assert _ranks_agree([o["params"], {k: v.detach() for k, v in
                                               trainer.state.params.items()}])
            assert o["losses"] == [float(v) for v in trainer.losses]


@pytest.mark.parametrize("spec", [(1, 2, 1), (1, 1, 2)])
def test_make_train_step_refuses_an_unarmed_module(spec):
    """On a spatial or tensor line the module must be sharded (after its
    masters were taken): a whole module's slab forward would be wrong."""
    from tests.test_torch_model_parallel import _fake_mesh

    model = create_waveformer(TOY, device="cpu", seed=0)
    with pytest.raises(ValueError, match="shard_model"):
        make_train_step(model, tl.dice_ce_loss, _fake_mesh(spec))
