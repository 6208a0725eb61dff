"""The port's data parallelism (`waveformer_tpu_torch/parallel`) against the
JAX package's, on the CPU.

Two torch ranks run as child processes over gloo (`tests/torch_dist_child.py`,
`file://` rendezvous in a temporary directory, 60 s group timeout, each
child joined with a timeout), spawned once for the module; they import no
JAX. The JAX side runs here on conftest's virtual CPU devices: a `data=2`
mesh, `shard_map` for the collectives, `SyncBatchNorm` and the losses, the
mesh train step and `SSLTrainer`'s step. Same seeded numpy inputs on both
sides.

Gradients: every rank's autograd takes the gradient of Σ_r L_r (each
collective's backward sums the ranks' cotangents; `parallel/collectives.py`),
which JAX computes as `jax.grad` of the `psum` of the per-rank values under
`shard_map`. The data-parallel steps average the ranks' gradients, so they
are JAX's global-batch steps.

Tolerances:
  * collectives and `SyncBatchNorm` values, gradients and running statistics
    within 1e-5 (fp32 moments and sums in other orders); `gather_metrics`
    and `shard_cases_for_eval` exact;
  * the losses with a group: values within 1e-6, logits' gradients within
    1e-6 (fp32 reductions in other orders, as tests/test_torch_training.py);
  * two data-parallel train steps of the 32³ network against JAX's `data=2`
    mesh step: loss within 1e-5, gradient norm 1e-4 relative, parameters
    within 1e-5 on ≥ 99% of the elements and 5e-4 everywhere (the limits
    of tests/test_torch_training.py: AdamW turns a gradient's rounding into
    ±lr where it is tiny);
  * the same steps against the port's own one-process step on the global
    batch, drop path on and off: loss within 1e-6, gradient norm 1e-5
    relative, parameters within 1e-6 everywhere (the same model and masks;
    only the batch's sums split in two and added back);
  * two SSL steps against JAX `SSLTrainer`'s step on `data=2`: loss parts
    within 1e-5, parameters as the train step's;
  * `Trainer` at 2 ranks: both ranks' masters `torch.equal`, after a fresh
    start and after a resume.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from tests.torch_dist_child import LOSS_GROUP_CASES, loss_fn
from waveformer_tpu.models import Waveformer as JaxWaveformer
from waveformer_tpu.models.ssl import SSLViT as JaxSSLViT
from waveformer_tpu.parallel import collectives as jc
from waveformer_tpu.parallel import mesh as jmesh
from waveformer_tpu.training import losses as jl
from waveformer_tpu.training import ssl as jssl
from waveformer_tpu.training import state as jstate
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.parallel import collectives as pc
from waveformer_tpu_torch.parallel import mesh as pm
from waveformer_tpu_torch.tools import synthetic_cases
from waveformer_tpu_torch.training import losses as tl
from waveformer_tpu_torch.training import ssl as tssl
from waveformer_tpu_torch.training.checkpoint import params_tree
from waveformer_tpu_torch.training.state import (
    TrainState, make_optimizer, make_train_step, master_params)
from waveformer_tpu_torch.training.trainer import step_seed
from waveformer_tpu_torch.utils.jax_params import (
    ssl_params_tree, ssl_state_dict_from_jax, state_dict_from_jax)

CHILD = os.path.join(os.path.dirname(__file__), "torch_dist_child.py")
WORLD = 2
JOIN_TIMEOUT_S = 240
SMALL = dict(img_size=(32, 32, 32), patch_size=2, in_chans=2, out_chans=3,
             embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8),
             decom_levels=(3, 2, 1, 0), drop_path_rate=0.0)
SSL_TINY = dict(img_size=(16, 16, 16), patch_size=4, in_channels=2, hidden_size=32,
                mlp_dim=64, num_layers=2, num_heads=4, projection_size=8,
                upsample_mode="vae")
TRAINER_NET = dict(img_size=(16, 16, 16), patch_size=2, in_chans=4, out_chans=4,
                   embed_dims=(4, 8, 16, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 4),
                   decom_levels=(3, 2, 1, 0), drop_path_rate=0.1)
ADAM_BOUND = 5e-4
# SSL: parameters whose exact gradient is 0 (the attention's key bias and
# the vae decoder's conv biases before an InstanceNorm; the port detaches
# them, JAX gives them rounding noise that AdamW's g / (|g| + eps) scales
# to up to ±lr): in the two steps only the second has lr > 0 (1e-3 after a
# 1-step warmup), and an AdamW update is at most about 1.42·lr there
ZERO_GRADIENT = lambda k: k.endswith("attn/key/bias") or (
    k.startswith("dec_conv") and k.endswith("conv/bias"))
SSL_ZERO_GRADIENT_BOUND = 1.5e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the tier-1 run puts six pytest
    workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_params(model, *args, seed=0):
    """Seeded numpy parameters in the shapes `model.init` would make (no
    compile)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "relative_position_bias_table":
            return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = max(int(np.prod(s.shape[:-1])), 1)
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_inputs(workdir):
    rng = np.random.default_rng(0)
    inp = {
        "mean_x": rng.standard_normal((WORLD, 3, 5)).astype(np.float32),
        "mean_w": rng.standard_normal((WORLD, 3, 5)).astype(np.float32),
        "gather_x": np.arange(8.0, dtype=np.float32),
        "metrics": rng.standard_normal((6, 2)).astype(np.float32),
        "sbn_x": rng.standard_normal((8, 4, 4, 4, 6)).astype(np.float32),
        "sbn_c": rng.standard_normal((8, 4, 4, 4, 6)).astype(np.float32),
        "sbn_weight": (1.0 + 0.1 * rng.standard_normal(6)).astype(np.float32),
        "sbn_bias": (0.1 * rng.standard_normal(6)).astype(np.float32),
        "logits": (2.0 * rng.standard_normal((4, 6, 5, 4, 4))).astype(np.float32),
        "labels": rng.integers(0, 4, (4, 6, 5, 4, 1)).astype(np.int32),
        "regions": (rng.uniform(size=(4, 6, 5, 4, 4)) > 0.6).astype(np.float32),
        # the last channel marks the voxels to ignore
        "regions_ignore": (rng.uniform(size=(4, 6, 5, 4, 5)) > 0.6).astype(np.float32),
    }
    inp["sbn_x"][:4] += 3.0  # the ranks' halves differ
    data = rng.standard_normal((2, 32, 32, 32, 2)).astype(np.float32)
    seg = rng.integers(0, 3, (2, 32, 32, 32, 1)).astype(np.int32)
    inp["batch"] = (data, seg)
    jm = JaxWaveformer(**SMALL)
    inp["train_params"] = seeded_params(jm, jnp.asarray(data))
    inp["train_sd"] = state_dict_from_jax(inp["train_params"], SMALL["depths"])
    inp["train_cfg"] = SMALL
    inp["train_cfg_drop"] = dict(SMALL, drop_path_rate=0.3)
    gt = rng.standard_normal((2, 16, 16, 16, 2)).astype(np.float32)
    inp["ssl_params"] = seeded_params(JaxSSLViT(**SSL_TINY), jnp.asarray(gt), seed=1)
    inp["ssl_sd"] = ssl_state_dict_from_jax(inp["ssl_params"])
    inp["ssl_cfg"] = SSL_TINY
    inp["ssl_gt"] = gt
    views_rng = np.random.RandomState(4)
    inp["ssl_views"] = []
    for _ in range(2):
        v1, v2 = tssl.make_two_views(gt.transpose(0, 4, 1, 2, 3), views_rng)
        inp["ssl_views"].append(tuple(np.ascontiguousarray(v.transpose(0, 2, 3, 4, 1))
                                      for v in (v1, v2)))
    inp["trainer_cfg"] = TRAINER_NET
    synthetic_cases.write_training_cases(os.path.join(workdir, "fullres"), n=4,
                                         shape=(20, 22, 18), seed=0)
    return inp


class Ranks:
    """The spawned ranks; `results()` joins them (each within the
    timeout) and fails on any nonzero exit."""

    def __init__(self, suite, workdir, world=WORLD):
        self.workdir = workdir
        self.procs = [subprocess.Popen(
            [sys.executable, CHILD, suite, str(r), str(world), str(workdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self._out = None

    def results(self):
        if self._out is None:
            logs = []
            for p in self.procs:
                try:
                    log, _ = p.communicate(timeout=JOIN_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"a rank did not finish in {JOIN_TIMEOUT_S} s")
                logs.append(log)
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-4000:]
            self._out = [torch.load(os.path.join(self.workdir, f"rank{r}.pt"),
                                    weights_only=False) for r in range(len(self.procs))]
        return self._out

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("parallel")
    inp = make_inputs(str(workdir))
    # the children get no JAX tree (unpickling one would import flax)
    torch.save({k: v for k, v in inp.items() if k not in ("train_params", "ssl_params")},
               os.path.join(workdir, "inputs.pt"))
    ranks = Ranks("parallel", workdir)
    yield inp, ranks
    ranks.kill()


def _jmesh():
    return JaxMesh(np.asarray(jax.devices()[:WORLD]), ("data",))


def _rows(a):
    return np.split(np.asarray(a), WORLD)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


# --------------------------------------------------------------------------- #
# mesh (in this process: no group)
# --------------------------------------------------------------------------- #


def test_mesh_without_group_is_one_process():
    mesh = pm.make_mesh()
    assert (mesh.size, mesh.rank, mesh.group, mesh.is_main) == (1, 0, None, True)
    assert mesh.shape == {"data": 1, "spatial": 1, "tensor": 1}
    mesh.barrier()  # nothing to wait for
    t = [torch.ones(3)]
    assert pm.replicate(mesh, t) is t


@pytest.mark.parametrize("spec,err", [(pm.MeshSpec(spatial=2), NotImplementedError),
                                      (pm.MeshSpec(tensor=2), NotImplementedError),
                                      (pm.MeshSpec(data=2), ValueError)])
def test_make_mesh_refuses_what_it_cannot_build(spec, err):
    with pytest.raises(err):
        pm.make_mesh(spec)


def test_mesh_spec_matches_jax():
    for kw in ({}, {"data": 4}, {"data": 2, "spatial": 2}):
        j, t = jmesh.MeshSpec(**kw), pm.MeshSpec(**kw)
        assert (t.axis_names, t.shape, t.size()) == (j.axis_names, j.shape, j.size())


@pytest.mark.parametrize("rank", range(WORLD))
def test_shard_batch_takes_the_ranks_rows(rank):
    mesh = pm.Mesh(pm.MeshSpec(data=WORLD), rank)
    batch = {"data": np.arange(8 * 3).reshape(8, 3), "seg": torch.arange(8)}
    got = pm.shard_batch(mesh, batch)
    np.testing.assert_array_equal(got["data"], batch["data"][rank * 4:(rank + 1) * 4])
    assert torch.equal(got["seg"], torch.arange(rank * 4, (rank + 1) * 4))
    with pytest.raises(ValueError):
        pm.shard_batch(mesh, np.zeros((3, 2)))


@pytest.mark.parametrize("n,w", [(10, 4), (8, 2), (1, 3), (0, 2), (5, 5), (7, 1), (3, 8)])
def test_shard_cases_for_eval_equals_jax(n, w):
    got, gn = pc.shard_cases_for_eval(n, w)
    want, wn = jc.shard_cases_for_eval(n, w)
    assert gn == wn and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# collectives and SyncBatchNorm at 2 ranks
# --------------------------------------------------------------------------- #


def test_ranks_form_a_data_mesh(spawned):
    out = spawned[1].results()
    assert [o["rank"] for o in out] == [0, 1]
    assert all(o["size"] == WORLD and o["shape"] == {"data": WORLD, "spatial": 1, "tensor": 1}
               for o in out)


def test_cross_replica_mean_matches_jax(spawned):
    inp, ranks = spawned
    mesh = _jmesh()
    x, w = jnp.asarray(inp["mean_x"]), jnp.asarray(inp["mean_w"])
    sm = lambda f, out: jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                                      out_specs=out)
    value = jax.jit(sm(lambda xs, ws: jax.lax.pmean(xs, "data") * ws, P("data")))(x, w)
    grad = jax.jit(jax.grad(lambda x: sm(lambda xs, ws: jax.lax.psum(
        jnp.sum(jax.lax.pmean(xs, "data") * ws), "data"), P())(x, w)))(x)
    out = ranks.results()
    for r, o in enumerate(out):
        val, (g,) = o["mean"]
        _close(val, _rows(value)[r], 1e-6)
        _close(g, _rows(grad)[r], 1e-6)


def test_all_gather_with_grad_matches_jax(spawned):
    inp, ranks = spawned
    mesh = _jmesh()
    x = jnp.asarray(inp["gather_x"])
    sm = lambda f, out: jax.shard_map(f, mesh=mesh, in_specs=P("data"), out_specs=out)
    value = jax.jit(sm(lambda xs: jc.all_gather_with_grad(xs, "data")[None] ** 2,
                       P("data")))(x)
    grad = jax.jit(jax.grad(lambda x: sm(lambda xs: jax.lax.psum(
        jnp.sum(jc.all_gather_with_grad(xs, "data") ** 2), "data"), P())(x)))(x)
    # each x enters every rank's sum once: d/dx Σ_r Σ g² = 2·W·x
    np.testing.assert_allclose(np.asarray(grad), 2 * WORLD * np.asarray(x), rtol=1e-6)
    for r, o in enumerate(ranks.results()):
        val, (g,) = o["gather"]
        _close(val, np.asarray(value)[r], 0)
        _close(g, _rows(grad)[r], 1e-5)


def test_gather_metrics_matches_jax(spawned):
    inp, ranks = spawned
    mesh = _jmesh()
    want = jax.jit(jax.shard_map(lambda v: jc.gather_metrics(v, "data"), mesh=mesh,
                                 in_specs=P("data"), out_specs=P(), check_vma=False))(
        jnp.asarray(inp["metrics"]))
    for o in ranks.results():
        np.testing.assert_array_equal(o["metrics"], np.asarray(want))


def _jax_sbn(inp):
    """JAX `SyncBatchNorm(axis_name="data")` on the data=2 mesh: outputs,
    the gradient of Σ_r Σ y·c, new running statistics, and the eval-mode
    output from them."""
    mesh = _jmesh()
    bn = jc.SyncBatchNorm(features=6, axis_name="data")
    x, c = jnp.asarray(inp["sbn_x"]), jnp.asarray(inp["sbn_c"])
    params = {"scale": jnp.asarray(inp["sbn_weight"]), "bias": jnp.asarray(inp["sbn_bias"])}
    stats = {"mean": jnp.zeros(6), "var": jnp.ones(6)}

    def per(xs, cs, p):
        y, new = bn.apply({"params": p, "batch_stats": stats}, xs, mutable=["batch_stats"])
        return y, jax.lax.psum(jnp.sum(y * cs), "data"), new["batch_stats"]

    f = jax.shard_map(per, mesh=mesh, in_specs=(P("data"), P("data"), P()),
                      out_specs=(P("data"), P(), P()))
    y, _, new_stats = jax.jit(f)(x, c, params)
    gx, gp = jax.jit(jax.grad(lambda x, p: f(x, c, p)[1], argnums=(0, 1)))(x, params)
    y_eval = bn.apply({"params": params, "batch_stats": new_stats}, x, use_running_average=True)
    return y, gx, gp, new_stats, y_eval


def test_sync_batch_norm_matches_jax(spawned):
    inp, ranks = spawned
    y, gx, gp, stats, y_eval = _jax_sbn(inp)
    out = [o["sbn"] for o in ranks.results()]
    for r, o in enumerate(out):
        _close(o["y"], _rows(y)[r], 1e-5)
        _close(o["x_grad"], _rows(gx)[r], 1e-5)
        _close(o["running_mean"], stats["mean"], 1e-6)
        _close(o["running_var"], stats["var"], 1e-6)
        _close(o["y_eval"], _rows(y_eval)[r], 1e-5)
        assert o["num_batches_tracked"] == 1
    # each rank's parameter gradient is its own rows' part; their sum is JAX's
    _close(sum(o["weight_grad"] for o in out), gp["scale"], 1e-4)
    _close(sum(o["bias_grad"] for o in out), gp["bias"], 1e-4)


def test_sync_batch_norm_without_group_is_batch_norm():
    """No group: plain BatchNorm over the batch, JAX's formula, both modes."""
    x = np.random.default_rng(2).standard_normal((4, 3, 3, 3, 5)).astype(np.float32) * 2 + 1
    bn = pc.SyncBatchNorm(5).train()
    got = bn(torch.from_numpy(x)).detach().numpy()
    jbn = jc.SyncBatchNorm(features=5, axis_name=None)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, new = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    _close(got, want, 1e-5)
    _close(bn.running_mean, new["batch_stats"]["mean"], 1e-6)
    _close(bn.running_var, new["batch_stats"]["var"], 1e-6)
    bn.eval()
    _close(bn(torch.from_numpy(x)).detach().numpy(),
           jbn.apply({**v, **new}, jnp.asarray(x), use_running_average=True), 1e-5)


# --------------------------------------------------------------------------- #
# losses with a group
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", sorted(LOSS_GROUP_CASES))
def test_loss_with_group_matches_jax_axis_name(spawned, case):
    inp, ranks = spawned
    name, kw = LOSS_GROUP_CASES[case]
    target = inp["regions_ignore"] if kw.get("use_ignore_label") else (
        inp["regions"] if name == "dice_bce_loss" else inp["labels"])
    fn = loss_fn(jl, name, kw, {"axis_name": "data"})
    mesh = _jmesh()
    sm = lambda f, out: jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                                      out_specs=out)
    x, t = jnp.asarray(inp["logits"]), jnp.asarray(target)
    values = jax.jit(sm(lambda l, y: fn(l, y)[None], P("data")))(x, t)
    grad = jax.jit(jax.grad(lambda x: sm(lambda l, y: jax.lax.psum(fn(l, y), "data"),
                                         P())(x, t)))(x)
    out = [o["losses"][case] for o in ranks.results()]
    for r, (value, g) in enumerate(out):
        _close(value, np.asarray(values)[r], 1e-6 * max(1.0, abs(value)))
        _close(g, _rows(grad)[r], 1e-6)
    if kw.get("use_ignore_label"):
        return  # its BCE is a mean over each rank's unmasked voxels, as in JAX
    # the ranks' mean is the loss of the whole batch in one process
    whole = loss_fn(tl, name, kw, {})(torch.from_numpy(inp["logits"]), torch.from_numpy(target))
    _close(np.mean([v for v, _ in out]), float(whole), 1e-6 * max(1.0, abs(float(whole))))


# --------------------------------------------------------------------------- #
# the data-parallel train and SSL steps
# --------------------------------------------------------------------------- #


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def _errors(got, want):
    assert set(got) == set(want)
    return np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])


def _ranks_agree(params_by_rank):
    first = params_by_rank[0]
    return all(torch.equal(p[k], first[k]) for p in params_by_rank[1:] for k in first)


def test_train_step_matches_jax_data_mesh(spawned):
    inp, ranks = spawned
    data, seg = inp["batch"]
    jm = JaxWaveformer(**SMALL)
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=WORLD), jax.devices()[:WORLD])
    state = jmesh.replicate(mesh, jstate.TrainState.create(
        inp["train_params"], jstate.make_optimizer(lr=1e-4)))
    step = jstate.make_train_step(jm.apply, jl.dice_ce_loss, mesh=mesh, donate=False)
    batch = jmesh.shard_batch(mesh, {"data": data, "seg": seg})
    want_metrics = []
    for _ in range(2):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        want_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    want = dict(_flat(jax.device_get(state.params)["params"]))

    out = [o["train"]["no_drop"] for o in ranks.results()]
    assert _ranks_agree([o["params"] for o in out])
    for o in out:
        assert o["step"] == 2
        for (lt, nt), (lj, nj) in zip(o["metrics"], want_metrics):
            assert abs(lt - lj) <= 1e-5, (lt, lj)
            assert abs(nt - nj) <= 1e-4 * nj, (nt, nj)
    got = dict(_flat(params_tree(out[0]["params"], SMALL["depths"])["params"]))
    err = _errors(got, want)
    assert err.max() <= ADAM_BOUND, err.max()
    assert np.mean(err <= 1e-5) >= 0.99, np.mean(err <= 1e-5)


@pytest.mark.parametrize("tag", ["no_drop", "drop"])
def test_train_step_equals_one_process_step(spawned, tag):
    """The 2-rank step against the port's step on the whole batch in one
    process, from the same weights and drop-path generator seeds."""
    inp, ranks = spawned
    cfg = inp["train_cfg_drop" if tag == "drop" else "train_cfg"]
    model = create_waveformer(cfg, device="cpu").train()
    model.load_state_dict(inp["train_sd"], strict=True)
    state = TrainState.create(master_params(model), make_optimizer(lr=1e-4))
    step = make_train_step(model, tl.dice_ce_loss)
    data, seg = inp["batch"]
    batch = {"data": torch.from_numpy(data), "seg": torch.from_numpy(seg)}
    gen = torch.Generator()
    want_metrics = []
    for i in range(2):
        gen.manual_seed(step_seed(0, i))
        state, m = step(state, batch, gen)
        want_metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out = [o["train"][tag] for o in ranks.results()]
    assert _ranks_agree([o["params"] for o in out])
    (l1, n1), (l2, n2) = out[0]["metrics"]
    (w1, v1), (w2, v2) = want_metrics
    err = torch.cat([(out[0]["params"][k] - state.params[k].detach()).abs().ravel()
                     for k in state.params]).numpy()
    assert abs(l1 - w1) <= 1e-6 and abs(n1 - v1) <= 1e-5 * v1, ((l1, n1), (w1, v1))
    assert abs(l2 - w2) <= 1e-5 and abs(n2 - v2) <= 1e-4 * v2, ((l2, n2), (w2, v2))
    assert err.max() <= ADAM_BOUND, err.max()
    assert np.mean(err <= 1e-5) >= 0.99, np.mean(err <= 1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_rank_gradients_average_to_the_batch_gradient_float64(rate):
    """The data-parallel step's arithmetic, exactly: in float64 the mean of
    the two ranks' gradients (each on its row, drop-path masks from the
    same generator seed, `shard_drop_path`) equals the gradient of the
    whole batch's loss to 1e-8 of the largest gradient (float64 sums in
    other orders; the stencil's backward, `dwconv3_backward`, sums in the
    inputs' float64 too). In fp32 on the CPU a batch-1
    backward sums some reductions less accurately than a batch-2 one
    (1e-3 relative at a near-constant InstanceNorm input, against the
    float64 result), which is why the fp32 comparison above holds the
    step-2 parameters at the AdamW limits."""
    from waveformer_tpu_torch.models.common import shard_drop_path

    cfg = dict(TRAINER_NET, drop_path_rate=rate)
    model = create_waveformer(cfg, device="cpu", seed=0).train().double()
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.standard_normal((2, 16, 16, 16, 4)))
    seg = torch.from_numpy(rng.integers(0, 4, (2, 16, 16, 16, 1)).astype(np.int32))

    def grads(x, y, rank, world):
        shard_drop_path(model, rank, world)
        model.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(step_seed(0, 0))
        tl.dice_ce_loss(model(x, generator=gen), y).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    whole = grads(data, seg, 0, 1)
    parts = [grads(data[r:r + 1], seg[r:r + 1], r, 2) for r in range(2)]
    scale = max(float(g.abs().max()) for g in whole.values())
    for n, g in whole.items():
        mean = (parts[0][n] + parts[1][n]) / 2
        assert float((mean - g).abs().max()) <= 1e-8 * scale, n


def test_drop_path_shard_draws_the_global_masks():
    """Rank r of W keeps rows [r·b, (r+1)·b) of the masks one process draws
    for the whole batch from the same generator seed."""
    from waveformer_tpu_torch.models.common import DropPath, shard_drop_path

    x = torch.ones(8, 2, 3)
    whole = DropPath(0.5).train()(x, torch.Generator().manual_seed(7))
    parts = []
    for r in range(4):
        dp = torch.nn.Sequential(DropPath(0.5)).train()
        shard_drop_path(dp, r, 4)
        parts.append(dp[0](x[2 * r:2 * r + 2], torch.Generator().manual_seed(7)))
    assert torch.equal(torch.cat(parts), whole)
    assert 0 < int((whole == 0).all(dim=(1, 2)).sum()) < 8


def test_ssl_step_matches_jax_data_mesh(spawned, tmp_path):
    inp, ranks = spawned
    jt = jssl.SSLTrainer(JaxSSLViT(**SSL_TINY), num_steps=10, batch_size=2, lr=1e-3,
                         warmup_steps=1, logdir=str(tmp_path / "jax"), seed=0)
    assert dict(jt.mesh.shape)["data"] == WORLD
    state = jmesh.replicate(jt.mesh, jstate.TrainState.create(inp["ssl_params"], jt.tx))
    step = jt._make_step()
    want_metrics = []
    for i, (v1, v2) in enumerate(inp["ssl_views"]):
        b = jmesh.shard_batch(jt.mesh, {"v1": v1, "v2": v2, "gt": inp["ssl_gt"]})
        state, m = step(state, b["v1"], b["v2"], b["gt"],
                        jax.random.fold_in(jax.random.PRNGKey(0), i))
        want_metrics.append({k: float(m[k]) for k in ("loss", "contrast", "recon")})
    want = dict(_flat(jax.device_get(state.params)["params"]))

    out = [o["ssl"] for o in ranks.results()]
    assert _ranks_agree([o["params"] for o in out])
    for o in out:
        for got_m, want_m in zip(o["metrics"], want_metrics):
            for k in want_m:
                assert abs(got_m[k] - want_m[k]) <= 1e-5, (k, got_m[k], want_m[k])
    got = dict(_flat(ssl_params_tree(out[0]["params"], SSL_TINY["num_heads"])["params"]))
    zero = {k for k in want if ZERO_GRADIENT(k)}
    assert zero  # the key biases and the decoder's pre-InstanceNorm conv biases
    err = _errors({k: got[k] for k in want if k not in zero},
                  {k: want[k] for k in want if k not in zero})
    assert err.max() <= ADAM_BOUND, err.max()
    assert np.mean(err <= 1e-5) >= 0.99, np.mean(err <= 1e-5)
    zero_err = _errors({k: got[k] for k in zero}, {k: want[k] for k in zero})
    assert zero_err.max() <= SSL_ZERO_GRADIENT_BOUND, zero_err.max()


def test_nt_xent_group_is_the_global_batch_loss(spawned):
    """The contrast part every rank reports is NT-Xent over the whole
    batch's embeddings (the same scalar on every rank)."""
    out = [o["ssl"]["metrics"] for o in spawned[1].results()]
    for step_metrics in zip(*out):
        assert len({m["contrast"] for m in step_metrics}) == 1
        assert len({m["loss"] for m in step_metrics}) == 1


# --------------------------------------------------------------------------- #
# Trainer at 2 ranks
# --------------------------------------------------------------------------- #


def test_trainer_ranks_hold_equal_masters(spawned):
    out = [o["trainer"] for o in spawned[1].results()]
    assert _ranks_agree([o["first"] for o in out])
    assert all(o["global_step"] == 4 and np.isfinite(o["best"]) for o in out)


def test_trainer_rank0_alone_writes(spawned):
    inp, ranks = spawned
    out = [o["trainer"] for o in ranks.results()]
    assert [o["wrote"] for o in out] == [True, False]
    model_dir = os.path.join(ranks.workdir, "trainer_logs", "model")
    names = os.listdir(model_dir)
    assert sum(n.startswith("final_model_") and n.endswith(".npz") for n in names) == 1
    assert sum(n.startswith("best_model_") and n.endswith(".npz") for n in names) == 1


def test_trainer_resume_broadcasts_rank0_state(spawned):
    """Rank 1 reads no checkpoint and starts from other weights; after the
    resume every rank holds rank 0's state and trains the last epoch."""
    out = [o["trainer"] for o in spawned[1].results()]
    assert _ranks_agree([o["resumed"] for o in out])
    assert all(o["resumed_epochs"] == 1 and o["resumed_step"] == 6 for o in out)
    assert not all(torch.equal(out[0]["resumed"][k], out[0]["first"][k])
                   for k in out[0]["first"])


def test_validation_single_gpu_refuses_two_ranks(spawned):
    assert all(o["trainer"]["single_gpu_raised"] for o in spawned[1].results())
