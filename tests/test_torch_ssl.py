"""The port's SSL model, losses, augment ops, step and trainer against the
JAX package's, on the CPU in fp32 at tiny widths.

Same seeded numpy inputs on both sides; JAX params from `jax.jit(model.init)`
carried into the port by `ssl_state_dict_from_jax`. Tolerances:
  * forwards (`ViT3D`, `SSLViT` in every upsample mode) within 1e-5 of the
    largest output: fp32 sums in other orders, and the port's GELU is the
    exact erf where JAX's is the A&S polynomial (|Δerf| ≤ 1.5e-7, so an
    activation moves by at most 0.5·|x|·1.5e-7, below 1e-6 of these
    outputs' scale);
  * the losses and their gradients to 1e-6 (fp32 in another order);
  * the augment ops `np.array_equal` (the same host numpy and RandomState
    calls in the same order);
  * two train steps: the loss to 1e-5; the parameters as in
    `tests/test_torch_training.py`: within 1e-5 on at least 99% of the
    elements and within 5e-4 everywhere (AdamW turns a gradient's rounding
    into ±lr where the gradient is tiny).
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.models.ssl import SSLViT as JaxSSLViT
from waveformer_tpu.models.vit import ViT3D as JaxViT3D
from waveformer_tpu.parallel.mesh import replicate, shard_batch
from waveformer_tpu.training import ssl as jssl
from waveformer_tpu.training import state as jstate
from waveformer_tpu.training.checkpoint import load_params_npz as jax_load_params_npz
from waveformer_tpu_torch.models.ssl import SSLViT, create_ssl_vit
from waveformer_tpu_torch.models.vit import ViT3D
from waveformer_tpu_torch.training import ssl as tssl
from waveformer_tpu_torch.training.schedules import warmup_cosine_schedule
from waveformer_tpu_torch.training.state import TrainState, make_optimizer
from waveformer_tpu_torch.utils.jax_params import ssl_params_tree, ssl_state_dict_from_jax

TINY = dict(img_size=(16, 16, 16), patch_size=4, in_channels=2, hidden_size=32,
            mlp_dim=64, num_layers=2, num_heads=4, projection_size=8)
FWD_REL = 1e-5
ADAM_BOUND = 5e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the tier-1 run puts six pytest
    workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed=0, b=2, c=TINY["in_channels"]):
    return np.random.default_rng(seed).standard_normal((b, 16, 16, 16, c)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_init(mode):
    jm = JaxSSLViT(**TINY, upsample_mode=mode)
    return jm, jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_x())))


def _jax_pair(mode="vae"):
    """A JAX `SSLViT`, its params from `jax.jit(init)` (made once per mode)
    and the port's module with those weights."""
    jm, params = _jax_init(mode)
    tm = SSLViT(**TINY, upsample_mode=mode)
    tm.load_state_dict(ssl_state_dict_from_jax(params), strict=True)
    return jm, params, tm


def _close(got, want, rel=FWD_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# --------------------------------------------------------------------------- #
# models and converters
# --------------------------------------------------------------------------- #


def test_vit_matches_jax():
    kw = {k: v for k, v in TINY.items() if k not in ("in_channels", "projection_size")}
    x = _x()
    jm = JaxViT3D(**kw)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    sd = ssl_state_dict_from_jax({"vit": params["params"], "proj_contrastive": {
        "kernel": np.zeros((32, 8), np.float32), "bias": np.zeros(8, np.float32)}})
    tm = ViT3D(in_channels=2, **kw)
    tm.load_state_dict({k[4:]: v for k, v in sd.items() if k.startswith("vit.")}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 32)  # 4³ tokens × hidden 32
    _close(got, want)


@pytest.mark.parametrize("mode", ["vae", "deconv", "large_kernel_deconv"])
def test_ssl_vit_matches_jax(mode):
    jm, params, tm = _jax_pair(mode)
    x = _x(3)
    je, jr = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        te, tr = tm(torch.from_numpy(x))
    assert tr.shape == x.shape and te.shape == (2, TINY["projection_size"])
    _close(te, je)
    _close(tr, jr)


@pytest.mark.parametrize("mode", ["vae", "deconv", "large_kernel_deconv"])
def test_converters_round_trip_exactly(mode):
    _, params, tm = _jax_pair(mode)
    back = ssl_params_tree(ssl_state_dict_from_jax(params), TINY["num_heads"])
    want, got = dict(_flat(params["params"])), dict(_flat(back["params"]))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    sd = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    again = ssl_state_dict_from_jax(ssl_params_tree(sd, TINY["num_heads"]))
    assert set(again) == set(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.mark.parametrize("kw,match", [(dict(patch_size=6), "power of two"),
                                      (dict(upsample_mode="pixelshuffle"), "unknown upsample")])
def test_bad_geometry_raises_like_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        SSLViT(**dict(TINY, **kw))
    jm = JaxSSLViT(**dict(TINY, img_size=(12, 12, 12) if "patch_size" in kw else (16,) * 3,
                          **kw))
    with pytest.raises(ValueError, match=match):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *jm.img_size, 2)))


def test_create_ssl_vit_is_seeded():
    a = create_ssl_vit(device="cpu", seed=5, **TINY)
    b = create_ssl_vit(device="cpu", seed=5, **TINY)
    c = create_ssl_vit(device="cpu", seed=6, **TINY)
    assert not a.training and a.compute_dtype == torch.float32
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.vit.patch_embed.weight, c.vit.patch_embed.weight)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #


def _embeddings(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((3, 8), (3, 8), (3, 4, 4, 4, 1), (3, 4, 4, 4, 1), (3, 4, 4, 4, 1))]


def test_nt_xent_value_and_grads_match_jax():
    c1, c2 = _embeddings()[:2]
    want = jssl.nt_xent(jnp.asarray(c1), jnp.asarray(c2), 0.5)
    wg = jax.grad(lambda a, b: jssl.nt_xent(a, b, 0.5), argnums=(0, 1))(
        jnp.asarray(c1), jnp.asarray(c2))
    t1, t2 = (torch.tensor(a, requires_grad=True) for a in (c1, c2))
    got = tssl.nt_xent(t1, t2, 0.5)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6
    for g, w in zip((t1.grad, t2.grad), wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    # identical views score lower than unrelated ones, as in JAX's test
    assert tssl.nt_xent(t1, t1).item() < got.item()


def test_ssl_total_loss_and_grads_match_jax():
    c1, c2, r1, r2, gt = _embeddings(1)

    def jloss(*a):
        return jssl.ssl_total_loss(*a, gt, gt, 0.5, 0.7, 1.3)

    (wt, wparts), wg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (c1, c2, r1, r2)))
    ts = [torch.tensor(a, requires_grad=True) for a in (c1, c2, r1, r2)]
    total, parts = tssl.ssl_total_loss(*ts, torch.from_numpy(gt), torch.from_numpy(gt),
                                       0.5, 0.7, 1.3)
    total.backward()
    assert abs(total.item() - float(wt)) <= 1e-6
    for k in ("contrast", "recon"):
        assert abs(parts[k].item() - float(wparts[k])) <= 1e-6
    for t, w in zip(ts, wg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    # perfect reconstruction: recon 0, total 0 whatever the contrast
    r = torch.from_numpy(r1)
    zero, zparts = tssl.ssl_total_loss(ts[0], ts[0], r, r, r, r)
    assert zero.item() == 0.0 and zparts["recon"].item() == 0.0


# --------------------------------------------------------------------------- #
# augment ops
# --------------------------------------------------------------------------- #

AUGMENTS = {
    "patch_rand_drop": lambda m, x, rng: m.patch_rand_drop(x[0], rng=rng),
    "patch_rand_drop_replace": lambda m, x, rng: m.patch_rand_drop(x[0], x[1], rng=rng),
    "rot_rand": lambda m, x, rng: m.rot_rand(x, rng),
    "aug_rand": lambda m, x, rng: m.aug_rand(x, rng),
    "context_restoration": lambda m, x, rng: m.augment_context_restoration(x[0], rng=rng),
    "two_views": lambda m, x, rng: m.make_two_views(x, rng),
}


@pytest.mark.parametrize("name", sorted(AUGMENTS))
@pytest.mark.parametrize("seed", [0, 7])
def test_augment_ops_equal_jax(name, seed):
    x = np.random.default_rng(seed).standard_normal((3, 2, 14, 12, 12)).astype(np.float32)
    want = AUGMENTS[name](jssl, x.copy(), np.random.RandomState(seed))
    got = AUGMENTS[name](tssl, x.copy(), np.random.RandomState(seed))
    want, got = (w if isinstance(w, tuple) else (w,) for w in (want, got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# --------------------------------------------------------------------------- #
# steps and the trainer
# --------------------------------------------------------------------------- #


def test_two_steps_match_jax(tmp_path):
    jm, params, tm = _jax_pair("vae")
    tm.train()
    gt = _x(11)
    rng = np.random.RandomState(4)
    views = []
    for _ in range(2):
        v1, v2 = jssl.make_two_views(gt.transpose(0, 4, 1, 2, 3), rng)
        views.append(tuple(np.ascontiguousarray(v.transpose(0, 2, 3, 4, 1)) for v in (v1, v2)))

    jt = jssl.SSLTrainer(jm, num_steps=10, batch_size=2, lr=1e-3, warmup_steps=1,
                         logdir=str(tmp_path / "jax"), seed=0)
    jstate_ = replicate(jt.mesh, jstate.TrainState.create(params, jt.tx))
    jstep = jt._make_step()
    state = TrainState.create(
        {n: p for n, p in tm.named_parameters()},
        make_optimizer(lr=warmup_cosine_schedule(1e-3, 1, 10), weight_decay=1e-5,
                       grad_clip_norm=None))
    step = tssl.make_ssl_step(tm)
    for i, (v1, v2) in enumerate(views):
        b = shard_batch(jt.mesh, {"v1": v1, "v2": v2, "gt": gt})
        jstate_, jmet = jstep(jstate_, b["v1"], b["v2"], b["gt"],
                              jax.random.fold_in(jax.random.PRNGKey(0), i))
        state, tmet = step(state, *(torch.from_numpy(a) for a in (v1, v2, gt)))
        for k in ("loss", "contrast", "recon"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5, (i, k)
    want = dict(_flat(jax.device_get(jstate_.params)["params"]))
    got = dict(_flat(ssl_params_tree(state.params, TINY["num_heads"])["params"]))
    assert set(got) == set(want)
    err = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert err.max() <= ADAM_BOUND, err.max()
    assert np.mean(err <= 1e-5) >= 0.99, np.mean(err <= 1e-5)


def test_trainer_checkpoint_applies_in_jax(tmp_path):
    """The port's `SSLTrainer` (fp32, 3 steps, validation every 2) writes
    best and final params that the JAX `SSLViT` applies to the port's
    output."""
    model = create_ssl_vit(device="cpu", seed=0, **TINY)
    logdir = tmp_path / "logs"
    trainer = tssl.SSLTrainer(model, num_steps=3, lr=1e-3, warmup_steps=1, eval_every=2,
                              logdir=str(logdir), seed=0)
    batches = [_x(20 + i) for i in range(4)]
    best = trainer.train(iter(batches), [batches[-1]])
    assert np.isfinite(best) and trainer.state.step == 3 and len(trainer.step_times) == 3
    assert not model.training
    names = sorted(os.path.basename(p) for p in glob.glob(str(logdir / "model" / "*.npz")))
    assert names == [f"best_model_{-best:.4f}_ssl_vit.npz", "final_model_0.0000_ssl_vit.npz"]
    x = _x(30)
    with torch.no_grad():
        te, tr = model(torch.from_numpy(x))
    jparams = jax_load_params_npz(str(logdir / "model" / names[1]))
    je, jr = JaxSSLViT(**TINY).apply(jparams, jnp.asarray(x))
    _close(te, je)
    _close(tr, jr)
