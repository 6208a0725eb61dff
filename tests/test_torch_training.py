"""The port's losses, schedules, optimizer, train step and `Plans` against
the JAX package's, on the CPU in fp32 (TF32 does not apply on the CPU).

Same seeded numpy inputs on both sides. Tolerances: the losses agree to
1e-6 (fp32 reductions in other orders); the schedules to 1e-7 (optax
evaluates them in fp32, the port in float64); clip + AdamW over 3 steps to
1e-6 relative at the reference's learning rate (equal formulas in fp32;
XLA's `pow` rounds the bias correction 1 - 0.999**t differently from
numpy's, by up to 2e-5 relative at t = 3; the first moment's tolerance is
relative to the magnitudes it sums); one train step of the small WaveFormer to 1e-5 in the loss and 1e-4
relative in the gradient norm; the parameters after 2 steps: see
`ADAM_BOUND`. The bf16 step's tolerances are stated at its test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from waveformer_tpu.config import Config as JaxConfig
from waveformer_tpu.data import planning as jplanning
from waveformer_tpu.models import Waveformer as JaxWaveformer
from waveformer_tpu.training import losses as jl
from waveformer_tpu.training import schedules as js
from waveformer_tpu.training import state as jstate
from waveformer_tpu_torch.config import Config
from waveformer_tpu_torch.data import planning as tplanning
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.training import losses as tl
from waveformer_tpu_torch.training import schedules as ts
from waveformer_tpu_torch.training import state as tstate
from waveformer_tpu_torch.training.checkpoint import params_tree
from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax

SMALL = dict(img_size=(32, 32, 32), patch_size=2, in_chans=2, out_chans=3,
             embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8),
             decom_levels=(3, 2, 1, 0), drop_path_rate=0.0)

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the tier-1 run puts six pytest
    workers on the cores, and torch's thread pools then contend (these small
    CPU steps ran 10-50× slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logits_labels(seed=0, shape=(2, 6, 5, 4), k=4, ignore=False):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((*shape, k))).astype(np.float32)
    labels = rng.integers(0, k, (*shape, 1)).astype(np.int32)
    if ignore:
        labels[0, 0] = -1  # outside every class: a zero one-hot row on both sides
    return logits, labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #

CLASS_WEIGHTS = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
LOSS_CASES = {
    "ce": (lambda m, x, y: m.softmax_cross_entropy(x, y), {}),
    # class weights normalised to sum 1, as class-frequency weights are
    "ce_weighted": (lambda m, x, y: m.softmax_cross_entropy(
        x, y, weight=(jnp.asarray if m is jl else _t)(CLASS_WEIGHTS)), {}),
    "dice": (lambda m, x, y: m.soft_dice_loss(x, y), {}),
    "dice_no_bg_squared": (lambda m, x, y: m.soft_dice_loss(
        x, y, include_background=False, squared_pred=True, smooth_nr=0.0, smooth_dr=1e-3), {}),
    "dice_batch": (lambda m, x, y: m.soft_dice_loss(x, y, batch_dice=True), {}),
    "dice_no_softmax": (lambda m, x, y: m.soft_dice_loss(x, y, apply_softmax=False), {}),
    "dice_ce": (lambda m, x, y: m.dice_ce_loss(x, y, lambda_dice=0.7, lambda_ce=1.3), {}),
    "dice_ce_batch_no_bg": (lambda m, x, y: m.dice_ce_loss(
        x, y, include_background=False, batch_dice=True), {}),
    "DiceCELoss": (lambda m, x, y: m.DiceCELoss(lambda_dice=0.5, batch_dice=True)(x, y), {}),
    "ce_ignored_label": (lambda m, x, y: m.softmax_cross_entropy(x, y), {"ignore": True}),
    "dice_ignored_label": (lambda m, x, y: m.soft_dice_loss(x, y), {"ignore": True}),
    "topk": (lambda m, x, y: m.topk_cross_entropy(x, y, k_percent=10.0), {}),
    "topk_tiny": (lambda m, x, y: m.topk_cross_entropy(x, y, k_percent=0.1), {}),
    "dice_topk": (lambda m, x, y: m.dice_topk_loss(x, y, k_percent=25.0, batch_dice=True), {}),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    fn, kw = LOSS_CASES[name]
    x, y = _logits_labels(**kw)
    want = fn(jl, jnp.asarray(x), jnp.asarray(y))
    got = fn(tl, _t(x), _t(y))
    _close(got, want)


@pytest.mark.parametrize("ignore,batch_dice", [(False, True), (True, True), (True, False),
                                               (False, False)])
def test_dice_bce_matches_jax(ignore, batch_dice):
    rng = np.random.default_rng(3)
    x = (2.0 * rng.standard_normal((2, 5, 6, 4, 3))).astype(np.float32)
    t = (rng.uniform(size=(2, 5, 6, 4, 4 if ignore else 3)) > 0.6).astype(np.float32)
    kw = dict(weight_ce=0.8, weight_dice=1.2, use_ignore_label=ignore, batch_dice=batch_dice)
    _close(tl.dice_bce_loss(_t(x), _t(t), **kw),
           jl.dice_bce_loss(jnp.asarray(x), jnp.asarray(t), **kw))


def test_bf16_logits_reduce_in_fp32():
    x, y = _logits_labels()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _close(tl.dice_ce_loss(_t(x).to(torch.bfloat16), _t(y)), jl.dice_ce_loss(xb, jnp.asarray(y)))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_deep_supervision_weights_match_jax(n):
    _close(tl.deep_supervision_weights(n), jl.deep_supervision_weights(n), atol=1e-7)


def test_deep_supervision_loss_matches_jax():
    outs, labs = [], []
    for i, shape in enumerate([(2, 8, 8, 8), (2, 4, 4, 4), (2, 2, 2, 2)]):
        x, y = _logits_labels(seed=10 + i, shape=shape)
        outs.append(x)
        labs.append(y)
    want = jl.deep_supervision_loss(jl.dice_ce_loss, [jnp.asarray(o) for o in outs],
                                    [jnp.asarray(l) for l in labs])
    got = tl.deep_supervision_loss(tl.dice_ce_loss, [_t(o) for o in outs], [_t(l) for l in labs])
    _close(got, want)


def test_loss_gradients_match_jax():
    x, y = _logits_labels()
    g_jax = jax.grad(lambda z: jl.dice_ce_loss(z, jnp.asarray(y)))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    tl.dice_ce_loss(xt, _t(y)).backward()
    _close(xt.grad, g_jax, atol=1e-7)


# --------------------------------------------------------------------------- #
# schedules
# --------------------------------------------------------------------------- #

SCHEDULES = [(None, 0), ("constant", 0), ("poly", 0), ("poly_decay", 0),
             ("warmup_cosine", 10), ("cosine_with_warmup", 0), ("poly_with_warmup", 10),
             ("poly_with_warmup", 0), ("constant_with_warmup", 10),
             ("constant_with_warmup", 0)]


@pytest.mark.parametrize("name,warmup", SCHEDULES)
def test_schedule_matches_optax(name, warmup):
    total = 100
    want = js.make_schedule(name, 3e-4, total, warmup)
    got = ts.make_schedule(name, 3e-4, total, warmup)
    for step in (0, 1, warmup, warmup + 1, total // 2, total - 1, total, total + 5):
        assert abs(got(step) - float(want(step))) <= 1e-7, (name, step)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        ts.make_schedule("cyclic", 1e-4, 10)


# --------------------------------------------------------------------------- #
# clip + AdamW against optax.chain
# --------------------------------------------------------------------------- #

# the gradients' global norms step by step: above, below, above the clip at 12
GRAD_NORMS = (30.0, 5.0, 15.0)


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
def test_clip_adamw_matches_optax(schedule):
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for norm in GRAD_NORMS:
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        total = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
        grads.append({k: (v * (norm / total)).astype(np.float32) for k, v in g.items()})

    # the reference's learning rate (`3_train.py:70`)
    lr_j = js.make_schedule(schedule, 1e-4, 10, 2)
    tx = jstate.make_optimizer(lr=lr_j)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jp)
    tstate_ = tstate.TrainState.create({k: _t(v.copy()) for k, v in params.items()},
                                       tstate.make_optimizer(lr=ts.make_schedule(schedule, 1e-4, 10, 2)))
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, jp)
        jp = optax.apply_updates(jp, upd)
        norm = tstate_.apply_gradients([_t(g[k].copy()) for k in tstate_.params])
        np.testing.assert_allclose(float(norm), np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                                                            for v in g.values())), rtol=1e-6)
    adam = opt[1][0]
    mu, nu = tstate_.moments()
    assert tstate_.step == 3
    # the first moment sums signed terms; "relative" is to the sum of their
    # magnitudes, Σ (1 - b1)·b1^(T-t)·|clipped g_t| (a moment that cancels to
    # near zero keeps its terms' rounding)
    mu_scale = {k: sum(0.1 * 0.9 ** (len(grads) - 1 - t) * np.abs(g[k]) * min(1.0, 12.0 / n)
                       for t, (g, n) in enumerate(zip(grads, GRAD_NORMS))) for k in shapes}
    for k in shapes:
        np.testing.assert_allclose(tstate_.params[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)
        assert np.all(np.abs(mu[k].numpy() - np.asarray(adam.mu[k])) <= 1e-6 * mu_scale[k]), k
        np.testing.assert_allclose(nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("norm", [5.0, 30.0])
def test_clip_by_global_norm_is_optax_form(norm):
    rng = np.random.default_rng(1)
    g = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3)]
    s = norm / np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g))
    g = [(x * s).astype(np.float32) for x in g]
    want, _ = optax.clip_by_global_norm(12.0).update([jnp.asarray(x) for x in g], None)
    got = [_t(x.copy()) for x in g]
    tstate.clip_by_global_norm(got, 12.0, tstate.global_norm(got))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    if norm < 12:  # below the clip: untouched, bit for bit
        assert all(np.array_equal(a.numpy(), x) for a, x in zip(got, g))


# --------------------------------------------------------------------------- #
# one train step of the small WaveFormer against make_train_step
# --------------------------------------------------------------------------- #


def _jax_params(model, x, seed=0):
    """Seeded numpy parameters in the shapes `model.init` would make."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
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


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((2, 32, 32, 32, 2)).astype(np.float32)
    seg = rng.integers(0, 3, (2, 32, 32, 32, 1)).astype(np.int32)
    return data, seg


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def _run_pair(dtype_j, dtype_t, steps):
    data, seg = _batch()
    jm = JaxWaveformer(**SMALL, dtype=dtype_j)
    params = _jax_params(jm, jnp.asarray(data))
    jax_state = jstate.TrainState.create(params, jstate.make_optimizer(lr=1e-4))
    jstep = jstate.make_train_step(jm.apply, jl.dice_ce_loss, donate=False)
    rng = jax.random.PRNGKey(0)

    model = create_waveformer(SMALL, dtype=dtype_t, device="cpu").train()
    sd = state_dict_from_jax(params, SMALL["depths"])
    model.load_state_dict(sd, strict=True)
    masters = {n: p if p.dtype == torch.float32 else sd[n].clone()
               for n, p in model.named_parameters()}
    state = tstate.TrainState.create(masters, tstate.make_optimizer(lr=1e-4))
    tstep = tstate.make_train_step(model, tl.dice_ce_loss)
    batch = {"data": _t(data), "seg": _t(seg)}
    out = []
    for _ in range(steps):
        jax_state, jmet = jstep(jax_state, {"data": jnp.asarray(data), "seg": jnp.asarray(seg)}, rng)
        state, tmet = tstep(state, batch)
        out.append((float(jmet["loss"]), float(tmet["loss"]),
                    float(jmet["grad_norm"]), float(tmet["grad_norm"])))
    want = dict(_flat(jax.device_get(jax_state.params)["params"]))
    got = dict(_flat(params_tree(state.params, SMALL["depths"])["params"]))
    assert set(got) == set(want)
    return out, got, want, model, state


# AdamW divides each gradient by its own running RMS, so a parameter whose
# gradient is small against the two sides' rounding difference (gradients
# agree to about 1e-4 relative: the logits to 2e-5) moves by ±lr on either
# side. Two steps move a parameter by at most lr·(1 + 1.42) plus the decay,
# so the sides can differ by at most ADAM_BOUND anywhere; elsewhere they
# agree to 1e-5, on at least 99% of the small model's parameters in fp32.
ADAM_BOUND = 5e-4


def _param_errors(got, want):
    return np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])


def test_train_step_matches_jax_fp32():
    out, got, want, model, state = _run_pair(jnp.float32, torch.float32, steps=2)
    for lj, lt, nj, nt in out:
        assert abs(lt - lj) <= 1e-5, (lt, lj)
        assert abs(nt - nj) <= 1e-4 * nj, (nt, nj)
    assert state.step == 2
    err = _param_errors(got, want)
    assert err.max() <= ADAM_BOUND, err.max()
    assert np.mean(err <= 1e-5) >= 0.99, np.mean(err <= 1e-5)
    # an fp32 module is its own master: updated in place, no copy
    assert all(state.params[n] is p for n, p in model.named_parameters())


# bf16: the loss (a mean over 65,536 voxels) within 1e-3 relative. JAX's
# bf16 gradients are the less accurate side: it reduces the bias gradients in
# bf16 (its output-conv bias gradient is far from the fp32 one), so its
# global norm falls several percent below the fp32 norm while the port's
# stays within 1e-2 of it; the two bf16 norms are held within 15% of each
# other. The parameters: the AdamW bound everywhere, and 90% within 1e-4.
BF16_TOL = {"loss_rel": 1e-3, "grad_norm_fp32_rel": 1e-2, "grad_norm_jax_rel": 0.15}


def test_train_step_matches_jax_bf16():
    out, got, want, model, state = _run_pair(jnp.bfloat16, torch.bfloat16, steps=2)
    data, seg = _batch()
    ref = create_waveformer(SMALL, device="cpu")
    ref.load_state_dict(state_dict_from_jax(
        _jax_params(JaxWaveformer(**SMALL), jnp.asarray(data)), SMALL["depths"]))
    tl.dice_ce_loss(ref.train()(_t(data)), _t(seg)).backward()
    norm32 = float(tstate.global_norm([p.grad for p in ref.parameters()]))
    lj, lt, nj, nt = out[0]
    assert abs(nt - norm32) <= BF16_TOL["grad_norm_fp32_rel"] * norm32, (nt, norm32)
    for lj, lt, nj, nt in out:
        assert abs(lt - lj) <= BF16_TOL["loss_rel"] * abs(lj), (lt, lj)
        assert abs(nt - nj) <= BF16_TOL["grad_norm_jax_rel"] * nj, (nt, nj)
    err = _param_errors(got, want)
    assert err.max() <= ADAM_BOUND, err.max()
    assert np.mean(err <= 1e-4) >= 0.9, np.mean(err <= 1e-4)
    # the masters are fp32 and the module holds their bf16 rounding
    for n, p in model.named_parameters():
        m = state.params[n]
        assert m.dtype == torch.float32
        if p.dtype == torch.bfloat16:
            assert torch.equal(p, m.to(torch.bfloat16))


def test_eval_step_is_the_forward():
    model = create_waveformer(SMALL, device="cpu", seed=0)
    x = _t(_batch()[0])
    got = tstate.make_eval_step(model)(x)
    assert not got.requires_grad
    with torch.no_grad():
        assert torch.equal(got, model(x))


def test_drop_path_generator_draws_reproducible_masks():
    cfg = dict(SMALL, drop_path_rate=0.5)
    model = create_waveformer(cfg, device="cpu", seed=0).train()
    x = _t(_batch()[0])
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(3))
        b = model(x, generator=torch.Generator().manual_seed(3))
        c = model(x, generator=torch.Generator().manual_seed(4))
        model.eval()
        d = model(x, generator=torch.Generator().manual_seed(3))
        e = model(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, e)  # eval mode draws nothing


def test_checkpointed_blocks_redraw_the_forward_masks():
    """With activation checkpointing the backward recomputes each block: the
    generator's state is restored first, so the gradients equal those of the
    uncheckpointed model on the same masks."""
    cfg = dict(SMALL, drop_path_rate=0.5)
    grads = []
    for ckpt in (False, True):
        model = create_waveformer(dict(cfg, use_checkpoint=ckpt), device="cpu", seed=0).train()
        y = model(_t(_batch()[0]), generator=torch.Generator().manual_seed(5))
        y.float().square().mean().backward()
        grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]))
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------- #
# plans
# --------------------------------------------------------------------------- #


def test_plans_match_jax(tmp_path):
    spacings = [(1.0, 1.0, 1.0), (1.2, 0.9, 0.9), (3.0, 0.8, 0.8)]
    sizes = [(155, 240, 240), (140, 256, 256), (60, 300, 300)]
    plan_j = jplanning.plan_experiment(spacings, sizes)
    plan_t = tplanning.plan_experiment(spacings, sizes)
    assert plan_t == plan_j
    tplanning.Plans.from_plan(plan_t, normalization="zscore",
                              foreground_classes=[1, 2]).save(str(tmp_path / "plans.json"))
    pj = jplanning.Plans.find(str(tmp_path))
    pt = tplanning.Plans.find(str(tmp_path))
    assert pt.raw == pj.raw
    for attr in ("patch_size", "target_spacing", "normalization", "foreground_classes",
                 "intensity_properties", "pool_op_kernel_sizes", "conv_kernel_sizes"):
        assert getattr(pt, attr) == getattr(pj, attr), attr
    assert pt.network_patch_size() == pj.network_patch_size()
    assert pt.preprocessor_kwargs() == pj.preprocessor_kwargs()
    cj, ct = pj.apply_to_config(JaxConfig()), pt.apply_to_config(Config())
    assert ct.roi_size == cj.roi_size
    assert tuple(ct.network.img_size) == tuple(cj.network.img_size)
    assert tuple(ct.prediction.patch_size) == tuple(cj.prediction.patch_size)
    assert tplanning.Plans.find(str(tmp_path / "nowhere")) is None
    with open(tmp_path / "plans.json") as f:
        assert json.load(f) == pt.raw
