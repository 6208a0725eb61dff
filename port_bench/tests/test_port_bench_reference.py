"""The benchmark's plain reference against the system's plain (CPU) path at
a tiny size, and the reference's imports.

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from port_bench.archs import waveformer as arch
from port_bench.reference import model as ref_model
from port_bench.reference import serve as ref_serve
from port_bench.reference import train as ref_train
from port_bench.tests import tiny

BANNED = {"waveformer_tpu_torch", "waveformer_tpu", "jax", "jaxlib", "flax", "optax"}
REFERENCE = os.path.join(tiny.ROOT, "port_bench", "reference")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _state_dict(seed=5):
    return arch.make_state_dict(tiny.NETWORK, seed, "cpu")


def _port(sd, dtype=torch.float32, **kw):
    from waveformer_tpu_torch.models import create_waveformer

    model = create_waveformer(tiny.NETWORK, dtype=dtype, device="cpu", **kw)
    model.load_state_dict(sd)
    return model


def test_reference_imports_nothing_of_the_system_or_jax():
    for fname in sorted(os.listdir(REFERENCE)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(REFERENCE, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED, f"{fname} imports {name}"


def test_state_dict_keys_are_the_systems():
    sd = _state_dict()
    assert set(sd) == set(_port(sd).state_dict())


def test_forward_matches_the_systems_plain_path():
    sd = _state_dict()
    ref = ref_model.build(tiny.NETWORK, "cpu")
    ref.load_state_dict(sd)
    ref.eval()
    x = torch.randn(2, 32, 32, 32, 2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = ref(x), _port(sd)(x)
    assert (a - b).abs().max() <= 1e-5 * a.abs().max()


def test_sliding_window_with_tta_matches_the_systems_inferer():
    from waveformer_tpu_torch.inference import SlidingWindowInferer

    sd = _state_dict()
    port = _port(sd, io_layout="channels_first")
    ref = ref_model.build(tiny.NETWORK, "cpu")
    ref.load_state_dict(sd)
    ref.eval()
    vol = torch.randn(2, 40, 36, 33, generator=torch.Generator().manual_seed(1))
    inferer = SlidingWindowInferer((32, 32, 32), sw_batch_size=3, overlap=0.5,
                                   mirror_axes=(0, 1), layout="channels_first", tta_mode="patch")
    with torch.no_grad():
        got = inferer(vol, port, 3)
        want = ref_serve.predict_logits(ref, vol, 3, (32, 32, 32), 0.5, 2, (0, 1))
    assert got.shape == want.shape == (3, 40, 36, 33)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert ref_serve.widest_gap(want, want.argmax(0)) == 0.0


def test_training_steps_match_the_systems_step():
    from waveformer_tpu_torch.training.losses import dice_ce_loss
    from waveformer_tpu_torch.training.state import (
        TrainState, make_optimizer, make_train_step, master_params)

    sd = _state_dict()
    g = torch.Generator().manual_seed(2)
    batches = [{"data": torch.randn(2, 32, 32, 32, 2, generator=g),
                "seg": torch.randint(0, 3, (2, 32, 32, 32, 1), generator=g)} for _ in range(2)]
    port = _port(sd).train()
    state = TrainState.create(master_params(port, torch.float32), make_optimizer(1e-3, 1e-2, 1.0))
    step = make_train_step(port, dice_ce_loss)
    gen = torch.Generator()
    losses = []
    for t, batch in enumerate(batches):
        gen.manual_seed(ref_train.step_seed(9, t))
        losses.append(float(step(state, batch, gen)[1]["loss"]))
        if t == 0:
            first = {n: m / 0.1 for n, m in zip(state.params, state.opt_state.mu)}

    ref = ref_model.build(tiny.NETWORK, "cpu")
    ref.load_state_dict(sd)
    opt = ref_train.AdamW(list(ref.parameters()), 1e-3, 1e-2, 1.0)
    out = ref_train.run_steps(ref, batches, 9, opt, arch)
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
    # the reference's backward runs one sample at a time: fp32 sums in
    # another order, 1e-3 apart at a near-constant InstanceNorm input
    for n, g in out["first_grads"].items():
        assert (first[n] - g).norm() <= 5e-3 * g.norm() + 1e-9, n


def test_clip_and_adamw_match_the_systems_update():
    from waveformer_tpu_torch.training.state import TrainState, make_optimizer

    g = torch.Generator().manual_seed(4)
    params = [torch.randn(7, 5, generator=g), torch.randn(11, generator=g)]
    grads = [[torch.randn(7, 5, generator=g) * s, torch.randn(11, generator=g) * s]
             for s in (3.0, 0.01, 1.0)]  # clipped, not clipped, clipped
    state = TrainState.create({"a": params[0].clone(), "b": params[1].clone()},
                              make_optimizer(1e-3, 1e-2, 4.0))
    ref = [p.clone() for p in params]
    opt = ref_train.AdamW(ref, 1e-3, 1e-2, 4.0)
    for gs in grads:
        state.apply_gradients([x.clone() for x in gs])
        opt.step(ref, [x.clone() for x in gs])
    for got, want in zip(state.params.values(), ref):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
