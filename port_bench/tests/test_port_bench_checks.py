"""The check that decides `correct`, shown to fail: at a tiny size on the
CPU, the float8 control reads above the limits, and a run with the timed
path broken underneath comes out not correct, once for each fault a cell
can have (one card: no exchange between chips to leave out)."""

from __future__ import annotations

import pytest
import torch

from port_bench import run
from port_bench.registry import Registry
from port_bench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return tiny.make_root(str(tmp_path))


def _workload(root, cell, seed, **kw):
    reg = Registry(root)
    entry = reg.cell(cell)
    config = reg.config(entry["config"])
    ctx = run.Context(CPU, seed, config, reg.traffic(entry["traffic"]), reg.arch(config))
    ctx.state_dict = ctx.arch.make_state_dict(config["network"], seed, CPU)
    return reg.kind(ctx.traffic["kind"]).Workload(ctx, **kw)


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-case", "tiny-train"])
def test_sound_runs_are_correct(root, cell):
    assert run.run_cell(cell, 3, 0.5, False, CPU, root=root)["correct"] is True


@pytest.mark.parametrize("cell,seed", [("tiny-stream", 1), ("tiny-case", 2), ("tiny-train", 1),
                                       ("tiny-train", 3)])
def test_the_float8_control_fails(root, cell, seed):
    w = _workload(root, cell, seed)
    w.window(seconds=0.3)
    w.release()
    assert _fails(w.control(), tiny.LIMITS[cell])


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-case"])
def test_an_answer_altered_where_it_is_produced(root, cell, monkeypatch):
    from waveformer_tpu_torch.inference import predictor

    finish = predictor.Predictor._finish_case

    def altered(self, seg_dev, properties):
        seg = finish(self, seg_dev, properties)
        seg[: seg.shape[0] // 4] = (seg[: seg.shape[0] // 4] + 1) % 3
        return seg

    monkeypatch.setattr(predictor.Predictor, "_finish_case", altered)
    assert run.run_cell(cell, 3, 0.5, False, CPU, root=root)["correct"] is False


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-case"])
def test_half_of_the_batch_left_out(root, cell, monkeypatch):
    from waveformer_tpu_torch.models import waveformer

    forward = waveformer.Waveformer.forward

    def half(self, x, generator=None):
        out = forward(self, x[: max(x.shape[0] // 2, 1)], generator)
        return torch.cat([out, torch.zeros_like(out)])[: x.shape[0]]

    monkeypatch.setattr(waveformer.Waveformer, "forward", half)
    assert run.run_cell(cell, 3, 0.5, False, CPU, root=root)["correct"] is False


def test_a_step_that_returns_its_state_unchanged(root, monkeypatch):
    from waveformer_tpu_torch.training import state

    monkeypatch.setattr(state.AdamWState, "update", lambda self, *a, **k: None)
    line = run.run_cell("tiny-train", 3, 0.5, False, CPU, root=root)
    assert line["correct"] is False
    assert line["checked"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_step_that_leaves_its_state_unchanged_after_the_first_steps(root, monkeypatch):
    from port_bench.kinds import train
    from waveformer_tpu_torch.training import state

    update = state.AdamWState.update

    def warm_skip(self, *a, **k):
        if self.count < train.CHECK_STEPS:
            update(self, *a, **k)

    monkeypatch.setattr(state.AdamWState, "update", warm_skip)
    line = run.run_cell("tiny-train", 3, 0.5, False, CPU, root=root)
    assert line["correct"] is False
    assert line["checked"]["change_gap"]["value"] <= tiny.LIMITS["tiny-train"]["change_gap"]
    assert line["checked"]["last_change_gap"]["value"] == pytest.approx(1.0)


def test_the_loss_of_half_of_the_batch(root, monkeypatch):
    from port_bench.kinds import train
    from waveformer_tpu_torch.training import losses

    monkeypatch.setattr(losses, "dice_ce_loss", train.half_batch_loss(losses.dice_ce_loss))
    assert run.run_cell("tiny-train", 3, 0.5, False, CPU, root=root)["correct"] is False
