"""A cell on more than one card, at a tiny size on the CPU: the tiny
training step on two ranks over gloo (`ranks.launch`, each rank its own
process), sound and with a fault planted in one or every rank. Sound runs
are correct with replicas equal (`rank_gap` 0); each fault fails the check,
and a killed rank fails the run at once."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import ranks, run
from port_bench.tests import ddp_faults, tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.add_ddp(tiny.make_root(str(tmp_path_factory.mktemp("ddp"))))


def _launch(root, target, seed=7, trace=False):
    return ranks.launch(2, "cpu", target, (tiny.DDP_CELL, seed, 0.5, trace, root,
                                           time.perf_counter()), deadline_s=600)


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_are_correct_with_equal_replicas(root, trace):
    line = _launch(root, ddp_faults.sound, seed=11, trace=trace)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checked"]["rank_gap"] == {"value": 0.0, "limit": 0.0}
    assert line["device"]["count"] == 2
    # every rank ran the same steps, and the step's samples are both ranks'
    assert line["attempted"] % 2 == 0
    if not trace:
        assert "train_samples_per_s" in line["metrics"]


@pytest.mark.parametrize("fault", ["ignore_reducer", "no_exchange", "other_batches",
                                   "half_batch"])
def test_a_fault_fails_the_check(root, fault):
    line = _launch(root, getattr(ddp_faults, fault))
    assert line["correct"] is False
    if fault in ("ignore_reducer", "no_exchange"):
        assert line["checked"]["rank_gap"]["value"] > 0.0


def test_the_float8_control_fails_on_two_ranks(root):
    numbers = ranks.launch(2, "cpu", ddp_faults.control, (tiny.DDP_CELL, 5, root),
                           deadline_s=600)
    limits = tiny.LIMITS["tiny-train"]
    assert any(numbers[k] > v for k, v in limits.items())


def test_a_killed_rank_fails_the_run_at_once(root):
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailed) as failed:
        _launch(root, ddp_faults.killed)
    assert failed.value.code != 0 and time.monotonic() - t0 < 120


def test_one_process_has_nothing_to_share():
    one = ranks.Ranks()
    one.barrier("x")
    go = one.pace(units=2)
    assert [go(n) for n in range(3)] == [True, True, False]
    t = torch.arange(3.0)
    assert one.gather(t)[0] is t and one.gap_to_rank0(t) == 0.0


def test_fewer_cards_than_the_cell_asks_for_exit_2(root, monkeypatch, capsys):
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", tiny.DDP_CELL, "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


@pytest.mark.parametrize("code,rc", [(-9, 1), (1, 1), (3, 3)])
def test_a_failed_rank_exits_without_a_result(root, monkeypatch, capsys, code, rc):
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def failed(*a, **k):
        raise ranks.RankFailed("rank 1 exited", code)

    monkeypatch.setattr(run, "run_chips", failed)
    rc_got = run.main(["--workload", tiny.DDP_CELL, "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc_got == rc and captured.out == "" and "rank 1" in captured.err
