"""Rank targets for the two-rank CPU tests (`ranks.launch` pickles them by
name): a sound rank, ranks with a fault planted before they run, and the
float8 control's reading."""

from __future__ import annotations

import os
import signal

import torch

from port_bench import run


def sound(ranks, device, *args):
    torch.set_num_threads(2)
    return run._rank(ranks, device, *args)


def ignore_reducer(ranks, device, *args):
    """Rank 1 takes part in the all-reduce and steps on its own gradients."""
    if ranks.rank == 1:
        from waveformer_tpu_torch.training import state

        call = state.GradientReducer.__call__

        def local(self, grads, loss, masters=None):
            call(self, [g.clone() for g in grads], loss.clone(), masters)
            return grads, loss

        state.GradientReducer.__call__ = local
    return sound(ranks, device, *args)


def no_exchange(ranks, device, *args):
    """No rank reduces its gradients: each steps on its own shard."""
    from waveformer_tpu_torch.training import state

    state.make_reducer = lambda mesh, replicated=False: None
    return sound(ranks, device, *args)


def other_batches(ranks, device, *args):
    """Rank 1 is fed rank 0's ring (its batches made from rank 0's
    stream); the check makes rank 1's own again."""
    if ranks.rank == 1:
        from port_bench import seeds

        derive, fed = seeds.derive, []

        def wrong_once(seed, stream):
            if stream == "batches.1" and not fed:
                fed.append(stream)
                return derive(seed, "batches.0")
            return derive(seed, stream)

        seeds.derive = wrong_once
    return sound(ranks, device, *args)


def half_batch(ranks, device, *args):
    """Every rank's loss takes the first half of its batch only."""
    from port_bench.kinds import train
    from waveformer_tpu_torch.training import losses

    losses.dice_ce_loss = train.half_batch_loss(losses.dice_ce_loss)
    return sound(ranks, device, *args)


def killed(ranks, device, *args):
    """Rank 1 is killed during set-up."""
    if ranks.rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    return sound(ranks, device, *args)


def control(ranks, device, cell, seed, root):
    """The check's numbers for the reference in float8 in the system's
    place, on every rank (the readings' `control`)."""
    from port_bench import readings
    from port_bench.registry import Registry

    torch.set_num_threads(2)
    return readings.reading(Registry(root), cell, seed, 0.3, "control", device, ranks)
