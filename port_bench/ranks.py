"""A cell on more than one card: one process per card, as `torchrun` starts
a data-parallel job on one node.

`launch` keeps a `torch.distributed.TCPStore` on a free local port and
starts `world` processes from a fresh interpreter (`spawn`). Rank r takes
card r: it joins the store, then the program's process group through the
program's own `init_distributed` (NCCL on the card, gloo on the CPU, over
a second free local port), and runs the target. What rank 0's target
returns comes back through the store once every rank has ended with 0.
A rank that exits otherwise, or any rank still running at the deadline,
ends every rank and raises `RankFailed`; a rank that loses its launcher
is killed with it. The store and the process group time out after
`TIMEOUT_S`, so a rank that hangs makes the others fail.

`Ranks` is what a rank's code sees of the others: a barrier, the pace of a
window that rank 0's clock sets for every rank, a gather, the largest gap
of a tensor to rank 0's, and the reports the other ranks send rank 0. A
single process is `Ranks()`: rank 0 of 1, with nothing to share.
"""

from __future__ import annotations

import ctypes
import json
import multiprocessing
import multiprocessing.connection
import os
import signal
import socket
import sys
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 300
HOST = "127.0.0.1"


class RankFailed(RuntimeError):
    """A rank of a multi-card run ended without success or did not end;
    `code` is its exit code (1 for one that did not end)."""

    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.code = code


@dataclass
class Ranks:
    rank: int = 0
    world: int = 1
    store: Optional[dist.Store] = None
    windows: int = 0  # windows paced so far, for the keys of the next

    def barrier(self, name: str) -> None:
        """Wait on the host until every rank has come here."""
        if self.world == 1:
            return
        if self.store.add(f"barrier.{name}", 1) == self.world:
            self.store.set(f"barrier.{name}.open", "1")
        self.store.wait([f"barrier.{name}.open"])

    def pace(self, seconds: Optional[float] = None,
             units: Optional[int] = None) -> Callable[[int], bool]:
        """`go(n)`: whether every rank runs unit n of this window. Rank 0
        decides by its own clock (until `seconds` from now) and count
        (fewer than `units`) before it starts each unit; the others wait
        for its decision, so every rank stops after the same unit."""
        self.windows += 1
        tag = self.windows
        deadline = None if seconds is None else time.perf_counter() + seconds

        def go(n: int) -> bool:
            if self.rank != 0:
                return self.store.get(f"go.{tag}.{n}") == b"1"
            ok = (units is None or n < units) and (deadline is None
                                                    or time.perf_counter() < deadline)
            if self.world > 1:
                self.store.set(f"go.{tag}.{n}", "1" if ok else "0")
            return ok

        return go

    def gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t`, in rank order."""
        if self.world == 1:
            return [t]
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return parts

    def gap_to_rank0(self, t: torch.Tensor) -> float:
        """The largest |t − rank 0's t| over every rank's elements."""
        if self.world == 1:
            return 0.0
        base = t.clone()
        dist.broadcast(base, 0)
        gap = (t - base).abs().max().reshape(1).float()
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap)

    def report(self, what: Dict) -> None:
        """Hand `what` to rank 0 (a rank other than 0)."""
        self.store.set(f"report.{self.rank}", json.dumps(what))

    def reports(self) -> List[Dict]:
        """What the other ranks reported, in rank order (rank 0)."""
        return [json.loads(self.store.get(f"report.{r}")) for r in range(1, self.world)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _die_with_launcher() -> None:
    """SIGKILL this process when the launcher ends (Linux prctl)."""
    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _entry(target, args, rank: int, world: int, device_type: str, store_port: int,
           master_port: int) -> None:
    _die_with_launcher()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR=HOST, MASTER_PORT=str(master_port))
    try:
        from waveformer_tpu_torch.parallel.mesh import init_distributed

        store = dist.TCPStore(HOST, store_port, None, False, timedelta(seconds=TIMEOUT_S))
        device = init_distributed("cpu" if device_type == "cpu" else None,
                                  timeout=timedelta(seconds=TIMEOUT_S))
        result = target(Ranks(rank, world, store), device, *args)
        if rank == 0:
            store.set("result", json.dumps(result))
        dist.destroy_process_group()
    except SystemExit as e:
        sys.stderr.flush()
        os._exit(e.code if isinstance(e.code, int) else 1)
    except BaseException:  # noqa: BLE001 (any failure ends this rank with 1, at once)
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def launch(world: int, device_type: str, target, args: Sequence = (),
           deadline_s: float = 900.0) -> Dict:
    """Run `target(ranks, device, *args)` on `world` ranks; rank 0's return
    value (JSON). `target` is a module-level function (it is pickled)."""
    store = dist.TCPStore(HOST, 0, None, True, timedelta(seconds=TIMEOUT_S),
                          wait_for_workers=False)
    master_port = _free_port()
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_entry, args=(target, tuple(args), r, world, device_type,
                                              store.port, master_port))
             for r in range(world)]
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            for r, code in enumerate(codes):
                if code not in (None, 0):
                    raise RankFailed(f"rank {r} exited with {code}", code)
            if all(c == 0 for c in codes):
                return json.loads(store.get("result"))
            if time.monotonic() > end:
                raise RankFailed(f"ranks still running after {deadline_s:.0f} s")
            multiprocessing.connection.wait([p.sentinel for p in procs if p.exitcode is None],
                                            timeout=1.0)
    finally:
        for p in procs:
            if p.exitcode is None and p.pid is not None:
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
