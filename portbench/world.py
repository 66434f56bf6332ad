"""The benchmark's side of a cell on more than one card.

:func:`launch`: a run's first process starts its command again as one rank
a card through ``torch.distributed.run`` (torchrun), the launcher that
users of the program's data-parallel fine-tune run. It gives each rank the
environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) that the program's ``parallel.init_distributed`` reads,
ends the other ranks when one fails, waits for every rank, and exits with
a code other than 0 unless all of them exited with 0. Rank 0 alone prints
a result.

Once the program has joined the world, the ranks agree on numbers and hand
rank 0 what it reports through a gloo group of the benchmark's own, so that
none of it runs on the cards; :func:`apart` alone is a collective of the
world's own backend. Without a world each is this one process's.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
from typing import List, Optional

import torch
import torch.distributed as dist

# the launcher's start, handed to the ranks
START_ENV = "PORTBENCH_T_START"
_group = None


def _in_world() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _in_world() else 0


def size() -> int:
    return dist.get_world_size() if _in_world() else 1


def _harness_group():
    global _group
    if _group is None:
        _group = dist.new_group(backend="gloo")
    return _group


def gather(obj) -> Optional[list]:
    """Every rank's `obj`, in rank order, on rank 0 (None on the others)."""
    if not _in_world():
        return [obj]
    out = [None] * size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0, group=_harness_group())
    return out


def agree(value: float) -> float:
    """The largest of the ranks' `value`s, on every rank."""
    if not _in_world():
        return value
    out = [None] * size()
    dist.all_gather_object(out, value, group=_harness_group())
    return max(out)


@torch.no_grad()
def apart(tensors: List[torch.Tensor]) -> float:
    """The largest difference between the ranks' copies of any element of
    `tensors` (nan where one is not finite); 0.0 without a world."""
    if not _in_world():
        return 0.0
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    bad = (~torch.isfinite(flat)).any().float().reshape(1)
    hi, lo = flat.clone(), flat
    dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return math.nan if bool(bad) else float((hi - lo).max())


def leave() -> None:
    """Leave the world (the program's group and the harness's)."""
    global _group
    if _in_world():
        dist.destroy_process_group()
    _group = None


def launched() -> bool:
    """Whether this process is a rank that :func:`launch` started."""
    return "LOCAL_RANK" in os.environ


def start_time(default: float) -> float:
    """The ``time.perf_counter()`` at which the run began: the launcher's
    start in a rank it started (the clock is the system's monotonic one,
    the same in every process), else `default`."""
    return float(os.environ.get(START_ENV, default))


def launch(n: int, module: str, args: List[str], t_start: float) -> int:
    """Run ``python -m <module> <args>`` as `n` ranks under
    ``torch.distributed.run`` and return its exit code. A rank other than 0
    sends its standard output to standard error (:func:`quiet`), so that
    rank 0's result is the run's last line; `t_start` reaches the ranks
    (:func:`start_time`)."""
    env = dict(os.environ, **{START_ENV: repr(t_start)})
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", module, *args]
    return subprocess.run(cmd, env=env).returncode


def quiet() -> None:
    """On a rank other than 0, send standard output to standard error."""
    if int(os.environ.get("RANK", 0)) != 0:
        sys.stdout.flush()
        os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
