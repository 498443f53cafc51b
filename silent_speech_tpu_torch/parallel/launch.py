"""Local ranks of a mesh: ``spawn`` starts n processes on this host and
``torchrun`` environments are read by ``mesh.make_mesh``.

``spawn(fn, n, args, device=...)`` runs ``fn(*args)`` in n new processes
(``torch.multiprocessing``'s spawn context), each a rank of a default
process group initialized from a file store in a temporary directory, so
that two launches on one host (two test workers) never race for a TCP
port. On CUDA rank r takes card r and the backend is NCCL; asking for
more ranks than cards raises before anything starts. On the CPU the
backend is gloo. ``fn`` must be a module-level function; each rank's
return value comes back through ``torch.save``, in rank order. A rank that
raises makes ``spawn`` stop the others and raise with its traceback.

The CLIs run under ``torchrun --nproc_per_node=N``; ``make_mesh`` reads
its ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import backend_for


def check_ranks(n: int, device: torch.device) -> None:
    """Raise unless ``n`` ranks fit on ``device``'s kind: one card each on
    CUDA (never a virtual mesh in its place)."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if device.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise RuntimeError(f"{n} CUDA ranks need {n} cards; this host "
                               f"has {have}")


def _rank_main(rank: int, n: int, tmp: str, fn: Callable, args: Sequence,
               device: str, threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    try:
        dist.init_process_group(
            backend_for(dev), init_method=f"file://{tmp}/store", rank=rank,
            world_size=n)
        result = fn(*args)
        torch.save(result, os.path.join(tmp, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence = (),
          device: Union[str, torch.device] = "cpu",
          threads: Optional[int] = None) -> List:
    """``[fn(*args) on rank r for r in range(n)]``, each rank its own
    process. ``threads`` sets torch's CPU threads in each rank."""
    device = torch.device(device)
    check_ranks(n, device)
    tmp = tempfile.mkdtemp(prefix="sstpu_spawn_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, tmp, fn, tuple(args), str(device),
                               threads))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(tmp, failed, procs))
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(_failure(tmp, failed, procs))
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def _failure(tmp: str, failed: List[int], procs) -> str:
    """Each failed rank's exit code, and every traceback a rank wrote (the
    first failure may be on a rank that has not exited yet)."""
    msgs = [f"rank {r} exited with {procs[r].exitcode}" for r in failed]
    for r in range(len(procs)):
        path = os.path.join(tmp, f"error_{r}.txt")
        if os.path.exists(path):
            msgs.append(f"rank {r}:\n{open(path).read()}")
    return "\n".join(msgs)
