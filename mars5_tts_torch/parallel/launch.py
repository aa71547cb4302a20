"""Run a function in several processes joined in one ``torch.distributed``
group: the port's counterpart of the JAX package's virtual host devices
(``graft_entry.dryrun_multichip``, ``tools/train_tiny.py``) and of two
tensor-parallel ranks sharing one card (``chip_smoke.py`` phase 6 (e)).

The processes are spawned (never forked: a parent that touched CUDA cannot
fork a child that does) and meet at a ``file://`` rendezvous in a temporary
directory, so concurrent runs never share a port. Each rank's return value
travels back through ``torch.save`` in that directory.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist


def _rank_entry(rank, fn, world, tmp, backend, args):
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    try:
        torch.save(fn(rank, world, *args), os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, backend: str = "gloo", timeout: float = 600.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` new processes, each the rank
    of its number in one ``backend`` group; returns their results by rank.
    ``fn`` must be importable by name (a module-level function). Each rank
    runs one intra-op thread, so ``world`` ranks on one host do not
    oversubscribe its cores and CPU sums keep one order. A rank that raises fails the run with its traceback
    (``torch.multiprocessing.ProcessRaisedException``); past ``timeout``
    seconds TimeoutError. Every process has ended when this returns or
    raises."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_entry, args=(fn, world, tmp, backend, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__}: {world} ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
                for r in range(world)]
