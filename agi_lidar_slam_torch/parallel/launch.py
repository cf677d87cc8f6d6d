"""Spawn a process group on one machine: the torch counterpart of the
process bring-up that `jax.distributed` gives the reference.

    results = launch(fn, nprocs, args, device="cpu")

runs `fn(rank, *args)` in `nprocs` processes started with the `spawn` method
(CUDA cannot live in a forked child), each joined to one process group
through parallel/distributed.init_distributed and the environment variables
it reads. The rendezvous is a FileStore in `rendezvous_dir` where one is
given, else a TCP port on localhost that the parent picks. Each rank gets
LOCAL_RANK = its rank, so on cuda it takes cuda:{rank % device count}.

For cuda the parent builds the kernel library (`_build.build()`) before it
spawns: the ranks only load it, and never race to build it into `_build/`.

Every rank has a deadline: a rank that raises, dies, or still runs at
`deadline_s` kills the whole group, and `launch` raises in the parent with
the rank's traceback. `init_timeout_s` is the process group's own timeout,
for the rendezvous and for each collective: a hung collective fails there.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
import uuid

import torch


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, nprocs: int, coordinator: str, fn, args, device, backend,
               threads, init_timeout_s: float, results) -> None:
    import torch.distributed as dist

    from .distributed import init_distributed

    try:
        if threads:
            torch.set_num_threads(threads)
        os.environ.update(COORDINATOR_ADDRESS=coordinator, NUM_PROCESSES=str(nprocs),
                          PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
        init_distributed(backend=backend, device=device, timeout_s=init_timeout_s)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which kills the group and raises
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, nprocs: int, args: tuple = (), device="cuda", backend: str | None = None,
           threads: int | None = None, rendezvous_dir: str | None = None,
           init_timeout_s: float = 120.0, deadline_s: float = 600.0) -> list:
    """Run fn(rank, *args) on `nprocs` spawned ranks of one process group;
    returns their return values in rank order. `fn`, `args` and the results
    are pickled (fn by its import path). `backend` defaults to nccl for
    cuda and gloo for the CPU; `threads` sets each rank's torch threads."""
    if torch.device(device).type == "cuda":
        from .. import _build

        _build.build()
    if rendezvous_dir is not None:
        coordinator = "file://" + os.path.join(os.path.abspath(rendezvous_dir),
                                               f"rendezvous-{uuid.uuid4().hex}")
    else:
        coordinator = f"localhost:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, coordinator, fn, args, str(device), backend, threads,
                               init_timeout_s, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict = {}
    failed: dict = {}
    end = time.monotonic() + deadline_s
    try:
        while len(out) + len(failed) < nprocs:  # drain the queue before any join
            left = end - time.monotonic()
            if left <= 0:
                if failed:
                    break
                raise TimeoutError(f"ranks {sorted(set(range(nprocs)) - set(out))} still "
                                   f"running at the {deadline_s:.0f} s deadline")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and r not in failed and p.exitcode not in (None, 0):
                        failed[r] = f"died with exit code {p.exitcode} without a result"
                continue
            if ok:
                out[rank] = payload
            else:
                failed[rank] = payload
            if failed:  # the others' reports follow within moments: the first is
                # often a peer's broken connection, not the cause
                end = min(end, time.monotonic() + 2.0)
        if failed:
            raise RuntimeError("\n".join(f"rank {r} of {nprocs} failed:\n{failed[r]}"
                                         for r in sorted(failed)))
        for p in procs:
            p.join(timeout=max(end - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
    return [out[r] for r in range(nprocs)]
