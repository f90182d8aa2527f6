"""`spawn`: start one process a rank, with the launch environment set.

Counterpart: ``paddle_tpu/distributed/spawn.py:15-125`` (`ParallelMode`,
`ParallelEnv`, `spawn`). The parent opens the rendezvous store
(`torch.distributed.TCPStore` on a free port, never a fixed one) and
keeps it open while the ranks run; each rank finds it through the
reference's environment contract (``PADDLE_TRAINER_ID``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``,
``PADDLE_MASTER``) and joins with `collective.init_parallel_env`.
"""
from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import os
import time

import torch.distributed as dist


class ParallelMode:
    """Parallelism taxonomy (reference ``parallel.py:ParallelMode``)."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class ParallelEnv:
    """This process's distributed identity, read from the environment
    (reference ``parallel.py:ParallelEnv``)."""

    def __init__(self):
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._device_id = int(os.getenv("PADDLE_LOCAL_RANK",
                                        os.getenv("LOCAL_RANK", "0")))
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")
        eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._nrings = int(os.getenv("FLAGS_nccl_nrings", "1"))

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    @property
    def nrings(self):
        return self._nrings

    # legacy aliases (the reference keeps both spellings)
    local_rank = rank
    nranks = world_size
    dev_id = device_id


def _spawn_target(func, rank, nprocs, master, args):
    addr, port = master.rsplit(":", 1)
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_LOCAL_RANK": str(rank),
        "PADDLE_MASTER": master,
        "MASTER_ADDR": addr,
        "MASTER_PORT": port,
        "RANK": str(rank),
        "WORLD_SIZE": str(nprocs),
        "LOCAL_RANK": str(rank),
    })
    func(*args)


class SpawnContext:
    """The spawned ranks and the store they meet at."""

    def __init__(self, procs, store):
        self.processes = procs
        self._store = store

    def join(self, timeout=None):
        """Wait for every rank. A rank that fails stops the others (they
        would wait for it forever); so does ``timeout`` (seconds).
        True when every rank exited with 0."""
        end = None if timeout is None else time.monotonic() + timeout
        live = list(self.processes)
        while live:
            left = None if end is None else max(0.0, end - time.monotonic())
            mp.connection.wait([p.sentinel for p in live], left)
            for p in [p for p in live if not p.is_alive()]:
                p.join()
                live.remove(p)
            failed = any(p.exitcode not in (None, 0) for p in self.processes)
            if live and (failed or (end is not None
                                    and time.monotonic() >= end)):
                for p in live:
                    p.terminate()
                for p in live:
                    p.join()
                live = []
        return all(p.exitcode == 0 for p in self.processes)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run ``func(*args)`` in ``nprocs`` new processes (default:
    ``PADDLE_TRAINERS_NUM`` or 1), rank ``i`` with the launch environment
    of rank ``i`` set (reference ``spawn.py:spawn``). ``func`` and
    ``args`` are pickled (a module-level function). ``options``:
    ``start_method`` (default ``"spawn"``). With ``join`` (default) it
    waits and raises `RuntimeError` when a rank fails; else it returns
    the `SpawnContext` at once."""
    if nprocs == -1:
        nprocs = int(os.getenv("PADDLE_TRAINERS_NUM", "1")) or 1
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    master = f"127.0.0.1:{store.port}"
    ctx = mp.get_context(options.get("start_method", "spawn"))
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_spawn_target,
                        args=(func, rank, nprocs, master, tuple(args)),
                        daemon=daemon)
        p.start()
        procs.append(p)
    context = SpawnContext(procs, store)
    if join and not context.join():
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"spawned ranks failed, exit codes {codes}")
    return context


__all__ = ["ParallelMode", "ParallelEnv", "SpawnContext", "spawn"]
