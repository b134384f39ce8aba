"""Starting and joining worlds of ranks: the port of
``repro.launch.mesh``.

A world is joined from ``torchrun``'s environment (:func:`join`) or
started here (:func:`spawn`: ``spawn`` start method, a ``FileStore``
rendezvous in a temporary directory, so no TCP port is raced for). The
mesh, the world a process joined and the collectives are
:mod:`repro_torch.distributed`'s; the names the reference's module
exports (``make_host_mesh``, ``make_data_mesh``, ...) are re-exported
here for the launchers.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed import (  # noqa: F401  (the launchers' names)
    BACKENDS, TIMEOUT_S,
    World, all_equal, check_backend, default_backend, init_world, joined,
    leave, make_data_mesh, make_host_mesh, placement_device, replicated,
    world)


def in_torchrun() -> bool:
    """True when ``torchrun`` (or another launcher) set this process's
    rank and world size in the environment."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join(backend: Optional[str] = None, device="cuda") -> World:
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); ``backend=None`` picks
    :func:`default_backend`."""
    if not in_torchrun():
        raise RuntimeError("join: RANK / WORLD_SIZE are not set (start the "
                           "program under torchrun, or use spawn)")
    size = int(os.environ["WORLD_SIZE"])
    backend = backend or default_backend(device, size)
    return init_world(backend, device, int(os.environ["RANK"]), size,
                      "env://")


def _rank_main(call_path, rank, size, backend, device, init_method,
               timeout, out):
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if torch.device(device).type == "cpu":
            # ranks on the CPU share its cores: without a share each,
            # every rank runs as many threads as there are cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        init_world(backend, device, rank, size, init_method, timeout)
        result = fn(*args)
        dist.barrier()
        out.put((rank, True, result))
    except BaseException:
        # the parent raises with this traceback; the rank exits non-zero
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        leave()


def spawn(fn: Callable, world_size: int, backend: str, device, *,
          args: Sequence = (), timeout: float = TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``world_size`` new ranks (``spawn`` start
    method; ``fn`` and ``args`` are pickled by value into a file each
    rank reads, so ``fn`` is a module-level function and tensors in
    ``args`` arrive as copies) that have joined one world, and return
    their results in
    rank order. On the CPU each rank computes on its share of the cores
    (``torch.set_num_threads``). A rank that raises, or a world that does not finish
    within ``timeout`` seconds, raises ``RuntimeError`` here after
    every rank has been stopped."""
    check_backend(backend, device, world_size)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        # the call goes through a file, not the process's start pipe: a
        # start blocks while a child has not read its pipe, and a child
        # reads it only after importing fn's module, so large args
        # would start the ranks one after another
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(call, r, world_size, backend,
                                   str(device), init, timeout, out))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results: dict = {}
        failures = []
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(failures) < world_size:
                left = deadline - time.monotonic()
                try:
                    rank, ok, value = out.get(timeout=max(left, 0.01))
                except queue.Empty:
                    raise RuntimeError(
                        f"spawn: world of {world_size} did not finish in "
                        f"{timeout:.0f} s ({len(results)} ranks done)")
                if ok:
                    results[rank] = value
                else:
                    failures.append((rank, value))
                    break
        finally:
            # ranks that all finished still free their memory and leave
            # the group; otherwise one may hold the rest in a collective
            done = len(results) == world_size
            for p in procs:
                p.join(timeout=60.0 if done else 1.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if failures:
        rank, tb = failures[0]
        raise RuntimeError(f"spawn: rank {rank} of {world_size} failed:\n"
                           f"{tb}")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawn: ranks exited with codes {bad}")
    return [results[r] for r in range(world_size)]
