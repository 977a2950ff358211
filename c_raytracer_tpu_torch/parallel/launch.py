"""Start the ranks of a mesh on one host (the counterpart of the JAX
package's ``jax.distributed.initialize`` and of its two-process worker).

``launch(fn, n_ranks, backend=, device=, args=)`` spawns ``n_ranks``
processes (start method ``spawn``), initialises a ``torch.distributed``
group among them on a free localhost port, runs ``fn(rank, device,
*args)`` in each, destroys the group and returns each rank's result, in
rank order.  ``fn`` must be picklable (a module-level function) and its
result too; a rank that raises fails the launch, and the other ranks are
stopped.

Devices, only as asked:

* ``backend="nccl"``, ``device="cuda"``: rank ``r`` on card ``r``; with
  fewer cards than ranks it raises (NCCL refuses two ranks on one card);
* ``backend="gloo"``, ``device="cuda"`` (or ``"cuda:k"``): every rank on
  that one card, the collectives staged through the host;
* ``backend="gloo"``, ``device="cpu"``: CPU processes.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this fails its rank, and the launch
TIMEOUT_S = 1800


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(backend: str, device, rank: int) -> torch.device:
    """The device of ``rank``: its own card under NCCL, the named card
    under gloo, or the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank)
    if device.type == "cuda":
        return torch.device("cuda", device.index or 0)
    return device


def _check(n_ranks: int, backend: str, device: torch.device) -> None:
    if n_ranks < 1:
        raise ValueError(f"launch: {n_ranks} ranks")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"launch: unknown backend {backend!r}")
    if device.type == "cpu":
        if backend != "gloo":
            raise ValueError("launch: CPU ranks take the gloo backend")
        return
    if device.type != "cuda":
        raise ValueError(f"launch: unsupported device {device}")
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and n_cards < n_ranks:
        raise RuntimeError(
            f"launch: nccl needs one card a rank: {n_ranks} ranks, "
            f"{n_cards} cards (gloo can share one card: backend='gloo')")
    if backend == "gloo" and n_cards <= (device.index or 0):
        raise RuntimeError(f"launch: no card {device} ({n_cards} cards)")


def _rank_main(rank, fn, n_ranks, port, backend, device, args, results,
               threads):
    if threads is not None:
        torch.set_num_threads(threads)
    dev = _rank_device(backend, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}",
        world_size=n_ranks, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        # pickled here by value: a tensor sent through the queue as is
        # would go as a shared-memory handle, gone when this process ends
        out = pickle.dumps(fn(rank, dev, *args))
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, *, backend: str = "nccl", device="cuda",
           args: tuple = (), threads: int | None = None) -> list:
    """Run ``fn(rank, device, *args)`` on ``n_ranks`` ranks of a new
    process group; returns the results in rank order.  ``threads`` is each
    rank's
    ``torch.set_num_threads``, by default for CPU ranks the host's cores
    shared among them (ranks that each spin on every core while gloo waits
    run many times slower: 8 min against 21 s for the dry run's two CPU
    ranks on 8 cores).  Card ranks keep torch's default."""
    device = torch.device(device)
    _check(n_ranks, backend, device)
    if threads is None and device.type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // n_ranks)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = _free_port()
    procs = mp.start_processes(
        _rank_main, args=(fn, n_ranks, port, backend, device, args, results,
                          threads),
        nprocs=n_ranks, join=False, start_method="spawn")
    got, failed = {}, []

    def drain():
        while not results.empty():
            rank, ok, out = results.get()
            if ok:
                got[rank] = pickle.loads(out)
            else:
                failed.append(f"rank {rank}:\n{out}")

    try:
        while True:
            drain()
            if failed:
                raise RuntimeError("launch: " + "\n".join(failed))
            try:
                if procs.join(timeout=0.05):
                    break
            except mp.ProcessRaisedException as e:
                drain()
                raise RuntimeError(
                    "launch: " + ("\n".join(failed) or str(e))) from e
            except mp.ProcessExitedException as e:
                raise RuntimeError(f"launch: {e}") from e
        drain()
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join(timeout=30)
    if failed or len(got) != n_ranks:
        raise RuntimeError("launch: " + ("\n".join(failed)
                                         or f"{len(got)} of {n_ranks} "
                                         "ranks returned"))
    return [got[r] for r in range(n_ranks)]

