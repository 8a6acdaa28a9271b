"""Starting the ranks of the multi-device path.

`init_group(rank, world, device)` joins this process to a process group
over a loopback TCP rendezvous: NCCL for a CUDA device (rank r on card
r % device_count), gloo for the CPU. `run_ranks(fn, world, device, *args)`
spawns `world` processes, runs fn(mesh, *args) in each and returns the
results in rank order. Nothing tells a program of a cluster here: the
address, world size and rank are given explicitly.
"""

from __future__ import annotations

import multiprocessing
import queue as queue_mod
import socket
import traceback

import torch
import torch.distributed as dist

from .mesh import BACKENDS, Mesh, make_mesh


def free_port() -> int:
    """A TCP port on localhost that was free when asked."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(rank: int, world: int, device="cuda",
               port: int | None = None) -> Mesh:
    """Join a `world`-rank process group as `rank` (rendezvous at
    tcp://127.0.0.1:port) and return its mesh."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        BACKENDS[device.type],
        init_method=f"tcp://127.0.0.1:{port or free_port()}",
        world_size=world, rank=rank)
    return make_mesh(world, device.type)


def _rank_main(rank, world, device, port, fn, args, results):
    try:
        mesh = init_group(rank, world, device, port)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, device="cuda", *args, timeout: float = 600.0):
    """fn(mesh, *args) in `world` spawned ranks; the list of their results
    in rank order. fn must be importable (spawned processes import it by
    name) and return picklable host data. Raises if a rank fails or the
    ranks do not finish within `timeout` seconds; no rank is left running.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(device), port, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    errors = []
    try:
        # drain the queue before joining: a rank blocks on a full pipe
        for _ in range(world):
            rank, ok, out = results.get(timeout=timeout)
            if not ok:
                errors.append(f"rank {rank}:\n{out}")
                break
            got[rank] = out
    except queue_mod.Empty:
        errors.append(f"ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(world)]
