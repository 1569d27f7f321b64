"""Run a function on N ranks, one process each (the JAX package's single
controller sees every device and needs no launcher).

    results = launch(fn, 2, arg, device="cuda")      # fn(mesh, arg) per rank

Ranks are spawned (CUDA cannot be used in a forked child), meet through a
FileStore in a temporary directory, and each gets its mesh: rank r takes
cuda:r over NCCL (device="cuda"), the one card named (device="cuda:0":
every rank on it, over gloo when there are several, since NCCL refuses two
ranks on one device), or the CPU over gloo (device="cpu", one thread a
rank). Each rank's mesh is the 1-D ray mesh; a rank function that wants a
rays x lights layout makes it with make_mesh_2d. Under torchrun, build the
mesh with make_mesh() in each process instead.

The kernels are built here, before the spawn, so the ranks do not each
run nvcc. A rank's exception ends every rank and is raised here; so is a
run that outlasts `timeout` seconds. fn must be importable by the spawned
processes (a module-level function); its return value comes back pickled.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from psnerf_torch.parallel.mesh import PG_TIMEOUT, make_mesh


def _rank_main(rank, world, out_dir, device, backend):
    # every rank is on this host: keep the rendezvous on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    elif dev.index is None:
        dev = torch.device("cuda", rank)
    # the call comes through a file: a spawned child that dies while it
    # reads a large pickle from its pipe would block the parent's write
    fn, args = torch.load(os.path.join(out_dir, "call.pt"),
                          weights_only=False)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    try:
        out = fn(make_mesh(world, dev), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, n_ranks: int, *args, device: str = "cuda",
           timeout: float | None = None) -> list:
    """fn(mesh, *args) on n_ranks ranks; returns each rank's result, in
    rank order. timeout: seconds (None waits for the ranks)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from psnerf_torch.device import resolve_device
        from psnerf_torch.mesh.build import build as build_mesh_library
        from psnerf_torch.ops.build import build_all

        resolve_device(dev)
        if dev.index is None and n_ranks > torch.cuda.device_count():
            raise ValueError(f"{n_ranks} ranks, {torch.cuda.device_count()} "
                             "CUDA devices: one rank a device")
        build_all()                 # once here, not nvcc in every rank
        build_mesh_library()
    shared_card = dev.index is not None and n_ranks > 1
    backend = "nccl" if dev.type == "cuda" and not shared_card else "gloo"
    tmp = tempfile.mkdtemp(prefix="psnerf_launch_")
    try:
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(n_ranks, tmp, device, backend),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks of {fn.__name__} "
                                       f"ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n_ranks)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
