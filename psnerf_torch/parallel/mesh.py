"""The device mesh of data-parallel runs (counterpart of
psnerf_tpu/parallel/mesh.py): one process per GPU under torch.distributed.

The JAX package drives every device from one controller and lets shard_map
and XLA place the collectives. Here each rank is a process that owns one
device, holds the parameters and the optimizer state whole (replicated),
draws every step's batch whole, exactly as every other rank does, and keeps
its contiguous block of it:

  * a 1-D mesh splits the ray (pixel) axis over the ranks;
  * a 2-D mesh (rays x lights) also splits the light axis: rank r sits at
    ray row r // n_light and light column r % n_light, as the JAX package
    reshapes its device list.

Rays are independent, so rendering needs collectives only to gather its
outputs; training needs one gradient all-reduce a step and the loss's
global denominators (psnerf_torch.train.losses).

A single device is the one-rank case (as_mesh(None, device)): rank 0 of
1, both axes of size 1 and without a group. Every helper below returns
its input on it and none calls torch.distributed, which may stay
uninitialised, so the runners and the steps have one code path for one
device and for many.

Collectives used: all_reduce, all_gather (the list form) and broadcast. The
gloo backend takes CUDA tensors for all_reduce and broadcast; all_gather of
a CUDA tensor under gloo goes through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os

import torch
import torch.distributed as dist
from torch import nn

from psnerf_torch.device import resolve_device

RAY_AXIS = "rays"
LIGHT_AXIS = "lights"
PG_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in the mesh. shape: {"rays": n_ray, "lights":
    n_light} (n_light is 1 on a 1-D mesh); groups: the process group of
    each axis, i.e. of the ranks that differ from this one only along it
    (None for an axis of size 1); backend: None on one rank."""
    rank: int
    size: int
    device: torch.device | None
    shape: dict
    groups: dict
    backend: str | None

    @property
    def ray_index(self) -> int:
        return self.rank // self.shape[LIGHT_AXIS]

    @property
    def light_index(self) -> int:
        return self.rank % self.shape[LIGHT_AXIS]

    @property
    def is_main(self) -> bool:
        """Rank 0: the one rank that writes files."""
        return self.rank == 0


def _default_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _init(device) -> torch.device:
    """The default process group (from the environment, as torchrun sets
    it, when nothing initialised it yet: NCCL on CUDA, gloo on the CPU)
    and this rank's device."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="env://",
                                timeout=PG_TIMEOUT)
    dev = _default_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_mesh_2d(n_ray: int, n_light: int, device="cuda") -> Mesh:
    """A rays x lights mesh over every rank of the default process group
    (n_ray * n_light must be its size). Every rank must call it, in the
    same order as every other call that makes a mesh: each axis's groups
    are created by all ranks."""
    dev = _init(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_ray * n_light != world:
        raise ValueError(f"a {n_ray} x {n_light} mesh needs {n_ray * n_light}"
                         f" ranks; the process group has {world}")
    groups = {}
    # ranks sharing a light column differ along the ray axis, and back
    for axis, n_axis, lines in (
            (RAY_AXIS, n_ray, [[i * n_light + j for i in range(n_ray)]
                               for j in range(n_light)]),
            (LIGHT_AXIS, n_light, [[i * n_light + j for j in range(n_light)]
                                   for i in range(n_ray)])):
        if n_axis == 1:
            groups[axis] = None
        elif n_axis == world:
            groups[axis] = dist.group.WORLD
        else:
            for ranks in lines:             # new_group is collective
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    return Mesh(rank=rank, size=world, device=dev,
                shape={RAY_AXIS: n_ray, LIGHT_AXIS: n_light}, groups=groups,
                backend=dist.get_backend())


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The 1-D ray mesh over every rank of the default process group,
    initialising it from the environment (torchrun's RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) if needed: NCCL on CUDA, gloo on the CPU.
    n_devices, if given, must be the group's size. A CUDA
    rank takes cuda:LOCAL_RANK (or cuda:rank) unless device names an
    index."""
    dev = _init(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a process group of "
                         f"{world} ranks: a mesh spans every rank")
    return make_mesh_2d(world, 1, dev)


def as_mesh(mesh: Mesh | None, device=None) -> Mesh:
    """mesh itself, or for None the one-rank mesh of a single device:
    rank 0 of 1, both axes of size 1 and without a group, no backend. The
    public entries (the runners, the train steps, the losses) take
    mesh=None and read it through here. device: where the one rank runs
    (None for a train step's, which runs where its tensors are)."""
    if mesh is not None:
        return mesh
    return Mesh(rank=0, size=1,
                device=None if device is None else resolve_device(device),
                shape={RAY_AXIS: 1, LIGHT_AXIS: 1},
                groups={RAY_AXIS: None, LIGHT_AXIS: None}, backend=None)


# ------------------------------------------------------- the runners' roles

def writes(mesh: Mesh) -> bool:
    """Whether this process writes files: rank 0."""
    return mesh.is_main


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (nothing on one rank)."""
    if mesh.size > 1:
        dist.barrier()


def say(mesh: Mesh, msg: str) -> None:
    """Print on the rank that writes."""
    if writes(mesh):
        print(msg)


def rank_tile(tile: int, mesh: Mesh) -> int:
    """A ray rank's share of a tile of pixels."""
    n = mesh.shape[RAY_AXIS]
    if tile % n:
        raise ValueError(f"tile={tile} not divisible by the mesh's {n} ray "
                         "ranks")
    return tile // n


def rank0_flag(flag: bool, mesh: Mesh, device) -> bool:
    """Rank 0's flag on every rank (a host decision, such as a wall-clock
    budget, that the ranks must take together)."""
    if mesh.size == 1:
        return flag
    t = torch.tensor(float(flag), device=device)
    dist.broadcast(t, src=0)
    return bool(t)


def rank0_only(method):
    """A runner method that, under the runner's mesh, runs on rank 0
    alone; the other ranks wait for it and return None."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        out = method(self, *args, **kwargs) if writes(self.mesh) else None
        barrier(self.mesh)
        return out
    return run


# --------------------------------------------------------------- collectives

def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A detached copy of x summed over a group (x itself when the group
    is None, an axis of size 1)."""
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def world_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over every rank of the mesh, detached (x itself on one
    rank): the loss's global counts and the logged loss terms."""
    return x if mesh.size == 1 else all_sum(x, dist.group.WORLD)


def any_over_lights(mask: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A 0/1 mask set wherever any rank of this rank's light row sets it
    (mask itself on a light axis of size 1): the stage-2 light tables'
    row gate of the whole batch."""
    group = mesh.groups[LIGHT_AXIS]
    return mask if group is None else (all_sum(mask, group) > 0).to(
        mask.dtype)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks of x in rank order, concatenated along dim (x
    itself when the group is None). Every rank's x has the same shape."""
    if group is None:
        return x
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.detach().contiguous()
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def gather_rays(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    return all_gather_cat(x, mesh.groups[RAY_AXIS], dim)


def gather_lights(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    return all_gather_cat(x, mesh.groups[LIGHT_AXIS], dim)


def all_reduce_grads(grads: list, mesh: Mesh) -> None:
    """Sum a list of gradient tensors over every rank in place, through one
    flat buffer in the list's order (nothing on one rank)."""
    if mesh.size == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def replicate(tree, mesh: Mesh):
    """Broadcast rank 0's values of a module's parameters and buffers, a
    tensor, or a (nested) dict of them, into every rank's, in place.
    Returns the tree."""
    if mesh.size == 1:
        return tree
    for t in _tensors(tree):
        dist.broadcast(t.data, src=0)
    return tree


def _tensors(tree) -> list:
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return []


# ------------------------------------------------------------------ layouts

def _block(x: torch.Tensor, n: int, i: int, dim: int, what: str):
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{what}: {size} along dim {dim} not divisible by "
                         f"the {n}-way mesh axis")
    b = size // n
    return x.narrow(dim, i * b, b)


def ray_block(x: torch.Tensor, mesh: Mesh, dim: int = 0,
              what: str = "rays") -> torch.Tensor:
    """This rank's contiguous block of x along the ray axis."""
    return _block(x, mesh.shape[RAY_AXIS], mesh.ray_index, dim, what)


def light_block(x: torch.Tensor, mesh: Mesh, dim: int = 0,
                what: str = "lights") -> torch.Tensor:
    """This rank's contiguous block of x along the light axis."""
    return _block(x, mesh.shape[LIGHT_AXIS], mesh.light_index, dim, what)


# keys whose FIRST axis is the pixel axis
STAGE2_PIX0 = ("uv", "object_mask", "points", "normal", "surface_mask")
# keys whose SECOND axis is the pixel axis (leading light axis)
STAGE2_PIX1 = ("rgb_gt", "visibility", "vis_train_gt")
_STAGE1_PIX0 = ("pixels", "rgb_gt", "normal_gt", "norm_mask", "mask_gt",
                "mask_valid")


def shard_stage1_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's block of a full stage-1 batch: the per-ray keys split
    over the ray axis, the rest whole."""
    return {k: ray_block(v, mesh, 0, k) if k in _STAGE1_PIX0 else v
            for k, v in batch.items()}


def shard_stage2_batch_2d(batch: dict, mesh: Mesh) -> dict:
    """This rank's block of a full stage-2 batch over a rays x lights mesh
    (a 1-D mesh is its n x 1 case): per-pixel keys over the ray axis,
    rgb_gt and visibility over both, the light-table rows l_slt over the
    light axis; vis_train_gt over the ray axis only (its light count
    depends on the schedule). Without vis_train_gt, light_vis_train holds
    the directions of the batch's own lights (their visibility is its
    ground truth) and splits with them. The light-axis size must divide
    the training light count."""
    own_lights = ("l_slt",) + (() if "vis_train_gt" in batch
                               else ("light_vis_train",))
    out = {}
    for k, v in batch.items():
        if k in STAGE2_PIX0:
            v = ray_block(v, mesh, 0, k)
        elif k in STAGE2_PIX1:
            if k != "vis_train_gt":
                v = light_block(v, mesh, 0, k)
            v = ray_block(v, mesh, 1, k)
        elif k in own_lights:
            v = light_block(v, mesh, 0, k)
        out[k] = v
    return out


# the JAX package's name for the ray-axis split; one layout rule serves both
shard_stage2_batch = shard_stage2_batch_2d


def shard_noise(noise: dict, mesh: Mesh) -> dict:
    """This rank's rows of a render's per-ray draws (scalars stay whole)."""
    return {k: ray_block(v, mesh, 0, k) if v.ndim else v
            for k, v in noise.items()}
