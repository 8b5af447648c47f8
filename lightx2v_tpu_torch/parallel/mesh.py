"""Process groups and the device mesh (counterpart of
``lightx2v_tpu.parallel.mesh``).

One process per GPU, started by ``torchrun`` (``python -m
torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; the reference's NCCL init (``lightx2v/infer.py:28-30``).
The backend follows the device: NCCL for CUDA ranks (each on
``cuda:LOCAL_RANK``), gloo for CPU ranks. A world of one process started
without torchrun's environment has no process group.

The mesh has the JAX package's axes, laid out row-major in ``AXES`` order
over the ranks of the mesh, as ``reshape(sizes)`` lays out the devices there:

* ``dp``: data parallel (the CFG pair: cond and uncond rows on different
  ranks);
* ``sp``: sequence parallel (video tokens; Ulysses all-to-all or ring);
* ``tp``: tensor parallel (attention heads and the FFN hidden dim).

``build_mesh`` gives each rank its coordinate and one process group per
axis (the ranks that differ from it along that axis only). An axis of size 1
has no group and its collectives are the identity, so a mesh of 1 needs no
process group at all.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "sp", "tp")


def torchrun_env() -> bool:
    """Was this process started by torchrun (or given its variables)?"""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def rank_device(device) -> torch.device:
    """A CUDA rank's device is ``cuda:LOCAL_RANK``; a CPU one stays the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torchrun_env():
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def init_distributed(device="cuda", init_method: Optional[str] = None) -> Optional[Dict]:
    """Initialise the default process group from torchrun's variables: NCCL
    on ``cuda:LOCAL_RANK``, gloo on the CPU. Runs one all-reduce on the
    rank's device as a handshake, so a backend that cannot run fails here.
    Returns ``{"rank", "world", "backend", "device"}``, or None without
    torchrun's environment (a plain one-process run)."""
    if not torchrun_env():
        return None
    dev = rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(backend, init_method=init_method or "env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **kw)
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    if int(one.item()) != dist.get_world_size():
        raise RuntimeError(f"the {backend} handshake summed {one.item()} over a world of {dist.get_world_size()}")
    return {"rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(),
            "device": str(dev)}


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_and_world():
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class Mesh:
    """This rank's view of a ``(dp, sp, tp)`` mesh. ``coords`` is None on a
    rank that the mesh leaves idle (a mesh smaller than the world)."""

    sizes: Dict[str, int]
    ranks: List[int]  # the global ranks of the mesh, in mesh order
    coords: Optional[Dict[str, int]] = None
    groups: Dict[str, object] = field(default_factory=dict)  # axis (or "mesh", all of it) -> process group, size > 1
    group_ranks: Dict[str, List[int]] = field(default_factory=dict)  # axis -> global ranks, in axis order

    @property
    def member(self) -> bool:
        return self.coords is not None

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis] if self.coords is not None else 0

    def group(self, axis: str):
        return self.groups.get(axis)


def build_mesh(mesh_shape: Optional[Dict[str, int]] = None, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """mesh_shape e.g. {"sp": 4}, {"dp": 2, "sp": 4}; missing axes get 1.
    With no shape, the whole world goes to ``sp`` (the reference's default
    torchrun layout). ``ranks`` (global ranks, the port's ``mesh_devices``)
    carves the mesh out of a sub-group; by default the first ``total`` ranks.
    Every rank of the world must call it (``new_group`` is collective).
    A mesh larger than the world (or than ``ranks``) raises ``ValueError``."""
    rank, world = rank_and_world()
    pool = list(range(world)) if ranks is None else [int(r) for r in ranks]
    shape = dict(mesh_shape or {})
    if not shape:
        shape = {"sp": len(pool)}
    unknown = set(shape) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes are {AXES}")
    sizes = {a: int(shape.get(a, 1)) for a in AXES}
    total = int(np.prod(list(sizes.values())))
    if total > len(pool) or any(r >= world for r in pool):
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {len(pool)} of a world of {world}")
    mesh_ranks = pool[:total]
    grid = np.asarray(mesh_ranks).reshape([sizes[a] for a in AXES])
    mesh = Mesh(sizes=sizes, ranks=mesh_ranks)
    if rank in mesh_ranks:
        pos = np.argwhere(grid == rank)[0]
        mesh.coords = {a: int(p) for a, p in zip(AXES, pos)}
    if total > 1:
        g = dist.new_group(mesh_ranks)
        if rank in mesh_ranks:
            mesh.groups["mesh"], mesh.group_ranks["mesh"] = g, mesh_ranks
    for ai, axis in enumerate(AXES):
        if sizes[axis] == 1:
            continue
        # every line of the grid along this axis is one group; all ranks create all groups, in one order
        lines = np.moveaxis(grid, ai, -1).reshape(-1, sizes[axis])
        for line in lines:
            members = [int(r) for r in line]
            g = dist.new_group(members)
            if rank in members:
                mesh.groups[axis] = g
                mesh.group_ranks[axis] = members
    return mesh


def mesh_axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else mesh.size(axis)


# ---------------------------------------------------------------- collectives
def all_gather_cat(x: torch.Tensor, mesh: Optional[Mesh], axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in the axis's order."""
    g = None if mesh is None else mesh.group(axis)
    if g is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x, group=g)
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """The sum of ``x`` over the axis (a new tensor; ``x`` is not written)."""
    g = None if mesh is None else mesh.group(axis)
    if g is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=g)
    return out


def broadcast_from_first(tree, mesh: Optional[Mesh]):
    """``tree`` (tensors and numpy arrays in dicts, lists and tuples) as the
    mesh's first rank holds it, on every rank of the mesh: the ranks then
    start the denoise from the same encoder outputs whatever their text
    encoders did (a synthetic tokenizer hashes words with Python's
    per-process salted ``hash()``)."""
    g = None if mesh is None else mesh.group("mesh")
    if g is None:
        return tree

    def rec(x):
        if isinstance(x, dict):
            return {k: rec(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rec(v) for v in x)
        if isinstance(x, np.ndarray):
            return rec(torch.from_numpy(np.ascontiguousarray(x))).numpy()
        if isinstance(x, torch.Tensor):
            on_cpu = x.device.type == "cpu" and dist.get_backend(g) == "nccl"
            t = (x.cuda() if on_cpu else x).contiguous()
            dist.broadcast(t, src=mesh.ranks[0], group=g)
            return t.cpu() if on_cpu else t
        return x

    return rec(tree)


def shard(x: torch.Tensor, mesh: Optional[Mesh], axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous ``1 / size`` slice of ``x`` along ``dim``."""
    n = mesh_axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide {axis} = {n}")
    c = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * c, c)
