"""The collectives of the sharded paths, over a 1-D
:class:`~torch.distributed.device_mesh.DeviceMesh` (the port's counterpart
of the JAX package's ``jax.sharding`` mesh and its ``psum`` /
``all_gather`` / ``ppermute``).

* :func:`all_reduce` is ``psum``: one ``dist.all_reduce(SUM)`` on the
  mesh's group over one flat buffer that packs every tensor it is given.
* :func:`all_gather` is ``all_gather``: each rank's block is broadcast from
  that rank in turn, as raw bytes, so the gathered values are bitwise the
  ranks' own. Broadcast is the one collective that NCCL and gloo both carry
  for CPU and CUDA tensors on the torch releases the port runs on (gloo
  has no CUDA ``send``/``recv``, and ``all_gather_into_tensor`` is
  deprecated on one of them); a gather is W broadcasts of a few kilobytes
  (poses) or of W frames (the sequence-parallel halo).

The backend is the process group's: NCCL for a CUDA mesh, gloo for a CPU
one, as :func:`align3d_torch.parallel.batch.make_mesh` and
:func:`align3d_torch.parallel.multihost.initialize` set it up. Nothing here
falls back to another backend or device: a tensor on another device type
than the mesh's is refused (:func:`check_device`), and a failed collective
raises. ``COLLECTIVES`` counts the collectives issued and ``BYTES`` the
bytes this rank has put through them (an all-reduce's buffer; a gather's W
broadcasts of a block each); both are read, never reset.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from align3d_torch.se3 import Transform

COLLECTIVES = 0
BYTES = 0


def one_dim_mesh(devices, axis_name: str):
    """A 1-D DeviceMesh named ``axis_name`` over every rank of the process
    group, on ``devices`` (a device type). In a process with no group it
    first makes a one-rank group (NCCL for CUDA, gloo for the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device(devices).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs CUDA")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def world(mesh) -> int:
    return mesh.size()


def rank(mesh) -> int:
    return mesh.get_local_rank()


def device(mesh) -> torch.device:
    """This rank's device: the current CUDA device for a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def resolve_device(mesh, requested) -> torch.device:
    """The device a path runs on: ``requested`` (default ``"cuda"``), or
    with a mesh the mesh's device, which ``requested`` must then name."""
    if mesh is None:
        return torch.device("cuda" if requested is None else requested)
    ours = device(mesh)
    if requested is not None and torch.device(requested).type != ours.type:
        raise ValueError(f"device {requested!r} is not the mesh's device type {mesh.device_type!r}")
    return ours


def check_device(mesh, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise ValueError(f"a tensor on {t.device} given to a {mesh.device_type} mesh")


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor sharded on dim 0 (what
    :func:`align3d_torch.parallel.multihost.host_local_batch` returns)."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(x, DTensor) and any(isinstance(p, Shard) and p.dim == 0 for p in x.placements)


def local(x):
    """A DTensor's local part (this rank's shard, or the whole of a
    replicated one); anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def share(n: int, mesh) -> tuple[int, int, int]:
    """This rank's contiguous share [lo, hi) of ``n`` items split into
    blocks of ``per`` = ceil(n / W) (the last ranks' may be short or
    empty); returns (lo, hi, per)."""
    per = math.ceil(n / world(mesh)) if n else 0
    lo = min(rank(mesh) * per, n)
    return lo, min(lo + per, n), per


def pad_rows(x: torch.Tensor, count: int, fill: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` with ``count`` rows appended: copies of ``fill`` (a row), or of
    x's last row (the JAX package's padding)."""
    if count <= 0:
        return x
    row = x[-1:] if fill is None else fill[None]
    return torch.cat([x, row.expand(count, *x.shape[1:])])


def all_reduce(mesh, *tensors: torch.Tensor):
    """``psum``: the sum over the mesh's ranks of each tensor (float32), by
    one all-reduce of a packed buffer. Returns one tensor or a tuple."""
    global COLLECTIVES, BYTES
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group())
    COLLECTIVES += 1
    BYTES += flat.numel() * flat.element_size()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out[0] if len(out) == 1 else tuple(out)


def all_gather(mesh, *tensors: torch.Tensor):
    """``all_gather`` along a new leading axis: each tensor, the same shape
    and dtype on every rank, comes back as (W, *shape), rank r's at [r],
    bitwise. The tensors travel packed as bytes, one broadcast per rank."""
    global COLLECTIVES, BYTES
    blob = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    w, me = world(mesh), rank(mesh)
    group = mesh.get_group()
    out = torch.empty((w, blob.numel()), dtype=torch.uint8, device=blob.device)
    out[me] = blob
    for r in range(w):
        dist.broadcast(out[r], src=dist.get_global_rank(group, r), group=group)
        COLLECTIVES += 1
        BYTES += blob.numel()
    gathered, at = [], 0
    for t in tensors:
        size = t.numel() * t.element_size()
        gathered.append(out[:, at:at + size].contiguous().view(t.dtype).reshape(w, *t.shape))
        at += size
    return gathered[0] if len(gathered) == 1 else tuple(gathered)


def gather_poses(mesh, relative: Transform, per: int, front: int = 0) -> Transform:
    """Every rank's relative poses, in rank order: each rank's (at most
    ``per``) poses are padded with identities, ``front`` of them before
    and the rest after, to ``per`` slots; returns the (W * per,) slots."""
    dev = relative.rotation.device
    back = per - front - relative.rotation.shape[0]
    ident = Transform.identity(device=dev)
    rot = torch.cat([ident.rotation.expand(front, 3, 3), relative.rotation, ident.rotation.expand(back, 3, 3)])
    trans = torch.cat([ident.translation.expand(front, 3), relative.translation, ident.translation.expand(back, 3)])
    rot, trans = all_gather(mesh, rot, trans)
    return Transform(rot.reshape(-1, 3, 3), trans.reshape(-1, 3))
