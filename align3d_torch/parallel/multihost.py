"""Multi-process runtime entry for distributed odometry (port of
``align3d_tpu/parallel/multihost.py``).

* :func:`initialize` joins this process to a ``torch.distributed`` process
  group (``init_process_group``): NCCL when the process runs on a CUDA
  device, gloo on the CPU, or the ``backend`` the caller names. After it,
  every mesh built by :func:`global_mesh` (or
  :func:`align3d_torch.parallel.batch.make_mesh`) spans all processes, and
  the sharded paths (``odometry_step(mesh=)``,
  ``odometry_sequence_parallel``, the pose graph and bundle adjustment)
  run one program across them with the same code as in one process.
* :func:`host_local_batch` makes one global batch of every process's local
  share: a DTensor sharded on dim 0, whose local part the sharded entry
  points take.

Launch with ``torchrun`` (which sets ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, read when no coordinator is
given)::

    torchrun --nproc-per-node 2 my_script.py   # my_script: initialize(); mesh = global_mesh()

or name the coordinator on each host, as with the JAX package::

    initialize("host0:1234", 2, 0)   # host 0
    initialize("host0:1234", 2, 1)   # host 1

``align3d_torch/tools/run_multiprocess.py`` drives two processes on one
machine and checks them against one process.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from align3d_torch.parallel import collectives as col
from align3d_torch.parallel.batch import BATCH_AXIS

TIMEOUT = datetime.timedelta(minutes=10)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = TIMEOUT,
) -> None:
    """Join the process group (a no-op for a single process).

    ``coordinator_address`` is ``host:port`` (TCP) or a URL
    (``tcp://...``, ``file://...``); without it, torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` are read.
    ``local_device_ids[0]``, or else ``LOCAL_RANK`` where CUDA is present,
    picks this process's CUDA device (and NCCL); with neither, and with no
    ``backend`` given, the process runs on the CPU over gloo. ``backend``
    names the backend explicitly (``"gloo"`` runs CUDA tensors over gloo,
    as several ranks on one card need: NCCL refuses two ranks on one
    device). ``timeout`` bounds every collective of the group.
    """
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or (num_processes or 1) <= 1:
        return  # single process: nothing to join
    if local_device_ids:
        local = int(local_device_ids[0])
    elif "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        local = int(os.environ["LOCAL_RANK"])
    else:
        local = None
    if local is not None:
        torch.cuda.set_device(local)  # raises without CUDA: no silent move to the CPU
    if backend is None:
        backend = "nccl" if local is not None else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id, timeout=timeout)


def global_mesh(axis_name: str = BATCH_AXIS, devices="cuda"):
    """1-D mesh named ``axis_name`` over every rank of the process group
    (spans processes after :func:`initialize`), on ``devices`` (a device
    type); in a process with no group, a one-rank mesh."""
    return col.one_dim_mesh(devices, axis_name)


def host_local_batch(mesh, local_data):
    """One global batch from this process's share: a DTensor sharded on
    dim 0 over ``mesh``, of global dim 0 the mesh size times
    ``local_data``'s (every process passes the same shape), on the mesh's
    device. With one process the data passes through, as a tensor on the
    mesh's device."""
    from torch.distributed.tensor import DTensor, Shard

    data = torch.as_tensor(local_data).to(col.device(mesh))
    if col.world(mesh) == 1:
        return data
    return DTensor.from_local(data, mesh, [Shard(0)], run_check=False)


def replicate(mesh, value):
    """A value every process holds alike, as a DTensor replicated over
    ``mesh``, on the mesh's device."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(torch.as_tensor(value).to(col.device(mesh)), mesh, [Replicate()], run_check=False)
