"""Scale-out (port of ``align3d_tpu/parallel``): frame-pair batching,
sharding over a 1-D ``torch.distributed`` device mesh (NCCL on CUDA, gloo
on the CPU), sequence parallelism with a one-frame halo, and the sharded
pose graph (:mod:`.pose_graph`) and bundle adjustment
(:mod:`.bundle_adjustment`)."""

from align3d_torch.parallel.batch import (
    build_pyramids_batched,
    make_mesh,
    multiscale_align_batched,
    odometry_step,
)
from align3d_torch.parallel.bundle_adjustment import BAProblem
from align3d_torch.parallel.sequence import odometry_sequence_parallel

__all__ = [
    "build_pyramids_batched",
    "multiscale_align_batched",
    "odometry_step",
    "make_mesh",
    "BAProblem",
    "odometry_sequence_parallel",
]
