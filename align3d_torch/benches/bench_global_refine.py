"""Global refinement at scale: a 500-pose pose graph and bundle adjustment
at 500 poses x 50k landmarks x 200k observations (the port's
``benches/bench_global_refine.py``).

    python -m align3d_torch.benches.bench_global_refine [--device cpu] [--quick]

The JAX bench's problems, from one generator of seed 11 (:func:`problems`):

* a 500-pose loop (a circle of 0.1-unit steps) whose odometry carries 0.01
  twist noise a step, closed by exact edges (0, 250) and (0, 499) at weight
  10; each call is ``pose_graph.optimize``, 4 Gauss-Newton iterations of
  768 block-Jacobi PCG trips;
* bundle adjustment over the circle's true poses, 50k landmarks in a box
  2-8 m ahead moved by 5 cm, 200k exact (u, v, z) observations of random
  (pose, landmark) pairs; each call is ``bundle_adjustment.optimize``, 3
  iterations of 32 trips on the COO path.

The problems are built on the CPU and copied to the device outside the
timed calls. Neither path has a kernel of its own. ``index_add_`` adds by
atomics on the card, so reruns there are not bitwise. Prints one JSON line:
``ba_500x50k_3gn_seconds``, wall seconds of one BA optimize, with the pose
graph's seconds beside it.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from align3d_torch import se3
from align3d_torch.benches import _harness as h
from align3d_torch.camera import CameraIntrinsics
from align3d_torch.parallel import bundle_adjustment as ba
from align3d_torch.parallel import pose_graph as pg
from align3d_torch.se3 import Transform
from align3d_torch.trajectory import Trajectory

METRIC = "ba_500x50k_3gn_seconds"
PG_ITERS, BA_ITERS = 4, 3  # Gauss-Newton iterations
INTRINSICS = CameraIntrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


@dataclasses.dataclass
class Problems:
    graph: pg.PoseGraph
    ground_truth: Transform  # (n,) the circle
    problem: ba.BAProblem

    def to(self, device) -> "Problems":
        g, p = self.graph, self.problem
        graph = pg.PoseGraph(g.nodes.to(device), g.edges.to(device), g.measurements.to(device), g.weights.to(device))
        problem = dataclasses.replace(
            p, poses=p.poses.to(device), landmarks=p.landmarks.to(device), obs_pose=p.obs_pose.to(device),
            obs_landmark=p.obs_landmark.to(device), obs_uv=p.obs_uv.to(device), weights=p.weights.to(device),
            obs_z=p.obs_z.to(device))
        return Problems(graph, self.ground_truth.to(device), problem)


def problems(n: int, m: int, o: int, seed: int = 11) -> Problems:
    """The JAX bench's pose graph of ``n`` poses and BA problem of ``n``
    poses, ``m`` landmarks and ``o`` observations, on the CPU."""
    rng = np.random.default_rng(seed)
    step = Transform.exp(torch.tensor([0.1, 0, 0, 0, 0, 2 * np.pi / n], dtype=torch.float32))
    gt = [Transform.identity()]
    for _ in range(n - 1):
        gt.append(gt[-1] @ step)
    est = [gt[0]]
    for k in range(n - 1):
        noise = Transform.exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32)))
        est.append(est[-1] @ ((gt[k].inverse() @ gt[k + 1]) @ noise))
    graph = pg.PoseGraph.from_trajectory(Trajectory(se3.stack(est), torch.arange(n, dtype=torch.float32)))
    for j in (n // 2, n - 1):
        graph = graph.with_edge(0, j, gt[0].inverse() @ gt[j], 10.0)

    landmarks_gt = torch.from_numpy(rng.uniform([-4, -4, 2.0], [4, 4, 8.0], (m, 3)).astype(np.float32))
    poses_gt = se3.stack(gt)
    obs_pose = torch.from_numpy(rng.integers(0, n, o).astype(np.int64))
    obs_landmark = torch.from_numpy(rng.integers(0, m, o).astype(np.int64))
    p_cam = poses_gt[obs_pose].inverse().apply(landmarks_gt[obs_landmark])
    z = p_cam[:, 2]
    uv = torch.stack([p_cam[:, 0] * INTRINSICS.fx / z + INTRINSICS.cx, p_cam[:, 1] * INTRINSICS.fy / z + INTRINSICS.cy],
                     dim=1)
    landmarks = landmarks_gt + torch.from_numpy(rng.normal(0, 0.05, (m, 3)).astype(np.float32))
    problem = ba.BAProblem(poses_gt, landmarks, obs_pose, obs_landmark, uv, torch.ones(o), INTRINSICS, obs_z=z)
    return Problems(graph, poses_gt, problem)


def run(argv=None) -> h.Outcome:
    ap = h.parser(__doc__.splitlines()[0], calls=1)
    ap.add_argument("--poses", type=int, default=500)
    ap.add_argument("--landmarks", type=int, default=50_000)
    ap.add_argument("--observations", type=int, default=200_000)
    ap.add_argument("--pg-cg-iters", type=int, default=768)
    ap.add_argument("--ba-cg-iters", type=int, default=32)
    args = h.parse(ap, argv)
    device = h.setup(args.device)
    probs = problems(args.poses, args.landmarks, args.observations).to(device)

    graph = h.measure(lambda: pg.optimize(probs.graph, iterations=PG_ITERS, solver="cg",
                                          cg_iters=args.pg_cg_iters), device, args)
    h.describe(f"pose graph, {args.poses} poses, {PG_ITERS} GN x {args.pg_cg_iters} CG, s", graph.summary(1, "s"), "s")
    bundle = h.measure(lambda: ba.optimize(probs.problem, iterations=BA_ITERS, solver="coo",
                                           cg_iters=args.ba_cg_iters), device, args)
    h.describe(f"BA {args.poses} x {args.landmarks} x {args.observations}, s", bundle.summary(1, "s"), "s")
    poses, landmarks = bundle.result
    rms = float(ba.mean_reprojection_error(dataclasses.replace(probs.problem, poses=poses, landmarks=landmarks)))
    pg_err = float(torch.linalg.norm(graph.result.translation - probs.ground_truth.translation, dim=-1).mean())
    line = h.record(METRIC, "s", bundle, device, poses=args.poses, landmarks=args.landmarks,
                    observations=args.observations, ba_rms_px=rms,
                    pose_graph_seconds=graph.summary(1, "s")["value"], pose_graph=graph.summary(1, "s"),
                    pose_graph_mean_translation_error=pg_err, pcg_trips=PG_ITERS * args.pg_cg_iters,
                    pg_cg_iters=args.pg_cg_iters, ba_cg_iters=args.ba_cg_iters)
    return h.Outcome(line, {"pose_graph": graph.result, "bundle_adjustment": bundle.result})


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
