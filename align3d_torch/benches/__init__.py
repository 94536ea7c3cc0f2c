"""The port's benches: one module per bench of the JAX package (``bench.py``
and ``benches/``), each printing one JSON line under the JAX metric name.

    python -m align3d_torch.benches.bench_image_icp [--device cpu] [--quick]

:mod:`_harness` times every bench the same way (CUDA events for wall time,
a host clock ended by a synchronise, ``torch.profiler`` for the device's
busy time, the kernels' launch counters against the launches the profiler
saw). Each bench runs on ``cuda`` unless ``--device cpu`` is given, takes
its sizes as flags (defaults: the JAX bench's), and ``--quick`` (two
repeats, one warm-up call) keeps the shapes. Each module's
``run(argv)`` prints the line and returns it with the bench's result, so a
caller can hold the result against the same port call made directly.

==============================  =======================================
module                          metric (the JAX bench's)
==============================  =======================================
``bench_image_icp``             ``image_icp_640x480_ms_per_pair``
``bench_icp_kernel``            ``kernel_only_v3_r2_us_per_pair_iter``
``bench_odometry``              ``odometry_e2e_640x480_ms_per_frame``
``bench_pcl_icp``               ``pcl_icp_100k_10iter_ms``
``bench_voxel_nn``              ``nn_500k_x_500k_ms``
``bench_mesh``                  ``mesh_normals_200k_faces_ms``
``bench_normals``               ``compute_normals_640x480_ms``
``bench_bilateral``             ``bilateral_filter_640x480_ms``
``bench_global_refine``         ``ba_500x50k_3gn_seconds``
``bench_scaling``               ``dp_odometry_weak_scaling_eff_2dev_pinned``
==============================  =======================================
"""

#: The bench modules, in the order of the users' costs (ROADMAP Queue 1).
BENCHES = ("bench_image_icp", "bench_icp_kernel", "bench_odometry", "bench_pcl_icp", "bench_voxel_nn",
           "bench_mesh", "bench_normals", "bench_bilateral", "bench_global_refine", "bench_scaling")
