"""Command-line tools of the port (python -m tpurast_torch.tools.<name>).

Device probes, on an NVIDIA GPU: microbench (gather, table size, sort,
scatter, shading decomposition, on-chip table take) and
microbench_pipeline (launch geometry of a G-buffer plane copy).

Analysis tools, counterparts of the reference's tools/ scripts under the
same names (--scene orbit and --device cuda by default; --device cpu runs
the plain versions): profile_stages, sample_stage_probe, profile_sampler,
sampler_plan_stats, check_sampler, aniso_mode_stats, residual_analysis
and sampler_sim; and the pose tools, fit_pose (a camera pose fitted to a
screenshot by a random mask search) and parity_render (the fitted poses
rendered beside their screenshots). Each has a function that takes a
scene already built, for chip_smoke.py and the tests.
"""
