"""Command-line probes of the port on an NVIDIA GPU (python -m
tpurast_torch.tools.<name>): microbench (gather, table size, sort,
scatter, shading decomposition, on-chip table take) and
microbench_pipeline (launch geometry of a G-buffer plane copy)."""
