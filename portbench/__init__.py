"""The benchmark of tpurast_torch, the PyTorch and CUDA port of tpurast.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of BENCHMARK.json once (portbench/run.py). README.md says how
a configuration, a traffic mix or a metric is added as files.
"""
