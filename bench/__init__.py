"""The serving benchmark of the PyTorch/CUDA port (``repro_torch``).

Run one cell with ``python3 bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``README.md``
says how the harness finds its configurations, traffic mixes and metrics.
"""
