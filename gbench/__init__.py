"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell run
once by ``python gbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. ``BENCHMARK.json`` at the root
names the cells; everything a cell needs is found by name under this folder
(``configs/``, ``traffic/``, ``generators/``, ``queries/``, ``metrics/``)."""
