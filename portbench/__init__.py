"""The PyTorch/CUDA port's benchmark (``BENCHMARK.json``): run a cell with
``python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1``."""
