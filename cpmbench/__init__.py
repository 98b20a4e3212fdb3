"""The benchmark of the PyTorch and CUDA port (cpm_tpu_torch): run a cell with python3 cpmbench/run.py --workload NAME --seed N --seconds S --trace 0|1."""
