"""The benchmark of the PyTorch/CUDA port (`easysimp_tpu_torch`): one cell
per run, `python3 simpbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`.  It imports nothing of JAX or of the JAX package."""
