"""The benchmark of the PyTorch and CUDA port (`dsv2_tpu_torch`): see
BENCHMARK.json at the root and `codecbench/run.py`."""
