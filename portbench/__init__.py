"""portbench: the benchmark of ``sdf_nmpc_tpu_torch`` (the PyTorch/CUDA
port) on one or four NVIDIA H100 cards.  ``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``; see
``harness.py``."""
