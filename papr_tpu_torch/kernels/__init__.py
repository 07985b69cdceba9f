"""Build and load the CUDA kernels under ``papr_tpu_torch/csrc``."""
