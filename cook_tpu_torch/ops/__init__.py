"""Tensor ops of the port: plain PyTorch versions of the JAX package's
``cook_tpu.ops`` functions, and the CUDA stage kernels of the fused
scheduling cycle (``csrc/``, bound through ``cuda_lib``)."""
