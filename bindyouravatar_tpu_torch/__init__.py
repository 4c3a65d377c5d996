"""PyTorch/CUDA port of `bindyouravatar_tpu` for one NVIDIA H100.

Module paths and public names mirror the JAX package; `bindyouravatar_tpu`
stays the reference every module here is tested against.  This package
imports `torch` and never `jax`.
"""
