"""PyTorch and CUDA port of baselines_tpu, for an NVIDIA H100.

The package mirrors ``baselines_tpu``'s layout (``envs/``, ``nn/``, ``data/``, ``ops/``,
``algos/``, ``core/``) and keeps its array layouts at the public functions: observations
NHWC u8, rollout arrays time-major (T, N). It imports torch and numpy and nothing of JAX
or of ``baselines_tpu``. The kernels that ``baselines_tpu`` wrote in Pallas for the TPU
are CUDA C++ under ``csrc/``, built with nvcc at first use (``ops/cuda_lib.py``).
"""
