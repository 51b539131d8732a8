"""The port's hand-written CUDA kernels for the JAX package's Pallas kernels, each with
its plain PyTorch version for CPU tensors (counterpart of baselines_tpu/ops/__init__.py,
with the same export)."""

from baselines_tpu_torch.ops.gather import take_rows  # noqa: F401
