"""The fused forward of the space-to-depth Nature CNN, as hand-written CUDA kernels.

Replaces the Pallas kernel ``_fwd_kernel`` of ``baselines_tpu/ops/fused_cnn.py``
(reached there through ``fused_cnn_forward`` -> ``_fused_fwd``). It computes the whole
``NatureCNNS2D(dtype=bfloat16)`` forward: u8 frames x 1/255 -> bf16 -> three convs and
the 3136->512 dense layer, each with f32 accumulation, bias and relu in f32 and bf16
between layers; only the f32 latent is written.

What bounds it on an H100: 18.69 MFLOP a sample against 30 KB of input and output and
3.37 MB of weights, so the weights' bytes bound it at deepq's batch of 64 (1.6 us) and
tensor-core operations at the rollout's batch of 256 (4.8 us) and above. The kernel
(``csrc/fused_cnn.cu``) is two launches under this one call (``conv_stage`` and
``dense_stage``, which ``chip_smoke.py`` also times apart): a conv stage, one sample a
block with each layer's weights staged in shared memory and every fragment loaded by
``ldmatrix``, writes the bf16 conv3 output to a scratch tensor; a dense stage, a tiled
GEMM whose depth is split over a thread-block cluster at small batch, reads it. See the
source for the tiling. The Pallas kernel's (H, W, B, C) layout was forced by the TPU
compiler and is not carried over: the kernel reads the u8 NHWC frames as they are.

``pack_params`` lays the module's weights out for the kernel once; the rollout packs
them once for each rollout and reuses them at every step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from baselines_tpu_torch.ops import cuda_lib

H0, W0, C0 = 21, 21, 64
C1, C2, C3 = 32, 64, 64
FC_IN, FC_OUT = 7 * 7 * 64, 512
INV255 = 1.0 / 255.0
MAX_BATCH = 65535 * 64  # the dense stage's grid takes 65535 tiles of 64 samples

# (shape, dtype) of each packed weight, in the kernel's argument order
PACKED_LAYOUT = (
    ((4, C1, C0), torch.bfloat16), ((C1,), torch.float32),
    ((16, C2, C1), torch.bfloat16), ((C2,), torch.float32),
    ((9, C3, C2), torch.bfloat16), ((C3,), torch.float32),
    ((FC_OUT, FC_IN), torch.bfloat16), ((FC_OUT,), torch.float32),
)


def pack_params(net) -> tuple:
    """A NatureCNNS2D's params as the kernel takes them: conv weights tap-major
    (k*k, Cout, Cin) in bf16, the dense weight (512, 3136) in bf16, biases in f32."""

    def taps(conv):
        w = conv.weight.detach()  # (Cout, Cin, k, k)
        cout, cin, kh, kw = w.shape
        return w.permute(2, 3, 0, 1).reshape(kh * kw, cout, cin).to(torch.bfloat16).contiguous()

    def bias(layer):
        return layer.bias.detach().to(torch.float32).contiguous()

    return (
        taps(net.c1), bias(net.c1), taps(net.c2), bias(net.c2), taps(net.c3), bias(net.c3),
        net.fc1.weight.detach().to(torch.bfloat16).contiguous(), bias(net.fc1),
    )


def reference_forward(x: torch.Tensor, packed: tuple) -> torch.Tensor:
    """The plain version: the kernel's arithmetic in PyTorch ops. bf16 operands are
    held in f32, so every product is exact and every sum is taken in f32, as the
    kernel's f32 accumulation does (a float32 convolution may run in TF32 on the card,
    which keeps bf16 operands exact too)."""
    w1, b1, w2, b2, w3, b3, wfc, bfc = packed
    h = (x.permute(0, 3, 1, 2).to(torch.float32) * INV255).to(torch.bfloat16).to(torch.float32)

    def conv(h, w, b, k, stride):
        weight = w.to(torch.float32).reshape(k, k, w.shape[1], w.shape[2]).permute(2, 3, 0, 1)
        z = F.conv2d(h, weight, stride=stride) + b.view(1, -1, 1, 1)
        return torch.relu(z).to(torch.bfloat16).to(torch.float32)

    h = conv(h, w1, b1, 2, 1)
    h = conv(h, w2, b2, 4, 2)
    h = conv(h, w3, b3, 3, 1)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], FC_IN)
    return torch.relu(h @ wfc.to(torch.float32).t() + bfc)


def _check(x: torch.Tensor, packed: tuple) -> None:
    if x.dtype != torch.uint8 or x.dim() != 4 or tuple(x.shape[1:]) != (H0, W0, C0):
        raise ValueError(f"fused_cnn_forward takes u8 (B, {H0}, {W0}, {C0}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[0] == 0 or not x.is_contiguous():
        raise ValueError("fused_cnn_forward takes a non-empty contiguous batch")
    if len(packed) != len(PACKED_LAYOUT):
        raise ValueError(f"expected {len(PACKED_LAYOUT)} packed weights, got {len(packed)}")
    for i, (p, (shape, dtype)) in enumerate(zip(packed, PACKED_LAYOUT)):
        if tuple(p.shape) != shape or p.dtype != dtype or not p.is_contiguous():
            raise ValueError(f"packed weight {i}: expected contiguous {dtype} {shape}, got "
                             f"{p.dtype} {tuple(p.shape)}")
        if p.device != x.device:
            raise ValueError(f"packed weight {i} is on {p.device}, x on {x.device}")


def fused_cnn_forward(x: torch.Tensor, packed: tuple) -> torch.Tensor:
    """(B, 21, 21, 64) u8 frames -> (B, 512) f32 latent of NatureCNNS2D in bf16.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs the plain
    version."""
    _check(x, packed)
    if x.device.type == "cpu":
        return reference_forward(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_cnn_forward runs on cuda or cpu, not {x.device}")
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"fused_cnn_forward takes at most {MAX_BATCH} samples a call")
    if any(t.data_ptr() % 16 for t in (x, *packed)):
        raise ValueError("fused_cnn_forward needs 16-byte aligned input and weights")
    a3 = torch.empty((x.shape[0], FC_IN), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((x.shape[0], FC_OUT), dtype=torch.float32, device=x.device)
    conv_stage(x, packed, a3)
    dense_stage(a3, packed, out)
    fused_cnn_forward.launches += 1
    return out


fused_cnn_forward.launches = 0


def conv_stage(x: torch.Tensor, packed: tuple, a3: torch.Tensor) -> None:
    """The kernel's first launch, x -> bf16 (B, 3136) conv3 output in a3, on arguments
    ``fused_cnn_forward`` has checked. Not counted: a call of the op counts once."""
    w1, b1, w2, b2, w3, b3 = (p.data_ptr() for p in packed[:6])
    err = cuda_lib.library().btt_fused_cnn_conv(
        x.data_ptr(), w1, b1, w2, b2, w3, b3, a3.data_ptr(), x.shape[0],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(err, "fused_cnn_forward conv stage")


def dense_stage(a3: torch.Tensor, packed: tuple, out: torch.Tensor) -> None:
    """The kernel's second launch, a3 -> f32 (B, 512) latent in out. Not counted."""
    err = cuda_lib.library().btt_fused_cnn_dense(
        a3.data_ptr(), packed[6].data_ptr(), packed[7].data_ptr(), out.data_ptr(), a3.shape[0],
        torch.cuda.current_stream(a3.device).cuda_stream,
    )
    cuda_lib.check(err, "fused_cnn_forward dense stage")
