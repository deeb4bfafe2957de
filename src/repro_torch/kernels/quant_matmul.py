"""Int8 weight-only inference matmul (DESIGN.md §12), with its CUDA
kernel ``csrc/int8_matmul.cu``.

Inference quantizes each dense weight per *output channel*
(scale_n = max_k |W[k, n]| / 127, floored at 1e-30) with round-to-
nearest, and computes  out = (x @ q_f32) * scale  with the scale applied
after the reduction over k.

Kernel (replaces ``repro/kernels/quant_matmul.py::_int8_matmul_kernel``),
shaped for latency, since the serving shapes are too small to be bound
by bytes or operations: 16×32 output tiles, so the engine step's
(320, 128) × (128, 256) launches 160 blocks on the 132 SMs; K in
128-deep chunks staged in shared memory by ``cp.async`` with 16-byte
copies (a float4 of x, 16 int8 of q), two chunks in flight, so K ≤ 256
is one load phase and K = 4098 (the paper's d_embed 4096 + 2) streams
through the two stages; 128 threads, each 4×4 outputs over a quarter of
K, the four partial sums added by a fixed xor butterfly; q widened to
f32 in registers by byte permutes, exactly. All three edges are masked
in the kernel; operands whose rows do not allow 16-byte copies (K not a
multiple of 4, N not of 16, as the head's N = 1) take narrower ones.
No atomics and no split of K across warps or blocks: each output is
summed in a fixed order that depends only on K, so a row's result does
not depend on M or on the other rows (the serving cache's hit == miss
contract).

What bounds it on the H100: at the serving shapes (M ≤ 1280, K ≤ 256,
N ≤ 256) one call moves at most ~2 MB and does at most ~168 MFLOP: at
the engine's decode step (320, 128) × (128, 256), 21 MFLOP, 0.31 µs of
f32 CUDA-core work (67 TFLOP/s) and less of bytes, so launch latency,
the load's round trip and the number of blocks in flight set its time;
at the corner of that range, (1280, 256) × (256, 256), the operations,
2.5 µs. The engine step's int8 time is its launch count, which a CUDA graph
of the step (later work) would cut.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import backend
# the symmetric-quantization contract of the transport codec: 127
# levels, floored scale
from repro_torch.kernels.agg_reduce import INT8_LEVELS, _SCALE_FLOOR
from repro_torch.kernels.ref import ref_int8_matmul


class QuantizedLinear(NamedTuple):
    """An int8-quantized dense weight: ``q`` int8 with the original
    weight's shape (..., K, N), ``scale`` f32 (..., N) per-output-channel
    dequantization scales. Leading dims (the stacked-layer axis) are
    carried through; index both to get one layer's (K, N) / (N,)."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_linear(w: torch.Tensor) -> QuantizedLinear:
    """Per-output-channel symmetric int8 quantization of a dense weight
    (..., K, N), round half to even. Bit-equal to the JAX package's."""
    x = w.float()
    scale = torch.clamp(x.abs().amax(dim=-2) / INT8_LEVELS, min=_SCALE_FLOOR)
    q = torch.clamp(torch.round(x / scale[..., None, :]),
                    -INT8_LEVELS, INT8_LEVELS)
    return QuantizedLinear(q=q.to(torch.int8), scale=scale)


def dequantize_linear(ql: QuantizedLinear) -> torch.Tensor:
    """(..., K, N) f32 reconstruction."""
    return ql.q.float() * ql.scale[..., None, :]


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def int8_matmul_flat(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32, q (K, N) int8, scale (N,) f32 -> (M, N) f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0] \
            or scale.shape != (q.shape[1],):
        raise ValueError(f"int8_matmul shapes: x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    if backend.on_cpu("int8_matmul", x, q, scale,
                      dtypes=(torch.float32, torch.int8, torch.float32)):
        return ref_int8_matmul(x, q, scale)
    fn = backend.kernel("int8_matmul", "int8_matmul_launch", _ARGTYPES)
    m, k = x.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out.zero_()
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
             m, n, k, backend.stream_ptr(q.device))
    backend.check(err, "int8_matmul")
    int8_matmul_flat.launches += 1
    return out


int8_matmul_flat.launches = 0
