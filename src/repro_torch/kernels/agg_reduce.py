"""Server-aggregation reduce over the raveled client axis, with its CUDA
kernel ``csrc/fedavg_reduce.cu``.

Kernel (replaces ``repro/kernels/agg_reduce.py::_fedavg_kernel``):
Eq. 3 as one pass over the (C, P) client-delta matrix,
out[p] = Σ_c w_c · x[c, p]. A grid over P, each thread owning 4
consecutive outputs (read as one ``float4`` per client when P is a
multiple of 4, else one float), walking the clients in the fixed order
0..C−1: deterministic, no atomics, no padding of P (the last block masks
its tail). The TPU kernel's (C, bp) VMEM tile becomes a register
accumulator per thread.

What bounds it on the H100: bytes. It reads every delta once for one
FMA: 4·(C·P + P + C) bytes, 23.5 MB at the quickstart's
(C, P) = (10, 534016), about 7.0 µs at 3.35 TB/s. One launch per round.

The other reduce kernels of the reference (momentum, clip, quantize,
top-k, trimmed, pairwise) are not ported yet (ROADMAP queue A items 7
and 8).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ref import ref_fedavg_flat

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p]


def fedavg_reduce_flat(stacked: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """stacked (C, P) f32, weights (C,) f32 -> (P,) f32. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if stacked.dim() != 2 or weights.shape != stacked.shape[:1]:
        raise ValueError(f"fedavg_reduce shapes: stacked "
                         f"{tuple(stacked.shape)}, weights "
                         f"{tuple(weights.shape)}")
    if backend.on_cpu("fedavg_reduce", stacked, weights,
                      dtypes=(torch.float32, torch.float32)):
        return ref_fedavg_flat(stacked, weights)
    fn = backend.kernel("fedavg_reduce", "fedavg_reduce_launch", _ARGTYPES)
    c, p = stacked.shape
    out = torch.empty((p,), dtype=torch.float32, device=stacked.device)
    if p == 0:
        return out
    err = fn(stacked.data_ptr(), weights.data_ptr(), out.data_ptr(), c, p,
             backend.stream_ptr(stacked.device))
    backend.check(err, "fedavg_reduce")
    fedavg_reduce_flat.launches += 1
    return out


fedavg_reduce_flat.launches = 0
