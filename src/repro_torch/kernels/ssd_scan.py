"""Mamba2 SSD chunked scan, with its CUDA kernel ``csrc/ssd_scan.cu``.

Replaces ``repro/kernels/ssd_scan.py::_ssd_kernel`` (the ``pallas_call``
in ``ssd_scan_bhsp``). Per head, with a = −exp(A_log) and cs the
inclusive cumsum of dt·a over a chunk:

  scores(i, j) = (C_i·B_j) · exp(cs_i − cs_j) · dt_j        (j ≤ i)
  y_i   = Σ_j scores(i, j) x_j + exp(cs_i) · state·C_i + D x_i
  state = exp(cs_L) · state + Σ_j (x_j dt_j exp(cs_L − cs_j)) B_jᵀ

B and C are shared by every head (ngroups = 1). The kernel also writes
the final state (b, h, p, n) in f32 when asked: the decode cache of a
prefill, which the TPU kernel keeps in VMEM only.

Kernel: one block per (batch, head) walking the chunks in order, the
(p, n) state resident in shared memory; x and B of a chunk staged as
f32, the rows of C and of the scores in blocks of 32 (166 KB of shared
memory, sized for L 128, p 64, n 128 and zero past the call's), each
product a register tile per thread; the cumsum a warp scan.

What bounds it on the H100 SXM (data-sheet rates at its 700 W limit):
bytes. At mamba2-780m's prefill (b 4, s 2048, h 48, p 64, n 128, chunk
128, bf16) about 113 MB with the final state, 33.6 µs at 3.35 TB/s; the
22.6 GFLOP of the causal triangles and the state's products (32.2
counting the triangles in full) take 22.9 µs at the 989 TFLOP/s bf16
tensor-core rate. This kernel runs in f32 on the CUDA cores (67 TFLOP/s,
about 340 µs for the same work); tensor cores, a chunk-parallel state
pass and sharing C·Bᵀ across heads are later work. There is no
backward yet (ROADMAP A.8.5 / C.1): the wrapper refuses operands that
require grad while grad mode is on, on either device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ref import ref_ssd

DTYPES = (torch.float32, torch.bfloat16)
# the kernel's tiles: chunk L (its cumsum warps and score columns), head
# width p and state size n (mamba2-780m's 128, 64, 128)
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 128

_F32 = torch.float32
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _check(x, dt, A_log, B, C, D, chunk):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (b, s, h, p), got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (dt.shape != (b, s, h) or A_log.shape != (h,) or D.shape != (h,)
            or B.shape != (b, s, n) or C.shape != B.shape):
        raise ValueError(
            f"ssd_scan shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A_log {tuple(A_log.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}, D {tuple(D.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan: expected one of {DTYPES}, got "
                         f"{x.dtype}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"ssd_scan: chunk={chunk} must lie in [1, "
                         f"{MAX_CHUNK}] and divide s={s}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"ssd_scan: p={p} and n={n} must lie in [1, "
                         f"{MAX_P}] and [1, {MAX_N}] (the kernel's tiles)")


def ssd_scan_bhsp(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                  chunk: int = 128, return_state: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (b, s, h, p) and B/C (b, s, n) in one of f32 or bf16, dt
    (b, s, h), A_log and D (h,) in f32; s a multiple of ``chunk`` ->
    (y like x, the final state (b, h, p, n) f32 or None). CPU tensors
    take the plain version (``ref_ssd``); CUDA tensors launch the kernel
    or raise. Raises for operands that require grad under grad mode (no
    backward yet)."""
    _check(x, dt, A_log, B, C, D, chunk)
    backend.refuse_grad("ssd_scan_bhsp", x, dt, A_log, B, C, D)
    if backend.on_cpu("ssd_scan", x, B, C, dt, A_log, D,
                      dtypes=(x.dtype,) * 3 + (_F32,) * 3):
        y, state = ref_ssd(x, dt, A_log, B, C, D)
        return y, (state if return_state else None)
    b, s, h, p = x.shape
    n = B.shape[-1]
    fn = backend.kernel("ssd_scan", "ssd_scan_launch", _ARGTYPES)
    y = torch.empty_like(x)
    state = (torch.empty((b, h, p, n), dtype=_F32, device=x.device)
             if return_state else None)
    if b * h == 0:
        return y, state
    err = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
             C.data_ptr(), D.data_ptr(), y.data_ptr(),
             0 if state is None else state.data_ptr(), b, s, h, p, n, chunk,
             DTYPES.index(x.dtype), backend.stream_ptr(x.device))
    backend.check(err, "ssd_scan")
    ssd_scan_bhsp.launches += 1
    return y, state


ssd_scan_bhsp.launches = 0
