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

What bounds it on the H100 SXM (data-sheet rates at its 700 W limit):
bytes. At mamba2-780m's prefill (b 4, s 2048, h 48, p 64, n 128, chunk
128, bf16) about 113 MB with the final state, 33.6 µs at 3.35 TB/s; the
22.6 GFLOP of the causal triangles and the state's products (32.2
counting the triangles in full) take 22.9 µs at the 989 TFLOP/s bf16
tensor-core rate.

bf16 operands reach the tensor-core kernel: the four products on
``mma.sync`` m16n8k16 bf16 → f32. x, B and C are exact bf16 operands;
the three f32 operands (the scores, the state, x·dt·exp(cs_L − cs_j))
go in as a hi and a lo bf16 part, two mmas into one f32 accumulator
(about 16 bits of each). The scores stay in registers (the C·Bᵀ
accumulator, scaled and masked, is the A fragment of scores·x); the
state is f32 in registers across the scan, with a hi/lo bf16 copy in
shared memory for the next chunk's C·stateᵀ; the next chunk's x, B, C
and dt arrive by ``cp.async`` into a second stage while this one
computes. ~40 GFLOP of mma work at the shape above (the lo terms and
the causal band in 16-row tiles). A block takes a (batch, head) and
32 or 64 columns of p (``p_width_for``'s choice from the grid and the
card), recomputing C·Bᵀ per slice, so that batch 1 fills the card too.
The width changes no result.

Neither kernel caps the chunk, p or n (device memory is the only
limit); their tiles are 128 rows, 64 (f32) or 32/64 (bf16) columns of p
and 128 of n:

* a chunk of L > 128 rows runs as ⌈L/128⌉ tiles of at most 128 rows in
  order, the state carried from one to the next: the same function as
  the reference's one L-row piece, exact up to rounding (the chunked
  scan is an exact rewrite of the recurrence at any chunk);
* p runs in slices across blocks (the bf16 kernel's ``p_width_for``,
  the f32 kernel's 64), the rows of p independent in y and the state;
* n > 128 runs in 128-wide slices across blocks: C·Bᵀ and C·stateᵀ are
  sums over n and the state's columns are independent, so each slice
  writes its share of y (without D·x) in f32 to a scratch of
  ⌈n/128⌉·b·s·h·p floats, and one more launch adds them in slice order
  with D·x and rounds y once. At n ≤ 128 there is no scratch and no
  second launch.

f32 operands reach the original CUDA-core kernel, unchanged: one block
per (batch, head), the (p, n) state resident in shared memory, each
product a register tile per thread (about 340 µs of f32 work at the
shape above; TF32 mma would not hold the f32 tolerances).

There is no backward, as the reference has none (ROADMAP C.1): the
wrapper refuses operands that require grad while grad mode is on, on
either device; LM training takes the plain branch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ref import ref_ssd

DTYPES = (torch.float32, torch.bfloat16)
# the columns of n a block takes (kMaxN in the source, mamba2-780m's
# n); a wider n runs in slices of it
TILE_N = 128

# the columns of p a block of the bf16 kernel may take
P_WIDTHS = (64, 32)

_F32 = torch.float32
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def p_width_for(b: int, h: int, p: int, sms: int) -> int:
    """The columns of p a block of the bf16 kernel takes: the narrowest
    of ``P_WIDTHS`` whose b·h·⌈p/width⌉ blocks fit in one wave on the
    card's ``sms`` multiprocessors (one block an SM), else the narrowest
    that covers p in one slice. A block's time is mostly its C·Bᵀ and
    its chunk chain, whatever its width, so splitting p pays only while
    it fills idle SMs (PERF.md §6, the SSD rows)."""
    widest = min((w for w in P_WIDTHS if w >= p), default=max(P_WIDTHS))
    for w in sorted(P_WIDTHS):
        if w <= widest and b * h * -(-p // w) <= sms:
            return w
    return widest


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
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan: chunk={chunk} must be >= 1 and "
                         f"divide s={s}")
    if p < 1 or n < 1:
        raise ValueError(f"ssd_scan: p={p} and n={n} must be >= 1")


def ssd_scan_bhsp(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                  chunk: int = 128, return_state: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (b, s, h, p) and B/C (b, s, n) in one of f32 or bf16, dt
    (b, s, h), A_log and D (h,) in f32; s a multiple of ``chunk`` ->
    (y like x, the final state (b, h, p, n) f32 or None). CPU tensors
    take the plain version (``ref_ssd``); CUDA tensors launch the kernel
    (bf16 the tensor-core one, f32 the CUDA-core one) or raise.
    Raises for operands that require grad under grad mode (no backward
    yet)."""
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
    p_width = p_width_for(b, h, p, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    # n > TILE_N: each n slice's share of y, added up by a second launch
    slices = -(-n // TILE_N)
    part = (torch.empty((slices * b * s * h * p,), dtype=_F32,
                        device=x.device) if slices > 1 else None)
    err = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
             C.data_ptr(), D.data_ptr(), y.data_ptr(),
             0 if state is None else state.data_ptr(),
             0 if part is None else part.data_ptr(), b, s, h, p, n, chunk,
             DTYPES.index(x.dtype), p_width, backend.stream_ptr(x.device))
    backend.check(err, "ssd_scan")
    ssd_scan_bhsp.launches += 1
    return y, state


ssd_scan_bhsp.launches = 0
