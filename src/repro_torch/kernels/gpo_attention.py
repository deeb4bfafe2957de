"""GPO neural-process attention, forward and backward, with its CUDA
kernels ``csrc/gpo_attention_fwd.cu`` and ``csrc/gpo_attention_bwd.cu``,
tied together by the ``GPOAttention`` autograd Function.

The mask: context tokens (the first ``num_ctx``) attend to all context
tokens; target tokens attend to the context tokens and to themselves,
never to other targets.

Forward kernel (replaces ``repro/kernels/gpo_attention.py::
_gpo_fwd_kernel``): one block per (batch·head, 64 query rows), one
thread per query row. The block walks only the context keys
``[0, num_ctx)``, 32 at a time, staged in shared memory, keeping the
online-softmax state (running max m, sum l, the hd-wide accumulator) in
registers; after the walk each target row adds its own key once. That
is the TPU kernel's band (context tiles plus the diagonal) as a loop
inside the block: no S×S score tensor and no target×target key is ever
touched. Scores scale by 1/√hd, ``l`` clamps at 1e-30 and
``lse = m + log l``, as in the TPU kernel; the backward reuses lse.

Backward kernels (replace ``_gpo_bwd_dq_kernel`` and
``_gpo_bwd_dkdv_kernel``): ``delta = rowsum(do·o)`` is computed in plain
PyTorch, as the reference computes it outside any Pallas kernel; then
dq walks the forward's band per query row, and dk/dv the transposed
band per key row (a context key sweeps all S query rows, a target key
takes only its own query). Each recomputes p = exp(s − lse) from q and
k. One thread owns one output row: no atomics, and a result depends on
neither the grid order nor the batch.

What bounds them on the H100: at the training shapes (BH = 10 clients ×
4 heads = 40, S = 160, num_ctx = 80, hd = 32) q/k/v/do are 3.3 MB and
the band is 0.1 GFLOP per kernel, each about a microsecond or two of
the card's bytes or f32 rate, so a call is bound by its launch and its
per-row serial walk. The simple design keeps it to one launch per layer
and direction over all clients and heads and never materialises scores;
it leaves most SMs idle (S/64·BH blocks of 64 threads), which a later
PR can fix with more rows per block and tensor-core tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ref import (
    ref_gpo_attention,
    ref_gpo_attention_bwd_dkdv,
    ref_gpo_attention_bwd_dq,
)

HEAD_DIMS = (24, 32)  # head widths the CUDA sources instantiate

_F32 = torch.float32
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DKDV_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


def _check_shapes(q, k, v, num_ctx, *rest):
    if q.dim() != 3 or any(t.shape != q.shape for t in (k, v, *rest)):
        raise ValueError(f"gpo_attention shapes: q {tuple(q.shape)}, "
                         f"others {[tuple(t.shape) for t in (k, v, *rest)]}")
    s = q.shape[1]
    if not 0 <= num_ctx <= s:
        raise ValueError(f"num_ctx={num_ctx} outside [0, {s}]")


def _check_head_dim(hd: int) -> None:
    if hd not in HEAD_DIMS:
        raise ValueError(f"gpo_attention kernels are built for head_dim in "
                         f"{HEAD_DIMS}, got {hd}")


def gpo_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_ctx: int):
    """q/k/v (BH, S, hd) f32 -> (o (BH, S, hd), lse (BH, S) f32). CPU
    tensors take the plain version; CUDA tensors launch the kernel. The
    outputs carry no autograd history: differentiate through
    ``GPOAttention`` (``ops.gpo_attention``)."""
    _check_shapes(q, k, v, num_ctx)
    bh, s, hd = q.shape
    if backend.on_cpu("gpo_attention", q, k, v, dtypes=(_F32,) * 3):
        return ref_gpo_attention(q, k, v, num_ctx=num_ctx)
    _check_head_dim(hd)
    fn = backend.kernel("gpo_attention_fwd", "gpo_attention_fwd_launch",
                        _FWD_ARGTYPES)
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=_F32, device=q.device)
    if bh == 0 or s == 0:
        return o, lse
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), bh, s, num_ctx, hd, backend.stream_ptr(q.device))
    backend.check(err, "gpo_attention_fwd")
    gpo_attention_fwd.launches += 1
    return o, lse


def _bwd_operands(what, q, k, v, do, lse, delta, num_ctx) -> bool:
    """Shapes and the operand contract of a backward kernel; True when
    the operands lie on the CPU."""
    _check_shapes(q, k, v, num_ctx, do)
    if lse.shape != q.shape[:2] or delta.shape != q.shape[:2]:
        raise ValueError(f"{what}: lse {tuple(lse.shape)} and delta "
                         f"{tuple(delta.shape)} must be {tuple(q.shape[:2])}")
    return backend.on_cpu(what, q, k, v, do, lse, delta, dtypes=(_F32,) * 6)


def gpo_attention_bwd_dq(q, k, v, do, lse, delta, *,
                         num_ctx: int) -> torch.Tensor:
    """dq (BH, S, hd) from q/k/v/do (BH, S, hd) and the forward's lse
    and delta = rowsum(do·o), each (BH, S). CPU tensors take the plain
    version; CUDA tensors launch the dq kernel."""
    if _bwd_operands("gpo_attention_bwd_dq", q, k, v, do, lse, delta,
                     num_ctx):
        return ref_gpo_attention_bwd_dq(q, k, v, do, lse, delta,
                                        num_ctx=num_ctx)
    bh, s, hd = q.shape
    _check_head_dim(hd)
    fn = backend.kernel("gpo_attention_bwd", "gpo_attention_bwd_dq_launch",
                        _DQ_ARGTYPES)
    dq = torch.empty_like(q)
    if bh == 0 or s == 0:
        return dq
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, num_ctx,
             hd, backend.stream_ptr(q.device))
    backend.check(err, "gpo_attention_bwd_dq")
    gpo_attention_bwd_dq.launches += 1
    return dq


def gpo_attention_bwd_dkdv(q, k, v, do, lse, delta, *, num_ctx: int):
    """(dk, dv), each (BH, S, hd), from the same operands as
    ``gpo_attention_bwd_dq``. CPU tensors take the plain version; CUDA
    tensors launch the dk/dv kernel."""
    if _bwd_operands("gpo_attention_bwd_dkdv", q, k, v, do, lse, delta,
                     num_ctx):
        return ref_gpo_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                          num_ctx=num_ctx)
    bh, s, hd = q.shape
    _check_head_dim(hd)
    fn = backend.kernel("gpo_attention_bwd", "gpo_attention_bwd_dkdv_launch",
                        _DKDV_ARGTYPES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if bh == 0 or s == 0:
        return dk, dv
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             bh, s, num_ctx, hd, backend.stream_ptr(q.device))
    backend.check(err, "gpo_attention_bwd_dkdv")
    gpo_attention_bwd_dkdv.launches += 1
    return dk, dv


gpo_attention_fwd.launches = 0
gpo_attention_bwd_dq.launches = 0
gpo_attention_bwd_dkdv.launches = 0


class GPOAttention(torch.autograd.Function):
    """Differentiable banded attention on (BH, S, hd): the forward
    kernel saves (q, k, v, o, lse); the backward computes
    delta = rowsum(do·o) and launches the dq and dk/dv kernels. On CPU
    tensors both directions run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, num_ctx: int):
        o, lse = gpo_attention_fwd(q, k, v, num_ctx=num_ctx)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_ctx = num_ctx
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do * o).sum(dim=-1)
        dq = gpo_attention_bwd_dq(q, k, v, do, lse, delta,
                                  num_ctx=ctx.num_ctx)
        dk, dv = gpo_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                        num_ctx=ctx.num_ctx)
        return dq, dk, dv, None
