"""GPO neural-process attention, forward and backward, with its CUDA
kernels ``csrc/gpo_attention_fwd.cu`` and ``csrc/gpo_attention_bwd.cu``,
tied together by the ``GPOAttention`` autograd Function.

The mask: context tokens (the first ``num_ctx``) attend to all context
tokens; target tokens attend to the context tokens and to themselves,
never to other targets.

Forward kernel (replaces ``repro/kernels/gpo_attention.py::
_gpo_fwd_kernel``): a block of four warps per (batch·head, 16 query
rows) streams only the context keys ``[0, num_ctx)`` through shared
memory (``cp.async``, 32 keys a stage, a ring of four stages), each warp
8 keys of a stage: S = Q·Kᵀ and acc += P·V on the tensor cores in
3xTF32, with an online softmax (running max m and sum l) per row over
the warp's own keys. The four warps' (m, l, acc) are merged in warp
order, then each target row adds its own key once on the CUDA cores.
That is the TPU kernel's band (context tiles plus the diagonal): no S×S
score tensor and no target×target key is ever touched. Scores scale by
1/√hd, the mask value is −1e30, ``l`` clamps at 1e-30 and
``lse = m + log l``, as in the TPU kernel; the backward reuses lse.

Backward kernels (replace ``_gpo_bwd_dq_kernel`` and
``_gpo_bwd_dkdv_kernel``): ``delta = rowsum(do·o)`` is computed in plain
PyTorch, as the reference computes it outside any Pallas kernel; then
two launches recompute p = exp(s − lse) from q and k. Every product
(q·kᵀ, do·vᵀ, ds·k, dsᵀ·q, pᵀ·do), as the forward's, runs on the tensor
cores as ``mma.sync`` m16n8k8 TF32 in 3xTF32 (``csrc/gpo_tiles.cuh``
holds the schedule both directions share): each f32 operand is split into
big + small TF32 values and three products are summed, in short chains
whose results are added in f32, which keeps the plain f32 version's
accuracy (one TF32 pass would not; see
``tests/test_torch_gpo_fwd_numerics.py`` and
``tests/test_torch_gpo_bwd_numerics.py``). dq: a block of four warps
per (batch·head, 16 query rows) streams the context keys through
shared memory (``cp.async``, a ring of four stages, three in flight),
each warp 8 keys of a stage; the warps' partial dq tiles are summed in
a fixed order and each target row adds its own key on the CUDA cores.
dk/dv: a block per (batch·head, 16 context keys) streams all S query
rows the same way, keys in the mma's M; target keys, each read by its
own query alone, take an elementwise pass in extra blocks of the same
launch. No atomics: a result is bit-equal from call to call and does
not depend on the batch.

Head widths: the sources build every kernel at the widths
``HEAD_WIDTHS`` (multiples of 8, the mma's k-step, up to
``MAX_HEAD_DIM``). ``head_width_for(hd)`` is the padding plan: a head
of another width goes to the kernels padded with zero columns to the
next built width (zero columns add nothing to q·kᵀ; the scale stays
1/√hd of the head's own width, which the C entries take beside the
built width), and the padded columns of o, dq, dk and dv are sliced
off. hd 24 and 32 are built widths and go unpadded. Past 64 a block
owns a slab of the output's columns and splits its A fragments from
shared memory at each use (``csrc/gpo_tiles.cuh``). A head wider than
``MAX_HEAD_DIM`` is refused on both devices.

What bounds them on the H100: at the training shapes (BH = 10 clients ×
4 heads = 40, S = 160, num_ctx = 80, hd = 32) the bound is 0.99 µs
(forward), 1.24 µs (dq) and 1.48 µs (dk/dv), set by the bytes (the
three TF32 passes of their products take 0.4, 0.6 and 0.8 µs at the
dense TF32 rate). None sets the pace: a call takes one block's latency
(its stages in a row, each a chain of dependent ``mma.sync`` and an
exp) plus the instruction issue of the TF32 splits, with 3–4 warps an
SM sub-partition (``PERF.md`` §6). A q, k, v or do whose start lies
off a 16-byte step of its storage is refused on both devices
(``cp.async``).
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

# the head widths the CUDA sources build (GPO_WIDTHS in
# csrc/gpo_tiles.cuh), and the widest head the wrappers take
HEAD_WIDTHS = (8, 16, 24, 32, 40, 48, 56, 64, 96, 128, 192, 256)
MAX_HEAD_DIM = HEAD_WIDTHS[-1]

_F32 = torch.float32
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DKDV_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def _check_shapes(q, k, v, num_ctx, *rest):
    if q.dim() != 3 or any(t.shape != q.shape for t in (k, v, *rest)):
        raise ValueError(f"gpo_attention shapes: q {tuple(q.shape)}, "
                         f"others {[tuple(t.shape) for t in (k, v, *rest)]}")
    s = q.shape[1]
    if not 0 <= num_ctx <= s:
        raise ValueError(f"num_ctx={num_ctx} outside [0, {s}]")


def head_width_for(hd: int) -> int:
    """The padding plan: the built width (``HEAD_WIDTHS``) that a head of
    width hd runs at, the smallest at least hd. Raises outside 1 to
    ``MAX_HEAD_DIM``."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"gpo_attention kernels take head_dim 1 to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    return next(w for w in HEAD_WIDTHS if w >= hd)


def _padded(width: int, *ts: torch.Tensor):
    """Each (BH, S, hd) operand with zero columns up to ``width``."""
    hd = ts[0].shape[-1]
    if width == hd:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, width - hd)) for t in ts)


def _sliced(hd: int, *ts: torch.Tensor):
    """Each (BH, S, width) result cut back to its first hd columns."""
    if ts[0].shape[-1] == hd:
        return ts
    return tuple(t[..., :hd].contiguous() for t in ts)


def _check_aligned(what: str, **operands: torch.Tensor) -> None:
    """The kernels copy (S, hd) slabs 16 bytes at a time (cp.async); both
    allocators align a storage's start further, so a view that starts a
    whole number of 4 floats into its storage is aligned. Checked on
    both devices, so the CPU tests see what the card would refuse."""
    for name, t in operands.items():
        if t.storage_offset() % 4:
            raise ValueError(f"{what}: {name} starts {t.storage_offset()} "
                             "floats into its storage; the kernels need "
                             "a multiple of 4 (16-byte aligned)")


def gpo_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_ctx: int):
    """q/k/v (BH, S, hd) f32 -> (o (BH, S, hd), lse (BH, S) f32). CPU
    tensors take the plain version; CUDA tensors launch the kernel. The
    outputs carry no autograd history: differentiate through
    ``GPOAttention`` (``ops.gpo_attention``)."""
    _check_shapes(q, k, v, num_ctx)
    bh, s, hd = q.shape
    width = head_width_for(hd)
    cpu = backend.on_cpu("gpo_attention", q, k, v, dtypes=(_F32,) * 3)
    _check_aligned("gpo_attention_fwd", q=q, k=k, v=v)
    if cpu:
        return ref_gpo_attention(q, k, v, num_ctx=num_ctx)
    fn = backend.kernel("gpo_attention_fwd", "gpo_attention_fwd_launch",
                        _FWD_ARGTYPES)
    q, k, v = _padded(width, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=_F32, device=q.device)
    if bh == 0 or s == 0:
        return _sliced(hd, o)[0], lse
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), bh, s, num_ctx, hd, width,
             backend.stream_ptr(q.device))
    backend.check(err, "gpo_attention_fwd")
    gpo_attention_fwd.launches += 1
    return _sliced(hd, o)[0], lse


def _bwd_operands(what, q, k, v, do, lse, delta, num_ctx) -> bool:
    """Shapes and the operand contract of a backward kernel; True when
    the operands lie on the CPU."""
    _check_shapes(q, k, v, num_ctx, do)
    if lse.shape != q.shape[:2] or delta.shape != q.shape[:2]:
        raise ValueError(f"{what}: lse {tuple(lse.shape)} and delta "
                         f"{tuple(delta.shape)} must be {tuple(q.shape[:2])}")
    head_width_for(q.shape[-1])
    cpu = backend.on_cpu(what, q, k, v, do, lse, delta, dtypes=(_F32,) * 6)
    _check_aligned(what, q=q, k=k, v=v, do=do)
    return cpu


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
    width = head_width_for(hd)
    fn = backend.kernel("gpo_attention_bwd", "gpo_attention_bwd_dq_launch",
                        _DQ_ARGTYPES)
    q, k, v, do = _padded(width, q, k, v, do)
    dq = torch.empty_like(q)
    if bh == 0 or s == 0:
        return _sliced(hd, dq)[0]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, num_ctx,
             hd, width, backend.stream_ptr(q.device))
    backend.check(err, "gpo_attention_bwd_dq")
    gpo_attention_bwd_dq.launches += 1
    return _sliced(hd, dq)[0]


def gpo_attention_bwd_dkdv(q, k, v, do, lse, delta, *, num_ctx: int):
    """(dk, dv), each (BH, S, hd), from the same operands as
    ``gpo_attention_bwd_dq``. CPU tensors take the plain version; CUDA
    tensors launch the dk/dv kernel."""
    if _bwd_operands("gpo_attention_bwd_dkdv", q, k, v, do, lse, delta,
                     num_ctx):
        return ref_gpo_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                          num_ctx=num_ctx)
    bh, s, hd = q.shape
    width = head_width_for(hd)
    fn = backend.kernel("gpo_attention_bwd", "gpo_attention_bwd_dkdv_launch",
                        _DKDV_ARGTYPES)
    q, k, v, do = _padded(width, q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if bh == 0 or s == 0:
        return _sliced(hd, dk, dv)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             bh, s, num_ctx, hd, width, backend.stream_ptr(q.device))
    backend.check(err, "gpo_attention_bwd_dkdv")
    gpo_attention_bwd_dkdv.launches += 1
    return _sliced(hd, dk, dv)


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


def _banded_ctx_blocks(num_ctx: int, bk: int, num_kb: int) -> int | None:
    """k-blocks of the context band of the reference's Pallas grid, or
    None when the band saturates the grid (the reference then runs the
    full grid)."""
    ctx_blocks = min(-(-num_ctx // bk), num_kb)
    return ctx_blocks if ctx_blocks < num_kb else None


def gpo_tile_counts(s: int, num_ctx: int, bq: int, bk: int) -> tuple[int, int]:
    """(banded_tiles, full_grid_tiles) a head of the reference's forward
    grid at (S, num_ctx) and blocks (bq, bk): the grid-level work ratio
    its benchmarks report. Plain integers; no kernel."""
    num_qb, num_kb = s // bq, s // bk
    ctx_blocks = _banded_ctx_blocks(num_ctx, bk, num_kb)
    banded = num_qb * (ctx_blocks + 1 if ctx_blocks is not None else num_kb)
    return banded, num_qb * num_kb


def gpo_tile_counts_bwd(s: int, num_ctx: int, bq: int,
                        bk: int) -> tuple[int, int]:
    """(banded_bwd_tiles, full_grid_bwd_tiles) a head: the dq grid's
    steps plus the dk/dv grid's, the backward's counterpart of
    ``gpo_tile_counts``."""
    num_qb, num_kb = s // bq, s // bk
    ctx_blocks = _banded_ctx_blocks(num_ctx, bk, num_kb)
    full = 2 * num_qb * num_kb
    if ctx_blocks is None:
        return full, full
    dq = num_qb * (ctx_blocks + 1)
    dkdv = ctx_blocks * num_qb + (num_kb - ctx_blocks)
    return dq + dkdv, full
