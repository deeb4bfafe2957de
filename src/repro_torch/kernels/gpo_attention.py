"""GPO neural-process attention, forward, with its CUDA kernel
``csrc/gpo_attention_fwd.cu``.

The mask: context tokens (the first ``num_ctx``) attend to all context
tokens; target tokens attend to the context tokens and to themselves,
never to other targets.

Kernel (replaces ``repro/kernels/gpo_attention.py::_gpo_fwd_kernel``):
one block per (batch·head, 64 query rows), one thread per query row.
The block walks only the context keys ``[0, num_ctx)``, 32 at a time,
staged in shared memory, keeping the online-softmax state (running max
m, sum l, the hd-wide accumulator) in registers; after the walk each
target row adds its own key once. That is the TPU kernel's band
(context tiles plus the diagonal) as a loop inside the block: no S×S
score tensor and no target×target key is ever touched. Scores scale by
1/√hd, ``l`` clamps at 1e-30 and ``lse = m + log l``, as in the TPU
kernel, so the backward kernels of the training slice can reuse it.

What bounds it on the H100: at the served shapes (BH ≤ 28, S ≤ 160,
hd = 32) q/k/v are at most 1.7 MB and the band is ~30 MFLOP, both under
a microsecond of the card's bytes or f32 rate, so a call is launch-
bound. The simple design keeps it to one launch per layer and never
materialises scores; it leaves most SMs idle at these sizes (S/64·BH
blocks of 64 threads), which a later PR can fix with more rows per
block and tensor-core tiles.

Forward only: the backward kernels (dq, dk/dv) come with the training
slice, so a CUDA call that would need a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ref import ref_gpo_attention

HEAD_DIMS = (32,)  # head widths the CUDA source instantiates

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def gpo_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_ctx: int):
    """q/k/v (BH, S, hd) f32 -> (o (BH, S, hd), lse (BH, S) f32). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"gpo_attention shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bh, s, hd = q.shape
    if not 0 <= num_ctx <= s:
        raise ValueError(f"num_ctx={num_ctx} outside [0, {s}]")
    if backend.on_cpu("gpo_attention", q, k, v,
                      dtypes=(torch.float32,) * 3):
        return ref_gpo_attention(q, k, v, num_ctx=num_ctx)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "gpo_attention has no backward kernels yet; they come with "
            "the training slice of the port. Call it under "
            "torch.no_grad() or on tensors that need no gradient.")
    if hd not in HEAD_DIMS:
        raise ValueError(f"gpo_attention kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    fn = backend.kernel("gpo_attention_fwd", "gpo_attention_fwd_launch",
                        _ARGTYPES)
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    if bh == 0 or s == 0:
        return o, lse
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), bh, s, num_ctx, hd, backend.stream_ptr(q.device))
    backend.check(err, "gpo_attention_fwd")
    gpo_attention_fwd.launches += 1
    return o, lse


gpo_attention_fwd.launches = 0
