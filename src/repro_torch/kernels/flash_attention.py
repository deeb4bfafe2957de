"""Flash-attention forward for the LM backbones, with its CUDA kernels
``csrc/flash_attention_fwd.cuh``, instantiated at the head widths
``HEAD_WIDTHS`` by three sources (``SOURCE_WIDTHS``:
``csrc/flash_attention_fwd.cu``, ``_more.cu`` and ``_wide.cu``, so that
the build's nvcc runs share the work).

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (the
``pallas_call`` in ``flash_attention_bhsd``): online-softmax attention
with causal masking, an optional sliding window (``q − k < window``, 0
meaning global), an optional logit softcap applied before the mask, and
GQA by index (query head h reads kv head h // (H/KV); repeated KV is
never materialised). The kernel takes the unpadded key length and masks
the keys at or past it, so the padded tail the wrapper adds never
enters a softmax, causal or not.

Kernels, one launch a call, routed on the dtype:

* bf16, on the tensor cores (FlashAttention-2's scheme): a block of 4
  warps takes 64 query rows of one (batch, head), each warp 16 rows with
  its Q slice in registers as ``mma.sync.m16n8k16`` A fragments; 64-key
  tiles of K and V staged in shared memory in bf16 by ``cp.async`` in a
  ring of three, padded rows so ``ldmatrix`` reads are conflict-free;
  S = Q·Kᵀ and O += P·V in bf16 → f32 with m and l per row in
  registers, scores in log2 units (one ``ex2`` a probability), P
  rounded to bf16 in registers (the reference's ``p.astype(v.dtype)``)
  and fed back as the A operand of P·V.
* f32, on the CUDA cores (the first design): one block per
  (batch·head, 64 query rows), two threads per row (four past 128),
  32-key f32 tiles in shared memory. TF32 products would not hold the
  f32 tolerances.

Head widths: the kernels are built at ``HEAD_WIDTHS``, the multiples of
16 (the bf16 ``mma`` k-step) that models use up to 256; a head of any
other width from 1 to 256 is padded with zero columns to the next built
width (``head_width_for``), which leaves q·k unchanged, runs with the
scale 1/√hd of its own width, and has the padded columns of o sliced
off. Past 128 the bf16 kernel reads Q's fragments from shared memory at
each key tile (its o accumulator fills the registers) and at 256 keeps
two K/V tiles in flight, not three. At the narrowest built width, 16
(heads of 1 to 16 columns), the bf16 kernel feeds P·V with P in three
bf16 parts (about f32's 24 bits) rather than rounded once: a row of so
few numbers has too small a norm for that rounding (it read row errors
of 1.1e-2 at hd 8 and 6.9 at hd 1 on an H100, against phase 1's limit
of 6.9e-3 in ``chip_smoke.py``). Widths above 256 are refused on both
devices: no configuration in the repo uses one.

Both skip tiles outside the causal or window band by the TPU kernel's
relevance rule (the bf16 kernel masks per key only in tiles that cross
an edge or ``kv_len``) and compute o = acc / max(l, 1e-30) as the TPU
kernel does.

What bounds it on the H100 SXM (data-sheet rates at its 700 W limit):
operations. At qwen2-0.5b's prefill (B 4, H 14, KV 2, S 2048, hd 64,
bf16, causal) the band is about 30.1 GFLOP against 33.6 MB of q, k, v
and o (10 µs of bytes): about 30.4 µs at the 989 TFLOP/s bf16
tensor-core rate, which the bf16 kernel runs on. The f32 kernel's own
ceiling at the same shape is about 450 µs (67 TFLOP/s).

There is no backward, as the reference has none (ROADMAP C.1): the
wrapper refuses operands that require grad while grad mode is on, on
either device, rather than hand back a result without a ``grad_fn``;
LM training takes the plain branch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ref import ref_attention

# the head widths each CUDA source instantiates (FLASH_WIDTHS there)
SOURCE_WIDTHS = {"flash_attention_fwd": (16, 32, 48, 64, 128),
                 "flash_attention_fwd_more": (80, 96, 160),
                 "flash_attention_fwd_wide": (192, 256)}
HEAD_WIDTHS = tuple(sorted(w for ws in SOURCE_WIDTHS.values() for w in ws))
DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def head_width_for(hd: int) -> int:
    """The built width a head of width ``hd`` runs at: the smallest of
    ``HEAD_WIDTHS`` at least ``hd``. Raises above the widest."""
    for w in HEAD_WIDTHS:
        if w >= hd:
            return w
    raise ValueError(f"flash_attention: head_dim {hd} above the widest "
                     f"built width {HEAD_WIDTHS[-1]}")


def _check(q, k, v, kv_len, softcap):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, s, hd = q.shape
    kv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, hd) or kv == 0 \
            or h % kv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H a multiple of KV)")
    if hd < 1:
        raise ValueError(f"flash_attention: head_dim {hd} must be >= 1")
    head_width_for(hd)
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: expected one of {DTYPES}, got "
                         f"{q.dtype}")
    if not 1 <= kv_len <= s:
        raise ValueError(f"flash_attention: kv_len={kv_len} outside "
                         f"[1, {s}]")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap={softcap} must be > 0")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: Optional[float] = None,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, H, S, hd), k/v (B, KV, S, hd), all f32 or all bf16 ->
    (B, H, S, hd). Keys at or past ``kv_len`` (default S) are masked.
    CPU tensors take the plain version (``ref_attention``); CUDA tensors
    launch the kernel or raise. Raises for operands that require grad
    under grad mode (no backward yet)."""
    kv_len = q.shape[2] if kv_len is None else kv_len
    _check(q, k, v, kv_len, softcap)
    backend.refuse_grad("flash_attention_bhsd", q, k, v)
    if backend.on_cpu("flash_attention", q, k, v, dtypes=(q.dtype,) * 3):
        return ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, kv_len=kv_len)
    b, h, s, hd = q.shape
    width = head_width_for(hd)
    source = next(n for n, ws in SOURCE_WIDTHS.items() if width in ws)
    fn = backend.kernel(source, f"{source}_launch", _ARGTYPES)
    if width != hd:  # zero columns: q·k unchanged, o's sliced off below
        q, k, v = (torch.nn.functional.pad(t, (0, width - hd))
                   for t in (q, k, v))
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o[..., :hd]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
             k.shape[1], s, kv_len, width, hd, int(causal), int(window),
             float(softcap or 0.0), DTYPES.index(q.dtype),
             backend.stream_ptr(q.device))
    backend.check(err, "flash_attention_fwd")
    flash_attention_bhsd.launches += 1
    return o if width == hd else o[..., :hd].contiguous()


flash_attention_bhsd.launches = 0
