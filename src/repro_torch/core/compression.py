"""Communication-efficient client-delta transport (DESIGN.md §10), the
PyTorch port of ``repro/core/compression.py``.

The compression stage sits on the client→server path between the
privacy pipeline and the ``ServerAggregator``: each client's flat delta
d_c is released by the DP pipeline (clip + noise, ``core/privacy.py``),
the EF residual is folded in, the result is compressed and immediately
decompressed (the server consumes the "transmitted" values t_c), and the
aggregator reduces the t_c:

    d̃_c = privacy_release(d_c)          (ε is unaffected: compression
                                          is post-processing)
    u_c  = d̃_c + e_c                     (EF21-style residual carry-in)
    t_c  = D(Q(u_c))                     (codec round trip)
    e'_c = u_c − t_c                     (residual carry-out)
    Δ    = aggregate_c(w_c, t_c)

Codecs (``CompressionConfig.kind``):

* ``int8``: per-client symmetric quantization to 127 levels, scale
  s_c = max|u_c| / 127. Stochastic rounding q = ⌊u/s + υ⌋ with
  υ ~ U[0, 1) is unbiased; υ is a presampled (C, P) operand, drawn by
  the trainer from its ``torch.Generator`` (``client_uniform``) or
  replayed from the reference for parity (the reference folds its
  rounding keys out of the per-client training keys, which torch cannot
  reproduce). Without it, round half to even.
* ``topk``: magnitude sparsification: entries below the per-client
  ⌈topk_frac·P⌉-th largest |u_c| are zeroed (threshold ties kept). The
  threshold is a global selection (``torch.topk``, as the reference's
  ``lax.top_k``) outside any kernel; the ``topk_reduce`` CUDA kernel
  fuses the mask, the weighted reduce and the residual that follow it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import CompressionConfig, PrivacyConfig
from repro_torch.core import privacy as dp
from repro_torch.kernels import agg_quant_clip_reduce, agg_topk_reduce
from repro_torch.kernels.agg_reduce import INT8_LEVELS, _SCALE_FLOOR


def client_uniform(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """Presampled U[0, 1) stochastic-rounding tile (C, P) float32, drawn
    from ``gen`` on its device."""
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)


# ---------------------------------------------------------------------------
# codec primitives on the flat (C, P) matrix
# ---------------------------------------------------------------------------
def quantize_int8(vecs: torch.Tensor, *,
                  uniform: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, P) f32 -> (q int8 (C, P), scales f32 (C,)). Symmetric
    127-level grid; stochastic rounding when a presampled ``uniform``
    tile is given, round half to even otherwise. The scale floor keeps
    all-zero clients at exact zeros. Both divisions are IEEE quotients
    (tensor by tensor)."""
    x = vecs.float()
    amax = x.abs().amax(dim=1)
    scales = torch.clamp(amax / torch.full_like(amax, INT8_LEVELS),
                         min=_SCALE_FLOOR)
    z = x / scales[:, None]
    q = (torch.floor(z + uniform.float()) if uniform is not None
         else torch.round(z))
    q = torch.clamp(q, -INT8_LEVELS, INT8_LEVELS)
    return q.to(torch.int8), scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(C, P) int8 + (C,) scales -> (C, P) f32 transmitted values."""
    return q.float() * scales[:, None]


def topk_count(p: int, frac: float) -> int:
    """Entries kept per client: ⌈frac·P⌉, at least 1."""
    return max(1, int(math.ceil(frac * p)))


def topk_thresholds(vecs: torch.Tensor, frac: float) -> torch.Tensor:
    """(C,) per-client magnitude threshold: the k-th largest |value|
    (unique whatever order ties take)."""
    k = topk_count(vecs.shape[1], frac)
    mags = vecs.float().abs()
    return torch.topk(mags, k, dim=1).values[:, -1].contiguous()


def sparsify_topk(vecs: torch.Tensor, frac: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, P) -> (sparsified (C, P) f32, thresholds (C,)): zero every
    entry whose magnitude sits below the top-k threshold (ties kept)."""
    x = vecs.float()
    tau = topk_thresholds(x, frac)
    return torch.where(x.abs() >= tau[:, None], x, torch.zeros_like(x)), tau


def compress_flat(vecs: torch.Tensor, uniform: Optional[torch.Tensor],
                  comp: CompressionConfig) -> torch.Tensor:
    """Codec round trip D(Q(·)) on the (C, P) matrix: the transmitted
    values the server consumes. ``uniform`` is the rounding tile of a
    stochastic int8 config (None otherwise)."""
    if comp.kind == "int8":
        return dequantize_int8(*quantize_int8(
            vecs, uniform=uniform if comp.stochastic else None))
    if comp.kind == "topk":
        return sparsify_topk(vecs, comp.topk_frac)[0]
    return vecs.float()


def ef_compress_flat(vecs: torch.Tensor, uniform: Optional[torch.Tensor],
                     comp: CompressionConfig,
                     resid: Optional[torch.Tensor]
                     ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """EF21-style wrapper: compress(d̃ + e), e' = (d̃ + e) − t.
    ``resid=None`` (error feedback off) is a plain codec round trip."""
    u = vecs.float()
    if resid is not None:
        u = u + resid
    t = compress_flat(u, uniform, comp)
    return t, (u - t if resid is not None else None)


def release_flat(vecs: torch.Tensor, noise: Optional[torch.Tensor],
                 uniform: Optional[torch.Tensor], privacy: PrivacyConfig,
                 comp: CompressionConfig, resid: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-client released values without the client-axis reduction: DP
    release (if enabled), then the EF / codec round trip. Returns the
    (C, P) transmitted matrix and the carry-out residual; the rows are
    the plain path of ``transport_delta_flat``."""
    x = vecs.float()
    if privacy.enabled:
        x = dp.privatize_flat(x, noise, privacy)
    if not comp.enabled:
        return x, resid
    return ef_compress_flat(x, uniform, comp, resid)


# ---------------------------------------------------------------------------
# the full transport for client-stacked trainers
# ---------------------------------------------------------------------------
def transport_delta_flat(vecs: torch.Tensor, weights: torch.Tensor,
                         noise: Optional[torch.Tensor],
                         uniform: Optional[torch.Tensor],
                         privacy: PrivacyConfig, comp: CompressionConfig,
                         agg, resid: Optional[torch.Tensor], *,
                         use_pallas: bool = False
                         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """DP release → EF / compress → client-axis reduction on the raw
    flat (C, P) delta matrix. Returns (delta_vec (P,), new residual or
    None).

    ``use_pallas`` routes the linear family through one kernel call:
    ``agg_quant_clip_reduce`` for int8 (clip, noise, EF, quantize and
    reduce, no (C, P) intermediate but the new residual) or the top-k
    mask-and-reduce kernel after the threshold selection. The robust
    family privatizes and compresses in plain torch and reduces through
    ``agg.reduce_flat`` (the trimmed kernel under the same flag)."""
    x = vecs.float()
    w = weights.float()
    if comp.kind == "int8":
        uniform = uniform if comp.stochastic else None
        if use_pallas and agg.linear:
            clip, noise = ((privacy.clip_norm,
                            dp.noise_operand(noise, privacy))
                           if privacy.enabled else (0.0, None))
            return agg_quant_clip_reduce(x, w, clip=clip, noise=noise,
                                         uniform=uniform, resid=resid)
        if privacy.enabled:
            x = dp.privatize_flat(x, noise, privacy)
        u = x + resid if resid is not None else x
        t = dequantize_int8(*quantize_int8(u, uniform=uniform))
    elif comp.kind == "topk":
        if privacy.enabled:
            x = dp.privatize_flat(x, noise, privacy)
        u = x + resid if resid is not None else x
        tau = topk_thresholds(u, comp.topk_frac)
        if use_pallas and agg.linear:
            return agg_topk_reduce(u, w, tau,
                                   with_residual=resid is not None)
        t = torch.where(u.abs() >= tau[:, None], u, torch.zeros_like(u))
    else:
        raise ValueError(f"transport called with kind={comp.kind!r} "
                         "(callers must gate on CompressionConfig.enabled)")
    new_resid = u - t if resid is not None else None
    # the registry's reduce: the linear family's weighted flat sum or the
    # robust family's rank trim (kernel-backed under use_pallas; the
    # transport kernels took the linear + use_pallas paths above)
    return agg.reduce_flat(t, w), new_resid
