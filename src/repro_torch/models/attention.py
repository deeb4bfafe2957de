"""GQA self-attention with windowing, softcapping, qk-norm and a KV cache
(the reference's ``models/attention.py``, its single-device branches).

* GQA through a head-grouped einsum: repeated KV is never materialised.
* The window is a per-layer int (0 or below: global).
* The prefill's attention goes through the flash-attention kernel
  (``kernels/ops.py::flash_attention``) unless ``use_kernel=False``;
  ``gqa_scores_softmax`` is the plain branch, the reference's jnp path.
* Decode attends one query against the pre-allocated cache with
  validity masking, in plain PyTorch, as the reference computes it
  outside any Pallas kernel. The cache is updated in place (the
  reference returns a new one): the stacked cache is the model's
  largest activation and a copy a step would double it. Past the end of
  a full cache, decode raises (the reference clamps and overwrites the
  last slot). ``ring_decode_step`` decodes a local layer against a
  ring of ``window`` slots, which wraps by design.
* whisper's encoder attends bidirectionally (``encoder_self_attend``,
  through the flash kernel, non-causal) and its decoder attends to the
  encoder's states (``cross_kv`` once a prefill, ``cross_attend`` plain:
  the kernel takes only as many keys as queries).

Under an ``activation_sharding`` context (``models/partitioning.py``)
the plain branch repeats K and V to the full head count where
``prefers_repeat_kv``, as the reference does. The reference's other
layout choices (its query-sharded branch where ``prefers_q_sharding``,
the query-sequence split of MHA with heads the model axis does not
divide) only pick ``shard_act`` specs: in one process ``shard_act`` is
the identity, so they compute what the grouped and MHA branches compute
and the port has no branch for them. Without a context the values are
as before, bit for bit. The flash kernel handles GQA itself and takes
no layout from the context.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamInit, rms_norm, rope, softcap
from repro_torch.models.partitioning import prefers_repeat_kv, shard_act

NEG_INF = -2.3819763e38  # bf16-safe large negative


class AttnParams(NamedTuple):
    wq: torch.Tensor  # (d, H*hd)
    wk: torch.Tensor  # (d, KV*hd)
    wv: torch.Tensor  # (d, KV*hd)
    wo: torch.Tensor  # (H*hd, d)
    bq: Optional[torch.Tensor]
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]
    q_norm: Optional[torch.Tensor]  # (hd,)
    k_norm: Optional[torch.Tensor]  # (hd,)


def init_attn_params(init: ParamInit, cfg, dtype) -> AttnParams:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim

    def zeros(n):
        return init.zeros((n,), dtype)

    return AttnParams(
        wq=init.dense((d, qd), dtype),
        wk=init.dense((d, kvd), dtype),
        wv=init.dense((d, kvd), dtype),
        wo=init.dense((qd, d), dtype),
        bq=zeros(qd) if cfg.qkv_bias else None,
        bk=zeros(kvd) if cfg.qkv_bias else None,
        bv=zeros(kvd) if cfg.qkv_bias else None,
        q_norm=zeros(cfg.head_dim) if cfg.qk_norm else None,
        k_norm=zeros(cfg.head_dim) if cfg.qk_norm else None,
    )


def _project_qkv(p: AttnParams, x, num_heads, num_kv, head_dim, eps):
    b, s, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = shard_act(q.reshape(b, s, num_heads, head_dim),
                  ("batch", "seq", "heads", "hd"))
    k = shard_act(k.reshape(b, s, num_kv, head_dim),
                  ("batch", "seq", "kv_heads", "hd"))
    v = shard_act(v.reshape(b, s, num_kv, head_dim),
                  ("batch", "seq", "kv_heads", "hd"))
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, eps)
        k = rms_norm(k, p.k_norm, eps)
    return q, k, v


def gqa_scores_softmax(q, k, v, mask, logit_cap):
    """q (b, sq, H, hd), k/v (b, sk, KV, hd), mask (b, sq, sk) bool ->
    (b, sq, H, hd). Softmax in f32; the scores are rounded to the
    inputs' dtype before the upcast, as the reference's einsum does."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    scale = math.sqrt(hd)
    if kv != h and prefers_repeat_kv(h, kv):
        # repeated-KV layout: one shardable heads dim where the grouped
        # form would split it into two unshardable factors
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
        kv = h
    if kv == h:
        scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() / scale
        if logit_cap is not None:
            scores = softcap(scores, logit_cap)
        scores = torch.where(mask[:, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqs,bshd->bqhd", probs, v)
        return shard_act(out, ("batch", "seq", "heads", "hd"))
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() / scale
    if logit_cap is not None:
        scores = softcap(scores, logit_cap)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return shard_act(out.reshape(b, sq, h, hd), ("batch", "seq", "heads", "hd"))


def make_causal_window_mask(q_pos, k_pos, window: int, k_valid=None):
    """bool mask (b?, sq, sk); window <= 0 means global."""
    causal = k_pos[..., None, :] <= q_pos[..., :, None]
    mask = causal
    if window > 0:
        dist = q_pos[..., :, None] - k_pos[..., None, :]
        mask = mask & (dist < window)
    if k_valid is not None:
        mask = mask & k_valid[..., None, :]
    return mask


# sequences >= this use the q-chunked path: scores for a 32k prefill would
# otherwise materialise B*H*S^2 f32
CHUNK_THRESHOLD = 8192
Q_CHUNK = 1024


def _chunked_gqa(q, k, v, window, logit_cap, q_chunk: int):
    """Causal/windowed attention, q in chunks of ``q_chunk`` (q and k
    already roped): peak score memory O(q_chunk * S), not O(S^2)."""
    b, s, h, hd = q.shape
    assert s % q_chunk == 0, (s, q_chunk)
    k_pos = torch.arange(s, device=q.device)[None, :].expand(b, s)
    outs = []
    for i in range(s // q_chunk):
        q_pos = (i * q_chunk + torch.arange(q_chunk, device=q.device)
                 )[None, :].expand(b, q_chunk)
        mask = make_causal_window_mask(q_pos, k_pos, window)
        outs.append(gqa_scores_softmax(q[:, i * q_chunk:(i + 1) * q_chunk],
                                       k, v, mask, logit_cap))
    return torch.cat(outs, dim=1)


def _self_attend(q, k, v, cfg, window: int, positions, use_kernel: bool):
    s = q.shape[1]
    if use_kernel:
        return ops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_logit_softcap)
    if s >= CHUNK_THRESHOLD and s % Q_CHUNK == 0:
        return _chunked_gqa(q, k, v, window, cfg.attn_logit_softcap,
                            Q_CHUNK)
    mask = make_causal_window_mask(positions, positions, window)
    return gqa_scores_softmax(q, k, v, mask, cfg.attn_logit_softcap)


def attend_full(p: AttnParams, x, cfg, *, window: int, theta,
                positions=None, use_kernel: bool = True):
    """Full-sequence causal self-attention, no cache. positions defaults
    to arange."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(p, x, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.norm_eps)
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    out = _self_attend(q, k, v, cfg, window, positions, use_kernel)
    return out.reshape(b, s, -1) @ p.wo


def prefill(p: AttnParams, x, cfg, *, window: int, theta, cache_len: int,
            use_kernel: bool = True):
    """Full-sequence attention that also materialises the KV cache.
    Returns (out (b, s, d), k_cache (b, cache_len, KV, hd), v_cache)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(p, x, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.norm_eps)
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    out = _self_attend(q, k, v, cfg, window, positions, use_kernel)
    out = out.reshape(b, s, -1) @ p.wo
    pad = cache_len - s
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return out, k, v


def decode_step(p: AttnParams, x, k_cache, v_cache, cache_pos: int, cfg, *,
                window: int, theta):
    """One-token decode. x (b, 1, d); caches (b, S, KV, hd), written in
    place at ``cache_pos``; attends to positions <= cache_pos.
    Returns (out (b, 1, d), k_cache, v_cache)."""
    b = x.shape[0]
    s_max = k_cache.shape[1]
    pos = torch.full((b, 1), cache_pos, device=x.device)
    q, k, v = _project_qkv(p, x, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.norm_eps)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    k_cache[:, cache_pos] = k[:, 0]
    v_cache[:, cache_pos] = v[:, 0]
    k_pos = torch.arange(s_max, device=x.device)[None, :].expand(b, s_max)
    k_valid = k_pos <= cache_pos  # includes the token just written
    mask = make_causal_window_mask(pos, k_pos, window, k_valid=k_valid)
    out = gqa_scores_softmax(q, k_cache, v_cache, mask,
                             cfg.attn_logit_softcap)
    return out.reshape(b, 1, -1) @ p.wo, k_cache, v_cache


def ring_decode_step(p: AttnParams, x, k_cache, v_cache, cache_pos: int,
                     cfg, *, theta):
    """One-token decode against a RING cache of w = ``k_cache.shape[1]``
    slots (the local layer's window), written in place at slot
    ``cache_pos % w``. Slot s holds the roped key of true position
    ``cache_pos - (slot - s)`` for s <= slot, else ``cache_pos - (slot +
    w - s)``: always within (cache_pos - w, cache_pos], so the causal
    window's mask is only ``true_pos >= 0`` (slots not yet filled).
    Returns out (b, 1, d)."""
    b = x.shape[0]
    w = k_cache.shape[1]
    pos = torch.full((b, 1), cache_pos, device=x.device)
    q, k, v = _project_qkv(p, x, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.norm_eps)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    slot = cache_pos % w
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    s = torch.arange(w, device=x.device)
    true_pos = torch.where(s <= slot, cache_pos - (slot - s),
                           cache_pos - (slot + w - s))
    mask = (true_pos >= 0)[None, None, :].expand(b, 1, w)
    out = gqa_scores_softmax(q, k_cache, v_cache, mask,
                             cfg.attn_logit_softcap)
    return out.reshape(b, 1, -1) @ p.wo


# ---------------------------------------------------------------------------
# Cross attention (whisper's decoder on the encoder's states) and the
# encoder's bidirectional self-attention
# ---------------------------------------------------------------------------
class CrossAttnParams(NamedTuple):
    wq: torch.Tensor  # (d, H*hd)
    wk: torch.Tensor  # (d, KV*hd)
    wv: torch.Tensor  # (d, KV*hd)
    wo: torch.Tensor  # (H*hd, d)


def init_cross_attn_params(init: ParamInit, cfg, dtype) -> CrossAttnParams:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return CrossAttnParams(
        wq=init.dense((d, qd), dtype),
        wk=init.dense((d, kvd), dtype),
        wv=init.dense((d, kvd), dtype),
        wo=init.dense((qd, d), dtype),
    )


def cross_kv(p: CrossAttnParams, enc_out, cfg):
    """(k, v), each (b, S_enc, KV, hd), of the encoder's states: made once
    a prefill and kept in the decode cache."""
    b, s, _ = enc_out.shape
    k = (enc_out @ p.wk).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (enc_out @ p.wv).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return k, v


def cross_attend(p: CrossAttnParams, x, k, v, cfg):
    """x (b, sq, d) attends to every encoder position, no rope and no
    softcap. Plain PyTorch, as the reference computes it outside any
    Pallas kernel: the flash kernel takes only Sq == Sk."""
    b, sq, _ = x.shape
    q = (x @ p.wq).reshape(b, sq, cfg.num_heads, cfg.head_dim)
    mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool, device=x.device)
    out = gqa_scores_softmax(q, k, v, mask, None)
    return out.reshape(b, sq, -1) @ p.wo


def encoder_self_attend(p: AttnParams, x, cfg, use_kernel: bool = True):
    """Bidirectional (encoder) self-attention with rope at
    ``cfg.rope_theta``: through the flash kernel, non-causal, unless
    ``use_kernel=False``, which takes the plain masked softmax."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(p, x, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.norm_eps)
    q, k = rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                     cfg.rope_theta)
    if use_kernel:
        out = ops.flash_attention(q, k, v, causal=False,
                                  softcap=cfg.attn_logit_softcap)
    else:
        mask = torch.ones((b, s, s), dtype=torch.bool, device=x.device)
        out = gqa_scores_softmax(q, k, v, mask, cfg.attn_logit_softcap)
    return out.reshape(b, s, -1) @ p.wo
