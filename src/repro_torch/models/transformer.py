"""Backbone assembler: init and forward for every family of the
reference's ``models/transformer.py``: dense (all-attention), MoE,
pure SSM (all-Mamba2), the zamba2 hybrid, whisper's encoder-decoder and
llava's embeddings input.

* Params are a plain dict in the reference's tree layout, every
  per-layer leaf stacked on a leading L axis; the reference's
  ``lax.scan`` over layers is a Python loop over L.
* Per-layer windows and rope thetas come from ``layer_windows_thetas``
  as in the reference.
* ``use_kernels`` (default True) sends the prefill's attention through
  the flash-attention kernel and the Mamba2 prefill through the SSD
  kernel; False takes the plain branch, the reference's jnp path. It is
  an argument, not a ``ModelConfig`` field, because the configs copy
  the reference's field for field.
* Decode updates the stacked cache in place (see
  ``models/attention.py``).
* gemma2/3's post-norms, MoE layers (``models/moe.py``; the aux loss
  summed over layers is ``forward``'s third output) and the ring cache
  for periodic local:global patterns (``ring_cache=True``: the prefill
  fills the full cache, ``ring_cache_from_full`` converts it, and decode
  keeps a window-long ring a local layer).
* The zamba2 hybrid (``_run_hybrid``): super-blocks of
  ``shared_attn_every`` Mamba2 layers, each followed by the one
  shared-weight attention+MLP block (global, at ``cfg.rope_theta``),
  then the tail of the trunk; the reference's scans are Python loops,
  and decode writes the SSM, conv and super-block caches in place.
* The encoder-decoder (whisper): ``encode`` runs the bidirectional
  encoder (flash, non-causal), ``_stacked_cross_kv`` makes each decoder
  layer's cross K/V once a prefill, and the cache keeps them for decode.
* The embeddings input (llava): ``embeds=`` (B, S, d) in place of
  ``tokens=``; decode goes on from tokens.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, GLOBAL, MAMBA, ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import (
    AttnParams,
    CrossAttnParams,
    cross_attend,
    cross_kv,
    encoder_self_attend,
    init_attn_params,
    init_cross_attn_params,
)
from repro_torch.models.layers import ParamInit, rms_norm, softcap, swiglu
from repro_torch.models.moe import MoEParams, init_moe_params, moe_ffn
from repro_torch.models.ssm import (
    MambaParams,
    init_mamba_params,
    mamba_block,
    mamba_dims,
)

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a per-layer pattern that mixes kinds, as the reference's
    ``init_params`` does (zamba2 mixes through ``shared_attn_every``, not
    its pattern)."""
    if len(set(cfg.layer_kinds())) > 1:
        raise ValueError(f"mixed per-layer patterns unsupported: {cfg.name}")


def _stacked_layers(make, n: int) -> dict:
    """n layers from ``make()``, each leaf stacked on a leading L axis (a
    NamedTuple of params becomes a dict by field name; None stays). Each
    layer is copied into the stack as it is made, so the peak is the
    stack and one layer, not twice the stack."""
    def as_dict(tree):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return tree._asdict()
        return tree

    def empty(tree):
        tree = as_dict(tree)
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: empty(v) for k, v in tree.items()}
        return tree.new_empty((n,) + tuple(tree.shape))

    def fill(dst, tree, i):
        tree = as_dict(tree)
        if isinstance(tree, dict):
            for k, v in tree.items():
                fill(dst[k], v, i)
        elif tree is not None:
            dst[i].copy_(tree)

    first = make()
    out = empty(first)
    fill(out, first, 0)
    del first
    for i in range(1, n):
        fill(out, make(), i)
    return out


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------
def _init_mlp(init: ParamInit, d, ff, dtype):
    return {
        "w_gate": init.dense((d, ff), dtype),
        "w_up": init.dense((d, ff), dtype),
        "w_down": init.dense((ff, d), dtype),
    }


def _init_attn_layer(init: ParamInit, cfg: ModelConfig, dtype,
                     with_cross: bool = False) -> dict:
    layer = {
        "ln1": init.zeros((cfg.d_model,), dtype),
        "attn": init_attn_params(init, cfg, dtype),
        "ln2": init.zeros((cfg.d_model,), dtype),
    }
    if cfg.is_moe:
        layer["moe"] = init_moe_params(init, cfg, dtype)
    else:
        layer["mlp"] = _init_mlp(init, cfg.d_model, cfg.d_ff, dtype)
    if cfg.use_post_norm:
        layer["post_ln1"] = init.zeros((cfg.d_model,), dtype)
        layer["post_ln2"] = init.zeros((cfg.d_model,), dtype)
    if with_cross:
        layer["ln_cross"] = init.zeros((cfg.d_model,), dtype)
        layer["cross"] = init_cross_attn_params(init, cfg, dtype)
    return layer


def _init_mamba_layer(init: ParamInit, cfg: ModelConfig, dtype) -> dict:
    return {
        "ln": init.zeros((cfg.d_model,), dtype),
        "mamba": init_mamba_params(init, cfg, dtype),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> PyTree:
    """Random params in the reference's tree layout. The weights are
    drawn on the generator's device (a CUDA generator draws on the card)
    and moved to ``device`` (CUDA unless the caller names another).
    ``device="meta"`` makes only the shapes and needs no generator."""
    check_supported(cfg)
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    init = ParamInit(None if meta else generator)
    dtype = _dtype(cfg.param_dtype)
    params: dict = {
        "embed": (init.normal((cfg.vocab_size, cfg.d_model)) * 0.02
                  ).to(dtype),
        "final_norm": init.zeros((cfg.d_model,), dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init.dense((cfg.d_model, cfg.vocab_size), dtype)
    if cfg.layer_kinds()[0] == ATTN:
        params["layers"] = _stacked_layers(
            lambda: _init_attn_layer(init, cfg, dtype,
                                     with_cross=cfg.is_encoder_decoder),
            cfg.num_layers)
    else:
        params["layers"] = _stacked_layers(
            lambda: _init_mamba_layer(init, cfg, dtype), cfg.num_layers)
    if cfg.shared_attn_every:
        # zamba2: ONE shared-weight attention+MLP block
        params["shared_attn"] = {
            "ln1": init.zeros((cfg.d_model,), dtype),
            "attn": init_attn_params(init, cfg, dtype)._asdict(),
            "ln2": init.zeros((cfg.d_model,), dtype),
            "mlp": _init_mlp(init, cfg.d_model, cfg.d_ff, dtype),
        }
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": _stacked_layers(
                lambda: _init_attn_layer(init, cfg, dtype), cfg.enc_layers),
            "norm": init.zeros((cfg.d_model,), dtype),
        }
    if init.device != dev:
        params = _to(params, dev)
    return params


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return None if tree is None else tree.to(dev)


# ---------------------------------------------------------------------------
# Per-layer metadata (windows / thetas)
# ---------------------------------------------------------------------------
def layer_windows_thetas(cfg: ModelConfig) -> tuple[np.ndarray, np.ndarray]:
    n_attn = sum(1 for k in cfg.layer_kinds() if k == ATTN)
    wp = cfg.window_pattern
    windows = np.array([wp[i % len(wp)] for i in range(max(n_attn, 1))],
                       np.int32)
    windows = np.where(windows == GLOBAL, 0, windows)  # 0 => global
    theta_g = cfg.rope_theta_global or cfg.rope_theta
    thetas = np.where(windows == 0, theta_g, cfg.rope_theta).astype(np.float32)
    return windows, thetas


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def _embed_in(params, cfg: ModelConfig, tokens=None, embeds=None):
    """The token embeddings, or ``embeds`` (B, S, d) where given (llava's
    projected patch and text embeddings), in the activation dtype."""
    x = params["embed"][tokens] if embeds is None else embeds
    x = x.to(_dtype(cfg.activation_dtype))
    if cfg.scale_embeddings:
        x = x * torch.tensor(float(np.sqrt(cfg.d_model)), dtype=x.dtype)
    return x


def _unembed(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = (x @ head).float()
    if cfg.final_logit_softcap is not None:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return None if tree is None else tree[i]


# ---------------------------------------------------------------------------
# Attention-family layers (full / prefill / decode)
# ---------------------------------------------------------------------------
def _attn_residual(cfg: ModelConfig, lp: dict, x, a_out):
    """The attention output's residual, through its post-norm where the
    config has them."""
    if cfg.use_post_norm:
        a_out = rms_norm(a_out, lp["post_ln1"], cfg.norm_eps)
    return x + a_out


def _mlp_residual(cfg: ModelConfig, lp: dict, x):
    """The MLP's (or the MoE's) residual, through its post-norm where the
    config has them. Returns (x, the layer's aux loss, None where it has
    no MoE)."""
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        m_out, aux = moe_ffn(MoEParams(**lp["moe"]), h2, cfg.num_experts,
                             cfg.experts_per_token, cfg.router_aux_coef,
                             cfg.moe_capacity_factor)
    else:
        mlp = lp["mlp"]
        m_out = swiglu(h2, mlp["w_gate"], mlp["w_up"], mlp["w_down"])
        aux = None
    if cfg.use_post_norm:
        m_out = rms_norm(m_out, lp["post_ln2"], cfg.norm_eps)
    return x + m_out, aux


def _attn_layer(cfg: ModelConfig, mode: str, lp: dict, x, window: int,
                theta: float, *, k_cache=None, v_cache=None, cache_pos=None,
                cache_len=None, cross=None, use_kernels: bool = True):
    """One attention layer; ``cross``: this layer's encoder (k, v), whose
    residual sits between the self-attention's and the MLP's. Returns (x,
    (k, v) or None, aux or None)."""
    ap = AttnParams(**lp["attn"])
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    kv = None
    if mode == "full":
        a_out = attn_mod.attend_full(ap, h, cfg, window=window, theta=theta,
                                     use_kernel=use_kernels)
    elif mode == "prefill":
        a_out, k, v = attn_mod.prefill(ap, h, cfg, window=window,
                                       theta=theta, cache_len=cache_len,
                                       use_kernel=use_kernels)
        kv = (k, v)
    elif mode == "decode":
        a_out, k, v = attn_mod.decode_step(ap, h, k_cache, v_cache,
                                           cache_pos, cfg, window=window,
                                           theta=theta)
        kv = (k, v)
    else:
        raise ValueError(mode)
    x = _attn_residual(cfg, lp, x, a_out)
    if cross is not None:
        hc = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + cross_attend(CrossAttnParams(**lp["cross"]), hc, *cross, cfg)
    x, aux = _mlp_residual(cfg, lp, x)
    return x, kv, aux


def _scan_attn_layers(params, cfg, x, mode, *, cache=None, cache_pos=None,
                      cache_len=None, cross=None, use_kernels: bool = True):
    """The attention trunk; ``cross``: the stacked (L, B, S_enc, KV, hd)
    encoder keys and values, which the prefill's cache keeps."""
    windows, thetas = layer_windows_thetas(cfg)
    ks, vs = [], []
    aux = None
    for i in range(cfg.num_layers):
        kw = {}
        if mode == "decode":
            kw = dict(k_cache=cache["k"][i], v_cache=cache["v"][i],
                      cache_pos=cache_pos)
        x, kv, layer_aux = _attn_layer(
            cfg, mode, _layer(params["layers"], i), x, int(windows[i]),
            float(thetas[i]), cache_len=cache_len,
            cross=None if cross is None else (cross[0][i], cross[1][i]),
            use_kernels=use_kernels, **kw)
        if layer_aux is not None:
            aux = layer_aux if aux is None else aux + layer_aux
        if mode == "prefill":
            ks.append(kv[0])
            vs.append(kv[1])
    new_cache = None
    if mode == "prefill":
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if cross is not None:
            new_cache["cross_k"], new_cache["cross_v"] = cross
    elif mode == "decode":
        new_cache = cache  # written in place, layer by layer
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Ring-cache decode for periodic local:global patterns (gemma2/3)
# ---------------------------------------------------------------------------
def _ring_split(cfg: ModelConfig):
    """(period, n_super, tail, local positions-in-period, global
    positions)."""
    p = len(cfg.window_pattern)
    n_super = cfg.num_layers // p
    tail = cfg.num_layers - n_super * p
    local_js = [j for j, w in enumerate(cfg.window_pattern) if w > 0]
    global_js = [j for j, w in enumerate(cfg.window_pattern) if w <= 0]
    return p, n_super, tail, local_js, global_js


def uses_ring_cache(cfg: ModelConfig) -> bool:
    return (cfg.ring_cache and not cfg.is_encoder_decoder
            and not cfg.shared_attn_every
            and all(k == ATTN for k in cfg.layer_kinds())
            and any(w > 0 for w in cfg.window_pattern)
            and len(cfg.window_pattern) <= cfg.num_layers)


def _ring_slot(cfg: ModelConfig, idx: int) -> tuple:
    """Where layer ``idx`` keeps its keys and values in the ring layout:
    (k's name, v's name, the index into both)."""
    p, n_super, _, local_js, global_js = _ring_split(cfg)
    s, j = divmod(idx, p)
    if s >= n_super:
        return "tail_k", "tail_v", (idx - n_super * p,)
    if cfg.window_pattern[j] > 0:
        return "ring_k", "ring_v", (s, local_js.index(j))
    return "glob_k", "glob_v", (s, global_js.index(j))


def _ring_layer(cfg, lp, x, window: int, theta: float, k_cache, v_cache,
                cache_pos: int):
    """One decode layer; window > 0: the ring cache's semantics. The
    caches are written in place."""
    ap = AttnParams(**lp["attn"])
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if window > 0:
        a_out = attn_mod.ring_decode_step(ap, h, k_cache, v_cache,
                                          cache_pos, cfg, theta=theta)
    else:
        a_out, _, _ = attn_mod.decode_step(ap, h, k_cache, v_cache,
                                           cache_pos, cfg, window=0,
                                           theta=theta)
    x, _ = _mlp_residual(cfg, lp, _attn_residual(cfg, lp, x, a_out))
    return x


def _scan_ring_decode(params, cfg, x, cache, cache_pos: int):
    """Decode over super-blocks of one period each: local layers read
    and write (n_super, n_loc, B, W, KV, hd) rings, global layers
    full-length caches, and the tail layers (L % period) their own; all
    in place. The aux loss is 0, as the reference's ring decode returns
    it."""
    windows, thetas = layer_windows_thetas(cfg)
    for idx in range(cfg.num_layers):
        k_name, v_name, at = _ring_slot(cfg, idx)
        x = _ring_layer(cfg, _layer(params["layers"], idx), x,
                        int(windows[idx]), float(thetas[idx]),
                        cache[k_name][at], cache[v_name][at], cache_pos)
    return x, cache, torch.zeros((), device=x.device)


def init_ring_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                    device=None) -> dict:
    """The ring-structured decode cache (see ``_scan_ring_decode``), on
    ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.activation_dtype)
    p, n_super, tail, local_js, global_js = _ring_split(cfg)
    windows, _ = layer_windows_thetas(cfg)
    w_max = max(int(w) for w in windows if w > 0)
    kvh = (cfg.num_kv_heads, cfg.head_dim)

    def zeros(*shape):
        return torch.zeros(shape + kvh, dtype=dtype, device=dev)

    cache = {
        "ring_k": zeros(n_super, len(local_js), batch, w_max),
        "ring_v": zeros(n_super, len(local_js), batch, w_max),
        "glob_k": zeros(n_super, len(global_js), batch, max_seq),
        "glob_v": zeros(n_super, len(global_js), batch, max_seq),
    }
    if tail:
        tail_ws = [int(windows[n_super * p + t]) for t in range(tail)]
        t_len = max(w if w > 0 else max_seq for w in tail_ws)
        cache["tail_k"] = zeros(tail, batch, t_len)
        cache["tail_v"] = zeros(tail, batch, t_len)
    return cache


def ring_cache_from_full(cfg: ModelConfig, cache: dict, cache_pos: int,
                         batch: int, max_seq: int) -> dict:
    """A prefill's full cache in the ring layout, for decoding on from
    ``cache_pos`` (the last position written), on the cache's device."""
    windows, _ = layer_windows_thetas(cfg)
    full_k = cache["k"]
    ring = init_ring_cache(cfg, batch, max_seq, full_k.dtype,
                           device=full_k.device)
    w_max = ring["ring_k"].shape[3]
    # slot s holds the true position q with q % w_max == s, q in
    # (cache_pos - w_max, cache_pos]; zeros where there is none yet
    slots = torch.arange(w_max, device=full_k.device)
    cand = (cache_pos // w_max) * w_max + slots
    q = torch.where(cand <= cache_pos, cand, cand - w_max)
    q_clamped = q.clamp(0, max_seq - 1)
    valid = ((q >= 0) & (q > cache_pos - w_max))[None, :, None, None]

    def gather_window(full_layer):
        out = full_layer[:, q_clamped]
        return out * valid.to(out.dtype)

    for idx in range(cfg.num_layers):
        k_name, v_name, at = _ring_slot(cfg, idx)
        local = int(windows[idx]) > 0
        for name, src in ((k_name, cache["k"][idx]),
                          (v_name, cache["v"][idx])):
            ring[name][at].copy_(gather_window(src) if local else src)
    return ring


# ---------------------------------------------------------------------------
# Mamba-family (pure SSM) layers
# ---------------------------------------------------------------------------
def _mamba_range(params, cfg, x, layers, *, cache=None, states=None,
                 use_kernels: bool = True):
    """The trunk's Mamba2 layers ``layers`` (a range). Decode (``cache``
    given): each layer's SSM and conv states are read from the stacked
    cache and written back in place; otherwise each layer's final states
    are appended to ``states`` (two lists)."""
    decode = cache is not None
    for i in layers:
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        out, (ssm_s, conv_s) = mamba_block(
            MambaParams(**lp["mamba"]), h, cfg,
            ssm_state=cache["ssm"][i] if decode else None,
            conv_state=cache["conv"][i] if decode else None,
            decode=decode, use_kernel=use_kernels)
        x = x + out
        if decode:
            cache["ssm"][i].copy_(ssm_s)
            cache["conv"][i].copy_(conv_s)
        else:
            states[0].append(ssm_s)
            states[1].append(conv_s)
    return x


def _scan_mamba_layers(params, cfg, x, mode, *, cache=None,
                       use_kernels: bool = True):
    decode = mode == "decode"
    states = ([], [])
    x = _mamba_range(params, cfg, x, range(cfg.num_layers),
                     cache=cache if decode else None, states=states,
                     use_kernels=use_kernels)
    new_cache = cache if decode else {"ssm": torch.stack(states[0]),
                                      "conv": torch.stack(states[1])}
    return x, new_cache, torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# Hybrid (zamba2): super-blocks of Mamba2 layers + the shared attention
# ---------------------------------------------------------------------------
def _zamba_split(cfg) -> tuple[int, int, int]:
    """(layers a super-block, super-blocks, tail layers after the last)."""
    k = cfg.shared_attn_every
    n_super = cfg.num_layers // k
    return k, n_super, cfg.num_layers - n_super * k


def _shared_attn_apply(params, cfg, x, mode, *, k_cache=None, v_cache=None,
                       cache_pos=None, cache_len=None,
                       use_kernels: bool = True):
    """The shared-weight attention+MLP block: global attention at
    ``cfg.rope_theta``. Returns (x, (k, v) in a prefill, else None);
    decode writes ``k_cache`` and ``v_cache`` in place."""
    sp = params["shared_attn"]
    ap = AttnParams(**sp["attn"])
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    theta = cfg.rope_theta
    kv = None
    if mode == "full":
        a_out = attn_mod.attend_full(ap, h, cfg, window=0, theta=theta,
                                     use_kernel=use_kernels)
    elif mode == "prefill":
        a_out, k, v = attn_mod.prefill(ap, h, cfg, window=0, theta=theta,
                                       cache_len=cache_len,
                                       use_kernel=use_kernels)
        kv = (k, v)
    else:
        a_out, _, _ = attn_mod.decode_step(ap, h, k_cache, v_cache,
                                           cache_pos, cfg, window=0,
                                           theta=theta)
    x = x + a_out
    h2 = rms_norm(x, sp["ln2"], cfg.norm_eps)
    mlp = sp["mlp"]
    return x + swiglu(h2, mlp["w_gate"], mlp["w_up"], mlp["w_down"]), kv


def _run_hybrid(params, cfg, x, mode, *, cache=None, cache_pos=None,
                cache_len=None, use_kernels: bool = True):
    """n_super super-blocks of k Mamba2 layers, each followed by the
    shared block (its cache is super-block j's ``shared_k[j]``,
    ``shared_v[j]``), then the tail's L - n_super·k Mamba2 layers. A
    prefill's cache holds every layer's final states and each shared
    block's keys and values; decode writes them in place."""
    k, n_super, _ = _zamba_split(cfg)
    decode = mode == "decode"
    trunk_cache = cache if decode else None
    states, shared = ([], []), ([], [])
    for j in range(n_super):
        x = _mamba_range(params, cfg, x, range(j * k, (j + 1) * k),
                         cache=trunk_cache, states=states,
                         use_kernels=use_kernels)
        x, kv = _shared_attn_apply(
            params, cfg, x, mode,
            k_cache=cache["shared_k"][j] if decode else None,
            v_cache=cache["shared_v"][j] if decode else None,
            cache_pos=cache_pos, cache_len=cache_len,
            use_kernels=use_kernels)
        if kv is not None:
            shared[0].append(kv[0])
            shared[1].append(kv[1])
    x = _mamba_range(params, cfg, x, range(n_super * k, cfg.num_layers),
                     cache=trunk_cache, states=states,
                     use_kernels=use_kernels)
    zero = torch.zeros((), device=x.device)
    if decode:
        return x, cache, zero
    new_cache = {"ssm": torch.stack(states[0]),
                 "conv": torch.stack(states[1])}
    if mode == "prefill":  # (n_super, B, cache_len, KV, hd), n_super >= 0
        for name, kvs in (("shared_k", shared[0]), ("shared_v", shared[1])):
            new_cache[name] = torch.stack(kvs) if kvs else x.new_zeros(
                (0, x.shape[0], cache_len, cfg.num_kv_heads, cfg.head_dim))
    return x, new_cache, zero


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------
def encode(params, cfg: ModelConfig, enc_embeds, use_kernels: bool = True):
    """The bidirectional encoder over the stub frontend's frame
    embeddings (B, S_enc, d): its final states, normed."""
    x = enc_embeds.to(_dtype(cfg.activation_dtype))
    enc = params["encoder"]
    for i in range(cfg.enc_layers):
        lp = _layer(enc["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + encoder_self_attend(AttnParams(**lp["attn"]), h, cfg,
                                    use_kernel=use_kernels)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        mlp = lp["mlp"]
        x = x + swiglu(h2, mlp["w_gate"], mlp["w_up"], mlp["w_down"])
    return rms_norm(x, enc["norm"], cfg.norm_eps)


def _stacked_cross_kv(params, cfg, enc_out):
    """Each decoder layer's cross K/V, stacked: two (L, B, S_enc, KV,
    hd)."""
    ks, vs = zip(*(cross_kv(CrossAttnParams(
        **_layer(params["layers"], i)["cross"]), enc_out, cfg)
        for i in range(cfg.num_layers)))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> PyTree:
    """Pre-allocated decode cache, on ``device`` (CUDA unless the caller
    names another): attention K and V (the ring layout where
    ``uses_ring_cache``; an encoder-decoder's cross K/V beside them at
    ``enc_seq_len``); SSM: the SSD state in f32 and the conv history (the
    hybrid: and each super-block's shared K and V)."""
    check_supported(cfg)
    if uses_ring_cache(cfg):
        return init_ring_cache(cfg, batch, max_seq, dtype, device)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.activation_dtype)
    kvh = (cfg.num_kv_heads, cfg.head_dim)
    if all(k == MAMBA for k in cfg.layer_kinds()):
        _, n_heads, conv_dim = mamba_dims(cfg)
        cache = {
            "ssm": torch.zeros((cfg.num_layers, batch, n_heads,
                                cfg.ssm_head_dim, cfg.ssm_state_size),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((cfg.num_layers, batch,
                                 cfg.ssm_conv_width - 1, conv_dim),
                                dtype=dtype, device=dev),
        }
        if cfg.shared_attn_every:
            shape = (_zamba_split(cfg)[1], batch, max_seq) + kvh
            cache["shared_k"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["shared_v"] = torch.zeros(shape, dtype=dtype, device=dev)
        return cache
    shape = (cfg.num_layers, batch, max_seq) + kvh
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.is_encoder_decoder:
        shape = (cfg.num_layers, batch, cfg.enc_seq_len) + kvh
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


# ---------------------------------------------------------------------------
# Public forward
# ---------------------------------------------------------------------------
def _cross(params, cfg, mode, cache, enc_embeds, use_kernels):
    """An encoder-decoder's stacked cross K/V: the decode cache's, else
    made from ``enc_embeds`` through the encoder; None for the other
    families."""
    if not cfg.is_encoder_decoder:
        return None
    if mode == "decode":
        return cache["cross_k"], cache["cross_v"]
    if enc_embeds is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs enc_embeds "
                         "(B, enc_seq_len, d_model) outside decode")
    return _stacked_cross_kv(params, cfg,
                             encode(params, cfg, enc_embeds, use_kernels))


def _trunk(params, cfg, x, mode, *, cache=None, cache_pos=None,
           cache_len=None, cross=None, use_kernels=True):
    check_supported(cfg)
    if mode == "decode" and "ring_k" in cache:
        return _scan_ring_decode(params, cfg, x, cache, cache_pos)
    if cfg.shared_attn_every:
        return _run_hybrid(params, cfg, x, mode, cache=cache,
                           cache_pos=cache_pos, cache_len=cache_len,
                           use_kernels=use_kernels)
    if all(k == MAMBA for k in cfg.layer_kinds()):
        # mamba "prefill" == full forward; its final states are the cache
        return _scan_mamba_layers(
            params, cfg, x, "full" if mode == "prefill" else mode,
            cache=cache, use_kernels=use_kernels)
    return _scan_attn_layers(params, cfg, x, mode, cache=cache,
                             cache_pos=cache_pos, cache_len=cache_len,
                             cross=cross, use_kernels=use_kernels)


def hidden_states(params, cfg: ModelConfig, tokens=None, embeds=None,
                  enc_embeds=None, use_kernels: bool = True):
    """Final-layer hidden states (pre-unembed) and the aux loss (the MoE
    layers' sum; 0 for the other families): the frozen-backbone embedding
    interface. ``embeds`` in place of ``tokens`` (llava);
    ``enc_embeds`` for an encoder-decoder (whisper)."""
    x = _embed_in(params, cfg, tokens=tokens, embeds=embeds)
    cross = _cross(params, cfg, "full", None, enc_embeds, use_kernels)
    x, _, aux = _trunk(params, cfg, x, "full", cross=cross,
                       use_kernels=use_kernels)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


@torch.no_grad()
def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            enc_embeds=None, cache=None, cache_pos: Optional[int] = None,
            prefill_len: Optional[int] = None, use_kernels: bool = True):
    """Unified forward, no autograd (the port serves; LM training is
    ROADMAP queue A.8.5).

    Modes:
      * full    : cache=None, prefill_len=None -> (logits, None, aux)
      * prefill : prefill_len=S_max            -> (logits, cache, aux)
      * decode  : cache + cache_pos, S == 1    -> (logits, cache, aux)

    ``embeds`` (B, S, d) replaces ``tokens`` (llava's prefill); an
    encoder-decoder takes ``enc_embeds`` (B, enc_seq_len, d) outside
    decode, and decode reads the cross K/V from the cache. A decode
    cache in the ring layout (``ring_cache_from_full``) decodes through
    the ring; aux is the MoE layers' summed loss (0 in a ring decode and
    for the other families). The SSM families return their final states
    in the full mode too, as the reference does.
    """
    x = _embed_in(params, cfg, tokens=tokens, embeds=embeds)
    mode = "full"
    if prefill_len is not None:
        mode = "prefill"
    elif cache is not None:
        mode = "decode"
    cross = _cross(params, cfg, mode, cache, enc_embeds, use_kernels)
    x, new_cache, aux = _trunk(params, cfg, x, mode, cache=cache,
                               cache_pos=cache_pos, cache_len=prefill_len,
                               cross=cross, use_kernels=use_kernels)
    return _unembed(params, cfg, x), new_cache, aux
