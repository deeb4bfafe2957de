"""Backbone assembler: init and forward for the dense (all-attention) and
the pure-SSM (all-Mamba2) families (the reference's
``models/transformer.py``).

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

MoE, the zamba2 hybrid, the encoder-decoder, the embeddings input and
the ring cache are refused with ``NotImplementedError`` (ROADMAP queue
A.8).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, GLOBAL, MAMBA, ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import AttnParams, init_attn_params
from repro_torch.models.layers import ParamInit, rms_norm, softcap, swiglu
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
    """Refuse what the port's models do not run yet."""
    kinds = set(cfg.layer_kinds())
    missing = [what for what, bad in (
        ("MoE layers", cfg.is_moe),
        ("the Mamba2/shared-attention hybrid",
         cfg.shared_attn_every or len(kinds) > 1),
        ("the encoder-decoder", cfg.is_encoder_decoder),
        ("the embeddings input", cfg.input_kind != "tokens"),
        ("the ring cache", cfg.ring_cache),
        ("post-norms", cfg.use_post_norm)) if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port does not run {', '.join(missing)} yet "
            "(ROADMAP queue A.8)")


def _stack_layers(layers: list) -> dict:
    """[layer dict] -> one dict, each leaf stacked on a leading L axis
    (a NamedTuple of params becomes a dict by field name; None stays)."""
    def stack(items):
        first = items[0]
        if first is None:
            return None
        if isinstance(first, tuple) and hasattr(first, "_fields"):
            return {f: stack([getattr(it, f) for it in items])
                    for f in first._fields}
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        return torch.stack(items)

    return stack(layers)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------
def _init_mlp(init: ParamInit, d, ff, dtype):
    return {
        "w_gate": init.dense((d, ff), dtype),
        "w_up": init.dense((d, ff), dtype),
        "w_down": init.dense((ff, d), dtype),
    }


def _init_attn_layer(init: ParamInit, cfg: ModelConfig, dtype) -> dict:
    return {
        "ln1": init.zeros((cfg.d_model,), dtype),
        "attn": init_attn_params(init, cfg, dtype),
        "ln2": init.zeros((cfg.d_model,), dtype),
        "mlp": _init_mlp(init, cfg.d_model, cfg.d_ff, dtype),
    }


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
    one = (_init_attn_layer if cfg.layer_kinds()[0] == ATTN
           else _init_mamba_layer)
    params["layers"] = _stack_layers(
        [one(init, cfg, dtype) for _ in range(cfg.num_layers)])
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
def _embed_in(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens].to(_dtype(cfg.activation_dtype))
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
def _attn_layer(cfg: ModelConfig, mode: str, lp: dict, x, window: int,
                theta: float, *, k_cache=None, v_cache=None, cache_pos=None,
                cache_len=None, use_kernels: bool = True):
    """One dense layer. Returns (x, (k, v) or None)."""
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
    x = x + a_out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    mlp = lp["mlp"]
    x = x + swiglu(h2, mlp["w_gate"], mlp["w_up"], mlp["w_down"])
    return x, kv


def _scan_attn_layers(params, cfg, x, mode, *, cache=None, cache_pos=None,
                      cache_len=None, use_kernels: bool = True):
    windows, thetas = layer_windows_thetas(cfg)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        kw = {}
        if mode == "decode":
            kw = dict(k_cache=cache["k"][i], v_cache=cache["v"][i],
                      cache_pos=cache_pos)
        x, kv = _attn_layer(cfg, mode, _layer(params["layers"], i), x,
                            int(windows[i]), float(thetas[i]),
                            cache_len=cache_len, use_kernels=use_kernels,
                            **kw)
        if mode == "prefill":
            ks.append(kv[0])
            vs.append(kv[1])
    new_cache = None
    if mode == "prefill":
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    elif mode == "decode":
        new_cache = cache  # written in place, layer by layer
    return x, new_cache, torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# Mamba-family (pure SSM) layers
# ---------------------------------------------------------------------------
def _scan_mamba_layers(params, cfg, x, mode, *, cache=None,
                       use_kernels: bool = True):
    decode = mode == "decode"
    ssm, conv = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        out, (ssm_s, conv_s) = mamba_block(
            MambaParams(**lp["mamba"]), h, cfg,
            ssm_state=cache["ssm"][i] if decode else None,
            conv_state=cache["conv"][i] if decode else None,
            decode=decode, use_kernel=use_kernels)
        x = x + out
        if decode:  # the stacked cache, written in place
            cache["ssm"][i].copy_(ssm_s)
            cache["conv"][i].copy_(conv_s)
        else:
            ssm.append(ssm_s)
            conv.append(conv_s)
    new_cache = cache if decode else {"ssm": torch.stack(ssm),
                                      "conv": torch.stack(conv)}
    return x, new_cache, torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> PyTree:
    """Pre-allocated decode cache (attention: K and V; SSM: the SSD state
    in f32 and the conv history), on ``device`` (CUDA unless the caller
    names another)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg.activation_dtype)
    if all(k == MAMBA for k in cfg.layer_kinds()):
        _, n_heads, conv_dim = mamba_dims(cfg)
        return {
            "ssm": torch.zeros((cfg.num_layers, batch, n_heads,
                                cfg.ssm_head_dim, cfg.ssm_state_size),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((cfg.num_layers, batch,
                                 cfg.ssm_conv_width - 1, conv_dim),
                                dtype=dtype, device=dev),
        }
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


# ---------------------------------------------------------------------------
# Public forward
# ---------------------------------------------------------------------------
def _trunk(params, cfg, x, mode, *, cache=None, cache_pos=None,
           cache_len=None, use_kernels=True):
    check_supported(cfg)
    if all(k == MAMBA for k in cfg.layer_kinds()):
        # mamba "prefill" == full forward; its final states are the cache
        return _scan_mamba_layers(
            params, cfg, x, "full" if mode == "prefill" else mode,
            cache=cache, use_kernels=use_kernels)
    return _scan_attn_layers(params, cfg, x, mode, cache=cache,
                             cache_pos=cache_pos, cache_len=cache_len,
                             use_kernels=use_kernels)


def hidden_states(params, cfg: ModelConfig, tokens,
                  use_kernels: bool = True):
    """Final-layer hidden states (pre-unembed) and the aux loss (0 for
    these families): the frozen-backbone embedding interface."""
    x = _embed_in(params, cfg, tokens)
    x, _, aux = _trunk(params, cfg, x, "full", use_kernels=use_kernels)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


@torch.no_grad()
def forward(params, cfg: ModelConfig, *, tokens, cache=None,
            cache_pos: Optional[int] = None,
            prefill_len: Optional[int] = None, use_kernels: bool = True):
    """Unified forward, no autograd (the port serves; LM training is
    ROADMAP queue A.8).

    Modes:
      * full    : cache=None, prefill_len=None -> (logits, None, aux)
      * prefill : prefill_len=S_max            -> (logits, cache, aux)
      * decode  : cache + cache_pos, S == 1    -> (logits, cache, aux)
    """
    x = _embed_in(params, cfg, tokens)
    mode = "full"
    if prefill_len is not None:
        mode = "prefill"
    elif cache is not None:
        mode = "decode"
    x, new_cache, aux = _trunk(params, cfg, x, mode, cache=cache,
                               cache_pos=cache_pos, cache_len=prefill_len,
                               use_kernels=use_kernels)
    return _unembed(params, cfg, x), new_cache, aux
