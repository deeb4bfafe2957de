"""GPO: the transformer-based group preference predictor (Zhao et al. 2023),
the module PluralLLM trains federatedly; PyTorch port of
``repro/core/gpo.py``.

A transformer neural process (TNP-style):

* every (embedding x, preference y) pair becomes one token [x ; y ; is_ctx];
  target tokens carry y = 0 and is_ctx = 0;
* NO positional encoding — the predictor is permutation-invariant in the
  context set;
* the neural-process mask: context tokens attend to context tokens;
  target tokens attend to context tokens and themselves, never to other
  targets;
* the head reads target tokens and emits the predicted preference.

Every function takes an optional leading batch axis written out (the JAX
package vmaps instead): ctx_x (m, d_embed) or (B, m, d_embed), and so on.
``gpo_apply`` and ``gpo_loss`` also take *client-stacked* params, every
leaf with a leading C axis (``core/fedavg.py::broadcast_to_clients``),
against batched inputs with B = C: client c's batch meets client c's
weights, ``x @ w`` broadcasts (C, S, d) @ (C, d, e), and one attention
launch per layer covers every client and head. That is the reference's
``jax.vmap(local_train)`` written out. They run on the device of their
inputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GPOConfig
from repro_torch.kernels import gpo_attention, int8_matmul
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.quant_matmul import QuantizedLinear
from repro_torch.models.layers import dense_init, rms_norm

NEG_INF = -1e30


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """Dense-layer matmul with weight-format dispatch: plain f32 weights
    multiply directly; ``QuantizedLinear`` weights (the serving engine's
    load-time int8 weights, DESIGN.md §12) go through the int8 kernel,
    with every leading axis of x flattened into one launch."""
    if isinstance(w, QuantizedLinear):
        return int8_matmul(x, w.q, w.scale)
    return x @ w


class GPOLayer(NamedTuple):
    ln1: torch.Tensor
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    ln2: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor


def map_params(fn, tree):
    """Apply ``fn`` to every tensor of a params tree (dicts, GPOLayer and
    QuantizedLinear NamedTuples), keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(map_params(fn, v) for v in tree))
    return fn(tree)


def _layer(layers: GPOLayer, i: int, clients: bool = False) -> GPOLayer:
    """Layer i of the stacked (L, ...) weights, or (C, L, ...) for
    client-stacked params."""
    return map_params(lambda a: a[:, i] if clients else a[i], layers)


def _client_stacked(params: dict, batched: bool, b: int) -> bool:
    """Whether ``params`` carry a leading client axis (their norm scales
    are (C, d) rather than (d,)); such params need a batch of B = C."""
    if params["final_norm"].dim() == 1:
        return False
    c = params["final_norm"].shape[0]
    if not batched or b != c:
        raise ValueError(f"client-stacked params ({c} clients) need "
                         f"inputs batched over the same {c} clients")
    return True


def init_gpo_params(cfg: GPOConfig, generator: torch.Generator, *,
                    device=None) -> dict:
    """Random GPO params drawn from ``generator`` (a CPU generator, so a
    seed gives the same weights on every device), placed on ``device``
    (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    d, L = cfg.d_model, cfg.num_layers
    out_dim = 2 if cfg.learn_sigma else 1
    # token = [x ; y ; is_context] -> d_model
    in_proj = dense_init(generator, (cfg.d_embed + 2, d), dtype=dtype)

    def stack(shape):
        return torch.stack([dense_init(generator, shape, dtype=dtype)
                            for _ in range(L)])

    layers = GPOLayer(
        ln1=torch.zeros((L, d), dtype=dtype),
        wq=stack((d, d)), wk=stack((d, d)), wv=stack((d, d)),
        wo=stack((d, d)),
        ln2=torch.zeros((L, d), dtype=dtype),
        w1=stack((d, cfg.d_ff)), w2=stack((cfg.d_ff, d)))
    params = {
        "in_proj": in_proj,
        "layers": layers,
        "final_norm": torch.zeros((d,), dtype=dtype),
        "head": dense_init(generator, (d, out_dim), dtype=dtype),
    }
    return map_params(lambda a: a.to(dev), params)


def params_from_numpy(tree, device) -> dict:
    """The JAX package's GPO params as numpy arrays (same dict/GPOLayer
    structure, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) ->
    this package's params on ``device``. Leaves with ``q``/``scale``
    fields (quantized weights) become ``QuantizedLinear``."""
    dev = resolve_device(device)

    def leaf(a):
        if hasattr(a, "q") and hasattr(a, "scale"):
            return QuantizedLinear(leaf(a.q), leaf(a.scale))
        return torch.as_tensor(np.array(a), device=dev)

    layers = tree["layers"]
    get = layers.__getitem__ if isinstance(layers, dict) else \
        lambda f: getattr(layers, f)
    return {
        "in_proj": leaf(tree["in_proj"]),
        "layers": GPOLayer(*(leaf(get(f)) for f in GPOLayer._fields)),
        "final_norm": leaf(tree["final_norm"]),
        "head": leaf(tree["head"]),
    }


def _np_mask(num_ctx: int, num_tgt: int, device=None) -> torch.Tensor:
    """Neural-process attention mask (S, S), S = m + t.

    allowed[i, j] = True iff token i may attend token j:
      * j < m (context): always allowed,
      * j >= m: only if i == j (target self-attention).
    """
    s = num_ctx + num_tgt
    is_ctx_col = torch.arange(s, device=device) < num_ctx
    eye = torch.eye(s, dtype=torch.bool, device=device)
    return is_ctx_col[None, :].expand(s, s) | eye


def _batched(*xs):
    """Add a leading batch axis to unbatched inputs; returns the inputs
    and whether they came batched."""
    batched = xs[0].dim() == 3
    return (xs if batched else tuple(x[None] for x in xs)), batched


def gpo_apply(params: dict, cfg: GPOConfig, ctx_x, ctx_y, tgt_x):
    """Predict target preferences.

    ctx_x (m, d_embed), ctx_y (m,), tgt_x (t, d_embed)
    -> (mu (t,), log_sigma (t,) or None); with a leading batch axis B on
    all three inputs, the outputs carry it too.
    """
    (ctx_x, ctx_y, tgt_x), batched = _batched(ctx_x, ctx_y, tgt_x)
    b, m = ctx_x.shape[:2]
    t = tgt_x.shape[1]
    s = m + t
    ctx_tok = torch.cat([ctx_x, ctx_y[..., None], ctx_x.new_ones(b, m, 1)],
                        dim=-1)
    tgt_tok = torch.cat([tgt_x, tgt_x.new_zeros(b, t, 2)], dim=-1)
    tokens = torch.cat([ctx_tok, tgt_tok], dim=1)  # (B, S, d_embed+2)

    clients = _client_stacked(params, batched, b)

    def norm(x, scale):  # client norm scales (C, d) broadcast as (C, 1, d)
        return rms_norm(x, scale[:, None] if clients else scale,
                        cfg.norm_eps)

    x = _mm(tokens, params["in_proj"])  # (B, S, d)
    h_dim, nh = cfg.head_dim, cfg.num_heads
    mask = None if cfg.use_pallas_attention else _np_mask(m, t, x.device)
    for i in range(cfg.num_layers):
        layer = _layer(params["layers"], i, clients)
        h = norm(x, layer.ln1)
        q = _mm(h, layer.wq).reshape(b, s, nh, h_dim)
        k = _mm(h, layer.wk).reshape(b, s, nh, h_dim)
        v = _mm(h, layer.wv).reshape(b, s, nh, h_dim)
        if cfg.use_pallas_attention:
            # the banded CUDA kernels (forward, and dq and dk/dv under
            # autograd): no (heads, S, S) score tensor
            att = gpo_attention(q, k, v, num_ctx=m).reshape(b, s, -1)
        else:
            scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(h_dim)
            scores = torch.where(mask, scores, NEG_INF)
            probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
            att = torch.einsum("bhij,bjhd->bihd", probs, v).reshape(b, s, -1)
        x = x + _mm(att, layer.wo)
        h2 = norm(x, layer.ln2)
        x = x + _mm(F.gelu(_mm(h2, layer.w1), approximate="tanh"), layer.w2)
    x = norm(x, params["final_norm"])
    out = _mm(x[:, m:], params["head"])  # (B, t, 1 or 2)
    mu = out[..., 0]
    log_sigma = out[..., 1] if cfg.learn_sigma else None
    if not batched:
        mu = mu[0]
        log_sigma = None if log_sigma is None else log_sigma[0]
    return mu, log_sigma


class GPOPrefix(NamedTuple):
    """Per-layer context K/V from ``gpo_prefill`` — the reusable half of
    a GPO forward pass (DESIGN.md §12).

    The neural-process mask makes the split exact: context tokens attend
    only to context tokens, so every layer's context keys/values are
    independent of the targets later decoded against them. ``k``/``v``
    are (L, M, nh, hd), or (B, L, M, nh, hd) batched; rows at positions
    >= the ``ctx_len`` the prefix was built with are padding and are
    masked by the consumer."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_ctx(self) -> int:
        return self.k.shape[-3]


def _key_mask(num_keys: int, ctx_len, device=None) -> Optional[torch.Tensor]:
    """(num_keys,) or (B, num_keys) bool — True for real context
    positions. ``ctx_len`` is an int, a (B,) tensor, or None (every
    position is real)."""
    if ctx_len is None:
        return None
    pos = torch.arange(num_keys, device=device)
    return pos < torch.as_tensor(ctx_len, device=device)[..., None]


def gpo_prefill(params: dict, cfg: GPOConfig, ctx_x, ctx_y,
                ctx_len=None) -> GPOPrefix:
    """Run the context block alone and cache per-layer K/V.

    ctx_x (M, d_embed), ctx_y (M,) — or batched (B, M, ...) with
    ``ctx_len`` (B,). M may include padding rows past ``ctx_len``; they
    are excluded as attention keys, so their (finite) hidden states never
    influence real rows."""
    (ctx_x, ctx_y), batched = _batched(ctx_x, ctx_y)
    b, m = ctx_x.shape[:2]
    tokens = torch.cat([ctx_x, ctx_y[..., None], ctx_x.new_ones(b, m, 1)],
                       dim=-1)
    x = _mm(tokens, params["in_proj"])  # (B, M, d)
    h_dim, nh = cfg.head_dim, cfg.num_heads
    mask = _key_mask(m, ctx_len, x.device)
    if mask is not None:
        mask = mask.expand(b, m)[:, None, None, :]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        layer = _layer(params["layers"], i)
        h = rms_norm(x, layer.ln1, cfg.norm_eps)
        q = _mm(h, layer.wq).reshape(b, m, nh, h_dim)
        k = _mm(h, layer.wk).reshape(b, m, nh, h_dim)
        v = _mm(h, layer.wv).reshape(b, m, nh, h_dim)
        scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(h_dim)
        if mask is not None:
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
        att = torch.einsum("bhij,bjhd->bihd", probs, v).reshape(b, m, -1)
        x = x + _mm(att, layer.wo)
        h2 = rms_norm(x, layer.ln2, cfg.norm_eps)
        x = x + _mm(F.gelu(_mm(h2, layer.w1), approximate="tanh"), layer.w2)
        ks.append(k)
        vs.append(v)
    k, v = torch.stack(ks, dim=1), torch.stack(vs, dim=1)  # (B, L, M, ...)
    return GPOPrefix(k=k, v=v) if batched else GPOPrefix(k=k[0], v=v[0])


def gpo_decode(params: dict, cfg: GPOConfig, prefix: GPOPrefix, tgt_x,
               ctx_len=None):
    """Decode targets against a cached context prefix.

    tgt_x (T, d_embed) -> (mu (T,), log_sigma (T,) or None), or batched
    (B, T, d_embed) against a batched prefix. Each target token attends
    to the prefix keys (masked to ``ctx_len``) plus itself — an
    (nh, T, M+1) score tensor per group. Padded target rows produce
    finite garbage and are sliced off by the caller.
    """
    (tgt_x,), batched = _batched(tgt_x)
    pk, pv = (prefix.k, prefix.v) if batched else (prefix.k[None],
                                                   prefix.v[None])
    b, t = tgt_x.shape[:2]
    mctx = prefix.num_ctx
    tokens = torch.cat([tgt_x, tgt_x.new_zeros(b, t, 2)], dim=-1)
    x = _mm(tokens, params["in_proj"])  # (B, T, d)
    h_dim, nh = cfg.head_dim, cfg.num_heads
    mask = _key_mask(mctx, ctx_len, x.device)
    if mask is not None:
        full = torch.cat([mask.expand(b, mctx),  # self always attends
                          torch.ones((b, 1), dtype=torch.bool,
                                     device=x.device)], dim=-1)
        full = full[:, None, None, :]
    inv_sqrt = 1.0 / math.sqrt(h_dim)
    for i in range(cfg.num_layers):
        layer = _layer(params["layers"], i)
        kc, vc = pk[:, i], pv[:, i]  # (B, M, nh, hd)
        h = rms_norm(x, layer.ln1, cfg.norm_eps)
        q = _mm(h, layer.wq).reshape(b, t, nh, h_dim)
        k_self = _mm(h, layer.wk).reshape(b, t, nh, h_dim)
        v_self = _mm(h, layer.wv).reshape(b, t, nh, h_dim)
        sc_ctx = torch.einsum("bihd,bjhd->bhij", q, kc) * inv_sqrt
        sc_self = (q * k_self).sum(-1).transpose(1, 2)[..., None] * inv_sqrt
        scores = torch.cat([sc_ctx, sc_self], dim=-1)  # (B, h, T, M+1)
        if mask is not None:
            scores = torch.where(full, scores, NEG_INF)
        probs = torch.softmax(scores.float(), dim=-1).to(v_self.dtype)
        att = (torch.einsum("bhij,bjhd->bihd", probs[..., :mctx], vc)
               + probs[..., mctx:].transpose(1, 2) * v_self)
        x = x + _mm(att.reshape(b, t, -1), layer.wo)
        h2 = rms_norm(x, layer.ln2, cfg.norm_eps)
        x = x + _mm(F.gelu(_mm(h2, layer.w1), approximate="tanh"), layer.w2)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = _mm(x, params["head"])  # (B, T, 1 or 2)
    mu = out[..., 0]
    log_sigma = out[..., 1] if cfg.learn_sigma else None
    if not batched:
        mu = mu[0]
        log_sigma = None if log_sigma is None else log_sigma[0]
    return mu, log_sigma


def gpo_loss(params: dict, cfg: GPOConfig, ctx_x, ctx_y, tgt_x, tgt_y):
    """Eq. 1: NLL of target preferences given context (Gaussian p_theta),
    the mean over target points. A scalar, or (B,) with a batch axis
    (per client with client-stacked params): a trainer sums the clients'
    losses, so that each client's gradient is its own loss's."""
    mu, log_sigma = gpo_apply(params, cfg, ctx_x, ctx_y, tgt_x)
    if log_sigma is None:
        return (mu - tgt_y).square().mean(dim=-1)
    inv_var = torch.exp(-2.0 * log_sigma)
    return (0.5 * inv_var * (mu - tgt_y).square() + log_sigma).mean(dim=-1)


def predict_preferences(params: dict, cfg: GPOConfig, ctx_x, ctx_y, tgt_x,
                        num_options: int, *, device=None) -> torch.Tensor:
    """Predicted preference distributions per target question.

    tgt_x is (t*A, d_embed) grouped by question (A consecutive options),
    optionally with a leading batch axis. Returns (t, A) rows on the
    simplex (clip-and-normalize, GPO's eval), (B, t, A) batched. The
    inputs (arrays or tensors) are placed on ``device``, CUDA unless the
    caller names another; ``params`` must already lie there."""
    dev = resolve_device(device)
    ctx_x, ctx_y, tgt_x = (torch.as_tensor(a, device=dev)
                           for a in (ctx_x, ctx_y, tgt_x))
    mu, _ = gpo_apply(params, cfg, ctx_x, ctx_y, tgt_x)
    scores = mu.reshape(*mu.shape[:-1], -1, num_options).clamp(min=1e-4)
    return scores / scores.sum(dim=-1, keepdim=True)
