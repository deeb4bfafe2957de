"""Plain PyTorch versions of the hand-written kernels.

Each is the most obviously correct form of what its kernel computes
(naive masked softmax and its closed-form gradient; the step-by-step
SSD recurrence; dequantize-then-matmul; a weighted sum over clients; a
stable sort per coordinate; the direct difference form of a distance;
the DP clip, int8 codec and top-k mask stage by stage over the whole
(C, P) matrix), written independently of the kernels' tiling. The
clip, codec and top-k constants (the 1e-12 norm floor, 127 levels, the
1e-30 scale floor) are restated as literals, as the reference's oracles
restate them, so an oracle never imports the code it checks. The kernel
wrappers run these on CPU tensors, and ``chip_smoke.py`` holds each
kernel against its plain version on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap=None,
                  kv_len=None) -> torch.Tensor:
    """q (B, H, S, hd), k/v (B, KV, S, hd) -> (B, H, S, hd). Naive masked
    softmax with repeated KV heads; keys at or past ``kv_len`` (default
    all) are masked too."""
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, kk) / math.sqrt(hd)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = kpos < (s if kv_len is None else kv_len)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(vv.dtype), vv)


def ref_ssd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor):
    """Step-by-step SSD recurrence (the definition, O(S) sequential).
    x (b, s, h, p); dt (b, s, h); A_log/D (h,); B/C (b, s, n) ->
    (y like x, the final state (b, h, p, n) f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    a = -torch.exp(A_log.float())
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt = x[:, t].float()  # (b, h, p)
        dtt = dt[:, t].float()  # (b, h)
        decay = torch.exp(dtt * a[None, :])
        state = (decay[..., None, None] * state
                 + torch.einsum("bhp,bn->bhpn", xt * dtt[..., None],
                                B[:, t].float()))
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t].float())
                  + xt * D[None, :, None])
    y = torch.stack(ys, dim=1) if ys else x.float()
    return y.to(x.dtype), state


def ref_gpo_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_ctx: int):
    """q/k/v (..., S, hd) with the neural-process mask (key j is allowed
    for query i iff j < num_ctx or j == i) -> (o (..., S, hd),
    lse (..., S) float32), lse being the logsumexp of the masked
    scores."""
    s, hd = q.shape[-2:]
    scores = torch.einsum("...qd,...kd->...qk", q, k) / math.sqrt(hd)
    scores = torch.where(_np_allowed(s, num_ctx, q.device), scores,
                         NEG_INF).float()
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("...qk,...kd->...qd", probs, v), lse


def _np_allowed(s: int, num_ctx: int, device) -> torch.Tensor:
    """(S, S) bool: key j is allowed for query i iff j < num_ctx or
    j == i."""
    pos = torch.arange(s, device=device)
    return (pos[None, :] < num_ctx) | (pos[None, :] == pos[:, None])


def _bwd_terms(q, k, v, do, lse, delta, num_ctx):
    """The backward's per-pair terms over the whole (S, S) plane: the
    probabilities p = exp(s - lse) on the mask (0 off it) and
    ds = p * (do v^T - delta) * scale."""
    s, hd = q.shape[-2:]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("...qd,...kd->...qk", q, k) * scale
    p = torch.where(_np_allowed(s, num_ctx, q.device),
                    torch.exp(scores - lse[..., None]), 0.0)
    dp = torch.einsum("...qd,...kd->...qk", do, v)
    return p, p * (dp - delta[..., None]) * scale


def ref_gpo_attention_bwd_dq(q, k, v, do, lse, delta, *,
                             num_ctx: int) -> torch.Tensor:
    """dq (..., S, hd) = ds @ k, from the forward's lse and the
    preprocessed delta = rowsum(do * o)."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, num_ctx)
    return torch.einsum("...qk,...kd->...qd", ds, k)


def ref_gpo_attention_bwd_dkdv(q, k, v, do, lse, delta, *, num_ctx: int):
    """(dk = ds^T @ q, dv = p^T @ do), each (..., S, hd)."""
    p, ds = _bwd_terms(q, k, v, do, lse, delta, num_ctx)
    return (torch.einsum("...qk,...qd->...kd", ds, q),
            torch.einsum("...qk,...qd->...kd", p, do))


def ref_gpo_attention_bwd(q, k, v, o, lse, do, *, num_ctx: int):
    """(dq, dk, dv) of the neural-process attention in closed form, from
    the forward's output o and lse and the cotangent do:
    delta = rowsum(do * o), p = exp(s - lse) on the mask,
    ds = p * (do v^T - delta) * scale."""
    delta = (do * o).sum(dim=-1)
    dq = ref_gpo_attention_bwd_dq(q, k, v, do, lse, delta, num_ctx=num_ctx)
    dk, dv = ref_gpo_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                        num_ctx=num_ctx)
    return dq, dk, dv


def ref_fedavg_flat(stacked: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Eq. 3 on raveled clients: stacked (C, P), weights (C,) -> (P,),
    sum_c w_c x_c in float32, cast to the stacked dtype."""
    return torch.einsum("c,cp->p", weights.float(),
                        stacked.float()).to(stacked.dtype)


def ref_momentum_reduce_flat(stacked: torch.Tensor, weights: torch.Tensor,
                             moment: torch.Tensor, *, beta: float):
    """Weighted delta moment and server momentum, the obvious two-liner:
    (delta = sum_c w_c x_c, cast to the stacked dtype;
    beta * moment + delta in float32)."""
    d = torch.einsum("c,cp->p", weights.float(), stacked.float())
    nm = beta * moment.float() + d
    return d.to(stacked.dtype), nm


def ref_trimmed_flat(stacked: torch.Tensor, weights: torch.Tensor, *,
                     trim: int) -> torch.Tensor:
    """Rank-trimmed weighted mean through an explicit stable sort: sort
    each coordinate's clients (ties by client index), drop ``trim`` at
    each end, weighted mean of the survivors with their weights
    renormalised."""
    x = stacked.float()
    c = x.shape[0]
    xs, order = torch.sort(x, dim=0, stable=True)
    ws = weights.float()[order]
    pos = torch.arange(c, device=x.device)
    keep = ((pos >= trim) & (pos < c - trim)).float()[:, None]
    num = (keep * ws * xs).sum(dim=0)
    den = (keep * ws).sum(dim=0)
    return (num / den).to(stacked.dtype)


def ref_pairwise_sq_dists(stacked: torch.Tensor) -> torch.Tensor:
    """(C, P) deltas -> (C, C) pairwise squared L2 distances in the
    direct difference form sum_p (x_i[p] - x_j[p])^2, independent of the
    kernel's expansion form |x_i|^2 + |x_j|^2 - 2 x_i.x_j. One row of
    the output at a time, so that it holds (C, P) and not (C, C, P)."""
    x = stacked.float()
    return torch.stack([((x[i] - x) ** 2).sum(dim=-1)
                        for i in range(x.shape[0])])


def _clip_scale(x: torch.Tensor, clip: float) -> torch.Tensor:
    """(C, P) -> (C,) min(1, clip / max(‖x_c‖₂, 1e-12)). Both divisions
    of this module are tensor by tensor: PyTorch computes ``scalar /
    tensor`` as a reciprocal times the scalar (and, on CUDA, ``tensor /
    scalar`` too), one rounding more than the IEEE quotient that the
    kernels and the JAX package take."""
    norms = torch.sqrt(torch.square(x).sum(dim=1))
    return torch.clamp(torch.full_like(norms, clip)
                       / torch.clamp(norms, min=1e-12), max=1.0)


def ref_clip_reduce(stacked: torch.Tensor, weights: torch.Tensor, *,
                    clip: float, noise=None) -> torch.Tensor:
    """The DP-FedAvg reduction written out: per-client L2 norm, scale to
    the clip bound min(1, clip / max(norm, 1e-12)), optional presampled
    noise added, weighted sum over the clients -> (P,) float32."""
    x = stacked.float()
    y = x * _clip_scale(x, clip)[:, None]
    if noise is not None:
        y = y + noise.float()
    return torch.einsum("c,cp->p", weights.float(), y)


def ref_quant_clip_reduce(stacked: torch.Tensor, weights: torch.Tensor, *,
                          clip: float = 0.0, noise=None, uniform=None,
                          resid=None):
    """The quantized transport written out stage by stage: DP release
    (clip > 0: scale to the bound, add the presampled noise), the EF
    residual added, per-client symmetric int8 quantization (scale =
    absmax / 127 floored at 1e-30; stochastic rounding floor(z + u) from
    the presampled uniforms, round half to even without them),
    dequantize, weighted sum. Returns (reduced (P,), new residual (C, P)
    or None), both float32."""
    x = stacked.float()
    if clip > 0.0:
        x = x * _clip_scale(x, clip)[:, None]
        if noise is not None:
            x = x + noise.float()
    if resid is not None:
        x = x + resid.float()
    amax = x.abs().amax(dim=1)
    scales = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-30)
    z = x / scales[:, None]
    q = (torch.floor(z + uniform.float()) if uniform is not None
         else torch.round(z))
    t = torch.clamp(q, -127.0, 127.0) * scales[:, None]
    out = torch.einsum("c,cp->p", weights.float(), t)
    return out, (x - t if resid is not None else None)


def ref_topk_mask_reduce(stacked: torch.Tensor, weights: torch.Tensor,
                         thresholds: torch.Tensor, *,
                         with_residual: bool = False):
    """Given per-client magnitude thresholds (C,): keep the entries
    whose magnitude reaches the client's threshold (ties kept), zero the
    rest, weighted sum of the survivors. Returns (reduced (P,), the
    masked-out remainder (C, P) or None), float32."""
    x = stacked.float()
    t = torch.where(x.abs() >= thresholds.float()[:, None], x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    out = torch.einsum("c,cp->p", weights.float(), t)
    return out, (x - t if with_residual else None)


def ref_topk_reduce(stacked: torch.Tensor, weights: torch.Tensor, *,
                    frac: float):
    """Top-k transport: per client keep the entries whose magnitude
    reaches the ceil(frac·P)-th largest |value| (the threshold from a
    full sort; ties kept), zero the rest, weighted-sum the survivors.
    Returns (reduced (P,), masked-out remainder (C, P)): the remainder
    is the EF residual."""
    x = stacked.float()
    p = x.shape[1]
    k = max(1, int(math.ceil(frac * p)))
    tau = torch.sort(x.abs(), dim=1).values[:, p - k]
    return ref_topk_mask_reduce(x, weights, tau, with_residual=True)


def ref_int8_matmul(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Weight-only-quantized dense layer written out as dequantize-then-
    matmul: x (M, K) f32, q (K, N) int8, scale (N,) f32 -> (M, N) f32.
    The kernel applies the scale after the reduction instead (a
    per-column constant commutes with the sum over k)."""
    w = q.float() * scale.float()[None, :]
    return x.float() @ w
