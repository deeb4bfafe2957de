"""Mixture-of-Experts MLP with top-k routing and capacity-bounded
scatter/gather dispatch (the reference's ``models/moe.py``).

* Dispatch is sort/scatter based: each (token, choice) pair takes the
  next free slot of its expert's (E, cap, d) buffer, so the expert FFN is
  one batched product (E, cap, d) x (E, d, ff) and moves T·k·d bytes, not
  a one-hot einsum's T·E·cap·d.
* Tokens past an expert's capacity ``cap = ceil8(T·k/E · factor + 1)``
  are dropped (a standard dropping MoE); the Switch-style aux loss keeps
  the load balanced.
* The top-k keeps ``lax.top_k``'s tie order, lower expert index first
  (``torch.topk`` does not promise one), and the combine adds each
  token's k weighted outputs in choice order, as the reference's
  ``.at[token_of_pair].add`` does with ``token_of_pair = repeat(arange(T),
  k)``: a fixed order, so two runs of one step give the same bits (an
  ``index_add_`` adds with atomics in no set order on CUDA).

The port has no sharding context, so the reference's token blocks are
one block (its ``nb = 1``, ``shard_act`` the identity). The blocked
dispatch waits for ``models/partitioning.py`` with LM training (ROADMAP
queue A.7's leftover, A.8.5).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamInit

CAPACITY_FACTOR = 1.25


class MoEParams(NamedTuple):
    router: torch.Tensor  # (d, E), f32
    w_gate: torch.Tensor  # (E, d, ff)
    w_up: torch.Tensor  # (E, d, ff)
    w_down: torch.Tensor  # (E, ff, d)


def init_moe_params(init: ParamInit, cfg, dtype) -> MoEParams:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return MoEParams(
        router=init.dense((d, e), torch.float32),
        w_gate=init.dense((e, d, f), dtype, in_axis=1),
        w_up=init.dense((e, d, f), dtype, in_axis=1),
        w_down=init.dense((e, f, d), dtype, in_axis=1),
    )


def expert_capacity(num_tokens: int, num_experts: int, k: int,
                    factor: float = CAPACITY_FACTOR) -> int:
    cap = int(num_tokens * k / num_experts * factor) + 1
    # a multiple of 8, as the reference aligns it
    return max(8, -(-cap // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    to the lower index first (``lax.top_k``'s order): a stable sort."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _dispatch_block(xf, topk_idx, num_experts: int, k: int, cap: int):
    """Scatter the tokens into their (E, cap, d) expert buffer.

    Returns (expert_in, target, keep): ``target`` is each pair's row of
    the flat buffer (E·cap for a dropped pair, a sink row), ``keep``
    whether the pair found a slot."""
    d = xf.shape[1]
    flat_expert = topk_idx.reshape(-1)  # (T*k,), token-major
    # a pair's slot: the earlier pairs of its expert. The one-hot is laid
    # out (E, T*k) so the scan runs along its last axis: torch's scan
    # along a leading axis of E columns took 14 ms a granite-moe layer
    # on an H100 (PERF.md §5, lm-granite)
    onehot = F.one_hot(flat_expert, num_experts).T.contiguous()
    pos_in_expert = torch.cumsum(onehot, dim=1) - onehot  # (E, T*k)
    slot = pos_in_expert.gather(0, flat_expert[None, :])[0]
    keep = slot < cap
    target = torch.where(keep, flat_expert * cap + slot,
                         num_experts * cap)
    buf = xf.new_zeros((num_experts * cap + 1, d))
    buf[target] = xf.repeat_interleave(k, dim=0)  # the pairs' tokens
    expert_in = buf[: num_experts * cap].reshape(num_experts, cap, d)
    return expert_in, target, keep


def _combine_block(expert_out, target, keep, topk_probs, k: int):
    """Gather the expert outputs back to token order, weighted, each
    token's k pairs added in choice order."""
    e, cap, d = expert_out.shape
    flat_out = torch.cat([expert_out.reshape(e * cap, d),
                          expert_out.new_zeros((1, d))])
    w = (topk_probs.reshape(-1) * keep).to(flat_out.dtype)
    contrib = (flat_out[target] * w[:, None]).reshape(-1, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def moe_ffn(p: MoEParams, x: torch.Tensor, num_experts: int, k: int,
            aux_coef: float = 0.01,
            capacity_factor: float = CAPACITY_FACTOR):
    """x (B, S, d) -> (out (B, S, d), the aux loss, a () f32 tensor)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)

    logits = xf.float() @ p.router  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topk_probs, topk_idx = top_k(probs, k)  # (T, k)
    # renormalise the chosen experts' weights (mixtral/grok convention)
    topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True).clamp_min(
        1e-9)

    # load-balance aux loss (Switch-style, over all tokens)
    me = probs.mean(dim=0)  # (E,) mean router prob
    ce = F.one_hot(topk_idx[:, 0], num_experts).float().mean(dim=0)
    aux = aux_coef * num_experts * torch.sum(me * ce)

    cap = expert_capacity(t, num_experts, k, capacity_factor)
    expert_in, target, keep = _dispatch_block(xf, topk_idx, num_experts, k,
                                              cap)
    # the expert FFN (SwiGLU), batched over experts
    g = torch.bmm(expert_in, p.w_gate)
    u = torch.bmm(expert_in, p.w_up)
    h = F.silu(g.float()).to(u.dtype) * u
    expert_out = torch.bmm(h, p.w_down)
    out = _combine_block(expert_out, target, keep, topk_probs, k)
    return out.reshape(b, s, d).to(x.dtype), aux
