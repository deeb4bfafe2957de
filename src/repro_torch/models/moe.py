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

* Tokens are dispatched in ``nb`` independent blocks, each with its own
  capacity ``expert_capacity(T / nb, ...)``, as the reference's vmapped
  dispatch: ``nb`` is ``logical_axis_size("capacity")`` under an
  ``activation_sharding`` context (the data axes' size; 1 without a
  context, or where it does not divide T). The blocks run batched, with
  no value-dependent shape and no host read, so the dry run's meta step
  takes them too. With ``nb = 1`` the values are the one-block
  dispatch's, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamInit
from repro_torch.models.partitioning import logical_axis_size, shard_act

CAPACITY_FACTOR = 1.25


def _shard_moe_blocked(x):
    """(nb, E, C_local, d): token blocks over data, experts over model."""
    return shard_act(x, ("capacity", "experts", None, "embed"))


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


def _dispatch_block(xb, topk_idx, num_experts: int, k: int, cap: int):
    """Scatter each token block into its (E, cap, d) expert buffer.

    xb (nb, tl, d), topk_idx (nb, tl, k). Returns (expert_in (nb, E,
    cap, d), target, keep), both (nb, tl·k): ``target`` is each pair's
    row of its block's flat buffer (E·cap for a dropped pair, a sink
    row), ``keep`` whether the pair found a slot."""
    nb, tl, d = xb.shape
    rows = num_experts * cap + 1
    flat_expert = topk_idx.reshape(nb, tl * k)  # token-major in a block
    # a pair's slot: the earlier pairs of its expert in its block. The
    # one-hot is laid out (nb, E, tl*k) so the scan runs along its last
    # axis: torch's scan along a leading axis of E columns took 14 ms a
    # granite-moe layer on an H100 (PERF.md §5, lm-granite)
    onehot = F.one_hot(flat_expert, num_experts).transpose(1, 2).contiguous()
    pos_in_expert = torch.cumsum(onehot, dim=2) - onehot  # (nb, E, tl*k)
    slot = pos_in_expert.gather(1, flat_expert[:, None, :])[:, 0]
    keep = slot < cap
    target = torch.where(keep, flat_expert * cap + slot, num_experts * cap)
    buf = xb.new_zeros((nb * rows, d))
    block = torch.arange(nb, device=xb.device)[:, None] * rows
    # the pairs' tokens
    buf[(target + block).reshape(-1)] = xb.repeat_interleave(
        k, dim=1).reshape(-1, d)
    expert_in = buf.reshape(nb, rows, d)[:, :rows - 1].reshape(
        nb, num_experts, cap, d)
    return expert_in, target, keep


def _combine_block(expert_out, target, keep, topk_probs, k: int):
    """Gather each block's expert outputs back to token order, weighted,
    each token's k pairs added in choice order: (nb·tl, d)."""
    nb, e, cap, d = expert_out.shape
    flat_out = torch.cat([expert_out.reshape(nb, e * cap, d),
                          expert_out.new_zeros((nb, 1, d))], dim=1)
    w = (topk_probs.reshape(nb, -1) * keep).to(flat_out.dtype)
    pair_out = flat_out.gather(1, target[..., None].expand(-1, -1, d))
    contrib = (pair_out * w[..., None]).reshape(-1, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def _experts(expert_in, w):
    """(nb, E, c, d) x (E, d, f) -> (nb, E, c, f), one batched product
    over the experts."""
    nb, e, c, d = expert_in.shape
    x = expert_in.transpose(0, 1).reshape(e, nb * c, d)
    return torch.bmm(x, w).reshape(e, nb, c, -1).transpose(0, 1)


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

    # block-local dispatch
    nb = logical_axis_size("capacity")
    if nb <= 1 or t % nb != 0:
        nb = 1
    tl = t // nb
    cap = expert_capacity(tl, num_experts, k, capacity_factor)
    expert_in, target, keep = _dispatch_block(
        xf.reshape(nb, tl, d), topk_idx.reshape(nb, tl, k), num_experts, k,
        cap)
    expert_in = _shard_moe_blocked(expert_in)  # (nb, E, cap, d)
    # the expert FFN (SwiGLU), batched over experts and blocks
    g = _experts(expert_in, p.w_gate)
    u = _experts(expert_in, p.w_up)
    h = F.silu(g.float()).to(u.dtype) * u
    expert_out = _shard_moe_blocked(_experts(h, p.w_down))
    out = _combine_block(expert_out, target, keep, topk_probs, k)
    return out.reshape(b, s, d).to(x.dtype), aux
