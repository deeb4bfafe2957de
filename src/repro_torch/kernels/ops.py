"""Public wrappers around the kernels: the model's layouts in, the
kernels' flat layouts out and back. The batch axis is written out (no
vmap): one call is one launch however many groups (or clients) it
carries."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.agg_reduce import (
    clip_reduce_flat,
    fedavg_reduce_flat,
    momentum_reduce_flat,
    pairwise_dists_flat,
    quant_clip_reduce_flat,
    topk_reduce_flat,
    trimmed_reduce_flat,
)
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.gpo_attention import GPOAttention
from repro_torch.kernels.quant_matmul import int8_matmul_flat
from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
from repro_torch.utils.pytree import (
    tree_index,
    tree_ravel_clients,
    tree_unflatten_from_vector,
)


def _pad_seq(x: torch.Tensor, block: int, dim: int) -> torch.Tensor:
    """x zero-padded along ``dim`` to a multiple of ``block``."""
    pad = (-x.shape[dim]) % block
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    bq: int = 128) -> torch.Tensor:
    """Model layout: q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd).
    S is padded to the query block as the reference's wrapper pads it;
    the kernel is told the unpadded length and masks the padded keys, so
    the result is ``ref_attention``'s for every S, causal or not."""
    s_orig = q.shape[1]
    bq = min(bq, max(16, s_orig))

    def bhsd(t):
        return _pad_seq(t.transpose(1, 2), bq, 2).contiguous()

    out = flash_attention_bhsd(bhsd(q), bhsd(k), bhsd(v), causal=causal,
                               window=window, softcap=softcap, kv_len=s_orig)
    return out[:, :, :s_orig].transpose(1, 2)


def _ssd_padded(x, dt, A_log, B, C, D, chunk, return_state):
    s_orig = x.shape[1]
    chunk = min(chunk, max(16, s_orig))

    def padded(t):
        return _pad_seq(t, chunk, 1).contiguous()

    y, state = ssd_scan_bhsp(padded(x), padded(dt.float()),
                             A_log.float().contiguous(), padded(B),
                             padded(C), D.float().contiguous(), chunk=chunk,
                             return_state=return_state)
    return y[:, :s_orig], state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """Model layout (as ``models/ssm.py``): x (b, s, h, p), dt (b, s, h),
    B/C (b, s, n) -> y like x. S is padded to the chunk with dt = 0, an
    exact identity: a padded step neither decays the state nor adds to
    it."""
    return _ssd_padded(x, dt, A_log, B, C, D, chunk, False)[0]


def ssd_scan_with_state(x: torch.Tensor, dt: torch.Tensor,
                        A_log: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor, D: torch.Tensor, *,
                        chunk: int = 128):
    """``ssd_scan`` that also returns the final state (b, h, p, n) f32,
    the decode cache of a prefill; the padded tail leaves it exact."""
    return _ssd_padded(x, dt, A_log, B, C, D, chunk, True)


def gpo_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  num_ctx: int) -> torch.Tensor:
    """GPO layout: q/k/v (S, H, hd) or (B, S, H, hd) -> the same shape;
    neural-process mask with the first ``num_ctx`` tokens as context.
    Differentiable: the ``GPOAttention`` Function runs the backward
    kernels. S is not padded: a padded target row would attend only to
    itself, so the band needs no padding to stay exact."""
    lead = q.shape[:-3]
    s, h, hd = q.shape[-3:]

    def flat(t):  # (..., S, H, hd) -> (B·H, S, hd)
        return t.reshape(-1, s, h, hd).transpose(1, 2).reshape(
            -1, s, hd).contiguous()

    o = GPOAttention.apply(flat(q), flat(k), flat(v), num_ctx)
    return o.reshape(-1, h, s, hd).transpose(1, 2).reshape(*lead, s, h, hd)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) f32 activations, q (K, N) int8 weight, scale (N,) f32
    per-output-channel -> (..., N) f32. The leading axes flatten into
    the kernel's M, so one weight is one launch."""
    lead = x.shape[:-1]
    out = int8_matmul_flat(x.reshape(-1, x.shape[-1]).contiguous(), q, scale)
    return out.reshape(*lead, q.shape[-1])


def fedavg_reduce(stacked: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """stacked (C, P) raveled client params or deltas, weights (C,) ->
    (P,) f32: Eq. 3 in one launch."""
    return fedavg_reduce_flat(stacked.float().contiguous(),
                              weights.float().contiguous())


def fedavg_reduce_tree(stacked_tree, weights: torch.Tensor):
    """Client-stacked params tree (leaves (C, ...)) -> the aggregated
    tree through one ``fedavg_reduce`` launch on the raveled (C, P)
    matrix, in the reference's leaf order."""
    like = tree_index(stacked_tree, 0)
    return tree_unflatten_from_vector(
        fedavg_reduce(tree_ravel_clients(stacked_tree), weights), like)


def agg_momentum_reduce(stacked: torch.Tensor, weights: torch.Tensor,
                        moment: torch.Tensor, *, beta: float):
    """stacked (C, P) client deltas, weights (C,), moment (P,) ->
    (weighted delta moment (P,), beta·moment + delta (P,)) in one launch:
    the FedAvgM server update."""
    return momentum_reduce_flat(stacked.float().contiguous(),
                                weights.float().contiguous(),
                                moment.float().contiguous(), beta=beta)


def agg_trimmed_reduce(stacked: torch.Tensor, weights: torch.Tensor, *,
                       trim: int) -> torch.Tensor:
    """stacked (C, P) client deltas, weights (C,) -> (P,): the rank-
    trimmed weighted mean over the client axis (``trim`` clients cut at
    each end; trim = (C−1)//2 is the coordinate-wise median)."""
    return trimmed_reduce_flat(stacked.float().contiguous(),
                               weights.float().contiguous(), trim=trim)


def agg_pairwise_dists(stacked: torch.Tensor) -> torch.Tensor:
    """stacked (C, P) client deltas -> (C, C) pairwise squared L2
    distances over the raveled parameter axis: the Krum / multi-Krum
    selection metric."""
    return pairwise_dists_flat(stacked.float().contiguous())


def _f32(t):
    return None if t is None else t.float().contiguous()


def agg_clip_reduce(stacked: torch.Tensor, weights: torch.Tensor, *,
                    clip: float, noise=None) -> torch.Tensor:
    """stacked (C, P) client deltas, weights (C,), optional presampled
    σ-scaled per-client noise (C, P) -> (P,): the DP-aggregation kernel,
    per-client L2 norm, scale to the clip, noise add and weighted sum in
    one call. ``noise=None`` is the clip-only path (no zero matrix is
    read)."""
    return clip_reduce_flat(_f32(stacked), _f32(weights), clip=clip,
                            noise=_f32(noise))


def agg_quant_clip_reduce(stacked: torch.Tensor, weights: torch.Tensor, *,
                          clip: float = 0.0, noise=None, uniform=None,
                          resid=None):
    """stacked (C, P) raw client deltas, weights (C,), optional
    presampled σ-scaled noise (C, P), optional presampled U[0, 1)
    stochastic-rounding tile (C, P), optional EF residual (C, P) ->
    (reduced (P,), new residual (C, P) or None): the fused DP release +
    int8 quantized transport + weighted reduce kernel. ``clip=0`` skips
    the DP stage; ``uniform=None`` rounds to nearest (half to even)."""
    return quant_clip_reduce_flat(_f32(stacked), _f32(weights), clip=clip,
                                  noise=_f32(noise), uniform=_f32(uniform),
                                  resid=_f32(resid))


def agg_topk_reduce(stacked: torch.Tensor, weights: torch.Tensor,
                    thresholds: torch.Tensor, *,
                    with_residual: bool = False):
    """stacked (C, P) codec inputs, weights (C,), per-client magnitude
    thresholds (C,) -> (reduced (P,), residual (C, P) or None): the top-k
    mask + weighted-reduce kernel."""
    return topk_reduce_flat(_f32(stacked), _f32(weights), _f32(thresholds),
                            with_residual=with_residual)
