"""Mamba2 block via state-space duality (SSD), arXiv:2405.21060 (the
reference's ``models/ssm.py``).

The prefill's scan goes through the SSD chunked-scan kernel
(``kernels/ops.py::ssd_scan_with_state``, which also hands back the final
state, the decode cache) unless ``use_kernel=False``; ``ssd_chunked``
is the plain branch, the reference's jnp path: the same chunked
decomposition as an intra-chunk masked quadratic form plus a
sequential loop over the chunk states. Decode is one recurrent step in
plain PyTorch (``ssd_decode_step``), as the reference computes it
outside any Pallas kernel.

State convention (per head): S_t = exp(dt_t * A) * S_{t-1} + dt_t * x_t B_t^T
with A < 0 scalar per head, y_t = S_t C_t + D * x_t.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamInit, rms_norm


class MambaParams(NamedTuple):
    in_proj: torch.Tensor  # (d, 2*d_in + 2*N + H)
    conv_w: torch.Tensor  # (W, conv_dim) depthwise
    conv_b: torch.Tensor  # (conv_dim,)
    dt_bias: torch.Tensor  # (H,)
    A_log: torch.Tensor  # (H,)
    D: torch.Tensor  # (H,)
    norm: torch.Tensor  # (d_in,) gated RMSNorm scale
    out_proj: torch.Tensor  # (d_in, d)


def mamba_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state_size
    return d_in, n_heads, conv_dim


def init_mamba_params(init: ParamInit, cfg, dtype) -> MambaParams:
    d_in, n_heads, conv_dim = mamba_dims(cfg)
    # inverse-softplus so softplus(dt_bias) spans ~[1e-3, 1e-1]
    dt = torch.exp(init.uniform((n_heads,), math.log(1e-3), math.log(1e-1)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_init = init.uniform((n_heads,), 1.0, 16.0)
    return MambaParams(
        in_proj=init.dense((cfg.d_model, 2 * d_in + 2 * cfg.ssm_state_size
                            + n_heads), dtype),
        conv_w=(init.normal((cfg.ssm_conv_width, conv_dim))
                / math.sqrt(cfg.ssm_conv_width)).to(dtype),
        conv_b=init.zeros((conv_dim,), dtype),
        dt_bias=dt_bias.float(),
        A_log=torch.log(a_init).float(),
        D=init.ones((n_heads,), torch.float32),
        norm=init.zeros((d_in,), dtype),
        out_proj=init.dense((d_in, cfg.d_model), dtype),
    )


def causal_depthwise_conv(x, w, b, state=None):
    """x (B, S, C), w (W, C) depthwise causal; state (B, W-1, C) optional
    history. Returns (y (B, S, C), new_state (B, W-1, C))."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xx = torch.cat([state, x], dim=1)  # (B, S+W-1, C)
    y = sum(xx[:, i: i + x.shape[1], :] * w[i][None, None, :]
            for i in range(width)) + b
    new_state = xx[:, -(width - 1):, :] if width > 1 else state
    return y, new_state


def _segsum_decay(dA_chunk):
    """dA_chunk (..., L) log-decays -> (..., L, L) matrix exp(cs_i - cs_j)
    masked to j <= i (else 0)."""
    cs = torch.cumsum(dA_chunk, dim=-1)  # inclusive
    diff = cs[..., :, None] - cs[..., None, :]  # (..., i, j)
    l = dA_chunk.shape[-1]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=dA_chunk.device))
    return torch.where(mask, torch.exp(diff), 0.0)


def ssd_chunked(x, dt, A_log, B, C, D, chunk: int):
    """Chunked SSD forward (training / prefill): the plain branch.

    x (b,s,h,p); dt (b,s,h) positive; A_log (h,); B,C (b,s,n); D (h,).
    Returns (y (b,s,h,p), final_state (b,h,p,n)). Sequences not divisible
    by ``chunk`` are zero-padded: dt=0 makes padded steps exact
    identities (decay exp(0)=1, contribution dt*x=0).
    """
    b, s_orig, h, p = x.shape
    n = B.shape[-1]
    pad = (-s_orig) % chunk
    if pad:
        def padf(a):
            return F.pad(a, [0, 0] * (a.dim() - 2) + [0, pad])

        x, dt, B, C = padf(x), padf(dt), padf(B), padf(C)
    s = s_orig + pad
    nc, l = s // chunk, chunk

    f32 = torch.float32
    a = -torch.exp(A_log.to(f32))  # (h,) negative
    dt = dt.to(f32)
    dA = dt * a[None, None, :]  # (b,s,h) log decay

    xr = x.reshape(b, nc, l, h, p)
    dtr = dt.reshape(b, nc, l, h)
    dAr = dA.reshape(b, nc, l, h).permute(0, 1, 3, 2)  # (b,nc,h,l)
    Br = B.reshape(b, nc, l, n)
    Cr = C.reshape(b, nc, l, n)

    # ---- intra-chunk (quadratic attention form) ----
    decay = _segsum_decay(dAr)  # (b,nc,h,l,l)
    cb = torch.einsum("bcin,bcjn->bcij", Cr.to(f32), Br.to(f32))
    scores = cb[:, :, None] * decay  # (b,nc,h,i,j)
    xdt = xr.to(f32) * dtr[..., None]  # (b,nc,l,h,p)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, xdt)

    # ---- chunk states ----
    cs = torch.cumsum(dAr, dim=-1)  # (b,nc,h,l) inclusive
    total = cs[..., -1]  # (b,nc,h)
    decay_to_end = torch.exp(total[..., None] - cs)  # (b,nc,h,l)
    s_chunk = torch.einsum("bchj,bcjhp,bcjn->bchpn", decay_to_end, xdt,
                           Br.to(f32))

    # ---- inter-chunk recurrence over nc (sequential) ----
    s_prev = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    befores = []
    for c in range(nc):
        befores.append(s_prev)
        s_prev = (torch.exp(total[:, c])[..., None, None] * s_prev
                  + s_chunk[:, c])
    final_state = s_prev
    s_before = torch.stack(befores, dim=1)  # (b,nc,h,p,n)

    # ---- inter-chunk contribution ----
    in_decay = torch.exp(cs)  # (b,nc,h,l) decay from chunk start to i
    y_inter = torch.einsum("bchi,bcin,bchpn->bcihp", in_decay, Cr.to(f32),
                           s_before)

    y = y_intra + y_inter + xr.to(f32) * D[None, None, None, :, None]
    y = y.reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), final_state


def ssd_decode_step(x, dt, A_log, B, C, D, state):
    """One-token recurrent update. x (b,1,h,p); state (b,h,p,n)."""
    f32 = torch.float32
    a = -torch.exp(A_log.to(f32))
    dt = dt.to(f32)[:, 0]  # (b,h)
    dA = torch.exp(dt * a[None, :])  # (b,h)
    xb = torch.einsum("bhp,bn->bhpn", x[:, 0].to(f32) * dt[..., None],
                      B[:, 0].to(f32))
    new_state = dA[..., None, None] * state + xb
    y = torch.einsum("bhpn,bn->bhp", new_state, C[:, 0].to(f32))
    y = y + x[:, 0].to(f32) * D[None, :, None]
    return y[:, None].to(x.dtype), new_state


def mamba_block(p: MambaParams, x, cfg, *, ssm_state=None, conv_state=None,
                decode: bool = False, use_kernel: bool = True):
    """Full Mamba2 block. x (B,S,d) -> (y (B,S,d), (ssm_state, conv_state)).

    Training/prefill: decode=False, the states returned are the final
    states (through the SSD kernel, or ``ssd_chunked`` with
    ``use_kernel=False``). Decode: decode=True, S must be 1, the states
    are required.
    """
    d_in, n_heads, conv_dim = mamba_dims(cfg)
    n = cfg.ssm_state_size
    b, s, _ = x.shape

    zxbcdt = x @ p.in_proj
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in: d_in + conv_dim]
    dt_raw = zxbcdt[..., d_in + conv_dim:]  # (b,s,H)

    xbc, new_conv_state = causal_depthwise_conv(
        xbc, p.conv_w, p.conv_b, state=conv_state)
    xbc = F.silu(xbc.float()).to(xbc.dtype)

    xs = xbc[..., :d_in].reshape(b, s, n_heads, cfg.ssm_head_dim)
    B = xbc[..., d_in: d_in + n]
    C = xbc[..., d_in + n:]
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, None, :])

    if decode:
        y, new_ssm = ssd_decode_step(xs, dt, p.A_log, B, C, p.D, ssm_state)
    elif use_kernel:
        y, new_ssm = ops.ssd_scan_with_state(xs, dt, p.A_log, B, C, p.D,
                                             chunk=cfg.ssm_chunk)
    else:
        y, new_ssm = ssd_chunked(xs, dt, p.A_log, B, C, p.D, cfg.ssm_chunk)

    y = y.reshape(b, s, d_in)
    gated = y * F.silu(z.float()).to(y.dtype)
    gated = rms_norm(gated, p.norm, cfg.norm_eps)
    return gated @ p.out_proj, (new_ssm, new_conv_state)
