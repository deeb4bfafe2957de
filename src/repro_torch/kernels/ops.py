"""Public wrappers around the kernels: the model's layouts in, the
kernels' flat layouts out and back. The batch axis is written out (no
vmap): one call is one launch however many groups it carries."""
from __future__ import annotations

import torch

from repro_torch.kernels.gpo_attention import gpo_attention_fwd
from repro_torch.kernels.quant_matmul import int8_matmul_flat


def gpo_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  num_ctx: int) -> torch.Tensor:
    """GPO layout: q/k/v (S, H, hd) or (B, S, H, hd) -> the same shape;
    neural-process mask with the first ``num_ctx`` tokens as context."""
    lead = q.shape[:-3]
    s, h, hd = q.shape[-3:]

    def flat(t):  # (..., S, H, hd) -> (B·H, S, hd)
        return t.reshape(-1, s, h, hd).transpose(1, 2).reshape(
            -1, s, hd).contiguous()

    o, _ = gpo_attention_fwd(flat(q), flat(k), flat(v), num_ctx=num_ctx)
    return o.reshape(-1, h, s, hd).transpose(1, 2).reshape(*lead, s, h, hd)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) f32 activations, q (K, N) int8 weight, scale (N,) f32
    per-output-channel -> (..., N) f32. The leading axes flatten into
    the kernel's M, so one weight is one launch."""
    lead = x.shape[:-1]
    out = int8_matmul_flat(x.reshape(-1, x.shape[-1]).contiguous(), q, scale)
    return out.reshape(*lead, q.shape[-1])
