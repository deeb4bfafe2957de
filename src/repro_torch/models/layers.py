"""Primitive layers of the GPO predictor."""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun): N(0, 1/fan_in) cut at ±2σ.

    Drawn by inverse CDF on the CPU generator, so the same seed gives
    the same weights on any device; the caller moves them."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Φ(-2)
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator,
                                           dtype=torch.float64)
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)
    return (std * z.clamp(-2.0, 2.0)).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    normed = x * torch.rsqrt(var + eps)
    # (1 + scale) parameterization (gemma/llama style, init scale = 0)
    return (normed * (1.0 + scale.float())).to(dt)
