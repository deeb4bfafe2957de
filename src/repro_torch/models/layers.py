"""Primitive layers shared by the GPO predictor and the LM backbones."""
from __future__ import annotations

import math

import torch


# dense_init draws at most this many values at once: a larger tensor (an
# expert stack of grok-1, 1.6e9 values) is drawn in pieces of its flat
# order, so the float64 intermediates stay ~0.5 GB, not a few times the
# tensor
DRAW_CHUNK = 1 << 26


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun): N(0, 1/fan_in) cut at ±2σ.

    Drawn by inverse CDF on the generator's device: a CPU generator gives
    the same weights for the same seed whatever device the caller moves
    them to; a CUDA generator draws on the card (its own stream of
    numbers). The values are drawn in pieces of ``DRAW_CHUNK`` in flat
    order: a smaller tensor is one piece."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Φ(-2)

    def draw(size):
        u = lo + (1.0 - 2.0 * lo) * torch.rand(size, generator=generator,
                                               dtype=torch.float64,
                                               device=generator.device)
        z = math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)
        return (std * z.clamp(-2.0, 2.0)).to(dtype)

    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=generator.device)
    for start in range(0, n, DRAW_CHUNK):
        piece = out[start:start + DRAW_CHUNK]
        piece.copy_(draw(piece.shape))
    return out.reshape(shape)


class ParamInit:
    """Draws a backbone's random weights on the generator's device, or,
    given no generator, makes only their shapes on the meta device."""

    def __init__(self, generator: torch.Generator = None):
        self.gen = generator
        self.device = (torch.device("meta") if generator is None
                       else generator.device)

    def dense(self, shape, dtype, in_axis: int = 0) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        return dense_init(self.gen, shape, in_axis, dtype)

    def zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        """f32 uniform on [lo, hi)."""
        if self.gen is None:
            return torch.empty(shape, device=self.device)
        return lo + (hi - lo) * torch.rand(shape, generator=self.gen,
                                           device=self.device)

    def normal(self, shape) -> torch.Tensor:
        """f32 standard normal."""
        if self.gen is None:
            return torch.empty(shape, device=self.device)
        return torch.randn(shape, generator=self.gen, device=self.device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    normed = x * torch.rsqrt(var + eps)
    # (1 + scale) parameterization (gemma/llama style, init scale = 0)
    return (normed * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """Rotary embedding. x (..., S, H, hd); positions broadcastable to
    (..., S). The angles are f32; the result keeps x's dtype."""
    half = x.shape[-1] // 2
    freq_exponents = torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half
    inv_freq = torch.as_tensor(theta, dtype=torch.float32,
                               device=x.device) ** (-freq_exponents)
    angles = positions.float()[..., None] * inv_freq  # (..., S, half)
    sin = torch.sin(angles)[..., None, :]  # (..., S, 1, half)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(u.dtype) * u
    return h @ w_down
