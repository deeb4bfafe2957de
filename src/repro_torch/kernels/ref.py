"""Plain PyTorch versions of the hand-written kernels.

Each is the most obviously correct form of what its kernel computes
(naive masked softmax; dequantize-then-matmul), written independently of
the kernels' tiling. The kernel wrappers run these on CPU tensors, and
``chip_smoke.py`` holds each kernel against its plain version on the
card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def ref_gpo_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_ctx: int):
    """q/k/v (..., S, hd) with the neural-process mask (key j is allowed
    for query i iff j < num_ctx or j == i) -> (o (..., S, hd),
    lse (..., S) float32), lse being the logsumexp of the masked
    scores."""
    s, hd = q.shape[-2:]
    scores = torch.einsum("...qd,...kd->...qk", q, k) / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] < num_ctx) | (pos[None, :] == pos[:, None])
    scores = torch.where(mask, scores, NEG_INF).float()
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("...qk,...kd->...qd", probs, v), lse


def ref_int8_matmul(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Weight-only-quantized dense layer written out as dequantize-then-
    matmul: x (M, K) f32, q (K, N) int8, scale (N,) f32 -> (M, N) f32.
    The kernel applies the scale after the reduction instead (a
    per-column constant commutes with the sum over k)."""
    w = q.float() * scale.float()[None, :]
    return x.float() @ w
