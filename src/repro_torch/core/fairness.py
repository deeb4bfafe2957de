"""Alignment metrics (paper §4.4) used to score served rows.

Alignment Score AS(P1, P2; Q) — Eq. 4 — as mean_q (1 - JSD(P1(q),
P2(q))), higher is better, with JSD the Jensen-Shannon *distance* (sqrt
of the base-2 divergence, bounded [0, 1]). CoV, the fairness index and
the convergence round come with the training slice.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) in bits, last axis, safe for zeros."""
    p = p.clamp(_EPS, 1.0)
    q = q.clamp(_EPS, 1.0)
    return (p * (torch.log2(p) - torch.log2(q))).sum(dim=-1)


def js_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon distance in [0, 1] (sqrt of base-2 JS divergence)."""
    m = 0.5 * (p + q)
    div = 0.5 * kl_divergence(p, m) + 0.5 * kl_divergence(q, m)
    return torch.sqrt(div.clamp(0.0, 1.0))


def alignment_score(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Eq. 4 over a set of questions: p1, p2 (Q, A) -> scalar in [0, 1]."""
    return (1.0 - js_distance(p1, p2)).mean()
