"""Alignment and fairness metrics (paper §4.4).

* Alignment Score AS(P1, P2; Q) — Eq. 4 — as mean_q (1 - JSD(P1(q),
  P2(q))), higher is better, with JSD the Jensen-Shannon *distance*
  (sqrt of the base-2 divergence, bounded [0, 1]).
* CoV (Eq. 5) and the fairness index FI = 1/(1 + CoV²) (Eq. 6) over
  per-group alignment scores.
* Convergence round: the first round reaching 95% of the total loss
  descent.
"""
from __future__ import annotations

import numpy as np
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
    """Eq. 4 over a set of questions: p1, p2 (Q, A) -> scalar in [0, 1];
    with a leading group axis, (K, Q, A) -> (K,) one score per group."""
    return (1.0 - js_distance(p1, p2)).mean(dim=-1)


def coefficient_of_variation(scores: torch.Tensor) -> torch.Tensor:
    """Eq. 5 over per-group alignment scores (K,): population std over
    the mean (the mean floored at 1e-12)."""
    mu = scores.mean()
    sigma = torch.sqrt((scores - mu).square().mean())
    return sigma / torch.clamp(mu, min=_EPS)


def fairness_index(scores: torch.Tensor) -> torch.Tensor:
    """Eq. 6: FI = 1 / (1 + CoV²); 1 is perfectly equal opportunity."""
    return 1.0 / (1.0 + coefficient_of_variation(scores).square())


def convergence_round(losses, frac: float = 0.95) -> int:
    """First index where ``frac`` of the total descent (loss_0 ->
    loss_final) is reached; len(losses) - 1 if never, and on a diverging
    curve (final above start), which has no such round."""
    losses = np.asarray(losses, np.float64)
    if losses.size == 0:
        return 0
    start, final = losses[0], losses[-1]
    if final > start:
        return len(losses) - 1
    threshold = start - frac * (start - final)
    idx = np.nonzero(losses <= threshold)[0]
    return int(idx[0]) if idx.size else len(losses) - 1
