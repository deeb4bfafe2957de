"""Differentially-private client-delta pipeline (DESIGN.md §9), the
PyTorch port of ``repro/core/privacy.py``.

Every client's flattened parameter delta d_g is (1) L2-clipped to the
sensitivity bound S = ``clip_norm`` and (2) perturbed with per-client
Gaussian noise of std σ = z·S (z = ``noise_multiplier``):

    d̃_g = d_g · min(1, S / ‖d_g‖₂) + σ·ε_g,   ε_g ~ N(0, I)

The privatized (C, P) matrix, not a reduction of it, is what reaches the
aggregator, so the pipeline composes with every registry strategy: the
linear family weighted-sums the d̃_g (fused with the clip in the
``clip_reduce`` CUDA kernel under ``use_pallas_aggregation``), the
robust family rank-trims them. Per-client noising is the local /
distributed-DP release model: whatever the server computes downstream is
post-processing.

**Noise.** The reference folds each client's noise key out of its
training key; torch cannot reproduce JAX's keys, so here the noise is an
operand: a presampled σ-scaled (C, P) matrix, drawn by the trainer from
its own ``torch.Generator`` (``client_noise``) or replayed from the
reference for parity.

**Accounting.** ``RdpAccountant`` tracks the sampled Gaussian mechanism
in Rényi DP at integer orders (Mironov et al. 2019): per round the RDP
at order α is log A(α)/(α−1) with

    A(α) = Σ_{i=0..α} C(α,i) qⁱ (1−q)^{α−i} exp((i²−i)/(2z²))

(q the client sampling rate; q = 1 collapses to the Gaussian mechanism's
α/(2z²)). RDP composes additively over rounds and converts to (ε, δ) via
ε = min_α [ α-RDP·rounds + log(1/δ)/(α−1) ]. Host-side numpy and math,
copied from the reference. Per-round local losses shipped to
``adaptive`` aggregation are NOT privatized (``check_adaptive_privacy``).
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import PrivacyConfig
from repro_torch.kernels import agg_clip_reduce
from repro_torch.kernels.agg_reduce import _NORM_FLOOR


# ---------------------------------------------------------------------------
# clip + noise on the flattened (C, P) client-delta matrix
# ---------------------------------------------------------------------------
def clip_scales(vecs: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """(C, P) -> (C,) per-client scale min(1, S/‖d_c‖₂) (an IEEE
    quotient: ``scalar / tensor`` in PyTorch would multiply by a
    reciprocal)."""
    x = vecs.float()
    norms = torch.sqrt(torch.square(x).sum(dim=1))
    return torch.clamp(torch.full_like(norms, clip_norm)
                       / torch.clamp(norms, min=_NORM_FLOOR), max=1.0)


def client_noise(gen: torch.Generator, shape: tuple,
                 sigma: float) -> torch.Tensor:
    """σ-scaled per-client Gaussian noise matrix (C, P) float32, drawn
    from ``gen`` on its device."""
    return sigma * torch.randn(shape, generator=gen, device=gen.device,
                               dtype=torch.float32)


def noise_operand(noise: Optional[torch.Tensor],
                  privacy: PrivacyConfig) -> Optional[torch.Tensor]:
    """The noise operand a config releases with: None for a clip-only
    config, the given (C, P) matrix otherwise (which must be there)."""
    if privacy.noise_multiplier <= 0.0:
        return None
    if noise is None:
        raise ValueError(f"noise_multiplier={privacy.noise_multiplier} "
                         "needs a presampled (C, P) noise matrix")
    return noise.float()


def privatize_flat(vecs: torch.Tensor, noise: Optional[torch.Tensor],
                   privacy: PrivacyConfig) -> torch.Tensor:
    """Clip + noise the flat (C, P) delta matrix: the aggregator-
    agnostic release; the robust strategies rank-trim this output."""
    x = vecs.float()
    x = x * clip_scales(x, privacy.clip_norm)[:, None]
    noise = noise_operand(noise, privacy)
    if noise is not None:
        x = x + noise
    return x


def clip_noise_reduce(vecs: torch.Tensor, weights: torch.Tensor,
                      noise: Optional[torch.Tensor],
                      privacy: PrivacyConfig, *,
                      use_pallas: bool = False) -> torch.Tensor:
    """clip → noise → weighted sum over the client axis: the linear-
    strategy path. With ``use_pallas`` the norms, the scale to the clip,
    the noise add and the weighted sum are one ``clip_reduce`` kernel
    call; otherwise the same math through ``privatize_flat``."""
    if use_pallas:
        return agg_clip_reduce(vecs, weights.float(),
                               clip=privacy.clip_norm,
                               noise=noise_operand(noise, privacy))
    pvecs = privatize_flat(vecs, noise, privacy)
    return torch.einsum("c,cp->p", weights.float(), pvecs)


def private_delta_flat(vecs: torch.Tensor, weights: torch.Tensor,
                       noise: Optional[torch.Tensor],
                       privacy: PrivacyConfig, agg, *,
                       use_pallas: bool = False) -> torch.Tensor:
    """The DP release + client-axis reduction for a trainer that holds
    every client: linear strategies fuse clip and noise into the
    weighted sum, robust strategies reduce the privatized matrix
    (through the trimmed kernel under ``use_pallas``)."""
    if agg.linear:
        return clip_noise_reduce(vecs, weights, noise, privacy,
                                 use_pallas=use_pallas)
    return agg.reduce_flat(privatize_flat(vecs, noise, privacy), weights)


# ---------------------------------------------------------------------------
# Rényi-DP moments accountant (host-side; numpy and math)
# ---------------------------------------------------------------------------
def _log_binom(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def rdp_sampled_gaussian(q: float, noise_multiplier: float,
                         orders: Sequence[int]) -> np.ndarray:
    """Per-step RDP of the sampled Gaussian mechanism at integer orders
    (Mironov et al. 2019, Thm. 5 / the tensorflow-privacy integer-α sum).
    ``q`` is the sampling rate, ``noise_multiplier`` the ratio z = σ/S."""
    z = float(noise_multiplier)
    if z <= 0.0:
        return np.full(len(orders), np.inf)
    if not 0.0 < q <= 1.0:
        raise ValueError(f"sampling rate q={q} must lie in (0, 1]")
    out = np.empty(len(orders), np.float64)
    for j, alpha in enumerate(orders):
        alpha = int(alpha)
        if alpha < 2:
            raise ValueError(f"RDP orders must be integers >= 2: {alpha}")
        if q == 1.0:
            out[j] = alpha / (2.0 * z * z)
            continue
        # log A(alpha) = logsumexp_i [ log C(a,i) + i log q
        #   + (a-i) log(1-q) + (i^2 - i) / (2 z^2) ]
        terms = [
            _log_binom(alpha, i) + i * math.log(q)
            + (alpha - i) * math.log1p(-q)
            + (i * i - i) / (2.0 * z * z)
            for i in range(alpha + 1)
        ]
        out[j] = np.logaddexp.reduce(terms) / (alpha - 1)
    return out


def eps_from_rdp(rdp: np.ndarray, orders: Sequence[int],
                 delta: float) -> float:
    """Classic RDP→(ε, δ) conversion: min_α [ RDP(α) + log(1/δ)/(α−1) ]."""
    orders = np.asarray(orders, np.float64)
    eps = np.asarray(rdp, np.float64) + math.log(1.0 / delta) / (orders - 1)
    return float(np.min(eps))


class RdpAccountant:
    """Moments accountant for the per-round sampled Gaussian mechanism.
    The per-step RDP vector is constant (fixed q and z), so composition
    over ``steps`` rounds is a scalar multiply, cheap enough to record
    into ``History.round_eps`` every round."""

    def __init__(self, noise_multiplier: float, sampling_rate: float,
                 target_delta: float = 1e-5,
                 orders: Optional[Sequence[int]] = None):
        self.orders = tuple(orders or PrivacyConfig().accountant_orders)
        self.noise_multiplier = float(noise_multiplier)
        self.sampling_rate = float(sampling_rate)
        self.target_delta = float(target_delta)
        self._per_step = rdp_sampled_gaussian(
            self.sampling_rate, self.noise_multiplier, self.orders)

    def epsilon(self, steps: int) -> float:
        """ε at ``target_delta`` after ``steps`` composed rounds."""
        if steps <= 0:
            return 0.0
        if not np.all(np.isfinite(self._per_step)):
            return float("inf")
        return eps_from_rdp(steps * self._per_step, self.orders,
                            self.target_delta)


def make_accountant(privacy: PrivacyConfig,
                    sampling_rate: float) -> Optional[RdpAccountant]:
    """Accountant for an enabled, noised config; None otherwise (clip-
    only runs carry no finite ε: callers report inf)."""
    if not privacy.enabled or privacy.noise_multiplier <= 0.0:
        return None
    return RdpAccountant(privacy.noise_multiplier, sampling_rate,
                         privacy.target_delta, privacy.accountant_orders)


_ADAPTIVE_PRIVACY_MSG = (
    "agg.name='adaptive' reweighs groups by their RAW per-round local "
    "losses, which are shipped to the server UN-privatized (DESIGN.md "
    "§9): with noise_multiplier={z} > 0 the reported RDP epsilon does "
    "NOT cover the loss side-channel. Use a non-adaptive strategy for "
    "a DP run, or set FedConfig.strict_privacy=False to proceed with "
    "this warning.")


def check_adaptive_privacy(fed_cfg) -> None:
    """Guard the adaptive-aggregation + DP-noise foot-gun: the loss EMAs
    that drive the adaptive weights leak un-noised training losses, so a
    run claiming an (ε, δ) from the accountant would over-claim. Warns by
    default; ``FedConfig.strict_privacy=True`` raises."""
    if (fed_cfg.agg.name == "adaptive" and fed_cfg.privacy.enabled
            and fed_cfg.privacy.noise_multiplier > 0.0):
        msg = _ADAPTIVE_PRIVACY_MSG.format(
            z=fed_cfg.privacy.noise_multiplier)
        if fed_cfg.strict_privacy:
            raise ValueError(msg)
        warnings.warn(msg, UserWarning, stacklevel=2)
