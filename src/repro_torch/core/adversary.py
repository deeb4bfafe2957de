"""Byzantine adversarial-client simulation (DESIGN.md §13): the PyTorch
port of the reference's ``core/adversary.py``.

Three pieces:

1. **The attacker schedule.** Each round exactly min(f, C) clients of
   the C in the population attack: the f lowest of C uniforms
   (``attacker_mask``, a double stable argsort, so ties resolve by
   client index). ``FederatedGPO`` draws the C uniforms of every round
   from a CPU generator of their own, for all C clients even when the
   round samples fewer, so the schedule is a function of the seed and
   the round alone (the reference folds them out of its round key).
2. **Delta-level attacks.** ``apply_attack`` corrupts the attacked rows
   of the raw flat (rows, P) delta matrix before the privacy and codec
   release, so a corrupted row passes through the DP clip and the codec
   like an honest one: ``sign_flip`` ships −d, ``scaled`` λ·d,
   ``gaussian`` d + σ·ε (ε the client's row of a (C, P) standard-normal
   draw, so a client's noise does not depend on who else was sampled),
   and ``alie`` ("a little is enough", Baruch et al. 2019) the honest
   rows' mean + z·std per coordinate (``honest_stats``).
3. **Data-level poisoning.** ``label_flip`` maps the attacked clients'
   preference targets p to (1 − p)/(A − 1) (``flip_preferences``) inside
   local training; its delta-stage transform is the identity.

``norm_clip_rows`` is the server-side norm-bounding defense, and
``check_defense_composition`` guards adaptive aggregation in a defended
DP run.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.configs.base import AdversaryConfig

# the attacker generator's seed offset: the reference's Byzantine key
# tag (core/adversary.py::_BYZ_TAG)
BYZ_TAG = 0xBAD0C


def attacker_draws(gen: torch.Generator, num_clients: int) -> torch.Tensor:
    """The round's (C,) uniforms, one per client of the population."""
    return torch.rand((num_clients,), generator=gen)


def attacker_mask(u: torch.Tensor, num_attackers: int) -> torch.Tensor:
    """(C,) bool from the round's (C,) uniforms ``u``: exactly min(f, C)
    clients attack, the f lowest draws (a double stable argsort gives
    each client its rank, ties in client order)."""
    c = u.shape[0]
    f = min(int(num_attackers), c)
    if f <= 0:
        return torch.zeros((c,), dtype=torch.bool, device=u.device)
    rank = torch.argsort(torch.argsort(u, stable=True), stable=True)
    return rank < f


def honest_stats(vecs: torch.Tensor, mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coordinate-wise (mean, std) over the non-attacked rows of a
    (rows, P) matrix, in the moment form E[x²] − E[x]² clamped at 0:
    the reference's estimator, within which ALIE steers."""
    h = (~mask).float()[:, None]
    n = torch.clamp(h.sum(), min=1.0)
    x = vecs.float()
    mean = (h * x).sum(dim=0) / n
    var = torch.clamp((h * x * x).sum(dim=0) / n - mean * mean, min=0.0)
    return mean, torch.sqrt(var)


def honest_stats_sharded(vecs: torch.Tensor, mask: torch.Tensor, axes,
                         comm) -> tuple[torch.Tensor, torch.Tensor]:
    """``honest_stats`` over a client-sharded (rows, P) matrix: the masked
    moment sums are summed over the client mesh ``axes`` on ``comm``
    (``launch.collectives.Collectives``), so colluding attackers on
    different processes agree on the honest spread."""
    h = (~mask).float()[:, None]
    x = vecs.float()
    n = torch.clamp(comm.psum(h.sum().reshape(1), axes)[0], min=1.0)
    mean = comm.psum((h * x).sum(dim=0), axes) / n
    var = torch.clamp(comm.psum((h * x * x).sum(dim=0), axes) / n
                      - mean * mean, min=0.0)
    return mean, torch.sqrt(var)


def apply_attack(vecs: torch.Tensor, mask: torch.Tensor,
                 adv: AdversaryConfig,
                 noise: Optional[torch.Tensor] = None, *,
                 stats: Optional[tuple] = None) -> torch.Tensor:
    """Corrupt the attacked rows (``mask``, (rows,) bool, on any device)
    of the raw flat (rows, P) delta matrix; ``noise`` is the rows' (rows,
    P) standard normals of the ``gaussian`` attack; ``stats`` replaces
    ALIE's honest (mean, std) (the sharded round passes the ones summed
    over its processes). Identity for ``none`` and ``label_flip``.
    Returns float32."""
    if not adv.enabled or adv.data_level:
        return vecs
    x = vecs.float()
    mask = mask.to(x.device)
    if adv.kind == "sign_flip":
        bad = -x
    elif adv.kind == "scaled":
        bad = adv.scale * x
    elif adv.kind == "gaussian":
        bad = x + adv.noise_std * noise
    elif adv.kind == "alie":
        mean, std = honest_stats(x, mask) if stats is None else stats
        bad = (mean + adv.alie_z * std).expand_as(x)
    else:  # AdversaryConfig.validate rejects it earlier
        raise ValueError(f"unknown delta-level attack {adv.kind!r}")
    return torch.where(mask[:, None], bad, x)


def flip_preferences(y: torch.Tensor, num_options: int) -> torch.Tensor:
    """Label-flip poisoning of flattened preference targets: p(a|q) →
    (1 − p)/(A − 1), which keeps each question's row on the simplex and
    reverses its preference order."""
    return (1.0 - y.float()) / float(max(num_options - 1, 1))


def norm_clip_rows(vecs: torch.Tensor, bound: float) -> torch.Tensor:
    """Scale each received client row of the (C, P) delta matrix to L2
    norm ≤ ``bound``, so no single client can pull a linear aggregate
    further than bound/C · server_lr. Zero rows keep scale 1 (the norm
    is floored at 1e-12). Returns float32."""
    x = vecs.float()
    norms = torch.sqrt(torch.square(x).sum(dim=1))
    scale = torch.clamp(bound / torch.clamp(norms, min=1e-12), max=1.0)
    return x * scale[:, None]


_DEFENSE_COMPOSITION_MSG = (
    "agg.name='adaptive' reweighs groups by their RAW per-round local "
    "losses while a Byzantine defense is engaged "
    "(adversary.kind={kind!r}, agg.norm_bound={nb}): a validation-loss-"
    "dependent rule is both un-privatized under noise_multiplier={z} > 0 "
    "(the §9 side channel) and directly attacker-steerable — a Byzantine "
    "client reports whatever loss inflates its own weight, bypassing the "
    "delta-level defense entirely (DESIGN.md §13). Use a loss-free "
    "strategy (krum/geomedian/median) for a defended DP run, or set "
    "FedConfig.strict_privacy=False to proceed with this warning.")


def check_defense_composition(fed_cfg) -> None:
    """Warn (``strict_privacy``: raise ``ValueError``) when a defended
    run (an attack simulated or a norm bound set) aggregates with
    ``adaptive`` under DP noise: the loss channel is then both a privacy
    leak and an attack surface the defenses do not cover."""
    defended = fed_cfg.adversary.enabled or fed_cfg.agg.norm_bound > 0.0
    if (defended and fed_cfg.agg.name == "adaptive"
            and fed_cfg.privacy.enabled
            and fed_cfg.privacy.noise_multiplier > 0.0):
        msg = _DEFENSE_COMPOSITION_MSG.format(
            kind=fed_cfg.adversary.kind, nb=fed_cfg.agg.norm_bound,
            z=fed_cfg.privacy.noise_multiplier)
        if fed_cfg.strict_privacy:
            raise ValueError(msg)
        warnings.warn(msg, UserWarning, stacklevel=2)
