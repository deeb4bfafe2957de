"""The round's stage pipeline (DESIGN.md §13): the PyTorch port of the
reference's ``core/pipeline.py::RoundPipeline``, without its sharded
methods (the multi-process engine is ROADMAP.md queue A.7).

Every round is the five declared stages ``[local_train, attack, privacy,
codec, aggregate]``. ``FederatedGPO`` keeps local training (with the
label-flip poisoning of ``attacked_flags``); this module runs the rest on
the clients' raw deltas:

* with none of a delta attack, a norm bound or an edge hierarchy, the
  reference's fused dispatch: the codec on
  (``core/compression.py::transport_delta_flat``: DP release, EF
  residual, int8 or top-k round trip, reduce, the transport kernels
  under ``use_pallas``), else the privacy stage on
  (``core/privacy.py::private_delta_flat``: clip, noise, reduce, the
  clip kernel under ``use_pallas``), then ``agg.apply``; with both off,
  ``agg.step`` (weigh, reduce, apply; the fused kernel step where the
  strategy has one);
* otherwise (``restructured``) the rows are materialised: weigh, ravel
  the deltas to (C, P), attack the Byzantine rows (``attack_rows``),
  release them (``release_flat``: privacy, then the codec), clip each
  row to the norm bound (``_bound_rows``), reduce per edge and then
  over the edges (``hier_reduce_flat``; ``agg.reduce_flat`` at one
  edge), then ``agg.apply``.

The fault round (``FederatedGPO`` with ``FedConfig.avail`` on) releases
per row (``release_rows``), blends fresh and buffered rows, and reduces
with ``masked_reduce``.

``losses`` and ``idx`` pass through to the strategy. The randomness
comes in as operands: the attack's mask and noise rows
(``AttackDraws``), the release's σ-scaled noise and rounding uniforms,
(C, P) each; the EF residual is carry state that the caller owns.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import (
    AdversaryConfig,
    CompressionConfig,
    HierarchyConfig,
    PrivacyConfig,
)
from repro_torch.core import adversary as byz
from repro_torch.core import availability as av
from repro_torch.core import compression as cx
from repro_torch.core import privacy as dp
from repro_torch.core.adversary import norm_clip_rows
from repro_torch.core.aggregation import ServerAggregator
from repro_torch.utils.pytree import (
    tree_ravel_clients,
    tree_unflatten_from_vector,
)


# the declared stage sequence (DESIGN.md §13)
STAGE_NAMES = ("local_train", "attack", "privacy", "codec", "aggregate")


class AttackDraws(NamedTuple):
    """The attack stage's operands for a round's rows: which rows attack
    ((rows,) bool) and, for ``gaussian``, their (rows, P) standard
    normals (else None)."""

    mask: torch.Tensor
    noise: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class RoundPipeline:
    """Stateless: the caller threads the server state, the EF residual
    and the fault state through. ``num_clients`` is the full training
    population the attacker schedule draws over."""

    agg: ServerAggregator
    privacy: PrivacyConfig = PrivacyConfig()
    compression: CompressionConfig = CompressionConfig()
    use_pallas: bool = False
    adversary: AdversaryConfig = AdversaryConfig()
    num_clients: Optional[int] = None
    hierarchy: HierarchyConfig = HierarchyConfig()

    @property
    def attack_delta(self) -> bool:
        """A delta-level attack is configured."""
        return self.adversary.enabled and not self.adversary.data_level

    @property
    def flip_data(self) -> bool:
        """Data-level poisoning (label_flip) is configured."""
        return self.adversary.enabled and self.adversary.data_level

    @property
    def norm_bound(self) -> float:
        return self.agg.cfg.norm_bound

    @property
    def restructured(self) -> bool:
        """True when the round materialises the per-client released rows:
        a delta attack, norm bounding or the edge hierarchy."""
        return (self.attack_delta or self.norm_bound > 0.0
                or self.hierarchy.enabled)

    def stages(self) -> tuple:
        """The declared stages as (name, enabled) pairs."""
        return tuple(zip(STAGE_NAMES, (
            True, self.adversary.enabled, self.privacy.enabled,
            self.compression.enabled, True)))

    # -- attack stage ------------------------------------------------------
    def attack_draws(self, mask_full: torch.Tensor,
                     noise_full: Optional[torch.Tensor],
                     idx: Optional[torch.Tensor] = None) -> AttackDraws:
        """The participants' attack operands from the population's:
        ``mask_full`` (C,) bool on the host and ``noise_full`` (C, P) or
        None, their rows ``idx`` (None: all)."""
        if mask_full.shape != (self.num_clients,):
            raise ValueError(f"attacker mask of shape {tuple(mask_full.shape)}"
                             f" for a population of {self.num_clients}")
        if idx is None:
            return AttackDraws(mask_full, noise_full)
        rows = (None if noise_full is None
                else noise_full[idx.to(noise_full.device)])
        return AttackDraws(mask_full[idx.cpu()], rows)

    def attacked_flags(self, mask_full: Optional[torch.Tensor],
                       idx: Optional[torch.Tensor] = None):
        """The participants' (rows,) bool poison flags for label_flip,
        sliced from the population's mask by ``idx`` (None: all); None
        when no label flip is configured."""
        if not self.flip_data:
            return None
        return mask_full if idx is None else mask_full[idx]

    def attack_rows(self, vecs: torch.Tensor,
                    attack: Optional[AttackDraws]) -> torch.Tensor:
        """The attack stage on the raw flat (rows, P) delta matrix; the
        identity unless a delta attack is configured."""
        if not self.attack_delta:
            return vecs
        return byz.apply_attack(vecs, attack.mask, self.adversary,
                                attack.noise)

    def release_rows(self, vecs, noise, uniform, resid, *, attack=None):
        """Attack, privacy and codec on per-client rows, no reduction: the
        fault round buffers and masks the individual wire values, so an
        attacker's row that straggles is buffered corrupted. Returns
        (released rows, carry-out residual)."""
        return cx.release_flat(self.attack_rows(vecs, attack), noise,
                               uniform, self.privacy, self.compression,
                               resid)

    # -- aggregate stage ---------------------------------------------------
    def _bound_rows(self, rel: torch.Tensor) -> torch.Tensor:
        """Server-side norm bounding of what the server received, row by
        row; the identity at norm_bound 0."""
        if self.norm_bound > 0.0:
            return norm_clip_rows(rel, self.norm_bound)
        return rel

    def hier_reduce_flat(self, rel: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
        """The reduce of materialised (rows, P) released rows:
        ``agg.reduce_flat`` at one edge, else the client→edge→server
        reduce (DESIGN.md §14). Edge e owns the contiguous rows [e·C/E,
        (e+1)·C/E) and runs the configured rule over them; the linear
        family sums the edge partials (against the global weights), the
        robust family reduces each edge against within-edge normalised
        weights and reruns the rule over the E candidates, weighted by
        edge mass. Each edge call is one ``agg.reduce_flat``, so under
        ``use_pallas`` each launches the strategy's kernel."""
        e_count = self.hierarchy.num_edges
        if e_count <= 1:
            return self.agg.reduce_flat(rel, weights)
        c = rel.shape[0]
        v = rel.reshape(e_count, c // e_count, rel.shape[1])
        w = weights.float().reshape(e_count, c // e_count)
        if self.agg.linear:
            return torch.stack([self.agg.reduce_flat(v[e], w[e])
                                for e in range(e_count)]).sum(dim=0)
        mass = w.sum(dim=1)
        wn = w / torch.clamp(mass, min=1e-12)[:, None]
        edge_rows = torch.stack([self.agg.reduce_flat(v[e], wn[e])
                                 for e in range(e_count)])
        return self.agg.reduce_flat(edge_rows, mass)

    def masked_reduce(self, contrib: torch.Tensor, w_c: torch.Tensor,
                      mask_c: torch.Tensor, *,
                      trim_frac: float) -> torch.Tensor:
        """The fault round's reduce of the (C, P) blended rows (fresh and
        buffered) with their weights ``w_c`` and survivor mask
        ``mask_c`` (host (C,) tensors): the linear family renormalises
        over the survivors, median and trimmed mean shrink their trim
        depth with the survivor count, the defenses drop weight-0 rows.
        The norm bound clips the blended rows first."""
        agg, dev = self.agg, contrib.device
        contrib = self._bound_rows(contrib)
        if agg.linear:
            return agg.reduce_flat(
                contrib, av.masked_mean_weights(w_c, mask_c).to(dev))
        if agg.name in ("median", "trimmed_mean"):
            return av.masked_robust_reduce_flat(
                contrib, w_c, mask_c, name=agg.name, trim_frac=trim_frac)
        return agg.reduce_flat(contrib,
                               torch.where(mask_c, w_c, 0.0).to(dev))

    # -- the stacked round's tail --------------------------------------------
    def reduce_apply(self, server_state, global_params, deltas, weights, *,
                     losses, idx, resid=None, noise=None, uniform=None,
                     attack: Optional[AttackDraws] = None):
        """Client-stacked delta trees in, (new global params, new server
        state, new EF residual) out. ``idx`` are the participants' ids
        (None: all); ``resid`` their EF residual rows (None without error
        feedback); ``noise`` and ``uniform`` the round's presampled
        release draws (None where the config draws none); ``attack`` the
        attack stage's operands for the participants' rows."""
        agg, priv, comp = self.agg, self.privacy, self.compression
        if not (self.restructured or priv.enabled or comp.enabled):
            new_global, server_state = agg.step(
                server_state, global_params, deltas, weights,
                losses=losses, idx=idx)
            return new_global, server_state, resid
        w_eff = agg.weigh(server_state, weights, idx)
        vecs = tree_ravel_clients(deltas)
        if self.restructured:
            rel, resid = self.release_rows(vecs, noise, uniform, resid,
                                           attack=attack)
            delta_vec = self.hier_reduce_flat(self._bound_rows(rel), w_eff)
        elif comp.enabled:
            delta_vec, resid = cx.transport_delta_flat(
                vecs, w_eff, noise, uniform, priv, comp, agg, resid,
                use_pallas=self.use_pallas)
        else:
            delta_vec = dp.private_delta_flat(vecs, w_eff, noise, priv, agg,
                                              use_pallas=self.use_pallas)
        delta = tree_unflatten_from_vector(delta_vec, global_params)
        new_global, server_state = agg.apply(
            server_state, global_params, delta, losses=losses, idx=idx)
        return new_global, server_state, resid


def make_pipeline(fed_cfg, *, agg: ServerAggregator,
                  num_clients: Optional[int] = None) -> RoundPipeline:
    """The round pipeline of a FedConfig and its built aggregator."""
    return RoundPipeline(agg=agg, privacy=fed_cfg.privacy,
                         compression=fed_cfg.compression,
                         use_pallas=fed_cfg.use_pallas_aggregation,
                         adversary=fed_cfg.adversary,
                         num_clients=num_clients,
                         hierarchy=fed_cfg.hierarchy)
