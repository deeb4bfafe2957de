"""The round's stage pipeline (DESIGN.md §13): the PyTorch port of the
reference's ``core/pipeline.py::RoundPipeline``.

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

The sharded round (``core/federated.py::make_sharded_round``) holds
only its own clients' rows and ends its stages in collectives over the
client mesh ``axes`` on ``comm`` (``launch/collectives.py``):
``sharded_delta`` (one all-reduce of the (P,) partial sum for the
linear family, an all-gather of the rows for the robust one, the two
hops of ``_two_hop_reduce`` on an edge mesh), ``masked_reduce_sharded``
under faults, and ALIE's honest moments summed over the processes
(``attack_rows`` with ``axes``).

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
from repro_torch.core.fedavg import fedavg_allreduce
from repro_torch.utils.pytree import (
    tree_map,
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
        ``mask_full`` (C,) bool and ``noise_full`` (C, P) or None, their
        rows ``idx`` (None: all), indexed where each lies (the captured
        round holds all three on the device, so nothing is read back)."""
        if mask_full.shape != (self.num_clients,):
            raise ValueError(f"attacker mask of shape {tuple(mask_full.shape)}"
                             f" for a population of {self.num_clients}")
        if idx is None:
            return AttackDraws(mask_full, noise_full)
        rows = (None if noise_full is None
                else noise_full[idx.to(noise_full.device)])
        return AttackDraws(mask_full[idx.to(mask_full.device)], rows)

    def attacked_flags(self, mask_full: Optional[torch.Tensor],
                       idx: Optional[torch.Tensor] = None):
        """The participants' (rows,) bool poison flags for label_flip,
        sliced from the population's mask by ``idx`` (None: all); None
        when no label flip is configured."""
        if not self.flip_data:
            return None
        return mask_full if idx is None else mask_full[idx]

    def attack_rows(self, vecs: torch.Tensor,
                    attack: Optional[AttackDraws], *, axes=None,
                    comm=None) -> torch.Tensor:
        """The attack stage on the raw flat (rows, P) delta matrix; the
        identity unless a delta attack is configured. ``axes``: the
        client mesh axes when the rows are one process's shard (with
        ``comm``, its collectives): ALIE's honest moments are then
        summed over the processes, so colluding attackers agree."""
        if not self.attack_delta:
            return vecs
        stats = None
        if axes is not None and self.adversary.kind == "alie":
            stats = byz.honest_stats_sharded(
                vecs, attack.mask.to(vecs.device), axes, comm)
        return byz.apply_attack(vecs, attack.mask, self.adversary,
                                attack.noise, stats=stats)

    def release_rows(self, vecs, noise, uniform, resid, *, attack=None,
                     axes=None, comm=None):
        """Attack, privacy and codec on per-client rows, no reduction: the
        fault round buffers and masks the individual wire values, so an
        attacker's row that straggles is buffered corrupted. Returns
        (released rows, carry-out residual)."""
        return cx.release_flat(
            self.attack_rows(vecs, attack, axes=axes, comm=comm), noise,
            uniform, self.privacy, self.compression, resid)

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

    def _two_hop_reduce(self, rel: torch.Tensor, weights: torch.Tensor,
                        axes, comm) -> torch.Tensor:
        """The robust reduce of the sharded round on an ("edge", …) mesh
        (DESIGN.md §14): hop 1 all-gathers the released rows within the
        edge (``axes[1:]``) and every process of the edge reduces its C/E
        rows to the edge's candidate (against within-edge normalised
        weights, as ``hier_reduce_flat``); hop 2 all-gathers only the E
        candidates across the edges (``axes[0]``), as int8 with f32
        scales when the int8 codec is on (round to nearest: the candidate
        is an edge's value, with no client's rounding draw), and the
        rule runs over the (E, P) candidates weighted by edge mass. The
        largest collective shrinks from C rows to E."""
        agg, comp = self.agg, self.compression
        edge_ax, intra = axes[0], axes[1:]
        edge_vecs = comm.all_gather(rel, intra)
        edge_w = comm.all_gather(weights.float(), intra)
        mass = edge_w.sum()
        cand = agg.reduce_flat(
            edge_vecs, edge_w / torch.clamp(mass, min=1e-12))[None, :]
        if comp.enabled and comp.kind == "int8":
            q, scales = cx.quantize_int8(cand)
            all_cand = cx.dequantize_int8(comm.all_gather(q, edge_ax),
                                          comm.all_gather(scales, edge_ax))
        else:
            all_cand = comm.all_gather(cand, edge_ax)
        return agg.reduce_flat(all_cand,
                               comm.all_gather(mass.reshape(1), edge_ax))

    def masked_reduce(self, contrib: torch.Tensor, w_c: torch.Tensor,
                      mask_c: torch.Tensor, *,
                      trim_frac: float) -> torch.Tensor:
        """The fault round's reduce of the (C, P) blended rows (fresh and
        buffered) with their weights ``w_c`` and survivor mask
        ``mask_c`` ((C,) tensors on the rows' device): the linear family
        renormalises over the survivors, median and trimmed mean shrink
        their trim depth with the survivor count, the defenses drop
        weight-0 rows. The norm bound clips the blended rows first.
        Reads nothing back to the host; with no survivor the result is
        discarded by the caller, as in the reference's traced round."""
        agg = self.agg
        contrib = self._bound_rows(contrib)
        if agg.linear:
            return agg.reduce_flat(contrib,
                                   av.masked_mean_weights(w_c, mask_c))
        if agg.name in ("median", "trimmed_mean"):
            return av.masked_robust_reduce_flat(
                contrib, w_c, mask_c, name=agg.name, trim_frac=trim_frac)
        return agg.reduce_flat(contrib, torch.where(mask_c, w_c, 0.0))

    def masked_reduce_sharded(self, contrib_l: torch.Tensor,
                              w_c: torch.Tensor, mask_c: torch.Tensor,
                              gids: torch.Tensor, axes, comm, *,
                              trim_frac: float) -> torch.Tensor:
        """``masked_reduce`` for the sharded fault round: ``contrib_l`` are
        this process's blended rows (clients ``gids``), ``w_c`` and
        ``mask_c`` the population's (C,) weights and survivors, on the
        rows' device.
        The linear family sums its rows against the survivors'
        renormalised weights and makes one all-reduce; the robust rules
        and the defenses all-gather the rows and reduce the (C, P)
        matrix as ``masked_reduce`` does, on every process."""
        agg = self.agg
        contrib_l = self._bound_rows(contrib_l)
        if agg.linear:
            wn_l = av.masked_mean_weights(w_c, mask_c)[
                gids.to(w_c.device)]
            return comm.psum(agg.reduce_flat(contrib_l, wn_l), axes)
        all_vecs = comm.all_gather(contrib_l, axes)
        if agg.name in ("median", "trimmed_mean"):
            return av.masked_robust_reduce_flat(
                all_vecs, w_c, mask_c, name=agg.name, trim_frac=trim_frac)
        return agg.reduce_flat(all_vecs, torch.where(mask_c, w_c, 0.0))

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

    # -- the sharded round's middle -------------------------------------------
    def sharded_delta(self, deltas, weights, global_prev, *, axes, comm,
                      resid=None, noise=None, uniform=None,
                      attack: Optional[AttackDraws] = None):
        """One process's client-stacked delta trees (its C/W clients) in,
        (the round's reduced delta tree, the new residual rows) out, the
        same on every process. ``weights`` are the rows' Eq. 2 weights
        (normalised over all C, after ``agg.weigh``); ``resid``,
        ``noise``, ``uniform`` and ``attack`` the rows' residual and
        draws. The linear family ends in ONE all-reduce of its (P,)
        partial sum, the robust family all-gathers its rows (under the
        int8 codec the int8 payload and the f32 scales). With neither an
        attack, a norm bound nor edges, the branches of the stacked
        round's fused dispatch; otherwise (``restructured``) the rows are
        attacked (ALIE's moments summed over the processes), released and
        bounded where they are, and the linear family keeps its one
        all-reduce while the robust family gathers the released f32 rows
        (two hops on an edge mesh)."""
        agg, priv, comp = self.agg, self.privacy, self.compression
        ef = comp.enabled and comp.error_feedback
        w = weights.float()
        if self.restructured:
            vecs = self.attack_rows(tree_ravel_clients(deltas), attack,
                                    axes=axes, comm=comm)
            rel, new_resid = cx.release_flat(vecs, noise, uniform, priv,
                                             comp, resid)
            rel = self._bound_rows(rel)
            if agg.linear:
                # on an ("edge", "data") mesh this one sum IS the composed
                # two-hop partial-sum schedule (DESIGN.md §14)
                delta_vec = comm.psum(agg.reduce_flat(rel, w), axes)
            elif self.hierarchy.enabled and len(axes) > 1:
                delta_vec = self._two_hop_reduce(rel, w, axes, comm)
            else:
                delta_vec = agg.reduce_flat(comm.all_gather(rel, axes),
                                            comm.all_gather(w, axes))
            return (tree_unflatten_from_vector(delta_vec, global_prev),
                    new_resid if ef else None)
        new_resid = None
        if not (comp.enabled or priv.enabled) and agg.linear \
                and not self.use_pallas:
            # the leafwise path: each leaf's weighted sum over the rows,
            # then one all-reduce of them all
            local = tree_map(lambda x: (x.float() * w.reshape(
                (-1,) + (1,) * (x.dim() - 1))).sum(dim=0), deltas)
            return fedavg_allreduce(local, 1.0, axes, comm), None
        vecs = tree_ravel_clients(deltas)
        if agg.linear:
            if comp.enabled:
                local_vec, new_resid = cx.transport_delta_flat(
                    vecs, w, noise, uniform, priv, comp, agg, resid,
                    use_pallas=self.use_pallas)
            elif priv.enabled:
                local_vec = dp.clip_noise_reduce(vecs, w, noise, priv,
                                                 use_pallas=self.use_pallas)
            else:
                local_vec = agg.reduce_flat(vecs, w)  # fedavg_reduce
            delta_vec = comm.psum(local_vec, axes)
        elif comp.enabled:
            x = dp.privatize_flat(vecs, noise, priv) if priv.enabled \
                else vecs
            u = x + resid if ef else x
            if comp.kind == "int8":
                q, scales = cx.quantize_int8(
                    u, uniform=uniform if comp.stochastic else None)
                t_local = cx.dequantize_int8(q, scales)
                all_vecs = cx.dequantize_int8(comm.all_gather(q, axes),
                                              comm.all_gather(scales, axes))
            else:  # top-k: the dense f32 layout of the sparse rows
                t_local = cx.sparsify_topk(u, comp.topk_frac)[0]
                all_vecs = comm.all_gather(t_local, axes)
            new_resid = u - t_local if ef else None
            delta_vec = agg.reduce_flat(all_vecs, comm.all_gather(w, axes))
        else:
            x = dp.privatize_flat(vecs, noise, priv) if priv.enabled \
                else vecs
            delta_vec = agg.reduce_flat(comm.all_gather(x, axes),
                                        comm.all_gather(w, axes))
        return tree_unflatten_from_vector(delta_vec, global_prev), new_resid


def make_pipeline(fed_cfg, *, agg: ServerAggregator,
                  num_clients: Optional[int] = None) -> RoundPipeline:
    """The round pipeline of a FedConfig and its built aggregator."""
    return RoundPipeline(agg=agg, privacy=fed_cfg.privacy,
                         compression=fed_cfg.compression,
                         use_pallas=fed_cfg.use_pallas_aggregation,
                         adversary=fed_cfg.adversary,
                         num_clients=num_clients,
                         hierarchy=fed_cfg.hierarchy)
