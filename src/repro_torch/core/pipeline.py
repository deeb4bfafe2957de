"""The round's aggregate stage (DESIGN.md §13): the part of the
reference's ``core/pipeline.py::RoundPipeline`` that the port runs.

The reference declares five stages, ``[local_train, attack, privacy,
codec, aggregate]``. ``FederatedGPO`` keeps local training; this module
runs the aggregate stage on the clients' raw deltas:

* with ``norm_bound == 0``, ``agg.step`` (weigh, reduce, apply; the
  fused kernel step where the strategy has one), ``losses`` and ``idx``
  passed through;
* with ``norm_bound > 0``, the rows are materialised: weigh, ravel the
  deltas to (C, P), clip each row to the bound (``norm_clip_rows``),
  ``agg.reduce_flat``, then ``agg.apply``.

The attack, privacy, codec and hierarchy stages are ROADMAP.md queue A
item 8; ``FederatedGPO`` refuses a config that turns one on.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.adversary import norm_clip_rows
from repro_torch.core.aggregation import ServerAggregator
from repro_torch.utils.pytree import (
    tree_ravel_clients,
    tree_unflatten_from_vector,
)


@dataclass(frozen=True)
class RoundPipeline:
    """Stateless: the caller threads the server state through."""

    agg: ServerAggregator

    @property
    def norm_bound(self) -> float:
        return self.agg.cfg.norm_bound

    @property
    def restructured(self) -> bool:
        """True when the round materialises the per-client rows (norm
        bounding on)."""
        return self.norm_bound > 0.0

    def reduce_apply(self, server_state, global_params, deltas, weights, *,
                     losses, idx):
        """Client-stacked delta trees in, (new global params, new server
        state) out. ``idx`` are the participants' ids (None: all)."""
        agg = self.agg
        if not self.restructured:
            return agg.step(server_state, global_params, deltas, weights,
                            losses=losses, idx=idx)
        w_eff = agg.weigh(server_state, weights, idx)
        rel = norm_clip_rows(tree_ravel_clients(deltas), self.norm_bound)
        delta = tree_unflatten_from_vector(agg.reduce_flat(rel, w_eff),
                                           global_params)
        return agg.apply(server_state, global_params, delta, losses=losses,
                         idx=idx)
