"""The round's stage pipeline (DESIGN.md §13): the part of the
reference's ``core/pipeline.py::RoundPipeline`` that the port runs.

The reference declares five stages, ``[local_train, attack, privacy,
codec, aggregate]``. ``FederatedGPO`` keeps local training; this module
runs the privacy, codec and aggregate stages on the clients' raw deltas:

* with ``norm_bound == 0``, the reference's fused dispatch: the codec on
  (``core/compression.py::transport_delta_flat``: DP release, EF
  residual, int8 or top-k round trip, reduce, the transport kernels
  under ``use_pallas``), else the privacy stage on
  (``core/privacy.py::private_delta_flat``: clip, noise, reduce, the
  clip kernel under ``use_pallas``), then ``agg.apply``; with both off,
  ``agg.step`` (weigh, reduce, apply; the fused kernel step where the
  strategy has one);
* with ``norm_bound > 0``, the rows are materialised: weigh, ravel the
  deltas to (C, P), release them (``release_flat``: privacy, then the
  codec), clip each row to the bound (``norm_clip_rows``),
  ``agg.reduce_flat``, then ``agg.apply``.

``losses`` and ``idx`` pass through to the strategy. The randomness of
the release comes in as operands (the σ-scaled noise and the rounding
uniforms, (C, P) each), the EF residual as carry state that the caller
owns. The attack and hierarchy stages are ROADMAP.md queue A item 8;
``FederatedGPO`` refuses a config that turns one on.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import CompressionConfig, PrivacyConfig
from repro_torch.core import compression as cx
from repro_torch.core import privacy as dp
from repro_torch.core.adversary import norm_clip_rows
from repro_torch.core.aggregation import ServerAggregator
from repro_torch.utils.pytree import (
    tree_ravel_clients,
    tree_unflatten_from_vector,
)


@dataclass(frozen=True)
class RoundPipeline:
    """Stateless: the caller threads the server state and the EF
    residual through."""

    agg: ServerAggregator
    privacy: PrivacyConfig = PrivacyConfig()
    compression: CompressionConfig = CompressionConfig()
    use_pallas: bool = False

    @property
    def norm_bound(self) -> float:
        return self.agg.cfg.norm_bound

    @property
    def restructured(self) -> bool:
        """True when the round materialises the per-client released rows
        (norm bounding on)."""
        return self.norm_bound > 0.0

    def stages(self) -> tuple:
        """The declared stages as (name, enabled) pairs. The port runs no
        attack stage (``FederatedGPO`` refuses one)."""
        return (
            ("local_train", True),
            ("attack", False),
            ("privacy", self.privacy.enabled),
            ("codec", self.compression.enabled),
            ("aggregate", True),
        )

    def reduce_apply(self, server_state, global_params, deltas, weights, *,
                     losses, idx, resid=None, noise=None, uniform=None):
        """Client-stacked delta trees in, (new global params, new server
        state, new EF residual) out. ``idx`` are the participants' ids
        (None: all); ``resid`` their EF residual rows (None without error
        feedback); ``noise`` and ``uniform`` the round's presampled
        release draws (None where the config draws none)."""
        agg, priv, comp = self.agg, self.privacy, self.compression
        if not (self.restructured or priv.enabled or comp.enabled):
            new_global, server_state = agg.step(
                server_state, global_params, deltas, weights,
                losses=losses, idx=idx)
            return new_global, server_state, resid
        w_eff = agg.weigh(server_state, weights, idx)
        vecs = tree_ravel_clients(deltas)
        if self.restructured:
            rel, resid = cx.release_flat(vecs, noise, uniform, priv, comp,
                                         resid)
            delta_vec = agg.reduce_flat(norm_clip_rows(rel, self.norm_bound),
                                        w_eff)
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


def make_pipeline(fed_cfg, *, agg: ServerAggregator) -> RoundPipeline:
    """The round pipeline of a FedConfig and its built aggregator."""
    return RoundPipeline(agg=agg, privacy=fed_cfg.privacy,
                         compression=fed_cfg.compression,
                         use_pallas=fed_cfg.use_pallas_aggregation)
