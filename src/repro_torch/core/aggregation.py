"""Server aggregation behind the reference's strategy contract
(DESIGN.md §7), with the paper's FedAvg as its one strategy so far.

The delta contract: each round, client g trains from the broadcast
global model and ships d_g = θ_g − θ. The server reduces the deltas and
applies its update:

    Δ   = Σ_g w_g d_g           (reduce; Eq. 3 on deltas)
    θ' = θ + server_lr · Δ      (apply, in float32)

``ServerAggregator`` keeps the reference's callables (``init``,
``weigh``, ``reduce``, ``reduce_flat``, ``apply``, ``step``). With
``use_pallas`` the reduce runs the hand-written ``fedavg_reduce`` kernel
on the raveled (C, P) matrix (one launch); without it, a float32 sum per
leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import AggConfig
from repro_torch.core.fedavg import fedavg_stacked
from repro_torch.kernels import fedavg_reduce, fedavg_reduce_tree
from repro_torch.kernels.ref import ref_fedavg_flat
from repro_torch.utils.pytree import tree_map

PyTree = Any


class AggState(NamedTuple):
    """Server-side aggregator state, uniform across strategies (unused
    slots are scalar zeros)."""

    step: torch.Tensor  # rounds aggregated so far, () int32
    m: PyTree  # momentum / first moment (later strategies)
    v: PyTree  # second moment (later strategies)
    scores: PyTree  # adaptive per-group scores (later strategies)


@dataclass(frozen=True)
class ServerAggregator:
    """(init, weigh, reduce, apply) over parameter-delta trees."""

    name: str
    cfg: AggConfig
    init: Callable[[PyTree], AggState]
    weigh: Callable  # (state, weights, idx) -> weights
    reduce: Callable  # (stacked_deltas, weights) -> delta
    reduce_flat: Callable  # ((C, P), (C,)) -> (P,)
    apply: Callable  # (state, global, delta, losses, idx) -> (global, state)
    step: Optional[Callable] = None  # weigh + reduce + apply

    def __post_init__(self):
        if self.step is None:
            def step(state, global_params, deltas, weights, losses=None,
                     idx=None, **kw):
                w = self.weigh(state, weights, idx)
                delta = self.reduce(deltas, w)
                return self.apply(state, global_params, delta,
                                  losses=losses, idx=idx, **kw)

            object.__setattr__(self, "step", step)


def make_aggregator(cfg: AggConfig, *, num_clients: int,
                    use_pallas: bool = False) -> ServerAggregator:
    """The configured strategy. ``use_pallas`` routes the client-axis
    reduce through the ``fedavg_reduce`` CUDA kernel."""
    if cfg.name != "fedavg":
        raise NotImplementedError(
            f"aggregation strategy {cfg.name!r} is not ported yet "
            "(ROADMAP.md queue A item 7); the port runs 'fedavg'")
    reduce, reduce_flat = _linear_reduce(use_pallas)
    return ServerAggregator(
        name=cfg.name, cfg=cfg, init=_zeros_state, weigh=_identity_weigh,
        reduce=reduce, reduce_flat=reduce_flat, apply=_apply_sgd(cfg))


def _zeros_state(global_params: PyTree) -> AggState:
    dev = next(iter(global_params.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return AggState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zero, v=zero, scores=zero)


def _identity_weigh(state, weights, idx):
    return weights


def _linear_reduce(use_pallas: bool):
    """Weighted delta moment: per-leaf float32 sums, or the kernel on
    the raveled (C, P) matrix."""
    if not use_pallas:
        return fedavg_stacked, ref_fedavg_flat
    return fedavg_reduce_tree, fedavg_reduce


def _apply_sgd(cfg: AggConfig):
    """θ += server_lr · Δ, in float32, cast to each leaf's dtype."""

    def apply(state: AggState, global_params, delta, losses=None, idx=None,
              **kw):
        new_g = tree_map(lambda g, d: (g.float() + cfg.server_lr * d.float()
                                       ).to(g.dtype), global_params, delta)
        return new_g, state._replace(step=state.step + 1)

    return apply
