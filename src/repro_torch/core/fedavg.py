"""FedAvg aggregation (paper Eq. 2-3) on client-stacked params trees.

* ``normalize_weights`` — p_g = |D_g| / Σ|D_g'| (Eq. 2);
* ``fedavg_stacked`` — Eq. 3 per leaf over the leading client axis;
* ``fedavg_flat`` — the same through the aggregator's flat reduce on the
  raveled (C, P) matrix, the ``fedavg_reduce`` kernel's contract;
* ``fedavg_allreduce`` — the sharded round's form: each process weighs
  its own clients' params and one sum over the client mesh axes is the
  aggregation server (``launch/collectives.py``);
* ``broadcast_to_clients`` — the server's redistribution.

The strategy layer on top (the delta contract and the server update)
is ``core/aggregation.py``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils.pytree import (
    tree_flatten_to_vector,
    tree_index,
    tree_map,
    tree_ravel_clients,
    tree_unflatten_from_vector,
)

PyTree = Any


def normalize_weights(sizes) -> torch.Tensor:
    """p_g = |D_g| / Σ_g' |D_g'| (Eq. 2), float32. The denominator is
    clamped at 1e-12, so all-zero sizes give zero weights, not NaNs."""
    sizes = torch.as_tensor(sizes).float()
    return sizes / torch.clamp(sizes.sum(), min=1e-12)


def fedavg_stacked(stacked_params: PyTree, weights: torch.Tensor) -> PyTree:
    """Eq. 3 for client-stacked trees: leaves (C, ...) -> (...), summed
    in float32 and cast back to each leaf's dtype."""
    w = weights.float()

    def agg(leaf):
        wf = w.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return (leaf.float() * wf).sum(dim=0).to(leaf.dtype)

    return tree_map(agg, stacked_params)


def broadcast_to_clients(params: PyTree, num_clients: int) -> PyTree:
    """The global model copied to every client: leaves (C, ...). Copies,
    not views, since each client trains its own."""
    return tree_map(lambda x: x.unsqueeze(0).expand(
        num_clients, *x.shape).clone(), params)


def fedavg_allreduce(local_params: PyTree, weight, axis_names,
                     comm) -> PyTree:
    """The weighted sum over the client mesh axes ``axis_names`` of
    every process's ``local_params`` (already summed over its clients
    with weights normalized over all of them) times ``weight``, on
    ``comm`` (``launch.collectives.Collectives``). The leaves travel
    coalesced in one (P,) float32 buffer, so the round makes one
    all-reduce where the reference makes one psum a leaf (which XLA
    combines); each comes back in its dtype on every process."""
    vec = tree_flatten_to_vector(local_params) * weight
    return tree_unflatten_from_vector(comm.psum(vec, axis_names),
                                      local_params)


def fedavg_flat(stacked_params: PyTree, weights: torch.Tensor) -> PyTree:
    """Flattened-vector FedAvg through the ``fedavg`` strategy's
    ``reduce_flat`` (the weighted mean of the raveled (C, P) matrix),
    the aggregator built per call as the reference does."""
    from repro_torch.configs.base import AggConfig
    from repro_torch.core.aggregation import make_aggregator

    vecs = tree_ravel_clients(stacked_params)
    agg = make_aggregator(AggConfig(), num_clients=int(vecs.shape[0]))
    return tree_unflatten_from_vector(agg.reduce_flat(vecs, weights.float()),
                                      tree_index(stacked_params, 0))
