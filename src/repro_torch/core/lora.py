"""LoRA adapters — the federated payload for backbones too large for
full-parameter FedAvg (DESIGN.md §3, "FedLoRA").

The frozen backbone is identical across clients; only the adapter tree
diverges per client and is aggregated. This matches the paper's own
frozen-embedder design and its FederatedScope-LLM / FedBiot citations.

Adapters are keyed by the JAX package's flat-leaf index (``{"17": {"a":
..., "b": ...}}``, the index into ``utils.pytree.tree_leaves``, which
walks the reference's order) so the adapter tree is a plain tree: it
stacks per client, ravels to the (C, P) matrix of the aggregation
kernels, and checkpoints exactly like any parameter tree.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.utils.pytree import (
    tree_leaves,
    tree_paths,
    tree_unflatten,
)

PyTree = Any

# parameter-path substrings that receive adapters (attention + mlp mats)
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                   "in_proj", "out_proj")


def init_lora(params: PyTree, generator: Optional[torch.Generator],
              rank: int = 8, alpha: float = 16.0,
              targets=DEFAULT_TARGETS) -> dict:
    """A/B factors for every targeted 2-D (or stacked 3-D) leaf: A ~
    N(0, 1/d) drawn from ``generator`` on its device, B zero, both in the
    leaf's dtype on the leaf's device. Stacked per-layer leaves (L, d, f)
    get per-layer adapters (L, d, r) / (L, r, f)."""
    adapters: dict[str, dict] = {}
    for i, (path, leaf) in enumerate(zip(tree_paths(params),
                                         tree_leaves(params))):
        if not any(t in path for t in targets):
            continue
        if leaf.dim() == 2:
            d, f = leaf.shape
            batch = ()
        elif leaf.dim() == 3:  # stacked over layers
            _, d, f = leaf.shape
            batch = (leaf.shape[0],)
        else:
            continue
        gen_dev = generator.device if generator is not None else leaf.device
        a = torch.randn(batch + (d, rank), generator=generator,
                        device=gen_dev) / math.sqrt(d)
        adapters[str(i)] = {
            "a": a.to(device=leaf.device, dtype=leaf.dtype),
            "b": torch.zeros(batch + (rank, f), dtype=leaf.dtype,
                             device=leaf.device)}
    device = tree_leaves(params)[0].device
    return {"adapters": adapters,
            "scale": torch.tensor(alpha / rank, dtype=torch.float32,
                                  device=device)}


def apply_lora(params: PyTree, lora: dict) -> PyTree:
    """Effective params: W + scale · A @ B where an adapter exists, in
    f32, cast back to W's dtype."""
    out = list(tree_leaves(params))
    scale = lora["scale"]
    for idx_str, ad in lora["adapters"].items():
        i = int(idx_str)
        w = out[i]
        delta = torch.matmul(ad["a"].float(), ad["b"].float())
        out[i] = (w.float() + scale * delta).to(w.dtype)
    return tree_unflatten(params, out)


def lora_param_count(lora: dict) -> int:
    return int(sum(x.numel() for ad in lora["adapters"].values()
                   for x in (ad["a"], ad["b"])))


def make_lora_forward(forward_fn: Callable, params: PyTree) -> Callable:
    """forward(lora, *args) with the frozen backbone closed over — the
    trainable tree (and thus the federated payload) is only the
    adapters."""

    def fn(lora, *args, **kwargs):
        return forward_fn(apply_lora(params, lora), *args, **kwargs)

    return fn


def lora_from_reference(tree: dict, device=None) -> dict:
    """The JAX package's adapter tree (``{"adapters": {i: {"a", "b"}},
    "scale"}`` as numpy arrays) as the port's, on ``device`` (CUDA
    unless the caller names another)."""
    from repro_torch.models import _tensor

    dev = resolve_device(device)
    return {"adapters": {k: {n: _tensor(ad[n], dev) for n in ("a", "b")}
                         for k, ad in tree["adapters"].items()},
            "scale": _tensor(np.asarray(tree["scale"], np.float32), dev)}
