"""Adam over params trees, written out (not ``torch.optim``), in the
JAX package's formula so that the two agree step for step.

An ``Optimizer`` is an (init, update) pair; the state is itself a tree.
The federated trainer keeps one state per client, stacked on a leading
client axis: every moment leaf is (C, ...) and ``step`` is (C,) int32,
so each client's bias correction uses its own step count, as the
reference's ``jax.vmap(opt.init)`` state does. An unstacked state
(``step`` a 0-d tensor) serves one model, as in the centralized
baseline. Updates run under ``torch.no_grad`` and return new tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

PyTree = Any


class AdamState(NamedTuple):
    step: torch.Tensor  # () or (C,) int32
    mu: PyTree
    nu: PyTree


@dataclass(frozen=True)
class Optimizer:
    init: Callable[..., AdamState]
    update: Callable[[PyTree, AdamState, PyTree], tuple]
    """update(grads, state, params) -> (new_params, new_state)"""


def _per_row(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A () or (C,) tensor shaped to broadcast against a leaf (C, ...)."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def clip_by_global_norm(grads: PyTree, max_norm: float, *,
                        clients: bool = False):
    """Scale ``grads`` so the global L2 norm is at most ``max_norm``:
    over the whole tree, or per client over client-stacked grads.
    Returns (clipped grads, norm () or (C,))."""
    dims = lambda g: tuple(range(1 if clients else 0, g.dim()))  # noqa: E731
    norm = torch.sqrt(sum(g.float().square().sum(dim=dims(g))
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * _per_row(scale, g), grads), norm


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         grad_clip: float = 0.0) -> Optimizer:
    """Adam: m = b1 m + (1-b1) g, v = b2 v + (1-b2) g², and
    p − lr·m̂/(√v̂ + eps) with m̂ = m/(1−b1^t), v̂ = v/(1−b2^t), all in
    float32."""

    def init(params: PyTree, num_clients: int | None = None) -> AdamState:
        """Zero moments like ``params``; with ``num_clients`` the params
        are client-stacked and ``step`` is one count per client."""
        first = tree_leaves(params)[0]
        shape = () if num_clients is None else (num_clients,)
        zeros = lambda: tree_map(  # noqa: E731
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamState(step=torch.zeros(shape, dtype=torch.int32,
                                          device=first.device),
                         mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(grads: PyTree, state: AdamState, params: PyTree):
        if grad_clip > 0.0:
            grads, _ = clip_by_global_norm(grads, grad_clip,
                                           clients=state.step.dim() == 1)
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state.nu, grads)
        t = step.float()
        # the bases filled on the device (a tensor made from a Python
        # number would be copied from the host, which a captured round
        # cannot do)
        bc1 = 1.0 - torch.pow(torch.full((), b1, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.full((), b2, device=t.device), t)

        def upd(p, m, v):
            mhat = m / _per_row(bc1, m)
            vhat = v / _per_row(bc2, v)
            return (p.float() - lr * mhat / (torch.sqrt(vhat) + eps)
                    ).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu,
                                                         nu=nu)

    return Optimizer(init=init, update=update)
