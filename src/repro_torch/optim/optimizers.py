"""Adam, AdamW, Adafactor and SGD over params trees, written out (not
``torch.optim``), in the JAX package's formulas so that the two agree
step for step. ``lr`` is a float or a schedule of the new step
(``optim/schedules.py``).

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

from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

PyTree = Any


class AdamState(NamedTuple):
    step: torch.Tensor  # () or (C,) int32
    mu: PyTree
    nu: PyTree


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: PyTree


class AdafactorState(NamedTuple):
    step: torch.Tensor
    v_row: PyTree  # factored second moment (rows) for >=2D leaves
    v_col: PyTree  # factored second moment (cols)
    v_full: PyTree  # unfactored for <2D leaves


@dataclass(frozen=True)
class Optimizer:
    init: Callable[..., Any]
    update: Callable[[PyTree, Any, PyTree], tuple]
    """update(grads, state, params) -> (new_params, new_state)"""


def _lr_at(lr, step: torch.Tensor):
    """The learning rate at ``step``: a float as it is, a schedule's ()
    or (C,) f32 tensor."""
    return lr(step) if callable(lr) else lr


def _scaled(lr_t, x: torch.Tensor) -> torch.Tensor:
    """lr_t · x, a per-client lr_t broadcast over the leaf's rows."""
    if isinstance(lr_t, torch.Tensor):
        return _per_row(lr_t, x) * x
    return lr_t * x


def _zero_step(params: PyTree, num_clients: int | None) -> torch.Tensor:
    shape = () if num_clients is None else (num_clients,)
    return torch.zeros(shape, dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


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


def _zeros_f32(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         grad_clip: float = 0.0) -> Optimizer:
    """Adam: m = b1 m + (1-b1) g, v = b2 v + (1-b2) g², and
    p − lr·m̂/(√v̂ + eps) with m̂ = m/(1−b1^t), v̂ = v/(1−b2^t), all in
    float32; ``lr`` a float or a schedule, taken at the new step t."""

    def init(params: PyTree, num_clients: int | None = None) -> AdamState:
        """Zero moments like ``params``; with ``num_clients`` the params
        are client-stacked and ``step`` is one count per client."""
        return AdamState(step=_zero_step(params, num_clients),
                         mu=_zeros_f32(params), nu=_zeros_f32(params))

    @torch.no_grad()
    def update(grads: PyTree, state: AdamState, params: PyTree):
        if grad_clip > 0.0:
            grads, _ = clip_by_global_norm(grads, grad_clip,
                                           clients=state.step.dim() == 1)
        step = state.step + 1
        lr_t = _lr_at(lr, step)
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
            return (p.float() - _scaled(lr_t, mhat) / (torch.sqrt(vhat) + eps)
                    ).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu,
                                                         nu=nu)

    return Optimizer(init=init, update=update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01, grad_clip: float = 0.0) -> Optimizer:
    """Adam, then the decoupled decay p' − lr·wd·p of the old params."""
    base = adam(lr, b1, b2, eps, grad_clip)

    @torch.no_grad()
    def update(grads, state: AdamState, params):
        new_params, new_state = base.update(grads, state, params)
        lr_t = _lr_at(lr, new_state.step)
        return tree_map(
            lambda np_, p: (np_.float() - _scaled(lr_t * weight_decay,
                                                  p.float())
                            ).to(p.dtype), new_params, params), new_state

    return Optimizer(init=base.init, update=update)


def adafactor(lr, b2_decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Adafactor: the second moments of a (..., n, m) leaf kept as (...,
    n) row and (..., m) column means, a leaf of fewer than 2 dims in
    full; decay 1 − t^(−b2_decay), the update g·rsqrt(v + eps) clipped
    to RMS ``clip_threshold``. One model's state (``step`` a 0-d
    tensor): a client-stacked state is a stack of these, each client
    updated alone."""

    def factored(p):
        return p.dim() >= 2

    def init(params: PyTree) -> AdafactorState:
        def rows(p):
            return p.new_zeros(p.shape[:-1] if factored(p) else (1,),
                               dtype=torch.float32)

        def cols(p):
            return p.new_zeros(p.shape[:-2] + p.shape[-1:] if factored(p)
                               else (1,), dtype=torch.float32)

        def full(p):
            return (p.new_zeros((1,), dtype=torch.float32) if factored(p)
                    else torch.zeros_like(p, dtype=torch.float32))

        return AdafactorState(step=_zero_step(params, None),
                              v_row=tree_map(rows, params),
                              v_col=tree_map(cols, params),
                              v_full=tree_map(full, params))

    @torch.no_grad()
    def update(grads, state: AdafactorState, params):
        step = state.step + 1
        b2 = 1.0 - torch.pow(step.float(), -b2_decay)
        lr_t = _lr_at(lr, step)

        def upd(p, g, vr, vc, vf):
            g32 = g.float()
            g2 = g32.square() + eps
            if factored(p):
                vr = b2 * vr + (1 - b2) * g2.mean(dim=-1)
                vc = b2 * vc + (1 - b2) * g2.mean(dim=-2)
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                v = r[..., None] * vc[..., None, :]
            else:
                vf = b2 * vf + (1 - b2) * g2
                v = vf
            u = g32 * torch.rsqrt(v + eps)
            rms_u = torch.sqrt(u.square().mean() + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            return (p.float() - lr_t * u).to(p.dtype), vr, vc, vf

        results = [upd(*t) for t in zip(
            tree_leaves(params), tree_leaves(grads),
            tree_leaves(state.v_row), tree_leaves(state.v_col),
            tree_leaves(state.v_full))]

        def unf(i, like):
            return tree_unflatten(like, [r[i] for r in results])

        return unf(0, params), AdafactorState(
            step=step, v_row=unf(1, state.v_row), v_col=unf(2, state.v_col),
            v_full=unf(3, state.v_full))

    return Optimizer(init=init, update=update)


def sgd(lr, momentum: float = 0.0, grad_clip: float = 0.0) -> Optimizer:
    """SGD with heavy-ball momentum m = μ m + g, p − lr·m, in float32."""

    def init(params: PyTree, num_clients: int | None = None) -> SGDState:
        return SGDState(step=_zero_step(params, num_clients),
                        momentum=_zeros_f32(params))

    @torch.no_grad()
    def update(grads, state: SGDState, params):
        if grad_clip > 0.0:
            grads, _ = clip_by_global_norm(grads, grad_clip,
                                           clients=state.step.dim() == 1)
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        mom = tree_map(lambda m, g: momentum * m + g.float(),
                       state.momentum, grads)
        return tree_map(lambda p, m: (p.float() - _scaled(lr_t, m)
                                      ).to(p.dtype), params, mom), \
            SGDState(step=step, momentum=mom)

    return Optimizer(init=init, update=update)
