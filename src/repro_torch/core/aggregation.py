"""Pluggable server aggregation (DESIGN.md §7 and §13): the PyTorch port
of the reference's strategy registry.

The delta contract: each round, client g trains from the broadcast
global model and ships d_g = θ_g − θ. The server forms a weighted moment
of the deltas (or a robust order statistic of them) and applies a
stateful update:

    Δ   = reduce_g(w_g, d_g)          (reduce)
    θ' = θ + server_update(Δ)         (apply)

FedAvg (Eq. 3) is the degenerate member. ``ServerAggregator`` keeps the
reference's callables:

* ``init(global_params) -> AggState``: server state (momentum and moment
  trees, adaptive scores, the fedbuff buffer);
* ``weigh(state, weights, idx) -> weights``: identity except ``adaptive``;
* ``reduce(deltas, weights)`` / ``reduce_flat((C, P), (C,))``: the
  contraction over the client axis;
* ``apply(state, global, delta, losses, idx)``: the server update;
* ``step``: weigh, reduce, apply.

With ``use_pallas`` the client-axis work runs the hand-written CUDA
kernels on the raveled (C, P) matrix: ``fedavg_reduce`` for the linear
family, ``agg_momentum_reduce`` for fedavgm's fused step,
``agg_trimmed_reduce`` for trimmed_mean and median, and
``agg_pairwise_dists`` for krum and multi_krum. Without it, plain
float32 tensor ops. geomedian has no kernel in the reference either.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import AggConfig
from repro_torch.core.fedavg import fedavg_stacked
from repro_torch.kernels import (
    agg_momentum_reduce,
    agg_pairwise_dists,
    agg_trimmed_reduce,
    fedavg_reduce,
    fedavg_reduce_tree,
)
from repro_torch.kernels.ref import ref_fedavg_flat, ref_trimmed_flat
from repro_torch.utils.pytree import (
    tree_flatten_to_vector,
    tree_index,
    tree_leaves,
    tree_map,
    tree_ravel_clients,
    tree_unflatten_from_vector,
)
from repro_torch.utils.registry import Registry

PyTree = Any

AGGREGATORS: Registry = Registry("aggregator")


class AggState(NamedTuple):
    """Server-side aggregator state, one structure for every strategy
    (unused slots are scalar zeros)."""

    step: torch.Tensor  # rounds aggregated so far, () int32
    m: PyTree  # momentum / first moment (fedavgm, fedadam, fedyogi, fedbuff)
    v: PyTree  # second moment (fedadam, fedyogi)
    scores: PyTree  # adaptive {"ema", "seen"}, fedbuff {"count", "mass"}


@dataclass(frozen=True)
class ServerAggregator:
    """(init, weigh, reduce, apply) over parameter-delta trees."""

    name: str
    cfg: AggConfig
    linear: bool  # weighted-sum reduce vs order statistic
    needs_losses: bool  # apply consumes per-client losses (adaptive)
    init: Callable[[PyTree], AggState]
    weigh: Callable  # (state, weights, idx) -> weights
    reduce: Callable  # (stacked_deltas, weights) -> delta
    reduce_flat: Callable  # ((C, P), (C,)) -> (P,)
    apply: Callable  # (state, global, delta, losses, idx) -> (global, state)
    step: Optional[Callable] = None  # weigh + reduce + apply
    # fedbuff defers the server step until enough updates accumulate
    buffered: bool = False

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
    """The configured strategy from the registry (``KeyError`` naming
    the known ones for an unknown name). ``use_pallas`` routes the
    client-axis work through the CUDA kernels."""
    builder = AGGREGATORS.get(cfg.name)
    return builder(cfg, num_clients=num_clients, use_pallas=use_pallas)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def _device(tree: PyTree) -> torch.device:
    return tree_leaves(tree)[0].device


def _zeros_state(global_params: PyTree, *, with_m=False,
                 with_v=False) -> AggState:
    def zt():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        global_params)

    zero = torch.zeros((), dtype=torch.float32,
                       device=_device(global_params))
    return AggState(
        step=torch.zeros((), dtype=torch.int32, device=zero.device),
        m=zt() if with_m else zero,
        v=zt() if with_v else zero,
        scores=zero)


def _identity_weigh(state, weights, idx):
    return weights


def _linear_reduce(use_pallas: bool):
    """Weighted delta moment: per-leaf float32 sums, or the
    ``fedavg_reduce`` kernel on the raveled (C, P) matrix."""
    if not use_pallas:
        return fedavg_stacked, ref_fedavg_flat
    return fedavg_reduce_tree, fedavg_reduce


def _flat_to_tree(reduce_flat):
    """The tree form of a reduce on the raveled (C, P) matrix."""

    def reduce(deltas, weights):
        return tree_unflatten_from_vector(
            reduce_flat(tree_ravel_clients(deltas), weights),
            tree_index(deltas, 0))

    return reduce


def _trim_k(c: int, frac: float) -> int:
    """floor(frac·C), clamped so at least one client survives."""
    return min(int(frac * c), (c - 1) // 2)


def trimmed_mean_reduce_flat(vecs: torch.Tensor, weights: torch.Tensor,
                             k: int) -> torch.Tensor:
    """Rank-trimmed weighted mean on (C, P) f32: a stable sort per
    coordinate, k dropped at each end, the survivors' weights
    renormalised (the kernel's plain version). k = 0 is the exact
    weighted mean (no division)."""
    if k == 0:
        return ref_fedavg_flat(vecs, weights)
    return ref_trimmed_flat(vecs, weights, trim=k)


def _robust_reduce(use_pallas: bool, k_of: Callable[[int], int]):
    """Rank-trim reduce; ``k_of(C)`` maps the client count to the trim
    depth. k = 0 never reaches the kernel."""

    def reduce_flat(vecs, weights):
        k = k_of(vecs.shape[0])
        if use_pallas and k > 0:
            return agg_trimmed_reduce(vecs, weights.float(), trim=k)
        return trimmed_mean_reduce_flat(vecs, weights, k)

    return _flat_to_tree(reduce_flat), reduce_flat


def _step_sgd(g, d, lr):
    """θ + lr·d in float32, cast to θ's dtype."""
    return (g.float() + lr * d.float()).to(g.dtype)


def _apply_sgd(cfg: AggConfig):
    """θ += server_lr · Δ (FedAvg and the robust strategies)."""

    def apply(state: AggState, global_params, delta, losses=None, idx=None,
              **kw):
        new_g = tree_map(lambda g, d: _step_sgd(g, d, cfg.server_lr),
                         global_params, delta)
        return new_g, state._replace(step=state.step + 1)

    return apply


# ---------------------------------------------------------------------------
# registry entries: each factory returns a builder
# (cfg, *, num_clients, use_pallas) -> ServerAggregator
# ---------------------------------------------------------------------------
def _make_fedavg(cfg, *, num_clients, use_pallas):
    reduce, reduce_flat = _linear_reduce(use_pallas)
    return ServerAggregator(
        name=cfg.name, cfg=cfg, linear=True, needs_losses=False,
        init=_zeros_state, weigh=_identity_weigh, reduce=reduce,
        reduce_flat=reduce_flat, apply=_apply_sgd(cfg))


@AGGREGATORS.register("fedavg")
def _fedavg_factory():
    return _make_fedavg


# fedprox: the proximal term is client-side (AggConfig.prox_mu feeds the
# μ-regularizer in federated._make_local_train); the server rule is
# FedAvg, registered under the recipe's name.
@AGGREGATORS.register("fedprox")
def _fedprox_factory():
    return _make_fedavg


def _make_fedavgm(cfg, *, num_clients, use_pallas):
    reduce, reduce_flat = _linear_reduce(use_pallas)
    beta = cfg.momentum

    def apply_momentum(state, global_params, new_m):
        new_g = tree_map(lambda g, m: _step_sgd(g, m, cfg.server_lr),
                         global_params, new_m)
        return new_g, state._replace(step=state.step + 1, m=new_m)

    def apply(state: AggState, global_params, delta, losses=None, idx=None,
              **kw):
        new_m = tree_map(lambda m, d: beta * m + d.float(), state.m, delta)
        return apply_momentum(state, global_params, new_m)

    step = None
    if use_pallas:
        # the fused path: one momentum_reduce launch emits
        # (Δ, β·m + Δ) in one pass over the client deltas
        def step(state, global_params, deltas, weights, losses=None,
                 idx=None, **kw):
            _, nm_vec = agg_momentum_reduce(
                tree_ravel_clients(deltas), weights.float(),
                tree_flatten_to_vector(state.m), beta=beta)
            return apply_momentum(state, global_params,
                                  tree_unflatten_from_vector(nm_vec,
                                                             state.m))

    return ServerAggregator(
        name=cfg.name, cfg=cfg, linear=True, needs_losses=False,
        init=lambda g: _zeros_state(g, with_m=True),
        weigh=_identity_weigh, reduce=reduce, reduce_flat=reduce_flat,
        apply=apply, step=step)


@AGGREGATORS.register("fedavgm")
def _fedavgm_factory():
    return _make_fedavgm


def _make_fedadaptive(yogi: bool):
    """FedAdam / FedYogi (Reddi et al. 2021): server Adam on the delta."""

    def make(cfg, *, num_clients, use_pallas):
        reduce, reduce_flat = _linear_reduce(use_pallas)
        b1, b2, tau = cfg.beta1, cfg.beta2, cfg.tau

        def second_moment(v, d):
            d2 = torch.square(d.float())
            if yogi:
                return v - (1 - b2) * d2 * torch.sign(v - d2)
            return b2 * v + (1 - b2) * d2

        def apply(state: AggState, global_params, delta, losses=None,
                  idx=None, **kw):
            new_m = tree_map(lambda m, d: b1 * m + (1 - b1) * d.float(),
                             state.m, delta)
            new_v = tree_map(second_moment, state.v, delta)
            new_g = tree_map(
                lambda g, m, v: (g.float() + cfg.server_lr * m
                                 / (torch.sqrt(v) + tau)).to(g.dtype),
                global_params, new_m, new_v)
            return new_g, state._replace(step=state.step + 1, m=new_m,
                                         v=new_v)

        return ServerAggregator(
            name=cfg.name, cfg=cfg, linear=True, needs_losses=False,
            init=lambda g: _zeros_state(g, with_m=True, with_v=True),
            weigh=_identity_weigh, reduce=reduce, reduce_flat=reduce_flat,
            apply=apply)

    return make


@AGGREGATORS.register("fedadam")
def _fedadam_factory():
    return _make_fedadaptive(yogi=False)


@AGGREGATORS.register("fedyogi")
def _fedyogi_factory():
    return _make_fedadaptive(yogi=True)


def _make_robust(k_of: Callable[[AggConfig, int], int]):
    def make(cfg, *, num_clients, use_pallas):
        reduce, reduce_flat = _robust_reduce(use_pallas,
                                             lambda c: k_of(cfg, c))
        return ServerAggregator(
            name=cfg.name, cfg=cfg, linear=False, needs_losses=False,
            init=_zeros_state, weigh=_identity_weigh, reduce=reduce,
            reduce_flat=reduce_flat, apply=_apply_sgd(cfg))

    return make


@AGGREGATORS.register("trimmed_mean")
def _trimmed_factory():
    return _make_robust(lambda cfg, c: _trim_k(c, cfg.trim_frac))


@AGGREGATORS.register("median")
def _median_factory():
    return _make_robust(lambda cfg, c: (c - 1) // 2)


def _make_adaptive(cfg, *, num_clients, use_pallas):
    """APPA-style adaptive per-group weights: groups whose local loss EMA
    sits above the mean are upweighted (temperature fair_temp). The
    ``scores`` slot holds per-client (ema, seen): a client's first loss
    seeds its EMA, and a client not seen yet counts at the observed
    mean."""
    reduce, reduce_flat = _linear_reduce(use_pallas)
    temp, decay = cfg.fair_temp, cfg.fair_decay
    base_apply = _apply_sgd(cfg)

    def weigh(state: AggState, weights, idx):
        if temp == 0.0:
            return weights  # exact dataset-size weights (fedavg)
        ema, seen = state.scores["ema"], state.scores["seen"]
        mean_seen = (ema * seen).sum() / torch.clamp(seen.sum(), min=1.0)
        s_full = torch.where(seen > 0, ema, mean_seen)
        s = s_full if idx is None else s_full[idx]
        w = weights * torch.exp(temp * (s - s.mean()))
        return w / w.sum()

    def apply(state: AggState, global_params, delta, losses=None, idx=None,
              mask=None, **kw):
        """``mask`` (rows,) bool, in the fault round: only the clients
        whose update was released this round observed a loss; the other
        rows keep their previous ``ema`` and ``seen``."""
        new_g, state = base_apply(state, global_params, delta)
        if losses is not None:
            losses = losses.float()
            if idx is None:
                idx = torch.arange(losses.shape[0], device=losses.device)
            ema, seen = state.scores["ema"], state.scores["seen"]
            new_ema = torch.where(seen[idx] > 0,
                                  decay * ema[idx] + (1 - decay) * losses,
                                  losses)
            new_seen = 1.0
            if mask is not None:
                mask = mask.to(losses.device)
                new_ema = torch.where(mask, new_ema, ema[idx])
                new_seen = torch.where(mask, 1.0, seen[idx])
            ema, seen = ema.clone(), seen.clone()
            ema[idx] = new_ema
            seen[idx] = new_seen
            state = state._replace(scores={"ema": ema, "seen": seen})
        return new_g, state

    def init(global_params):
        state = _zeros_state(global_params)
        zeros = torch.zeros((num_clients,), dtype=torch.float32,
                            device=_device(global_params))
        return state._replace(scores={"ema": zeros, "seen": zeros.clone()})

    return ServerAggregator(
        name=cfg.name, cfg=cfg, linear=True, needs_losses=True,
        init=init, weigh=weigh, reduce=reduce, reduce_flat=reduce_flat,
        apply=apply)


@AGGREGATORS.register("adaptive")
def _adaptive_factory():
    return _make_adaptive


def _make_fedbuff(cfg, *, num_clients, use_pallas):
    """FedBuff-style buffered aggregation (Nguyen et al. 2022; DESIGN.md
    §11). The reduce is fedavg's; the server step is deferred: the
    reduced update accumulates into a buffer (``AggState.m``) with its
    weight mass and released-client count (``AggState.scores``), and
    θ += server_lr · buffer / mass is applied once at least ``buffer_k``
    client updates have been absorbed since the last flush. The fault
    round passes the realized ``mass`` (the survivors' discounted weight)
    and ``released`` count; without them the round released every
    participant with mass 1, so buffer_k <= C flushes every round
    (fedbuff is fedavg there)."""
    reduce, reduce_flat = _linear_reduce(use_pallas)
    base_lr, buffer_k = cfg.server_lr, cfg.buffer_k

    def init(global_params):
        state = _zeros_state(global_params, with_m=True)
        zero = torch.zeros((), dtype=torch.float32,
                           device=_device(global_params))
        return state._replace(scores={"count": zero, "mass": zero.clone()})

    def apply(state: AggState, global_params, delta, losses=None, idx=None,
              mass=None, released=None, **kw):
        if mass is None:
            mass = 1.0  # the weights are normalised
        if released is None:
            released = float(idx.shape[0] if idx is not None
                             else num_clients)
        buf = tree_map(lambda m, d: m + mass * d.float(), state.m, delta)
        count = state.scores["count"] + released
        total = state.scores["mass"] + mass
        flush = count >= buffer_k
        scale = torch.where(flush, base_lr / torch.clamp(total, min=1e-12),
                            0.0)
        new_g = tree_map(lambda g, b: (g.float() + scale * b).to(g.dtype),
                         global_params, buf)
        new_m = tree_map(lambda b: torch.where(flush, 0.0, b), buf)
        scores = {"count": torch.where(flush, 0.0, count),
                  "mass": torch.where(flush, 0.0, total)}
        return new_g, state._replace(step=state.step + 1, m=new_m,
                                     scores=scores)

    return ServerAggregator(
        name=cfg.name, cfg=cfg, linear=True, needs_losses=False,
        init=init, weigh=_identity_weigh, reduce=reduce,
        reduce_flat=reduce_flat, apply=apply, buffered=True)


@AGGREGATORS.register("fedbuff")
def _fedbuff_factory():
    return _make_fedbuff


# ---------------------------------------------------------------------------
# Byzantine-robust defenses (DESIGN.md §13). Rows of weight 0 are
# excluded from selection and never chosen.
# ---------------------------------------------------------------------------
# finite sentinel for masked distances and scores, not inf: with very few
# active clients every score would be inf, and argmin over all-inf is a
# degenerate tie
_BIG = 1e30


def _pairwise_sq_dists(vecs: torch.Tensor, use_pallas: bool) -> torch.Tensor:
    if use_pallas:
        return agg_pairwise_dists(vecs)
    x = vecs.float()
    sq = (x * x).sum(dim=1)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * x @ x.T, min=0.0)


def krum_scores(vecs: torch.Tensor, weights: torch.Tensor, f: int, *,
                use_pallas: bool = False) -> torch.Tensor:
    """(C,) Krum scores (Blanchard et al. 2017): client c's score is the
    sum of its n − f − 2 smallest squared distances to the OTHER active
    clients (n = the active rows, weight > 0). Lower is better."""
    x = vecs.float()
    c = x.shape[0]
    active = weights.float() > 0.0
    n = active.sum()
    d = _pairwise_sq_dists(x, use_pallas)
    off_diag = ~torch.eye(c, dtype=torch.bool, device=x.device)
    d = torch.where(active[:, None] & active[None, :] & off_diag, d, _BIG)
    nn = torch.clamp(n - f - 2, min=1, max=c - 1)
    ds, _ = torch.sort(d, dim=1)
    ranks = torch.arange(c, device=x.device)[None, :]
    score = torch.where(ranks < nn, ds, 0.0).sum(dim=1)
    return torch.where(active, score, _BIG * c)


def _make_krum(multi: bool):
    def make(cfg, *, num_clients, use_pallas):
        f = cfg.num_malicious
        m_sel = max(1, min(cfg.multi_krum_m, num_clients))

        def reduce_flat(vecs, weights):
            x = vecs.float()
            scores = krum_scores(x, weights, f, use_pallas=use_pallas)
            if not multi:
                return x[torch.argmin(scores)]
            # multi-Krum: the weighted mean of the m_sel best-scored rows
            # (weights renormalised over the selection)
            rank = torch.argsort(torch.argsort(scores, stable=True),
                                 stable=True)
            w = torch.where(rank < min(m_sel, x.shape[0]), weights.float(),
                            0.0)
            w = w / torch.clamp(w.sum(), min=1e-12)
            return torch.einsum("c,cp->p", w, x)

        return ServerAggregator(
            name=cfg.name, cfg=cfg, linear=False, needs_losses=False,
            init=_zeros_state, weigh=_identity_weigh,
            reduce=_flat_to_tree(reduce_flat), reduce_flat=reduce_flat,
            apply=_apply_sgd(cfg))

    return make


@AGGREGATORS.register("krum")
def _krum_factory():
    return _make_krum(multi=False)


@AGGREGATORS.register("multi_krum")
def _multi_krum_factory():
    return _make_krum(multi=True)


def geometric_median_flat(vecs: torch.Tensor, weights: torch.Tensor, *,
                          iters: int, eps: float) -> torch.Tensor:
    """Smoothed Weiszfeld iteration for the weighted geometric median
    (Pillutla et al. 2022): y ← Σ_c (w_c / max(‖x_c − y‖, eps)) x_c /
    Σ_c (w_c / max(‖x_c − y‖, eps)), a fixed ``iters`` steps from the
    weighted mean. Rows of weight 0 drop out exactly."""
    x = vecs.float()
    w = torch.clamp(weights.float(), min=0.0)
    y = torch.einsum("c,cp->p", w / torch.clamp(w.sum(), min=1e-12), x)
    for _ in range(iters):
        dist = torch.sqrt(torch.square(x - y[None, :]).sum(dim=1))
        inv = w / torch.clamp(dist, min=eps)
        y = torch.einsum("c,cp->p", inv, x) / torch.clamp(inv.sum(),
                                                          min=1e-12)
    return y


def _make_geomedian(cfg, *, num_clients, use_pallas):
    def reduce_flat(vecs, weights):
        return geometric_median_flat(vecs, weights,
                                     iters=cfg.geomedian_iters,
                                     eps=cfg.geomedian_eps)

    return ServerAggregator(
        name=cfg.name, cfg=cfg, linear=False, needs_losses=False,
        init=_zeros_state, weigh=_identity_weigh,
        reduce=_flat_to_tree(reduce_flat), reduce_flat=reduce_flat,
        apply=_apply_sgd(cfg))


@AGGREGATORS.register("geomedian")
def _geomedian_factory():
    return _make_geomedian
