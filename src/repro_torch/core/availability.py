"""Client availability and failure simulation (DESIGN.md §11): the
PyTorch port of the reference's ``core/availability.py``.

1. **The failure schedule.** Each round every client of the population
   draws three uniforms and a delay (``fault_draws``): offline, crash
   after local training, straggle by ``delay`` ∈ [1, max_staleness]
   rounds. ``FederatedGPO`` draws them from a CPU generator of their
   own, for all C clients every round even when it samples fewer, so the
   schedule is a function of the seed and the round alone.
   ``round_schedule`` resolves the draws against the carried
   ``FaultState``: a client with an upload in flight is busy, a crashed
   client stays offline ``rejoin_rounds`` more rounds.
2. **Fault state.** The schedule's (C,) metadata (``round``,
   ``offline_until``, ``pending_due``, ``pending_weight``,
   ``pending_birth``) stays on the host, so the round decides nothing
   from a device value; only the in-flight payloads ``pending`` (C, P)
   live on the device. ``advance_fault_state`` buffers the stragglers'
   released rows, clears the arrivals' slots and starts the crashed
   clients' rejoin countdown.
3. **Degraded-mode reductions.** The linear rules renormalize their
   weights over the survivors (``masked_mean_weights``); median and
   trimmed mean shrink their trim depth with the survivor count
   (``masked_robust_reduce_flat``, plain torch: the reference has no
   kernel for it). A zero-survivor round leaves params and ``AggState``
   unchanged: the schedule is on the host, so the round branches there
   (the reference's leafwise ``tree_where`` on a traced flag has no
   counterpart).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import AvailabilityConfig

# the fault generator's seed offset: the reference's fault key tag
# (core/availability.py::_FAULT_TAG)
FAULT_TAG = 0xFA117
# empty slot of the pending-arrival round
NO_PENDING = -1
# floor of the survivor-mass denominators
_MASS_FLOOR = 1e-12


class FaultDraws(NamedTuple):
    """A round's raw per-client draws, (C,) each on the host."""

    online: torch.Tensor  # bool: reachable this round
    crash: torch.Tensor  # bool: would crash after local training
    straggle: torch.Tensor  # bool: would straggle (online, no crash)
    delay: torch.Tensor  # int32 in [1, max_staleness]


def fault_draws(gen: torch.Generator, num_clients: int,
                cfg: AvailabilityConfig) -> FaultDraws:
    """Draw u (C, 3) uniforms, then the (C,) delays in [1,
    max_staleness], from ``gen``, and threshold them."""
    u = torch.rand((num_clients, 3), generator=gen)
    hi = max(cfg.max_staleness, 1) + 1
    delay = torch.randint(1, hi, (num_clients,), generator=gen)
    return FaultDraws(
        online=u[:, 0] < cfg.online_prob, crash=u[:, 1] < cfg.crash_prob,
        straggle=(u[:, 2] < cfg.straggler_prob) & (cfg.max_staleness > 0),
        delay=delay.to(torch.int32))


class FaultState(NamedTuple):
    """Cross-round fault state: ``pending`` (C, P) f32 on the device,
    the rest on the host."""

    round: int  # rounds elapsed under this schedule
    offline_until: torch.Tensor  # (C,) int32: crash-rejoin gate
    pending: torch.Tensor  # (C, P) f32: in-flight released payloads
    pending_due: torch.Tensor  # (C,) int32 arrival round; NO_PENDING=empty
    pending_weight: torch.Tensor  # (C,) f32: weight at send time
    pending_birth: torch.Tensor  # (C,) int32: round the update was made


def init_fault_state(num_clients: int, num_params: int,
                     device=None) -> FaultState:
    return FaultState(
        round=0,
        offline_until=torch.zeros((num_clients,), dtype=torch.int32),
        pending=torch.zeros((num_clients, num_params), device=device),
        pending_due=torch.full((num_clients,), NO_PENDING,
                               dtype=torch.int32),
        pending_weight=torch.zeros((num_clients,)),
        pending_birth=torch.zeros((num_clients,), dtype=torch.int32))


class RoundSchedule(NamedTuple):
    """A round's resolved schedule, (C,) bool on the host except
    ``delay`` and ``staleness``. available = fresh ∪ crashed ∪ straggle,
    disjoint."""

    available: torch.Tensor  # online, rejoined, not busy: trains now
    fresh: torch.Tensor  # trains and releases this round
    crashed: torch.Tensor  # trains, update lost before release
    straggle: torch.Tensor  # trains, release lands `delay` rounds late
    arrive: torch.Tensor  # a buffered upload lands this round
    delay: torch.Tensor  # (C,) int32 straggler delays
    staleness: torch.Tensor  # (C,) int32: rounds late, 0 where ~arrive


def round_schedule(draws: FaultDraws, state: FaultState) -> RoundSchedule:
    """Resolve the round's raw draws against the carried fault state."""
    r = state.round
    in_flight = (state.pending_due >= 0) & (state.pending_due > r)
    rejoined = r >= state.offline_until
    available = draws.online & rejoined & ~in_flight
    crashed = available & draws.crash
    straggle = available & ~draws.crash & draws.straggle
    fresh = available & ~draws.crash & ~draws.straggle
    arrive = state.pending_due == r
    staleness = torch.where(arrive, r - state.pending_birth, 0)
    return RoundSchedule(available=available, fresh=fresh, crashed=crashed,
                         straggle=straggle, arrive=arrive, delay=draws.delay,
                         staleness=staleness.to(torch.int32))


def staleness_discount(staleness: torch.Tensor,
                       power: float) -> torch.Tensor:
    """s(τ) = (1 + τ)^(−power) (FedBuff's 1/sqrt at 0.5); 1 at τ = 0."""
    return (1.0 + staleness.float()) ** (-power)


def advance_fault_state(state: FaultState, sched: RoundSchedule,
                        sent: torch.Tensor, send_weight: torch.Tensor,
                        rejoin_rounds: int = 0) -> FaultState:
    """Next round's fault state: the stragglers' rows of ``sent`` (the
    full (C, P) released matrix, on the device) enter the buffer with
    their ``send_weight`` (C,), arrivals clear their slot, and crashed
    clients stay offline ``rejoin_rounds`` rounds after this one."""
    r = state.round
    strag, arr = sched.straggle, sched.arrive
    dev = state.pending.device
    pending = torch.where(strag.to(dev)[:, None], sent,
                          torch.where(arr.to(dev)[:, None], 0.0,
                                      state.pending))
    due = torch.where(strag, r + sched.delay,
                      torch.where(arr, NO_PENDING, state.pending_due))
    weight = torch.where(strag, send_weight,
                         torch.where(arr, 0.0, state.pending_weight))
    birth = torch.where(strag, r, state.pending_birth)
    offline_until = torch.where(sched.crashed, r + 1 + int(rejoin_rounds),
                                state.offline_until)
    return FaultState(round=r + 1,
                      offline_until=offline_until.to(torch.int32),
                      pending=pending, pending_due=due.to(torch.int32),
                      pending_weight=weight.float(),
                      pending_birth=birth.to(torch.int32))


def masked_mean_weights(weights: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Linear degraded mode: zero the non-survivors and renormalize the
    surviving mass (all-zero stays all-zero)."""
    w = torch.where(mask, weights.float(), 0.0)
    return w / torch.clamp(w.sum(), min=_MASS_FLOOR)


def masked_robust_reduce_flat(vecs: torch.Tensor, weights: torch.Tensor,
                              mask: torch.Tensor, *, name: str,
                              trim_frac: float = 0.0) -> torch.Tensor:
    """Rank-trim reduce of a (C, P) matrix over the surviving rows
    (``mask``): masked rows sort last (+inf keys, a stable sort, as the
    reference), and the trim depth follows the survivor count n: k =
    ⌊(n−1)/2⌋ for ``median``, min(⌊frac·n⌋, ⌊(n−1)/2⌋) for
    ``trimmed_mean``. n = 0 gives zeros."""
    x = vecs.float()
    c = x.shape[0]
    n = int(mask.sum())
    m = mask.bool().to(x.device)
    if name == "median":
        k = max(n - 1, 0) // 2
    elif name == "trimmed_mean":  # frac·n in float32, as the reference
        k = min(int(torch.tensor(trim_frac, dtype=torch.float32) * n),
                max(n - 1, 0) // 2)
    else:
        raise ValueError(f"no masked robust reduce for strategy {name!r}")
    sort_key = torch.where(m[:, None], x, torch.inf)
    order = torch.argsort(sort_key, dim=0, stable=True)
    xs = torch.take_along_dim(x, order, dim=0)
    ws = torch.where(m, weights.to(x.device).float(), 0.0)[order]
    ranks = torch.arange(c, device=x.device)[:, None]
    keep = (ranks >= k) & (ranks < n - k)
    num = torch.where(keep, ws * xs, 0.0).sum(dim=0)
    den = torch.where(keep, ws, 0.0).sum(dim=0)
    return torch.where(den > 0.0, num / torch.clamp(den, min=_MASS_FLOOR),
                       0.0)
