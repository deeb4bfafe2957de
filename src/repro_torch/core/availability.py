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
2. **Fault state.** The whole ``FaultState`` lives on the trainer's
   device: the (C,) metadata (``offline_until``, ``pending_due``,
   ``pending_weight``, ``pending_birth``), the round counter ``round``
   as a 0-d int32 tensor, and the in-flight payloads ``pending`` (C, P).
   Only the draws are made on the host, and staged with the round's
   other operands. ``round_schedule`` and ``advance_fault_state`` are
   tensor arithmetic on that device and read nothing back, so the fault
   round can be captured into a CUDA graph; ``advance_fault_state``
   buffers the stragglers' released rows, clears the arrivals' slots and
   starts the crashed clients' rejoin countdown.
3. **Degraded-mode reductions.** The linear rules renormalize their
   weights over the survivors (``masked_mean_weights``); median and
   trimmed mean shrink their trim depth with the survivor count
   (``masked_robust_reduce_flat``, plain torch: the reference has no
   kernel for it), the count and the depth computed as device tensors.
   A zero-survivor round still reduces and applies, and then keeps the
   old params and ``AggState`` leaf by leaf (``tree_where`` on the
   round's 0-d survivor flag), as the reference's traced round does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import AvailabilityConfig
from repro_torch.utils.pytree import tree_map

# the fault generator's seed offset: the reference's fault key tag
# (core/availability.py::_FAULT_TAG)
FAULT_TAG = 0xFA117
# empty slot of the pending-arrival round
NO_PENDING = -1
# floor of the survivor-mass denominators
_MASS_FLOOR = 1e-12


class FaultDraws(NamedTuple):
    """A round's raw per-client draws, (C,) each: drawn on the host,
    staged on the trainer's device with the round's operands."""

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
    """Cross-round fault state, every field on the trainer's device."""

    round: torch.Tensor  # () int32: rounds elapsed under this schedule
    offline_until: torch.Tensor  # (C,) int32: crash-rejoin gate
    pending: torch.Tensor  # (C, P) f32: in-flight released payloads
    pending_due: torch.Tensor  # (C,) int32 arrival round; NO_PENDING=empty
    pending_weight: torch.Tensor  # (C,) f32: weight at send time
    pending_birth: torch.Tensor  # (C,) int32: round the update was made


def init_fault_state(num_clients: int, num_params: int,
                     device=None) -> FaultState:
    i32 = dict(dtype=torch.int32, device=device)
    return FaultState(
        round=torch.zeros((), **i32),
        offline_until=torch.zeros((num_clients,), **i32),
        pending=torch.zeros((num_clients, num_params), device=device),
        pending_due=torch.full((num_clients,), NO_PENDING, **i32),
        pending_weight=torch.zeros((num_clients,), device=device),
        pending_birth=torch.zeros((num_clients,), **i32))


class RoundSchedule(NamedTuple):
    """A round's resolved schedule, (C,) bool on the state's device
    except ``delay`` and ``staleness``. available = fresh ∪ crashed ∪
    straggle, disjoint."""

    available: torch.Tensor  # online, rejoined, not busy: trains now
    fresh: torch.Tensor  # trains and releases this round
    crashed: torch.Tensor  # trains, update lost before release
    straggle: torch.Tensor  # trains, release lands `delay` rounds late
    arrive: torch.Tensor  # a buffered upload lands this round
    delay: torch.Tensor  # (C,) int32 straggler delays
    staleness: torch.Tensor  # (C,) int32: rounds late, 0 where ~arrive


def round_schedule(draws: FaultDraws, state: FaultState) -> RoundSchedule:
    """Resolve the round's raw draws against the carried fault state
    (both on one device; no host read)."""
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
                        rejoin_rounds: int = 0,
                        rows: Optional[torch.Tensor] = None) -> FaultState:
    """Next round's fault state: the stragglers' rows of ``sent`` (the
    full (C, P) released matrix, on the device) enter the buffer with
    their ``send_weight`` (C,), arrivals clear their slot, and crashed
    clients stay offline ``rejoin_rounds`` rounds after this one.
    ``rows``: the clients whose rows ``sent`` and ``state.pending`` hold
    (the sharded round's own; None: all C)."""
    r = state.round
    strag, arr = sched.straggle, sched.arrive
    sl = slice(None) if rows is None else rows.to(strag.device)
    pending = torch.where(strag[sl][:, None], sent,
                          torch.where(arr[sl][:, None], 0.0,
                                      state.pending))
    due = torch.where(strag, r + sched.delay,
                      torch.where(arr, NO_PENDING, state.pending_due))
    weight = torch.where(strag, send_weight,
                         torch.where(arr, 0.0, state.pending_weight))
    birth = torch.where(strag, r, state.pending_birth)
    offline_until = torch.where(sched.crashed, r + 1 + int(rejoin_rounds),
                                state.offline_until)
    return FaultState(round=(r + 1).to(torch.int32),
                      offline_until=offline_until.to(torch.int32),
                      pending=pending, pending_due=due.to(torch.int32),
                      pending_weight=weight.float(),
                      pending_birth=birth.to(torch.int32))


def tree_where(flag: torch.Tensor, new, old):
    """Leafwise ``torch.where(flag, new, old)`` on a 0-d bool tensor:
    the zero-survivor gate for params and ``AggState``, a select, so the
    kept side comes out bit for bit."""
    return tree_map(lambda a, b: torch.where(flag, a, b), new, old)


def masked_mean_weights(weights: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Linear degraded mode: zero the non-survivors and renormalize the
    surviving mass (all-zero stays all-zero)."""
    w = torch.where(mask, weights.float(), 0.0)
    return w / torch.clamp(w.sum(), min=_MASS_FLOOR)


def trim_depth(n: torch.Tensor, name: str,
               trim_frac: float = 0.0) -> torch.Tensor:
    """The rank-trim depth k over n surviving rows (``n`` a () integer
    tensor, k one of its dtype and device, no host read): ⌊(n−1)/2⌋ for
    ``median`` (0 at n = 0), min(⌊f32(frac)·n⌋, ⌊(n−1)/2⌋) for
    ``trimmed_mean``, the product in float32, as the reference."""
    half = torch.clamp(n - 1, min=0) // 2
    if name == "median":
        return half
    if name == "trimmed_mean":
        return torch.minimum(
            (n.float() * float(np.float32(trim_frac))).to(n.dtype), half)
    raise ValueError(f"no masked robust reduce for strategy {name!r}")


def masked_robust_reduce_flat(vecs: torch.Tensor, weights: torch.Tensor,
                              mask: torch.Tensor, *, name: str,
                              trim_frac: float = 0.0) -> torch.Tensor:
    """Rank-trim reduce of a (C, P) matrix over the surviving rows
    (``mask``): masked rows sort last (+inf keys, a stable sort, as the
    reference), and the trim depth follows the survivor count n: k =
    ⌊(n−1)/2⌋ for ``median``, min(⌊frac·n⌋, ⌊(n−1)/2⌋) for
    ``trimmed_mean`` (``trim_depth``). n = 0 gives zeros. n and k are ()
    tensors on the rows' device (no host read)."""
    x = vecs.float()
    c = x.shape[0]
    m = mask.bool()
    n = m.sum()
    k = trim_depth(n, name, trim_frac)
    sort_key = torch.where(m[:, None], x, torch.inf)
    order = torch.argsort(sort_key, dim=0, stable=True)
    xs = torch.take_along_dim(x, order, dim=0)
    ws = torch.where(m, weights.float(), 0.0)[order]
    ranks = torch.arange(c, device=x.device)[:, None]
    keep = (ranks >= k) & (ranks < n - k)
    num = torch.where(keep, ws * xs, 0.0).sum(dim=0)
    den = torch.where(keep, ws, 0.0).sum(dim=0)
    return torch.where(den > 0.0, num / torch.clamp(den, min=_MASS_FLOOR),
                       0.0)
