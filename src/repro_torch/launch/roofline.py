"""Roofline terms of a counted step, with the NVIDIA H100's figures (the
reference's ``launch/roofline.py``, whose constants are TPU v5e's).

Per (arch x shape x mesh), in seconds (DESIGN.md §6):

  compute      = FLOPs_per_chip / PEAK_FLOPS
  memory       = bytes_per_chip / HBM_BW
  memory_lower = lower_bytes_per_chip / HBM_BW

FLOPs and bytes come from ``launch/hlo_cost.py::analyze_step`` (an eager
step counted op by op, divided by the chip count), not from an HLO
module. Its byte count is unfused, so ``memory`` is an upper bound on
the step's HBM time. ``memory_lower`` is a lower bound, where the caller
gives one: the bytes the step must move at least once (the dry run's
per-device params, optimizer state and batch, read, and its cache, read
in decode and written in prefill). The bottleneck is
named only where both bounds agree: ``compute`` where the compute term
is at least the upper bound, ``memory`` where the lower bound exceeds
the compute term, and ``undetermined`` between them.

The collective term has no counterpart: a step counted on meta in one
process issues no collectives, so ``collective_bytes`` and
``collective_s`` are None. The sharded GPO round's collectives are
reported from ``launch/collectives.py``'s ledger
(``collectives_from_ledger``, ``psum`` an "all-reduce", ``all_gather``
an "all-gather") by ``dryrun.lower_gpo_round``, not as a roofline term.
The reference's HLO-text parser (``parse_collectives``) has no
counterpart: the port has no HLO text.

Hardware constants, NVIDIA H100 SXM5 80 GB (NVIDIA's H100 Tensor Core
GPU data sheet, dense figures, without sparsity).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

PEAK_FLOPS = 989e12  # H100 SXM, bf16 tensor core, dense
HBM_BW = 3.35e12  # H100 SXM, HBM3 bytes/s

# launch/collectives.py's op names -> the reference's collective kinds
LEDGER_KINDS = {"psum": "all-reduce", "all_gather": "all-gather"}


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def collectives_from_ledger(ledger) -> CollectiveStats:
    """``launch/collectives.py``'s ``CollectiveCall`` records as the
    reference's kinds: bytes and calls by kind."""
    stats = CollectiveStats()
    for call in ledger:
        kind = LEDGER_KINDS[call.op]
        stats.bytes_by_kind[kind] = (stats.bytes_by_kind.get(kind, 0)
                                     + call.nbytes)
        stats.count_by_kind[kind] = stats.count_by_kind.get(kind, 0) + 1
    return stats


COLLECTIVE_WHY_NONE = ("no counterpart: a meta-device step in one process "
                       "issues no collectives")
BOTTLENECK_RULE = ("compute where compute_s >= memory_s (the unfused upper "
                   "bound), memory where memory_lower_s (bytes moved "
                   "at least once) > compute_s, else undetermined")


@dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes: Optional[float]
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    bottleneck: str
    model_flops_per_chip: float = 0.0
    useful_ratio: float = 0.0
    lower_bytes_per_chip: Optional[float] = None
    memory_lower_s: Optional[float] = None

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_s_is": "upper bound (unfused eager bytes)",
            "lower_bytes_per_chip": self.lower_bytes_per_chip,
            "memory_lower_s": self.memory_lower_s,
            "collective_s": self.collective_s,
            "collective_why_none": COLLECTIVE_WHY_NONE,
            "bottleneck": self.bottleneck,
            "bottleneck_rule": BOTTLENECK_RULE,
            "model_flops_per_chip": self.model_flops_per_chip,
            "useful_ratio": self.useful_ratio,
        }


def analyze(totals, num_chips: int = 1, model_flops_per_chip: float = 0.0,
            lower_bytes_per_chip: float | None = None) -> Roofline:
    """Roofline terms from ``hlo_cost.analyze_step``'s totals for the
    whole step, divided over ``num_chips``; ``lower_bytes_per_chip`` the
    bytes one chip must move at least once, where the caller knows them."""
    flops = float(totals.flops) / num_chips
    nbytes = float(totals.bytes) / num_chips
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    lower_s = (None if lower_bytes_per_chip is None
               else float(lower_bytes_per_chip) / HBM_BW)
    if compute_s >= memory_s:
        bottleneck = "compute"
    elif lower_s is not None and lower_s > compute_s:
        bottleneck = "memory"
    else:
        bottleneck = "undetermined"
    return Roofline(
        flops_per_chip=flops, bytes_per_chip=nbytes, collective_bytes=None,
        compute_s=compute_s, memory_s=memory_s, collective_s=None,
        bottleneck=bottleneck, model_flops_per_chip=model_flops_per_chip,
        useful_ratio=(model_flops_per_chip / flops) if flops else 0.0,
        lower_bytes_per_chip=(None if lower_bytes_per_chip is None
                              else float(lower_bytes_per_chip)),
        memory_lower_s=lower_s)


def model_flops(cfg, shape, num_chips: int) -> float:
    """6 * N * D with N = active params (MoE: the routed subset), D =
    tokens processed; decode shapes process B tokens a step."""
    from repro_torch.launch.specs import count_params

    n_total = count_params(cfg)
    if cfg.is_moe:
        # active = total - (inactive experts' FFN params)
        per_expert = 3 * cfg.d_model * cfg.d_ff * cfg.num_layers
        inactive = (cfg.num_experts - cfg.experts_per_token) * per_expert
        n_active = n_total - inactive
    else:
        n_active = n_total
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6  # fwd 2ND + bwd 4ND
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        factor = 2
    return factor * n_active * tokens / num_chips
