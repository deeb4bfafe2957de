"""The step counter that takes the HLO cost engine's role (the
reference's ``launch/hlo_cost.py``). There is no HLO in the port: a step
runs eagerly, one aten op after another, so this module counts the ops
as they run instead of parsing a compiled module.

``analyze_step(fn, *args, **kwargs) -> CostTotals`` runs ``fn`` under
two dispatch modes, normally on meta tensors (no storage, nothing
computed), and returns:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count, the
  matrix products (mm, addmm, bmm, einsum's products, convolutions,
  SDPA), 2 FLOPs a multiply-add; elementwise work is not counted, as
  the reference counts its dots;
* ``bytes``: the sum over every aten op of its tensor operands' and
  results' bytes. Eager execution runs unfused, so each op reads and
  writes HBM: this is an upper bound on the step's HBM traffic, not
  XLA's fused count, and the two are not to be compared;
* ``flops_by_op`` and ``ops``: the count by aten op, and how many ops
  ran.

Eager execution runs every layer and every microbatch, so the trip-count
problem the reference solves (a scanned body counted once by
``cost_analysis``) does not arise. One process issues no collectives, so
the totals have none; the sharded GPO round's collectives come from
``launch/collectives.py``'s ledger (``dryrun.lower_gpo_round``).

A kernel wrapper refuses meta tensors ("no kernel for device meta"), so a
step counted on meta takes the plain branch (``use_kernels=False``, the
``use_pallas_*`` flags off).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# ops that only describe a tensor (no data moves)
_VIEW_OPS = {"view", "_unsafe_view", "reshape", "expand", "permute",
             "transpose", "t", "squeeze", "unsqueeze", "slice", "select",
             "as_strided", "alias", "detach", "split", "split_with_sizes",
             "unbind", "chunk", "narrow", "diagonal", "view_as",
             "unflatten", "flatten", "lift_fresh", "_reshape_alias",
             "empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}


def _bytes(xs) -> int:
    leaves, _ = tree_flatten(xs)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Sums each aten op's tensor operand and result bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _VIEW_OPS:
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
            self.ops += 1
        return out


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    flops_by_op: dict = field(default_factory=dict)


def analyze_step(fn, *args, **kwargs) -> CostTotals:
    """Run ``fn(*args, **kwargs)`` once, counted, and return its totals
    (``fn``'s result is dropped). The counting works on any device; on
    meta nothing is allocated or computed."""
    flop_mode = FlopCounterMode(display=False)
    byte_mode = _ByteCounter()
    with flop_mode, byte_mode:
        fn(*args, **kwargs)
    by_op = {str(k): int(v) for k, v in
             flop_mode.get_flop_counts().get("Global", {}).items()}
    return CostTotals(flops=float(flop_mode.get_total_flops()),
                      bytes=float(byte_mode.bytes), ops=byte_mode.ops,
                      flops_by_op=by_op)
