"""Logical activation-sharding rules (the reference's
``models/partitioning.py``, MaxText-style).

Model code names an activation's dims with *logical* axes
(``shard_act(x, ("batch", "seq", "heads", "hd"))``); a context installed
by the dry run (``launch/dryrun.py``) maps logical names to mesh axes,
each only where the axis size divides the dim. Without a context every
call is the identity and every size is 1.

What a context changes in the port. One process places no sharding
constraint, so ``shard_act`` returns ``x`` unchanged under a context
too; it keeps the reference's signature and call sites so the model code
reads as the reference's. What the context does change is the
computation the reference picks for a layout, and those choices are
ported exactly:

* ``logical_axis_size("capacity")`` sets the MoE dispatch's token blocks
  (``models/moe.py``, ``nb``);
* ``prefers_repeat_kv`` repeats K and V to the full head count in the
  plain attention (``models/attention.py::gqa_scores_softmax``);
* ``prefers_q_sharding`` is ported for the rules' sake, but the port's
  attention does not read it: the reference's query-sharded branch
  differs from its grouped one only in ``shard_act`` calls, so in one
  process it computes the grouped branch's values.

Why the reference has the rules: without constraints GSPMD may shard an
attention contraction dim, which materialises partial full-size score
tensors and all-reduces them. Pinning activations to batch -> data and
heads/ff/vocab -> model (only where divisible) moves weights instead.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Optional, Sequence

_STATE = threading.local()


def default_rules(mesh) -> dict:
    """The logical -> mesh axis map of ``mesh`` (any object with
    ``axis_names`` and ``shape``, such as ``launch.mesh.MeshShape``)."""
    batch = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return {
        "batch": batch if len(batch) > 1 else (batch[0] if batch else None),
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "capacity": batch if len(batch) > 1 else (batch[0] if batch else None),
        "ssm_heads": "model",
        # query-sequence parallelism, when no head dim divides the model
        # axis (llava 56H/8KV, qwen2 14H/2KV)
        "seq_q": "model",
        # replicated logical axes
        "seq": None,
        "embed": None,
        "hd": None,
        "state": None,
    }


@contextmanager
def activation_sharding(mesh, rules: Optional[dict] = None):
    """Install ``mesh`` and ``rules`` (default: ``default_rules(mesh)``)
    for this thread until the block exits."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules or default_rules(mesh))
    try:
        yield
    finally:
        _STATE.ctx = prev


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def logical_axis_size(name: str) -> int:
    """Mesh size the given logical axis maps to (1 without a context)."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return 1
    mesh, rules = ctx
    return _axis_size(mesh, rules.get(name))


def prefers_repeat_kv(num_heads: int, num_kv_heads: int) -> bool:
    """GQA layout under the installed context: True when the query heads
    divide the model axis and the KV heads do not (qwen3: 64/8 on a
    16-way axis), so K and V are repeated to one clean heads dim."""
    size = logical_axis_size("heads")
    if size <= 1:
        return False
    return num_heads % size == 0 and num_kv_heads % size != 0


def prefers_q_sharding(num_heads: int, num_kv_heads: int) -> bool:
    """Neither head count divides the model axis: the reference shards
    attention on the query-sequence dim instead."""
    size = logical_axis_size("heads")
    if size <= 1:
        return False
    return num_heads % size != 0 and num_kv_heads % size != 0


def shard_act(x, logical: Sequence[Optional[str]]):
    """``x`` unchanged: the reference constrains it to the logical spec
    under a context; one process has no constraint to place."""
    return x
