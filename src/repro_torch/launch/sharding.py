"""Sharding rules: the parameter, optimizer-state, activation and cache
partition specs of every architecture on the production meshes (the
reference's ``launch/sharding.py``, rule for rule).

Conventions (DESIGN.md §6):

* ``model`` axis: tensor parallelism — attention heads (through the q/kv
  projection columns), d_ff, experts (when E divides the axis), vocab.
* ``data`` axis (+ ``pod`` on multi-pod): batch / FedAvg clients; with
  ``fsdp=True`` the parameter matrices also shard their second dim over
  it (ZeRO-3 style).
* every rule is divisibility-guarded (``_guarded``): a dim is sharded
  only where the axis size divides it, otherwise it is replicated or the
  next rule applies (mamba2's vocab 50280 is not 16-divisible, so its
  embedding is replicated).

What a spec is in the port. ``PartitionSpec`` (``P``) is a plain tuple,
one entry a dim: None, an axis name, or a tuple of axis names. Where the
reference returns ``jax.sharding.NamedSharding(mesh, spec)`` this module
returns its own ``NamedSharding(mesh, spec)`` record: a description of
the layout, not a DTensor placement, since nothing in the port places
tensors on a production mesh. The mesh is anything with ``shape`` (an
ordered dict) and ``axis_names``, such as ``launch.mesh.MeshShape``.
``per_device_shape`` gives the shard each device holds, which the dry
run sums into its per-device bytes.

Parameter paths are ``jax.tree_util.keystr`` strings, as the port's
``checkpoint._leaves`` names a tree's leaves.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

from repro_torch.checkpoint.checkpoint import _leaves, _rebuild
from repro_torch.configs.base import ModelConfig

PyTree = Any


class PartitionSpec(tuple):
    """One mesh-axis entry a dim (None: replicated)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def per_device_shape(shape, spec, mesh) -> tuple:
    """The shard of a ``shape`` tensor that one device holds under
    ``spec`` (each sharded dim divided by its axes' size; the rules shard
    only dims the size divides)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, spec):
        n = _axis_size(mesh, axis)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {axis} ({n})")
        out.append(dim // n)
    return tuple(out)


def _guarded(mesh, shape, assignment: dict[int, Any]) -> P:
    """A PartitionSpec keeping only the divisible assignments."""
    spec = [None] * len(shape)
    for dim, axis in assignment.items():
        if axis is None:
            continue
        if shape[dim] % _axis_size(mesh, axis) == 0:
            spec[dim] = axis
    return P(*spec)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------
def param_spec(path: str, shape: tuple, cfg: ModelConfig, mesh, *,
               fsdp: bool) -> P:
    """PartitionSpec for one parameter leaf. ``path`` is the keystr.

    Stacked per-layer leaves carry a leading L (or super-block) batch of
    dims which are never sharded; the rules address the trailing dims.
    """
    d_axis = "data" if (fsdp and "data" in mesh.axis_names) else None
    nd = len(shape)
    last, sec = nd - 1, nd - 2

    def tail_matmul(in_axis, out_axis):
        return _guarded(mesh, shape, {sec: in_axis, last: out_axis})

    if re.search(r"\bembed\b|'embed'", path) or path.endswith("['embed']"):
        # (V, d): vocab over model if divisible, else replicated (the
        # reference's choice: sharding the gathered trailing dim trips an
        # XLA SPMD bug, and the non-divisible vocabs are the <1B archs')
        if shape[0] % _axis_size(mesh, "model") == 0:
            return _guarded(mesh, shape, {0: "model", 1: d_axis})
        return P(*([None] * len(shape)))
    if "lm_head" in path:
        if shape[last] % _axis_size(mesh, "model") == 0:
            return tail_matmul(d_axis, "model")
        return tail_matmul("model", None)
    if "router" in path:
        return tail_matmul(d_axis, None)
    if re.search(r"w_gate|w_up", path):
        if cfg.is_moe and nd >= 3:
            # (L, E, d, ff): expert-parallel when E divides the model axis
            e_dim = nd - 3
            if shape[e_dim] % _axis_size(mesh, "model") == 0:
                return _guarded(mesh, shape, {e_dim: "model", sec: d_axis})
            return tail_matmul(d_axis, "model")
        return tail_matmul(d_axis, "model")
    if "w_down" in path:
        if cfg.is_moe and nd >= 3:
            e_dim = nd - 3
            if shape[e_dim] % _axis_size(mesh, "model") == 0:
                return _guarded(mesh, shape, {e_dim: "model", last: d_axis})
            return tail_matmul("model", d_axis)
        return tail_matmul("model", d_axis)
    if re.search(r"\bwq\b|'wq'|\bwk\b|'wk'|\bwv\b|'wv'|in_proj", path):
        return tail_matmul(d_axis, "model")
    if re.search(r"\bwo\b|'wo'|out_proj", path):
        return tail_matmul("model", d_axis)
    if re.search(r"'b[qkv]'", path):
        return _guarded(mesh, shape, {last: "model"})
    # norms, conv, dt_bias, A_log, D, small vectors: replicated
    return P(*([None] * nd))


def params_shardings(params_shapes: PyTree, cfg: ModelConfig, mesh, *,
                     fsdp: bool) -> PyTree:
    """A ``NamedSharding`` for every leaf of ``params_shapes`` (tensors,
    meta ones included), in its tree."""
    return _rebuild(params_shapes, lambda path, leaf: NamedSharding(
        mesh, param_spec(path, tuple(leaf.shape), cfg, mesh, fsdp=fsdp)))


def _replicated(tree: PyTree, mesh) -> PyTree:
    repl = NamedSharding(mesh, P())
    return _rebuild(tree, lambda path, leaf: repl)


# ---------------------------------------------------------------------------
# Optimizer-state rules (state trees mirror params leaf for leaf)
# ---------------------------------------------------------------------------
def adam_state_shardings(p_shard: PyTree, mesh):
    """AdamState(step, mu, nu): mu and nu mirror the param shardings."""
    from repro_torch.optim.optimizers import AdamState

    return AdamState(step=NamedSharding(mesh, P()), mu=p_shard, nu=p_shard)


def server_state_shardings(state: PyTree, mesh) -> PyTree:
    """The server aggregator's state is replicated on every shard
    (DESIGN.md §7): the post-psum server update is deterministic, so each
    shard carries the momentum and moment trees whole. A DP round adds
    no device-resident server state (the accountant is on the host)."""
    return _replicated(state, mesh)


def client_delta_sharding(mesh, client_axes=None) -> NamedSharding:
    """Client-stacked round arguments, (C, ...) leaves: the leading dim
    over the client axes (('edge', 'data') on the edge mesh, ('pod',
    'data') multi-pod, ('data',) otherwise; ``client_axes=None`` takes
    them from the mesh)."""
    from repro_torch.launch.mesh import client_axes as _client_axes

    ax = tuple(client_axes) if client_axes else _client_axes(mesh)
    return NamedSharding(mesh, P(ax if len(ax) > 1 else ax[0]))


def fault_state_shardings(mesh, client_axes=("data",)) -> PyTree:
    """``core.availability.FaultState`` (DESIGN.md §11): the schedule's
    metadata replicated (every shard recomputes the schedule from the
    replicated fault key), ``pending`` (the (C, P) in-flight payloads)
    over the client axes."""
    from repro_torch.core.availability import FaultState

    ax = tuple(client_axes)
    repl = NamedSharding(mesh, P())
    return FaultState(
        round=repl,
        offline_until=repl,
        pending=NamedSharding(mesh, P(ax if len(ax) > 1 else ax[0])),
        pending_due=repl,
        pending_weight=repl,
        pending_birth=repl)


def byz_key_sharding(mesh) -> NamedSharding:
    """The round's Byzantine key (DESIGN.md §13): replicated, as the
    fault key, so no collective decides who is corrupt."""
    return NamedSharding(mesh, P())


def adafactor_state_shardings(p_shard: PyTree, params_shapes: PyTree, mesh):
    """AdafactorState: v_row drops the param's last dim, v_col its
    second-to-last; v_full is the param's own for <2-D leaves, a
    replicated (1,) otherwise."""
    from repro_torch.optim.optimizers import AdafactorState

    scalar = NamedSharding(mesh, P())
    shard_of = dict(_leaves(p_shard))

    def each(fn):
        return _rebuild(params_shapes,
                        lambda path, leaf: fn(shard_of[path], leaf))

    def row_one(sh: NamedSharding, leaf):
        if leaf.dim() >= 2:
            return NamedSharding(mesh, P(*tuple(sh.spec)[:-1]))
        return scalar

    def col_one(sh: NamedSharding, leaf):
        if leaf.dim() >= 2:
            spec = tuple(sh.spec)
            return NamedSharding(mesh, P(*(spec[:-2] + spec[-1:])))
        return scalar

    def full_one(sh: NamedSharding, leaf):
        return scalar if leaf.dim() >= 2 else sh

    return AdafactorState(step=scalar, v_row=each(row_one),
                          v_col=each(col_one), v_full=each(full_one))


# ---------------------------------------------------------------------------
# Batch and cache rules
# ---------------------------------------------------------------------------
def batch_shardings(batch_shapes: dict, mesh, batch_axes) -> dict:
    """tokens/labels (B, S[, d]): B over the data axes (replicated where
    they do not divide B)."""
    out = {}
    for k, v in batch_shapes.items():
        b = v.shape[0]
        ax = batch_axes if b % _axis_size(mesh, tuple(batch_axes)) == 0 \
            else None
        spec = [None] * len(v.shape)
        if ax:
            spec[0] = tuple(ax) if len(ax) > 1 else ax[0]
        out[k] = NamedSharding(mesh, P(*spec))
    return out


def cache_shardings(cache_shapes: dict, cfg: ModelConfig, mesh,
                    batch_axes) -> dict:
    """Decode caches.

    * batch > 1: batch over the data axes; KV heads over model when
      divisible, else the sequence axis over model (flash-decode style).
    * batch == 1 (long_500k): the cache's sequence axis carries the
      parallelism, over (data x model) when the KV heads do not divide
      model, else seq over data and KV over model.
    """
    m = _axis_size(mesh, "model")
    d_ax = tuple(batch_axes)
    d_one = d_ax if len(d_ax) > 1 else d_ax[0]
    out = {}
    for k, v in cache_shapes.items():
        shape = tuple(v.shape)
        spec = [None] * len(shape)
        if k in ("ring_k", "ring_v", "glob_k", "glob_v"):
            # (n_super, n_per, B, S|W, KV, hd)
            _, _, B, S, KV, _ = shape
            if B % _axis_size(mesh, d_ax) == 0 and B > 1:
                spec[2] = d_one
            if KV % m == 0:
                spec[4] = "model"
            elif S % m == 0:
                spec[3] = "model"
            out[k] = NamedSharding(mesh, P(*spec))
            continue
        if k in ("tail_k", "tail_v"):
            _, B, S, KV, _ = shape
            if B % _axis_size(mesh, d_ax) == 0 and B > 1:
                spec[1] = d_one
            if KV % m == 0:
                spec[3] = "model"
            elif S % m == 0:
                spec[2] = "model"
            out[k] = NamedSharding(mesh, P(*spec))
            continue
        if k in ("k", "v", "cross_k", "cross_v", "shared_k", "shared_v"):
            L, B, S, KV, hd = shape
            big_batch = B % _axis_size(mesh, d_ax) == 0 and B > 1
            if big_batch:
                spec[1] = d_one
                if KV % m == 0:
                    spec[3] = "model"
                elif S % m == 0:
                    spec[2] = "model"
            else:
                if KV % m == 0:
                    spec[3] = "model"
                    if S % _axis_size(mesh, d_ax) == 0:
                        spec[2] = d_one
                else:
                    both = d_ax + ("model",)
                    if S % _axis_size(mesh, both) == 0:
                        spec[2] = both
        elif k == "ssm":
            L, B, H, Pd, N = shape
            if B % _axis_size(mesh, d_ax) == 0 and B > 1:
                spec[1] = d_one
            if H % m == 0:
                spec[2] = "model"
        elif k == "conv":
            L, B, W, C = shape
            if B % _axis_size(mesh, d_ax) == 0 and B > 1:
                spec[1] = d_one
            if C % m == 0:
                spec[3] = "model"
        out[k] = NamedSharding(mesh, P(*spec))
    return out
