"""Params-tree helpers the federated round needs.

A params tree is the port's dict of tensors and ``GPOLayer`` NamedTuples.
The leaf order is the JAX package's (``jax.tree_util`` sorts dict keys):
``final_norm``, ``head``, ``in_proj``, then ``layers`` ln1, wq, wk, wv,
wo, ln2, w1, w2. ``checkpoint._leaves`` already walks a tree in that
order (it names leaves as ``jax.tree_util.keystr`` does), so every helper
here takes its order from there; the raveled (C, P) client matrix thus
lays the parameters out exactly as the reference's ``tree_ravel_clients``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List

import torch

from repro_torch.checkpoint.checkpoint import _leaves, _rebuild

PyTree = Any


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """The leaves in the reference's order."""
    return [leaf for _, leaf in _leaves(tree)]


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """``like``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    by_path = {path: leaf for (path, _), leaf in zip(_leaves(like), leaves)}
    return _rebuild(like, lambda path, _: by_path[path])


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """fn applied leafwise over trees of one structure."""
    cols = zip(tree_leaves(tree), *(tree_leaves(t) for t in rest))
    return tree_unflatten(tree, [fn(*xs) for xs in cols])


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_index(tree: PyTree, i) -> PyTree:
    return tree_map(lambda x: x[i], tree)


def tree_count_params(tree: PyTree) -> int:
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)))


def tree_sq_norm(tree: PyTree) -> torch.Tensor:
    return sum(x.float().square().sum() for x in tree_leaves(tree))


def tree_flatten_to_vector(tree: PyTree) -> torch.Tensor:
    """Every leaf raveled and concatenated into one (P,) f32 vector, in
    the reference's leaf order."""
    return torch.cat([x.reshape(-1).float() for x in tree_leaves(tree)])


def tree_ravel_clients(stacked_tree: PyTree) -> torch.Tensor:
    """Client-stacked tree (leaves (C, ...)) -> (C, P) f32 matrix, the
    operand of the aggregation kernels."""
    leaves = tree_leaves(stacked_tree)
    c = leaves[0].shape[0]
    return torch.cat([x.reshape(c, -1).float() for x in leaves], dim=1)


def tree_unflatten_from_vector(vec: torch.Tensor, like: PyTree) -> PyTree:
    """(P,) vector -> ``like``'s structure, each leaf in its shape and
    dtype (views of ``vec`` where the dtype already matches)."""
    if vec.shape != (tree_count_params(like),):
        raise ValueError(f"vector of shape {tuple(vec.shape)} for a tree "
                         f"of {tree_count_params(like)} parameters")
    out, off = [], 0
    for leaf in tree_leaves(like):
        size = math.prod(leaf.shape)
        out.append(vec[off:off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return tree_unflatten(like, out)
