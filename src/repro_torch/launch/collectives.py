"""The sharded round's collectives over mesh axes, with a ledger of
every call: the PyTorch port of what ``jax.lax.psum`` and
``jax.lax.all_gather(..., tiled=True)`` do inside the reference's
``shard_map``, and of the reference's
``launch/hlo_cost.py::CostTotals.collective_ops``
for the byte contracts of DESIGN.md §10, §11 and §14.

* ``psum(t, axes)``: the sum of ``t`` over the ranks along ``axes``
  (one ``all_reduce``), the same on every one of them.
* ``all_gather(t, axes)``: the ranks' ``t`` stacked on axis 0 in mesh
  order (the list form of ``dist.all_gather``, then one concatenation).

Each call appends a ``CollectiveCall`` to ``ledger``: the op, the axes,
the bytes (a psum's operand; an all-gather's result, every rank's rows),
and the host time from the call to its result, the device synchronized
before and after. The gloo backend carries CUDA tensors through the
host: such a call copies its operand to the CPU and the result back,
and is marked ``staged`` (the copies are in its time).
"""
from __future__ import annotations

import time
from typing import List, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import ClientMesh


class CollectiveCall(NamedTuple):
    op: str  # "psum" or "all_gather"
    axes: tuple
    nbytes: int
    ms: float
    staged: bool  # a CUDA tensor carried through the host (gloo)


class Collectives:
    """Collectives over the axes of ``mesh``, each recorded in
    ``ledger``."""

    def __init__(self, mesh: ClientMesh):
        self.mesh = mesh
        self.ledger: List[CollectiveCall] = []

    def _run(self, op: str, t: torch.Tensor, axes, body) -> torch.Tensor:
        axes = self.mesh.canonical(axes)
        group = self.mesh.group(axes)
        staged = t.is_cuda and self.mesh.backend == "gloo"
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        x = t.detach().cpu() if staged else t.detach()
        out = body(x.contiguous(), group)
        if staged:
            out = out.to(t.device)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.ledger.append(CollectiveCall(
            op, axes, out.numel() * out.element_size(),
            (time.perf_counter() - t0) * 1e3, staged))
        return out

    def psum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Σ of ``t`` over the ranks along ``axes``."""
        def body(x, group):
            out = x.clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
            return out

        return self._run("psum", t, axes, body)

    def all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The ranks' ``t`` along ``axes``, stacked on axis 0 in mesh
        order: (n · rows, ...)."""
        n = self.mesh.size(axes)

        def body(x, group):
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            return torch.cat(parts, dim=0)

        return self._run("all_gather", t, axes, body)
