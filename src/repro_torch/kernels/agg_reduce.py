"""Server-aggregation kernels over the raveled (C, P) client-delta
matrix, each with its CUDA kernel in ``csrc/`` and its plain version in
``kernels/ref.py``. The client axis is small (tens), P is the model's
parameter count; every kernel reads the matrix once, so each is bound
by bytes on the H100. Shapes and times at the quickstart's
(C, P) = (10, 534016), 3.35 TB/s:

* ``fedavg_reduce_flat`` (``csrc/fedavg_reduce.cu``, replaces
  ``repro/kernels/agg_reduce.py::_fedavg_kernel``): Eq. 3,
  out[p] = Σ_c w_c · x[c, p]. A grid over P, each thread owning 4
  consecutive outputs (one ``float4`` per client when P is a multiple of
  4, else one float), clients walked in the fixed order 0..C−1:
  deterministic, no atomics, no padding of P. 4·(C·P + P + C) bytes,
  23.5 MB, about 7.0 µs.
* ``momentum_reduce_flat`` (``csrc/momentum_reduce.cu``, replaces
  ``_moment_kernel``): FedAvgM's fused step, Δ = Σ_c w_c x[c, :] and
  β·m + Δ in the same pass, on fedavg's grid. 4·(C·P + 3P + C) bytes,
  27.8 MB, about 8.3 µs.
* ``trimmed_reduce_flat`` (``csrc/trimmed_reduce.cu``, replaces
  ``_trim_kernel``): the per-coordinate stable-rank trimmed weighted
  mean, ``trim`` clients dropped at each end (the median at
  trim = (C−1)//2). One thread per coordinate ranks its C values in
  registers with ``_trim_kernel``'s own predicate (one instantiation
  per C, so the client loops unroll). 4·(C·P + P + C) bytes, about
  7.0 µs; the C² compares (53 M) are far under the rate.
* ``pairwise_dists_flat`` (``csrc/pairwise_dists.cu``, replaces
  ``_pairwise_kernel``): the (C, C) squared distances in the expansion
  form ‖x_i‖² + ‖x_j‖² − 2·x_i·x_j, clamped at 0. The TPU kernel sums
  into an output block resident across its sequential grid; here each
  block writes its 1024 columns' partial to an (nb, C, C) scratch and a
  second launch sums the partials in a fixed order: no atomics, two
  calls bit-equal. 4·C·P bytes, 21.4 MB, about 6.4 µs.

The trimmed and pairwise kernels hold at most ``MAX_CLIENTS`` clients
(instantiations and registers, shared memory per block); the wrappers
refuse more on both devices.
Every wrapper holds the operand contract on both devices, runs the plain
version on CPU tensors, launches on CUDA tensors or raises, and counts
its launches (the pairwise kernel's two launches count as one call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ref import (
    ref_fedavg_flat,
    ref_momentum_reduce_flat,
    ref_pairwise_sq_dists,
    ref_trimmed_flat,
)

# the trimmed and pairwise kernels' cap on C (kMaxClients in their
# sources): FedConfig.num_clients is 10 in the quickstart and the sweeps,
# 32 in benchmarks/bench_round.py's aggregation section
MAX_CLIENTS = 32
# columns per block of the pairwise kernel (kChunk in its source)
PAIRWISE_CHUNK = 1024

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p]
_MOMENTUM_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_TRIMMED_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_PAIRWISE_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def fedavg_reduce_flat(stacked: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """stacked (C, P) f32, weights (C,) f32 -> (P,) f32. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if stacked.dim() != 2 or weights.shape != stacked.shape[:1]:
        raise ValueError(f"fedavg_reduce shapes: stacked "
                         f"{tuple(stacked.shape)}, weights "
                         f"{tuple(weights.shape)}")
    if backend.on_cpu("fedavg_reduce", stacked, weights,
                      dtypes=(torch.float32, torch.float32)):
        return ref_fedavg_flat(stacked, weights)
    fn = backend.kernel("fedavg_reduce", "fedavg_reduce_launch", _ARGTYPES)
    c, p = stacked.shape
    out = torch.empty((p,), dtype=torch.float32, device=stacked.device)
    if p == 0:
        return out
    err = fn(stacked.data_ptr(), weights.data_ptr(), out.data_ptr(), c, p,
             backend.stream_ptr(stacked.device))
    backend.check(err, "fedavg_reduce")
    fedavg_reduce_flat.launches += 1
    return out


fedavg_reduce_flat.launches = 0


def momentum_reduce_flat(stacked: torch.Tensor, weights: torch.Tensor,
                         moment: torch.Tensor, *, beta: float):
    """stacked (C, P) f32 deltas, weights (C,) f32, moment (P,) f32 ->
    (delta (P,), beta * moment + delta (P,)), both f32. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if (stacked.dim() != 2 or weights.shape != stacked.shape[:1]
            or moment.shape != stacked.shape[1:]):
        raise ValueError(f"momentum_reduce shapes: stacked "
                         f"{tuple(stacked.shape)}, weights "
                         f"{tuple(weights.shape)}, moment "
                         f"{tuple(moment.shape)}")
    if backend.on_cpu("momentum_reduce", stacked, weights, moment,
                      dtypes=(torch.float32,) * 3):
        return ref_momentum_reduce_flat(stacked, weights, moment, beta=beta)
    fn = backend.kernel("momentum_reduce", "momentum_reduce_launch",
                        _MOMENTUM_ARGTYPES)
    c, p = stacked.shape
    d = torch.empty((p,), dtype=torch.float32, device=stacked.device)
    nm = torch.empty_like(d)
    if p == 0:
        return d, nm
    err = fn(stacked.data_ptr(), weights.data_ptr(), moment.data_ptr(),
             d.data_ptr(), nm.data_ptr(), float(beta), c, p,
             backend.stream_ptr(stacked.device))
    backend.check(err, "momentum_reduce")
    momentum_reduce_flat.launches += 1
    return d, nm


momentum_reduce_flat.launches = 0


def _check_clients(what: str, c: int) -> None:
    if not 1 <= c <= MAX_CLIENTS:
        raise ValueError(f"{what}: C={c} clients; the CUDA kernel holds 1 "
                         f"to {MAX_CLIENTS}")


def trimmed_reduce_flat(stacked: torch.Tensor, weights: torch.Tensor, *,
                        trim: int) -> torch.Tensor:
    """stacked (C, P) f32 deltas, weights (C,) f32 -> (P,) f32: the
    per-coordinate rank-trimmed weighted mean, ``trim`` clients dropped
    at each end. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if stacked.dim() != 2 or weights.shape != stacked.shape[:1]:
        raise ValueError(f"trimmed_reduce shapes: stacked "
                         f"{tuple(stacked.shape)}, weights "
                         f"{tuple(weights.shape)}")
    c, p = stacked.shape
    if not 0 <= 2 * trim < c:
        raise ValueError(f"trim={trim} must satisfy 0 <= 2*trim < C={c}")
    _check_clients("trimmed_reduce", c)
    if backend.on_cpu("trimmed_reduce", stacked, weights,
                      dtypes=(torch.float32, torch.float32)):
        return ref_trimmed_flat(stacked, weights, trim=trim)
    fn = backend.kernel("trimmed_reduce", "trimmed_reduce_launch",
                        _TRIMMED_ARGTYPES)
    out = torch.empty((p,), dtype=torch.float32, device=stacked.device)
    if p == 0:
        return out
    err = fn(stacked.data_ptr(), weights.data_ptr(), out.data_ptr(), c,
             int(trim), p, backend.stream_ptr(stacked.device))
    backend.check(err, "trimmed_reduce")
    trimmed_reduce_flat.launches += 1
    return out


trimmed_reduce_flat.launches = 0


def pairwise_dists_flat(stacked: torch.Tensor) -> torch.Tensor:
    """stacked (C, P) f32 deltas -> (C, C) f32 pairwise squared L2
    distances, clamped at 0. CPU tensors take the plain version (the
    direct difference form); CUDA tensors launch the kernel."""
    if stacked.dim() != 2:
        raise ValueError(f"pairwise_dists shapes: stacked "
                         f"{tuple(stacked.shape)}")
    c, p = stacked.shape
    _check_clients("pairwise_dists", c)
    if backend.on_cpu("pairwise_dists", stacked, dtypes=(torch.float32,)):
        return ref_pairwise_sq_dists(stacked)
    fn = backend.kernel("pairwise_dists", "pairwise_dists_launch",
                        _PAIRWISE_ARGTYPES)
    out = torch.empty((c, c), dtype=torch.float32, device=stacked.device)
    if p == 0:
        return out.zero_()
    nb = -(-p // PAIRWISE_CHUNK)
    part = torch.empty((nb, c, c), dtype=torch.float32,
                       device=stacked.device)
    err = fn(stacked.data_ptr(), part.data_ptr(), out.data_ptr(), c, p, nb,
             backend.stream_ptr(stacked.device))
    backend.check(err, "pairwise_dists")
    pairwise_dists_flat.launches += 1
    return out


pairwise_dists_flat.launches = 0
