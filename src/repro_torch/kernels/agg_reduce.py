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

* ``clip_reduce_flat`` (``csrc/clip_reduce.cu``, replaces
  ``_clip_reduce_kernel`` and ``_clip_reduce_noise_kernel``): the DP
  release and reduce, Σ_c w_c · (x_c · min(1, S/max(‖x_c‖, 1e-12)) +
  n_c). The TPU kernel's norm sweep becomes per-chunk partial squared
  norms on a (nb, C) grid (``csrc/client_rows.cuh``), finished in a fixed
  order by every block of the reduce. 4·(2·C·P + P + C) bytes with noise,
  44.9 MB, about 13.4 µs; 23.5 MB, 7.0 µs without.
* ``quant_clip_reduce_flat`` (``csrc/quant_clip_reduce.cu``, replaces
  ``_quant_clip_reduce_kernel``): the optional clip and noise, the EF
  residual, the per-client int8 round trip (stochastic or
  round-half-to-even) and the reduce, writing the new residual. Norm and
  absmax partials, then the quantize-and-reduce pass, each pass rebuilding
  the released value in the TPU kernel's op order. 4·(5·C·P + P + C)
  bytes with every operand, 109 MB, about 32.5 µs.
* ``topk_reduce_flat`` (``csrc/topk_reduce.cu``, replaces
  ``_topk_kernel``): the mask |x| ≥ τ_c (thresholds from outside), the
  weighted reduce and the optional residual, in one pass.
  4·(2·C·P + P + 2·C) bytes with the residual, 44.9 MB, about 13.4 µs.

The trimmed and pairwise kernels hold at most ``MAX_CLIENTS`` clients
(instantiations and registers, shared memory per block), the clip and
quant kernels at most ``MAX_ROWS`` (two floats a client in shared
memory); the wrappers refuse more on both devices.
Every wrapper holds the operand contract on both devices, runs the plain
version on CPU tensors, launches on CUDA tensors or raises, and counts
its launches (one call counts once, however many kernels it launches).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ref import (
    ref_clip_reduce,
    ref_fedavg_flat,
    ref_momentum_reduce_flat,
    ref_pairwise_sq_dists,
    ref_quant_clip_reduce,
    ref_topk_mask_reduce,
    ref_trimmed_flat,
)

# norm floor of the DP clip: a zero delta keeps scale 1 (clipping never
# manufactures a direction). Shared with core/privacy.py.
_NORM_FLOOR = 1e-12
# the symmetric int8 grid of the transport codec, q in [-127, 127], with
# the scale floored so an all-zero client quantizes to exact zeros.
# Shared with core/compression.py and kernels/quant_matmul.py.
INT8_LEVELS = 127.0
_SCALE_FLOOR = 1e-30

# the trimmed and pairwise kernels' cap on C (kMaxClients in their
# sources): FedConfig.num_clients is 10 in the quickstart and the sweeps,
# 32 in benchmarks/bench_round.py's aggregation section
MAX_CLIENTS = 32
# the clip and quant kernels' cap on C (kMaxRows in csrc/client_rows.cuh)
MAX_ROWS = 4096
# columns per block of the pairwise kernel (kChunk in its source)
PAIRWISE_CHUNK = 1024
# columns of one client row per partial block of the norm and absmax
# passes (kChunk in csrc/client_rows.cuh)
ROW_CHUNK = 8192

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p]
_MOMENTUM_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_TRIMMED_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_PAIRWISE_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
_CLIP_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p]
_QUANT_ARGTYPES = [ctypes.c_void_p] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p]
_TOPK_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


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


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_rows(what: str, stacked: torch.Tensor, weights: torch.Tensor,
                **mats) -> None:
    """(C, P) stacked, (C,) weights, every other operand (C, P) or None,
    and 1 <= C <= MAX_ROWS."""
    bad = {k: tuple(v.shape) for k, v in mats.items()
           if v is not None and v.shape != stacked.shape}
    if stacked.dim() != 2 or weights.shape != stacked.shape[:1] or bad:
        raise ValueError(f"{what} shapes: stacked {tuple(stacked.shape)}, "
                         f"weights {tuple(weights.shape)}, other operands "
                         f"{bad}")
    if not 1 <= stacked.shape[0] <= MAX_ROWS:
        raise ValueError(f"{what}: C={stacked.shape[0]} clients; the CUDA "
                         f"kernel holds 1 to {MAX_ROWS}")


def clip_reduce_flat(stacked: torch.Tensor, weights: torch.Tensor, *,
                     clip: float,
                     noise: torch.Tensor | None = None) -> torch.Tensor:
    """stacked (C, P) f32 deltas, weights (C,) f32, optional presampled
    σ-scaled noise (C, P) f32 -> (P,) f32:
    Σ_c w_c · (x_c · min(1, clip / ‖x_c‖₂) + n_c), the DP-FedAvg reduce.
    ``clip`` must be > 0. CPU tensors take the plain version; CUDA
    tensors launch the kernel (without noise, one that reads none)."""
    if clip <= 0.0:
        raise ValueError(f"clip={clip} must be > 0 (clip_norm == 0 means "
                         "the privacy pipeline is disabled; callers must "
                         "not reach the kernel)")
    _check_rows("clip_reduce", stacked, weights, noise=noise)
    ops = [t for t in (stacked, weights, noise) if t is not None]
    if backend.on_cpu("clip_reduce", *ops, dtypes=(torch.float32,) * 3):
        return ref_clip_reduce(stacked, weights, clip=clip, noise=noise)
    fn = backend.kernel("clip_reduce", "clip_reduce_launch", _CLIP_ARGTYPES)
    c, p = stacked.shape
    out = torch.empty((p,), dtype=torch.float32, device=stacked.device)
    if p == 0:
        return out
    nb = -(-p // ROW_CHUNK)
    part = torch.empty((nb, c), dtype=torch.float32, device=stacked.device)
    err = fn(stacked.data_ptr(), _ptr(noise), weights.data_ptr(),
             part.data_ptr(), out.data_ptr(), float(clip), c, p, nb,
             backend.stream_ptr(stacked.device))
    backend.check(err, "clip_reduce")
    clip_reduce_flat.launches += 1
    return out


clip_reduce_flat.launches = 0


def quant_clip_reduce_flat(stacked: torch.Tensor, weights: torch.Tensor, *,
                           clip: float = 0.0,
                           noise: torch.Tensor | None = None,
                           uniform: torch.Tensor | None = None,
                           resid: torch.Tensor | None = None):
    """Fused DP release + int8 quantized transport + weighted reduce.
    stacked (C, P) f32 raw deltas, weights (C,) f32, optional presampled
    σ-scaled noise (C, P) (only with ``clip > 0``), optional presampled
    U[0, 1) rounding tile (C, P) (round half to even without it),
    optional EF residual (C, P) -> (Σ_c w_c · dequant(Q(ũ_c)) (P,), the
    new residual ũ − t (C, P) or None), ũ_c being the clip/noise release
    of x_c plus the residual. ``clip <= 0`` skips the DP release. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if noise is not None and clip <= 0.0:
        raise ValueError("noise requires clip > 0 (the DP release scales "
                         "noise by the clip bound; see PrivacyConfig)")
    _check_rows("quant_clip_reduce", stacked, weights, noise=noise,
                uniform=uniform, resid=resid)
    ops = [t for t in (stacked, weights, noise, uniform, resid)
           if t is not None]
    if backend.on_cpu("quant_clip_reduce", *ops,
                      dtypes=(torch.float32,) * 5):
        return ref_quant_clip_reduce(stacked, weights, clip=clip,
                                     noise=noise, uniform=uniform,
                                     resid=resid)
    fn = backend.kernel("quant_clip_reduce", "quant_clip_reduce_launch",
                        _QUANT_ARGTYPES)
    c, p = stacked.shape
    dev = stacked.device
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    new_resid = None if resid is None else torch.empty_like(stacked)
    if p == 0:
        return out, new_resid
    nb = -(-p // ROW_CHUNK)
    parts = torch.empty((2, nb, c), dtype=torch.float32, device=dev)
    err = fn(stacked.data_ptr(), _ptr(noise), _ptr(resid), _ptr(uniform),
             weights.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
             out.data_ptr(), _ptr(new_resid), float(max(clip, 0.0)), c, p,
             nb, backend.stream_ptr(dev))
    backend.check(err, "quant_clip_reduce")
    quant_clip_reduce_flat.launches += 1
    return out, new_resid


quant_clip_reduce_flat.launches = 0


def topk_reduce_flat(stacked: torch.Tensor, weights: torch.Tensor,
                     thresholds: torch.Tensor, *,
                     with_residual: bool = False):
    """Top-k mask + weighted reduce. stacked (C, P) f32 codec inputs
    (already released and EF-accumulated), weights (C,) f32, thresholds
    (C,) f32, the k-th largest |x_c| per client -> (Σ_c w_c · t_c (P,),
    x − t (C, P) or None), t_c = x_c where |x_c| ≥ τ_c (ties kept), else
    0. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if (stacked.dim() != 2 or weights.shape != stacked.shape[:1]
            or thresholds.shape != stacked.shape[:1]):
        raise ValueError(f"topk_reduce shapes: stacked "
                         f"{tuple(stacked.shape)}, weights "
                         f"{tuple(weights.shape)}, thresholds "
                         f"{tuple(thresholds.shape)}")
    if backend.on_cpu("topk_reduce", stacked, weights, thresholds,
                      dtypes=(torch.float32,) * 3):
        return ref_topk_mask_reduce(stacked, weights, thresholds,
                                    with_residual=with_residual)
    fn = backend.kernel("topk_reduce", "topk_reduce_launch", _TOPK_ARGTYPES)
    c, p = stacked.shape
    out = torch.empty((p,), dtype=torch.float32, device=stacked.device)
    new_resid = torch.empty_like(stacked) if with_residual else None
    if p == 0 or c == 0:
        return out.zero_(), new_resid
    err = fn(stacked.data_ptr(), weights.data_ptr(), thresholds.data_ptr(),
             out.data_ptr(), _ptr(new_resid), c, p,
             backend.stream_ptr(stacked.device))
    backend.check(err, "topk_reduce")
    topk_reduce_flat.launches += 1
    return out, new_resid


topk_reduce_flat.launches = 0
