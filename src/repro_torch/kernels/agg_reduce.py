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
  trim = (C−1)//2). Two designs, picked by ``trimmed_design_for(C)``:
  "registers" for
  C ≤ ``REGISTER_CLIENTS`` (32), one thread per coordinate ranking its C
  values in registers with ``_trim_kernel``'s own predicate (one
  instantiation per C, so the client loops unroll; 4·(C·P + P + C)
  bytes, about 7.0 µs; the C² compares (53 M) are far under the rate);
  "select" above, a block staging the (C, cols) slab of ``cols``
  coordinates in shared memory as order keys (16 while the slab fits,
  then 8, 4, 2 or 1, the source's launch picks; past one column's slab
  the keys are read from device memory), one warp a coordinate selecting the pairs
  (key, client) at ranks trim and C−1−trim by a radix select over the
  key's bits, then one thread a coordinate summing in client order.
  Both give the reference's survivors (ties by client index) and add
  keep·w·x and keep·w over every client as the reference does, so a NaN
  anywhere in a column, or an infinity trimmed away, makes the column
  NaN in both designs as in the reference.
* ``pairwise_dists_flat`` (``csrc/pairwise_dists.cu``, replaces
  ``_pairwise_kernel``): the (C, C) squared distances
  G_ii + G_jj − 2·G_ij from the Gram matrix G = X·Xᵀ, clamped at 0. The
  TPU kernel takes the Gram part as one MXU product into an output block
  resident across its sequential grid; here each block takes 4096
  columns and computes its G_b on the tensor cores (``mma.sync`` TF32;
  each value's big part on its row's grid over a warp's k-steps, so
  that big·big sums exactly, and the small terms as L + Lᵀ), the warps'
  sums added in f64 into an (nb, C, C) scratch; a second launch sums the
  blocks in a fixed order in f64 and forms d from G's own diagonal: no
  atomics, two calls bit-equal, the diagonal exactly 0, the output
  exactly symmetric. 4·C·P bytes, 21.4 MB, about 6.4 µs. That is the
  "one_tile" design, for C ≤ ``REGISTER_CLIENTS``; "tiled"
  (``pairwise_design_for``) takes every C above: 32-row tiles of G, a
  block per column chunk and tile pair I ≤ J, the same exact big·big
  and three small products, and a column chunk that depends on (C, P)
  (``pairwise_split``) so that the f64 partials stay within
  ``PAIRWISE_BUDGET`` bytes while one partial fits it (C ≤ 5792); past
  that one chunk of every column, the partial twice the (C, C)
  output.

* ``clip_reduce_flat`` (``csrc/clip_reduce.cu``, replaces
  ``_clip_reduce_kernel`` and ``_clip_reduce_noise_kernel``): the DP
  release and reduce, Σ_c w_c · (x_c · min(1, S/max(‖x_c‖, 1e-12)) +
  n_c). The norm must be whole before any column is scaled. Two designs,
  picked before the launch by ``clip_design_for`` from (C, P) and the
  card, the pick recorded in the wrapper's ``design``: "on_chip" where x
  fits in shared memory, one cooperative launch on the on-chip quant
  design's grid (``quant_split``, ``csrc/on_chip_rows.cuh``), each block
  holding its columns of all C rows, per-block partial norms, one grid
  barrier, every block finishing the C scales in a fixed order, then the
  noise streamed once and the reduce from the tile: x and the noise read
  once (C ≤ 13 at P = 534016 on an H100 SXM; no H100 PCIe part holds
  128 blocks); "two_launch" elsewhere, per-chunk partial squared norms
  on a (nb, C) grid (``csrc/client_rows.cuh``) finished in a fixed
  order by every block of the reduce, which reads x again.
  4·(2·C·P + P + C) bytes with noise, 44.9 MB, about 13.4 µs; 23.5 MB,
  7.0 µs without.
* ``quant_clip_reduce_flat`` (``csrc/quant_clip_reduce.cu``, replaces
  ``_quant_clip_reduce_kernel``): the optional clip and noise, the EF
  residual, the per-client int8 round trip (stochastic or
  round-half-to-even) and the reduce, writing the new residual. u must
  survive two reductions over whole rows (the norm, then the absmax of
  u). Two designs, picked before the launch by ``quant_design_for``
  from (C, P) and the card, the pick recorded in the wrapper's
  ``design``:
  "on_chip" where u fits in shared memory, one cooperative launch of
  ⌈P / width⌉ blocks (``quant_split``: width = 4·⌈⌈P / 128⌉ / 4⌉, a
  function of P alone), each holding its columns of all C rows, with a
  grid barrier after the norm and after the absmax partials: each
  operand read once, each output written once (C ≤ 13 at P = 534016 on
  an H100 SXM's 132 SMs of 227 KB; no H100 PCIe part holds 128 blocks);
  "three_pass" elsewhere, norm and absmax partials then the
  quantize-and-reduce pass, each pass rebuilding u in the TPU kernel's
  op order. 4·(5·C·P + P + C) bytes with every operand, 109 MB, about
  32.5 µs; 87.6 MB and 26.1 µs as int8_ef calls it (no clip or noise).
* ``topk_reduce_flat`` (``csrc/topk_reduce.cu``, replaces
  ``_topk_kernel``): the mask |x| ≥ τ_c (thresholds from outside), the
  weighted reduce and the optional residual, in one pass.
  4·(2·C·P + P + 2·C) bytes with the residual, 44.9 MB, about 13.4 µs.

No kernel here caps C: device memory is the only limit. The clip and
quant designs that read x more than once keep the C scales in shared
memory up to 4096 clients (``kSmemRows`` in ``csrc/client_rows.cuh``;
every block finishes them from the partials); past that one warp a row
finishes them once into the scratch, after the partials, and the
reduce reads them there, the same scales bit for bit.
Every wrapper holds the operand contract on both devices, runs the plain
version on CPU tensors, launches on CUDA tensors or raises, and counts
its launches (one call counts once, however many kernels it launches;
a call under a CUDA graph capture counts once, its replays not at all:
``backend.py``).
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

# the cap of the trimmed and pairwise kernels' C <= 32 designs
# (kMaxClients in their sources): FedConfig.num_clients is 10 in the
# quickstart and the sweeps, 32 in benchmarks/bench_round.py's
# aggregation section, tens to thousands in cross-device rounds
REGISTER_CLIENTS = 32
# the tiled pairwise design: a column chunk is a multiple of its stage
# (kTCols) and at least PAIRWISE_CHUNK, and large enough that the
# (nb, C, C) f64 partials fit this many bytes
PAIRWISE_STAGE = 128
PAIRWISE_BUDGET = 256 << 20
# columns per block of the pairwise kernel (kChunk in its source)
PAIRWISE_CHUNK = 4096
# columns of one client row per partial block of the norm and absmax
# passes (kChunk in csrc/client_rows.cuh)
ROW_CHUNK = 8192
# the on-chip designs' column split (the quant and clip kernels'):
# ceil(P / QUANT_SPLIT) columns a block, rounded up to 4, and the columns
# a warp takes at a time in their row passes (kOcSplit, kSegCols in
# csrc/on_chip_rows.cuh)
QUANT_SPLIT = 128
QUANT_SEG = 512

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p]
_MOMENTUM_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_TRIMMED_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_PAIRWISE_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
_TILES_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p]
_CLIP_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_void_p]
_QUANT_ARGTYPES = [ctypes.c_void_p] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_void_p]
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
    if c < 1:
        raise ValueError(f"{what}: C={c} clients; the CUDA kernel needs "
                         "at least 1")


def trimmed_design_for(c: int) -> str:
    """The trimmed reduce's design at C clients: "registers" up to
    ``REGISTER_CLIENTS``, else "select"."""
    return "registers" if c <= REGISTER_CLIENTS else "select"


def trimmed_reduce_flat(stacked: torch.Tensor, weights: torch.Tensor, *,
                        trim: int) -> torch.Tensor:
    """stacked (C, P) f32 deltas, weights (C,) f32 -> (P,) f32: the
    per-coordinate rank-trimmed weighted mean, ``trim`` clients dropped
    at each end. CPU tensors take the plain version; CUDA tensors launch
    the kernel in ``trimmed_design_for(C)``."""
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


def pairwise_design_for(c: int) -> str:
    """The pairwise kernel's design at C clients: "one_tile" up to
    ``REGISTER_CLIENTS`` (one block holds the whole Gram of its columns),
    else "tiled" (32-row tile pairs)."""
    return "one_tile" if c <= REGISTER_CLIENTS else "tiled"


def pairwise_split(c: int, p: int) -> tuple[int, int]:
    """(chunk, nb): the columns a block takes and the number of column
    blocks of the pairwise kernel at (C, P). "one_tile": PAIRWISE_CHUNK
    columns. "tiled": a multiple of PAIRWISE_STAGE columns, at least
    PAIRWISE_CHUNK, with nb·C·C f64 partials within PAIRWISE_BUDGET
    bytes."""
    chunk = PAIRWISE_CHUNK
    if pairwise_design_for(c) == "tiled":
        most = max(1, PAIRWISE_BUDGET // (8 * c * c))  # blocks that fit
        chunk = max(chunk, -(-p // most))
        chunk = -(-chunk // PAIRWISE_STAGE) * PAIRWISE_STAGE
    return chunk, -(-p // chunk)


def pairwise_dists_flat(stacked: torch.Tensor) -> torch.Tensor:
    """stacked (C, P) f32 deltas -> (C, C) f32 pairwise squared L2
    distances, clamped at 0. CPU tensors take the plain version (the
    direct difference form); CUDA tensors launch the kernel in
    ``pairwise_design_for(C)``."""
    if stacked.dim() != 2:
        raise ValueError(f"pairwise_dists shapes: stacked "
                         f"{tuple(stacked.shape)}")
    c, p = stacked.shape
    _check_clients("pairwise_dists", c)
    if backend.on_cpu("pairwise_dists", stacked, dtypes=(torch.float32,)):
        return ref_pairwise_sq_dists(stacked)
    design = pairwise_design_for(c)
    fn = (backend.kernel("pairwise_dists", "pairwise_dists_launch",
                         _PAIRWISE_ARGTYPES) if design == "one_tile" else
          backend.kernel("pairwise_dists", "pairwise_tiles_launch",
                         _TILES_ARGTYPES))
    out = torch.empty((c, c), dtype=torch.float32, device=stacked.device)
    if p == 0:
        return out.zero_()
    chunk, nb = pairwise_split(c, p)
    part = torch.empty((nb, c, c), dtype=torch.float64,
                       device=stacked.device)
    extra = () if design == "one_tile" else (chunk,)
    err = fn(stacked.data_ptr(), part.data_ptr(), out.data_ptr(), c, p, nb,
             *extra, backend.stream_ptr(stacked.device))
    backend.check(err, "pairwise_dists")
    pairwise_dists_flat.launches += 1
    return out


pairwise_dists_flat.launches = 0


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_rows(what: str, stacked: torch.Tensor, weights: torch.Tensor,
                **mats) -> None:
    """(C, P) stacked, (C,) weights, every other operand (C, P) or None,
    and C >= 1."""
    bad = {k: tuple(v.shape) for k, v in mats.items()
           if v is not None and v.shape != stacked.shape}
    if stacked.dim() != 2 or weights.shape != stacked.shape[:1] or bad:
        raise ValueError(f"{what} shapes: stacked {tuple(stacked.shape)}, "
                         f"weights {tuple(weights.shape)}, other operands "
                         f"{bad}")
    if stacked.shape[0] < 1:
        raise ValueError(f"{what}: C={stacked.shape[0]} clients; the CUDA "
                         "kernel needs at least 1")


def clip_reduce_flat(stacked: torch.Tensor, weights: torch.Tensor, *,
                     clip: float,
                     noise: torch.Tensor | None = None) -> torch.Tensor:
    """stacked (C, P) f32 deltas, weights (C,) f32, optional presampled
    σ-scaled noise (C, P) f32 -> (P,) f32:
    Σ_c w_c · (x_c · min(1, clip / ‖x_c‖₂) + n_c), the DP-FedAvg reduce.
    ``clip`` must be > 0. CPU tensors take the plain version; CUDA
    tensors launch the kernel of the design ``clip_design_for`` picks,
    recorded in ``.design`` (without noise, one that reads none)."""
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
    dev = stacked.device
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    if p == 0:
        return out
    props = torch.cuda.get_device_properties(dev)
    design = clip_design_for(c, p, props.multi_processor_count,
                             props.shared_memory_per_block_optin)
    width, nb = quant_split(p) if design == "on_chip" else (
        0, -(-p // ROW_CHUNK))
    # the partial norms, then (two launches past kSmemRows) the C scales
    part = torch.empty(((nb + 1) * c,), dtype=torch.float32, device=dev)
    err = fn(stacked.data_ptr(), _ptr(noise), weights.data_ptr(),
             part.data_ptr(), out.data_ptr(), float(clip), c, p, nb, width,
             backend.stream_ptr(dev))
    backend.check(err, "clip_reduce")
    clip_reduce_flat.launches += 1
    clip_reduce_flat.design = design
    return out


clip_reduce_flat.launches = 0
# the design of the last launch: "on_chip" or "two_launch"
clip_reduce_flat.design = None


def quant_split(p: int) -> tuple:
    """(width, blocks) of the on-chip quant design at P columns: each
    block owns ``width`` = 4·⌈⌈P / QUANT_SPLIT⌉ / 4⌉ columns of every
    client row. A function of P alone, so a result does not depend on
    the card it ran on."""
    columns = -(-p // QUANT_SPLIT)
    width = 4 * -(-columns // 4)
    return width, -(-p // width)


def _on_chip_smem(c: int, width: int, per_row: int) -> int:
    """Shared memory of one on-chip block (oc_smem in
    csrc/on_chip_rows.cuh): the (C, width) tile, the per-row partials of
    its QUANT_SEG-column segments, and ``per_row`` arrays of C floats."""
    return 4 * (c * width + c * -(-width // QUANT_SEG) + per_row * c)


def quant_smem_bytes(c: int, width: int) -> int:
    """An on-chip quant block's: the tile of u, and the clip scales,
    quantization scales and weights."""
    return _on_chip_smem(c, width, 3)


def clip_smem_bytes(c: int, width: int) -> int:
    """An on-chip clip block's: the tile of x, the clip scales and the
    weights."""
    return _on_chip_smem(c, width, 2)


def _fits_on_chip(p: int, smem: int, sms: int, smem_optin: int) -> bool:
    """All ``quant_split(p)`` blocks resident at once, one a
    multiprocessor (``sms`` of them), ``smem`` bytes of shared memory
    each within ``smem_optin``."""
    return quant_split(p)[1] <= sms and smem <= smem_optin


def quant_design_for(c: int, p: int, sms: int, smem_optin: int) -> str:
    """"on_chip" when the on-chip design's blocks fit the card at once,
    one a multiprocessor (``sms`` of them, ``smem_optin`` bytes of
    shared memory a block), else "three_pass". At (10, 534016) 128
    blocks of 4172 columns, 167.4 KB each: on chip on an H100 SXM (132
    SMs, 227 KB), three passes on a PCIe part's 114 SMs and from 14
    clients at that P."""
    smem = quant_smem_bytes(c, quant_split(p)[0])
    return "on_chip" if _fits_on_chip(p, smem, sms, smem_optin) else (
        "three_pass")


def clip_design_for(c: int, p: int, sms: int, smem_optin: int) -> str:
    """"on_chip" when the on-chip clip's blocks (the quant design's
    split) fit the card at once, else "two_launch". At (10, 534016) 128
    blocks of 4172 columns, 167.3 KB each: on chip on an H100 SXM,
    two launches on a PCIe part's 114 SMs and from 14 clients at that
    P."""
    smem = clip_smem_bytes(c, quant_split(p)[0])
    return "on_chip" if _fits_on_chip(p, smem, sms, smem_optin) else (
        "two_launch")


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
    tensors take the plain version; CUDA tensors launch the kernel of the
    design ``quant_design_for`` picks, recorded in ``.design``."""
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
    props = torch.cuda.get_device_properties(dev)
    design = quant_design_for(c, p, props.multi_processor_count,
                              props.shared_memory_per_block_optin)
    width, nb = quant_split(p) if design == "on_chip" else (
        0, -(-p // ROW_CHUNK))
    # norm and absmax partials, then (three passes past kSmemRows) the
    # clip and quantization scales
    scratch = torch.empty(((2 * nb + 2) * c,), dtype=torch.float32,
                          device=dev)
    err = fn(stacked.data_ptr(), _ptr(noise), _ptr(resid), _ptr(uniform),
             weights.data_ptr(), scratch.data_ptr(),
             scratch[nb * c:].data_ptr(), out.data_ptr(), _ptr(new_resid),
             float(max(clip, 0.0)), c, p, nb, width,
             backend.stream_ptr(dev))
    backend.check(err, "quant_clip_reduce")
    quant_clip_reduce_flat.launches += 1
    quant_clip_reduce_flat.design = design
    return out, new_resid


quant_clip_reduce_flat.launches = 0
# the design of the last launch: "on_chip" or "three_pass"
quant_clip_reduce_flat.design = None


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
