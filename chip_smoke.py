#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (into the git-ignored ``build/``), then runs these phases on
the card, raising on any mismatch:

1. Kernel checks: each kernel against its plain PyTorch version on the
   same inputs on the card, at the serving and training paths' shapes:
   the int8 matmul, the attention forward and backward (dq, dk/dv; head
   widths 32 and 24), the ``GPOAttention`` Function's gradients, and
   the aggregation kernels: the FedAvg reduce, the FedAvgM momentum
   reduce, the rank-trimmed reduce (ties included), the Krum pairwise
   distances, the DP clip reduce (with and without noise), the fused int8
   quant-clip reduce (every operand combination of the reference's
   tests) and the top-k reduce (zero and tied rows), each also bit-equal
   from one call to the next.
2. Serving: ``PreferenceServer`` at ``ServeConfig()`` defaults over a
   64-request trace, with f32 and with int8 weights, at ``GPOConfig()``
   width with random weights from a seed; cache hit == miss bit for bit,
   served rows against the monolithic ``predict_preferences`` and against
   the port's CPU path, p50/p99 latency and QPS; then both engines once
   more under ``torch.profiler``: device kernel time against wall time.
3. The quickstart's serve step: ``predict_preferences`` with the
   attention kernel for every held-out group, against the dense branch.
4. Training: ``FederatedGPO`` at ``GPOConfig()`` width with the
   quickstart's ``FedConfig`` (10 clients, 6 local Adam epochs at 3e-4,
   16+16 questions) through the attention and FedAvg kernels: 3 rounds
   with the launch counts asserted, against the same trainer on the CPU
   and against the card's dense path; 20 more rounds, over which the
   loss must fall; a checkpoint saved, restored into a
   ``PreferenceServer`` and served; one round under ``torch.profiler``.
   Then every strategy of the aggregation registry that the reference's
   sweeps run (``benchmarks/bench_round.py``'s ``AGG_SWEEP``, krum and
   multi_krum as in ``BENCH_byz.json``, geomedian, fedbuff, and FedAvg
   with a norm bound that clips in round 0): 3 rounds each through the
   kernels with the launch counts asserted, against the same run with
   the aggregation's plain versions on the card, and median and krum
   against their CPU runs. Then the round's DP and codec stages: the
   clip alone, clip and noise, int8 with error feedback, both together,
   top-k with error feedback and DP under the median, 3 rounds each
   through the kernels with the launch counts asserted, against the
   plain-aggregation card run (the same device generator draws the
   noise and the uniforms), two of them against a CPU run that replays
   draws made once on the CPU, and the cumulative ε against the port's
   accountant; one round each of dp_int8_ef and topk_ef under the
   profiler.
5. Timing: each kernel, its plain version and one PyTorch library call
   at the main paths' shapes (CUDA events, median of repeats; replayed
   from a CUDA graph for the device time, and launched eagerly),
   beside the card's least time for the same work.

Launch counters are set to 0 right before each main-path phase and read
right after it. The last seven lines of standard output are the
``engine`` JSON line (steps, launches, latency summaries, profiles), the
``train`` JSON line (launches, agreement, losses, profile), the
``strategies`` JSON line (per strategy: launches, agreement, wall per
round), the ``private`` JSON line (the same per DP and codec
configuration, with ε), the ``kernels`` JSON line, the card's
``nvidia-smi`` name and power limit,
and ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout of the repository, the script exits non-zero and prints no
result. Full float32 throughout: TF32 is off for matmuls and cuDNN.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import (  # noqa: E402
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import (  # noqa: E402
    AggConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
    PrivacyConfig,
    ServeConfig,
)
from repro_torch.core import compression as cx  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core import privacy as dp  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FederatedGPO,
    PreferenceServer,
    gpo_apply,
    init_gpo_params,
    latency_summary,
    make_request_trace,
    predict_preferences,
    quantize_gpo_params,
)
from repro_torch.core.fairness import alignment_score  # noqa: E402
from repro_torch.core.gpo import map_params  # noqa: E402
from repro_torch.data import (  # noqa: E402
    SurveyConfig,
    make_survey_data,
    sample_icl_batch,
    split_groups,
)
from repro_torch.kernels import backend, quantize_linear  # noqa: E402
from repro_torch.kernels.agg_reduce import (  # noqa: E402
    clip_reduce_flat,
    fedavg_reduce_flat,
    momentum_reduce_flat,
    pairwise_dists_flat,
    quant_clip_reduce_flat,
    topk_reduce_flat,
    trimmed_reduce_flat,
)
from repro_torch.kernels.gpo_attention import (  # noqa: E402
    GPOAttention,
    gpo_attention_bwd_dkdv,
    gpo_attention_bwd_dq,
    gpo_attention_fwd,
)
from repro_torch.kernels.quant_matmul import int8_matmul_flat  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    ref_clip_reduce,
    ref_fedavg_flat,
    ref_momentum_reduce_flat,
    ref_pairwise_sq_dists,
    ref_quant_clip_reduce,
    ref_topk_mask_reduce,
    ref_trimmed_flat,
    ref_gpo_attention,
    ref_gpo_attention_bwd,
    ref_gpo_attention_bwd_dkdv,
    ref_gpo_attention_bwd_dq,
    ref_int8_matmul,
)
from repro_torch.utils.pytree import (  # noqa: E402
    tree_count_params,
    tree_leaves,
)

# weights, survey data, trace and kernel inputs. With seed 0 the random
# predictor's mu stays well above the 1e-4 clip on the served groups, so
# clip-and-normalized rows are well conditioned and the row tolerances
# below test the kernels, not the clip.
SEED = 0
# NVIDIA data sheet rows: (f32 CUDA-core FLOP/s, memory bytes/s), dense
_PEAKS = {"SXM": (67e12, 3.35e12), "PCIe": (51e12, 2.0e12),
          "NVL": (60e12, 3.9e12)}
INT8_SHAPES = [(66, 128), (128, 128), (128, 256), (256, 128), (128, 1),
               (4098, 128)]  # (K, N): in_proj, wq..wo, w1, w2, head, paper
# (BH, S, ctx): training's 10 clients x 4 heads, predict's 7 held-out
# groups x 4 heads, then ragged S and num_ctx
ATTN_SHAPES = [(10 * 4, 160, 80), (7 * 4, 160, 80), (4, 80, 60),
               (4, 85, 37)]
# the backward's: 10 clients x 4 heads at the quickstart's 16+16
# questions of 5 options, then ragged S and num_ctx at both ends
BWD_SHAPES = [(10 * 4, 160, 80), (4, 80, 60), (4, 85, 37), (4, 64, 0),
              (4, 64, 64)]
HEAD_DIM = 32
HEAD_DIMS = (32, 24)  # GPOConfig() and benchmarks/paper_experiment.py
# (C, P): the quickstart's 10 clients x 534,016 GPOConfig() params, then
# ragged P through the kernel's scalar path
FEDAVG_SHAPES = [(10, 534016), (3, 2049), (1, 7)]
# the other aggregation kernels: the quickstart's shape, ragged P, and
# the kernels' cap of 32 clients (bench_round.py's aggregation section)
AGG_SHAPES = [(10, 534016), (3, 2049), (1, 7), (32, 5001)]
# the registry's strategies on the training path: AGG_SWEEP of
# benchmarks/bench_round.py:217-228 (its hyperparameters), krum and
# multi_krum with f = 3 and m = 3 as in BENCH_byz.json, geomedian,
# fedbuff, and FedAvg with a server-side norm bound. Round 0's client
# delta norms at this config lie in 0.457-0.483 (the port's CPU run), so
# 0.475 clips about half of the rows there.
NORM_BOUND = 0.475
STRATEGIES = {
    "fedavg": {},
    "fedavgm": {"momentum": 0.9, "server_lr": 1.0},
    "fedadam": {"beta1": 0.9, "beta2": 0.99, "tau": 1e-2,
                "server_lr": 1e-2},
    "fedyogi": {"beta1": 0.9, "beta2": 0.99, "tau": 1e-2,
                "server_lr": 1e-2},
    "fedprox": {"prox_mu": 0.01},
    "trimmed_mean": {"trim_frac": 0.1},
    "median": {},
    "adaptive": {"fair_temp": 1.0, "fair_decay": 0.9},
    "krum": {"num_malicious": 3},
    "multi_krum": {"num_malicious": 3, "multi_krum_m": 3},
    "geomedian": {},
    "fedbuff": {},
    "fedavg+norm_bound": {"name": "fedavg", "norm_bound": NORM_BOUND},
}
# the aggregation kernel each strategy launches once a round (none:
# geomedian, which has no kernel in the reference either)
STRATEGY_KERNEL = {"fedavgm": "momentum_reduce",
                   "trimmed_mean": "trimmed_reduce",
                   "median": "trimmed_reduce", "krum": "pairwise_dists",
                   "multi_krum": "pairwise_dists", "geomedian": None}
CPU_STRATEGIES = ("median", "krum")
# the round's DP and codec stages (DESIGN.md §9, §10): the clip at the
# norm bound above (about half of round 0's rows clipped), the noise
# multiplier of examples/quickstart.py:30, the reference's int8 and
# top-k defaults (stochastic rounding, EF21 error feedback, 1% kept)
TOPK_FRAC = 0.01
_DP = {"clip_norm": NORM_BOUND, "noise_multiplier": 0.8}
PRIVATE = {
    "dp_clip": {"privacy": {"clip_norm": NORM_BOUND}},
    "dp_noise": {"privacy": _DP},
    "int8_ef": {"compression": {"kind": "int8"}},
    "dp_int8_ef": {"privacy": _DP, "compression": {"kind": "int8"}},
    "topk_ef": {"compression": {"kind": "topk", "topk_frac": TOPK_FRAC}},
    "dp_median": {"privacy": _DP, "agg": {"name": "median"}},
}
# the kernel each configuration launches once a round (dp_median:
# privatize in plain torch, then the median's trimmed kernel)
PRIVATE_KERNEL = {"dp_clip": "clip_reduce", "dp_noise": "clip_reduce",
                  "int8_ef": "quant_clip_reduce",
                  "dp_int8_ef": "quant_clip_reduce",
                  "topk_ef": "topk_reduce", "dp_median": "trimmed_reduce"}
CPU_PRIVATE = ("dp_noise", "int8_ef")
# one more round of these under the profiler: the heaviest transport
# kernel, and the top-k selection outside its kernel
PROFILED_PRIVATE = ("dp_int8_ef", "topk_ef")
# coordinates of params and EF residual that may lie beyond 1e-4 of the
# other run after 3 rounds (flipped int8 levels, swapped top-k near-ties;
# train_private): 0.02% of the 5.3 M, a bound against a systematic error
MAX_FLIPPED = 1000
# FederatedGPO against its CPU run and its dense run after 3 rounds
TRAIN_ROUNDS, MORE_ROUNDS = 3, 20
TRAIN_TOL = {"round_loss_rtol": 1e-4, "eval_atol": 1e-4,
             "params_max_abs": 1e-4}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _peaks(name: str):
    for key, val in _PEAKS.items():
        if key != "SXM" and key in name:
            return val
    return _PEAKS["SXM"]


def _bound_ms(nbytes: float, flops: float, peaks):
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def _time_ms(fn, iters: int = 50, reps: int = 7,
             graph: bool = True) -> tuple:
    """(device, eager) milliseconds per call of ``fn``, each the median
    over ``reps`` of CUDA-event times over ``iters`` calls, after a
    warm-up. Device: the calls captured once in a CUDA graph and
    replayed, so the host's launch cost is out of the reading and the
    card's own time for the work remains (inputs stay in the 50 MB L2,
    as the serving path's weights do); None with ``graph=False``. Eager:
    the same calls launched one by one from Python, host overhead
    included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(iters):
                fn()

    def median_ms(run):
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / iters)
        return float(np.median(times))

    def eager():
        for _ in range(iters):
            fn()

    return (median_ms(captured.replay) if graph else None), median_ms(eager)


def _timed(kernel_fn, plain_fn, library_fn) -> dict:
    """Device and eager times of a kernel, its plain version and the
    library call that computes the same function (None: no such call)."""
    (ms, eager), (plain, plain_eager) = (_time_ms(f)
                                         for f in (kernel_fn, plain_fn))
    lib, lib_eager = (None, None) if library_fn is None else _time_ms(
        library_fn)
    return {"ms": ms, "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "eager_ms": {"kernel": eager, "plain": plain_eager,
                         "library": lib_eager}}


def _profile(fn, trace: str = "engine_trace.json", match=()) -> dict:
    """Wall time of ``fn()`` under ``torch.profiler``, and the device
    time of every kernel it ran, read from the exported trace (kept as
    ``trace`` in the git-ignored ``build/``). ``busy_share`` is kernel
    time over wall time; the profiler's own host overhead is in the wall
    time. ``matched`` sums the launches and time of the kernels whose
    name holds each string of ``match`` (any case)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = ROOT / "build" / trace
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    by_name: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            n, ms = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, ms + e["dur"] * 1e-3)
    kernel_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    matched = {m: [sum(v[i] for k, v in by_name.items()
                       if m.lower() in k.lower()) for i in (0, 1)]
               for m in match}
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "kernels": sum(n for n, _ in by_name.values()),
            "busy_share": kernel_ms / wall_ms,
            "top": [{"name": k[:60], "launches": n, "ms": ms}
                    for k, (n, ms) in top],
            "matched": {m: {"launches": n, "ms": ms}
                        for m, (n, ms) in matched.items()}}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _int8_inputs(m, k, n, g, dev):
    x = torch.randn((m, k), generator=g).to(dev)
    ql = quantize_linear(torch.randn((k, n), generator=g) / k ** 0.5)
    return x, ql.q.to(dev), ql.scale.to(dev)


def _attn_inputs(bh, s, g, dev, hd=HEAD_DIM, n=3):
    return tuple(torch.randn((bh, s, hd), generator=g).to(dev)
                 for _ in range(n))


def _close(got, plain, tol: float) -> tuple:
    """(max abs error, all within tol*(1+|plain|) and finite)."""
    err = (got - plain).abs()
    ok = bool((err <= tol * (1 + plain.abs())).all()
              and torch.isfinite(got).all())
    return err.max().item(), ok


def _check_attention_bwd(g, dev, worst) -> None:
    """dq and dk/dv against the closed-form plain backward, at every
    backward shape and head width; then the GPOAttention Function's
    gradients against autograd through the plain forward."""
    for hd in HEAD_DIMS:
        for bh, s, nc in BWD_SHAPES:
            q, k, v, do = _attn_inputs(bh, s, g, dev, hd, n=4)
            o, lse = ref_gpo_attention(q, k, v, num_ctx=nc)
            plain = ref_gpo_attention_bwd(q, k, v, o, lse, do, num_ctx=nc)
            delta = (do * o).sum(-1)
            dq = gpo_attention_bwd_dq(q, k, v, do, lse, delta, num_ctx=nc)
            dk, dv = gpo_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                            num_ctx=nc)
            torch.cuda.synchronize()
            errs = [_close(got, want, 1e-5)
                    for got, want in zip((dq, dk, dv), plain)]
            print(f"  gpo_attention_bwd BH={bh:3d} S={s:4d} num_ctx={nc:3d} "
                  f"hd={hd}  max_abs_err dq={errs[0][0]:.3e} dk="
                  f"{errs[1][0]:.3e} dv={errs[2][0]:.3e}  "
                  f"tol=1e-5*(1+|plain|)")
            if not all(ok for _, ok in errs):
                raise AssertionError(f"gpo_attention_bwd mismatch at "
                                     f"{(bh, s, nc, hd)}")
            worst["gpo_attention_bwd_dq"] = max(
                worst["gpo_attention_bwd_dq"], errs[0][0])
            worst["gpo_attention_bwd_dkdv"] = max(
                worst["gpo_attention_bwd_dkdv"], errs[1][0], errs[2][0])

    bh, s, nc = BWD_SHAPES[0]
    q, k, v, do = _attn_inputs(bh, s, g, dev, n=4)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(GPOAttention.apply(*ins, nc), ins, do)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref_gpo_attention(*ins, num_ctx=nc)[0], ins,
                               do)
    torch.cuda.synchronize()
    errs = [_close(a, b, 1e-5) for a, b in zip(got, want)]
    print(f"  GPOAttention Function grads BH={bh} S={s} num_ctx={nc}: "
          f"max_abs_err {max(e for e, _ in errs):.3e} against autograd "
          f"through the plain forward (tol 1e-5*(1+|plain|))")
    if not all(ok for _, ok in errs):
        raise AssertionError("GPOAttention gradients off autograd")


def _check_fedavg(g, dev, worst) -> None:
    """fedavg_reduce against the plain weighted sum, and two calls on
    the same input bit-equal (a fixed client order, no atomics)."""
    for c, p in FEDAVG_SHAPES:
        x = torch.randn((c, p), generator=g).to(dev)
        w = torch.rand((c,), generator=g) + 0.1
        w = (w / w.sum()).to(dev)
        out = fedavg_reduce_flat(x, w)
        again = fedavg_reduce_flat(x, w)
        plain = ref_fedavg_flat(x, w)
        torch.cuda.synchronize()
        err, ok = _close(out, plain, 1e-6)
        same = torch.equal(out, again)
        print(f"  fedavg_reduce C={c:2d} P={p:7d}  max_abs_err={err:.3e}  "
              f"tol=1e-6*(1+|plain|)  repeat bit-equal: {same}")
        if not (ok and same):
            raise AssertionError(f"fedavg_reduce mismatch at {(c, p)}")
        worst["fedavg_reduce"] = max(worst["fedavg_reduce"], err)


def _agg_inputs(c, p, g, dev, ties=False):
    x = torch.randn((c, p), generator=g)
    if ties:  # few distinct values: many ties across the clients
        x = torch.round(2 * x) / 2
    w = torch.rand((c,), generator=g) + 0.1
    return x.to(dev), (w / w.sum()).to(dev)


def _check_agg_kernels(g, dev, worst) -> None:
    """momentum_reduce, trimmed_reduce and pairwise_dists against their
    plain versions, and two calls on the same input bit-equal (clients
    and column blocks summed in a fixed order, no atomics)."""
    for c, p in AGG_SHAPES:
        x, w = _agg_inputs(c, p, g, dev)
        m = torch.randn((p,), generator=g).to(dev)
        for beta in (0.0, 0.9):
            d, nm = momentum_reduce_flat(x, w, m, beta=beta)
            d2, nm2 = momentum_reduce_flat(x, w, m, beta=beta)
            pd, pnm = ref_momentum_reduce_flat(x, w, m, beta=beta)
            torch.cuda.synchronize()
            (ed, okd), (en, okn) = _close(d, pd, 1e-6), _close(nm, pnm, 1e-6)
            same = torch.equal(d, d2) and torch.equal(nm, nm2)
            print(f"  momentum_reduce C={c:2d} P={p:7d} beta={beta}  "
                  f"max_abs_err delta={ed:.3e} moment={en:.3e}  "
                  f"tol=1e-6*(1+|plain|)  repeat bit-equal: {same}")
            if not (okd and okn and same):
                raise AssertionError(f"momentum_reduce mismatch at {(c, p)}")
            worst["momentum_reduce"] = max(worst["momentum_reduce"], ed, en)

        trims = sorted({min(int(0.1 * c), (c - 1) // 2), (c - 1) // 2})
        for ties in (False, True):
            x, w = _agg_inputs(c, p, g, dev, ties=ties)
            for trim in trims:
                out = trimmed_reduce_flat(x, w, trim=trim)
                again = trimmed_reduce_flat(x, w, trim=trim)
                plain = ref_trimmed_flat(x, w, trim=trim)
                torch.cuda.synchronize()
                err, ok = _close(out, plain, 1e-6)
                same = torch.equal(out, again)
                print(f"  trimmed_reduce C={c:2d} P={p:7d} trim={trim:2d} "
                      f"ties={ties!s:5}  max_abs_err={err:.3e}  "
                      f"tol=1e-6*(1+|plain|)  repeat bit-equal: {same}")
                if not (ok and same):
                    raise AssertionError(f"trimmed_reduce mismatch at "
                                         f"{(c, p, trim, ties)}")
                worst["trimmed_reduce"] = max(worst["trimmed_reduce"], err)

        x, _ = _agg_inputs(c, p, g, dev)
        out = pairwise_dists_flat(x)
        again = pairwise_dists_flat(x)
        plain = ref_pairwise_sq_dists(x)
        torch.cuda.synchronize()
        # the expansion form cancels: atol 1e-5 * max_i |x_i|^2
        atol = 1e-5 * (x * x).sum(dim=1).max().item()
        err = (out - plain).abs().max().item()
        same = torch.equal(out, again)
        exact_diag = bool((torch.diagonal(out) == 0).all())
        print(f"  pairwise_dists C={c:2d} P={p:7d}  max_abs_err={err:.3e}  "
              f"tol={atol:.3e} (1e-5*max|x_i|^2)  zero diagonal: "
              f"{exact_diag}  repeat bit-equal: {same}")
        if not (err <= atol and same and exact_diag
                and torch.isfinite(out).all()):
            raise AssertionError(f"pairwise_dists mismatch at {(c, p)}")
        worst["pairwise_dists"] = max(worst["pairwise_dists"], err)


def _transport_inputs(c, p, g, dev):
    """Deltas with every other row 10x larger (half the rows above the
    median clip), normalised weights, noise, a residual and uniforms on
    ``dev``, and the median row norm as the clip."""
    x = torch.randn((c, p), generator=g)
    x[::2] *= 10.0
    w = torch.rand((c,), generator=g) + 0.1
    noise = 0.3 * torch.randn((c, p), generator=g)
    resid = 0.5 * torch.randn((c, p), generator=g)
    uniform = torch.rand((c, p), generator=g)
    clip = float(torch.linalg.vector_norm(x, dim=1).median())
    return [t.to(dev) for t in (x, w / w.sum(), noise, resid, uniform)], clip


def _check_transport_kernels(g, dev, worst) -> None:
    """clip_reduce, quant_clip_reduce and topk_reduce against their
    plain versions, and two calls on the same input bit-equal (norm and
    absmax partials finished in a fixed order, no atomics)."""
    for c, p in AGG_SHAPES:
        (x, w, noise, resid, uniform), clip = _transport_inputs(c, p, g,
                                                                dev)
        for n in (None, noise):
            out = clip_reduce_flat(x, w, clip=clip, noise=n)
            again = clip_reduce_flat(x, w, clip=clip, noise=n)
            plain = ref_clip_reduce(x, w, clip=clip, noise=n)
            torch.cuda.synchronize()
            err, ok = _close(out, plain, 1e-5)
            same = torch.equal(out, again)
            print(f"  clip_reduce C={c:2d} P={p:7d} noise={n is not None!s:5}"
                  f"  max_abs_err={err:.3e}  tol=1e-5*(1+|plain|)  repeat "
                  f"bit-equal: {same}")
            if not (ok and same):
                raise AssertionError(f"clip_reduce mismatch at {(c, p)}")
            worst["clip_reduce"] = max(worst["clip_reduce"], err)

        # one quantization level bounds |u| / 127: a scale an ulp off
        # (norms summed in another order) may flip one rounding decision
        level = (x.abs().max() + noise.abs().max()
                 + resid.abs().max()).item() / 127.0
        variants = {  # tests/test_compression.py:229-234, then two more
            "plain": {}, "clip": {"clip": clip},
            "clip_noise_ef": {"clip": clip, "noise": noise, "resid": resid},
            "ef_stochastic": {"uniform": uniform, "resid": resid},
            "stochastic": {"uniform": uniform},
            "every_operand": {"clip": clip, "noise": noise, "resid": resid,
                              "uniform": uniform}}
        for name, kw in variants.items():
            out, er = quant_clip_reduce_flat(x, w, **kw)
            out2, er2 = quant_clip_reduce_flat(x, w, **kw)
            pout, per = ref_quant_clip_reduce(x, w, **kw)
            torch.cuda.synchronize()
            pairs = [(out, pout)] + ([(er, per)] if er is not None else [])
            errs = [(a - b).abs() for a, b in pairs]
            err = max(e.max().item() for e in errs)
            # coordinates beyond float error: flipped levels
            flips = sum(int((e > 2e-5 + 2e-5 * b.abs()).sum())
                        for e, (_, b) in zip(errs, pairs))
            ok = err <= 2e-5 + level and flips <= 1e-3 * sum(
                b.numel() for _, b in pairs) and all(
                torch.isfinite(a).all() for a, _ in pairs)
            same = torch.equal(out, out2) and (er is None
                                               or torch.equal(er, er2))
            resid_exact = er is None or torch.equal(er, per)
            print(f"  quant_clip_reduce C={c:2d} P={p:7d} {name:13s}  "
                  f"max_abs_err={err:.3e}  tol=2e-5+level={2e-5 + level:.3e}"
                  f"  coords beyond 2e-5: {flips}  residual bit-equal: "
                  f"{resid_exact}  repeat bit-equal: {same}")
            if not (ok and same):
                raise AssertionError(f"quant_clip_reduce mismatch at "
                                     f"{(c, p, name)}")
            worst["quant_clip_reduce"] = max(worst["quant_clip_reduce"],
                                             err)

        xt = x.clone()
        xt[0] = 0.0  # a zero row: threshold 0, every zero kept
        if c > 2:  # a row of few distinct magnitudes: ties at the k-th
            xt[1] = torch.round(2 * xt[1]) / 2
        tau = cx.topk_thresholds(xt, TOPK_FRAC)
        for with_residual in (False, True):
            out, er = topk_reduce_flat(xt, w, tau,
                                       with_residual=with_residual)
            out2, er2 = topk_reduce_flat(xt, w, tau,
                                         with_residual=with_residual)
            pout, per = ref_topk_mask_reduce(xt, w, tau,
                                             with_residual=with_residual)
            torch.cuda.synchronize()
            err, ok = _close(out, pout, 1e-6)
            exact = er is None or torch.equal(er, per)
            same = torch.equal(out, out2) and (er is None
                                               or torch.equal(er, er2))
            print(f"  topk_reduce C={c:2d} P={p:7d} residual="
                  f"{with_residual!s:5}  max_abs_err={err:.3e}  "
                  f"tol=1e-6*(1+|plain|)  residual bit-equal: {exact}  "
                  f"repeat bit-equal: {same}")
            if not (ok and exact and same):
                raise AssertionError(f"topk_reduce mismatch at {(c, p)}")
            worst["topk_reduce"] = max(worst["topk_reduce"], err)


def check_kernels(dev) -> dict:
    """Phase 1: every kernel against its plain version on the card."""
    g = _gen(SEED)
    worst = {"int8_matmul": 0.0, "gpo_attention_fwd": 0.0,
             "gpo_attention_bwd_dq": 0.0, "gpo_attention_bwd_dkdv": 0.0,
             "fedavg_reduce": 0.0, "momentum_reduce": 0.0,
             "trimmed_reduce": 0.0, "pairwise_dists": 0.0,
             "clip_reduce": 0.0, "quant_clip_reduce": 0.0,
             "topk_reduce": 0.0}
    for k, n in INT8_SHAPES:
        tol = 1e-4 if k > 256 else 1e-5
        for m in (1, 37, 1280):
            x, q, s = _int8_inputs(m, k, n, g, dev)
            out = int8_matmul_flat(x, q, s)
            plain = ref_int8_matmul(x, q, s)
            torch.cuda.synchronize()
            err = (out - plain).abs()
            ok = bool((err <= tol * (1 + plain.abs())).all())
            one = int8_matmul_flat(x[-1:].contiguous(), q, s)
            rows_independent = torch.equal(one[0], out[-1])
            print(f"  int8_matmul M={m:5d} K={k:5d} N={n:4d}  max_abs_err="
                  f"{err.max().item():.3e}  tol={tol:g}*(1+|plain|)  "
                  f"last row alone bit-equal: {rows_independent}")
            if not ok or not rows_independent:
                raise AssertionError(f"int8_matmul mismatch at {(m, k, n)}")
            worst["int8_matmul"] = max(worst["int8_matmul"],
                                       err.max().item())
    for hd in HEAD_DIMS:
        for bh, s, nc in ATTN_SHAPES:
            q, k, v = _attn_inputs(bh, s, g, dev, hd)
            o, lse = gpo_attention_fwd(q, k, v, num_ctx=nc)
            po, plse = ref_gpo_attention(q, k, v, num_ctx=nc)
            torch.cuda.synchronize()
            eo = (o - po).abs().max().item()
            el = (lse - plse).abs().max().item()
            print(f"  gpo_attention_fwd BH={bh:3d} S={s:4d} num_ctx={nc:3d} "
                  f"hd={hd}  o max_abs_err={eo:.3e}  lse max_abs_err="
                  f"{el:.3e}  tol=1e-05")
            if not (eo <= 1e-5 and el <= 1e-5 and torch.isfinite(o).all()
                    and torch.isfinite(lse).all()):
                raise AssertionError(f"gpo_attention_fwd mismatch at "
                                     f"{(bh, s, nc, hd)}")
            worst["gpo_attention_fwd"] = max(worst["gpo_attention_fwd"], eo,
                                             el)
    _check_attention_bwd(g, dev, worst)
    _check_fedavg(g, dev, worst)
    _check_agg_kernels(g, dev, worst)
    _check_transport_kernels(g, dev, worst)
    return worst


def _rows(results) -> dict:
    return {c.rid: c.pred for c in results}


def _max_diff(a: dict, b: dict) -> float:
    if a.keys() != b.keys():
        raise AssertionError("completed request sets differ")
    return max(float(np.abs(a[r] - b[r]).max()) for r in a)


def serve(dev, data, groups, gcfg, params) -> dict:
    """Phase 2: the serving engine, f32 and int8."""
    trace = make_request_trace(data, groups, num_requests=64,
                               hit_ratio=0.5, seed=SEED)
    servers = {w: PreferenceServer(params, gcfg,
                                   ServeConfig(int8_weights=w),
                                   num_options=data.num_options, device=dev)
               for w in (False, True)}
    for srv in servers.values():  # first launches load the kernels
        srv.run_trace(trace[:8], clear_cache=True)
    torch.cuda.synchronize()

    # the main path: the int8 engine over the whole trace, cold cache
    int8_matmul_flat.launches = 0
    gpo_attention_fwd.launches = 0
    t0 = time.perf_counter()
    cold8 = servers[True].run_trace(trace, clear_cache=True)
    wall8 = time.perf_counter() - t0
    launches = int8_matmul_flat.launches
    steps = len(servers[True].batches)
    if len(cold8) != len(trace):
        raise AssertionError(f"served {len(cold8)} of {len(trace)} requests")
    if launches == 0 or gpo_attention_fwd.launches != 0:
        raise AssertionError("the int8 engine did not run on the int8 "
                             "kernel alone")
    record = {"launches": launches, "steps": steps,
              "prefill_requests": servers[True].stats.prefills,
              "max_decode_rows": max(b.batch_pad * b.tgt_bucket
                                     for b in servers[True].batches),
              # a full batch of prefills at the largest ctx bucket used
              "max_prefill_rows": ServeConfig().max_batch * max(
                  b.ctx_bucket for b in servers[True].batches)}
    print(f"  int8 engine: {launches} int8_matmul launches over {steps} "
          f"steps ({servers[True].stats})")

    t0 = time.perf_counter()
    cold32 = servers[False].run_trace(trace, clear_cache=True)
    wall32 = time.perf_counter() - t0
    summaries = {"int8 cold": latency_summary(cold8, wall8),
                 "f32 cold": latency_summary(cold32, wall32)}
    for w, cold in ((True, cold8), (False, cold32)):
        name = "int8" if w else "f32"
        t0 = time.perf_counter()
        warm = servers[w].run_trace(trace, clear_cache=False)
        summaries[f"{name} warm"] = latency_summary(
            warm, time.perf_counter() - t0)
        if not all(c.cache_hit for c in warm):
            raise AssertionError(f"{name}: warm trace missed the cache")
        if _max_diff(_rows(cold), _rows(warm)) != 0.0:
            raise AssertionError(f"{name}: cache hit != miss")
    for name, s in summaries.items():
        print(f"  {name:9s}: p50={s['p50_ms']:.3f}ms p99={s['p99_ms']:.3f}"
              f"ms qps={s['qps']:.1f} hit_rate={s['hit_rate']:.2f} "
              f"completed={s['completed']}")
    print("  cache hit == miss: bit-equal (f32 and int8)")

    rows8, rows32 = _rows(cold8), _rows(cold32)
    d = _max_diff(rows8, rows32)
    sums = max(abs(float(p.sum(-1).max()) - 1) for p in rows8.values())
    sums = max(sums, max(abs(float(p.sum(-1).min()) - 1)
                         for p in rows8.values()))
    print(f"  int8 vs f32 rows: max_abs={d:.3e} (tol 0.05); rows sum to 1 "
          f"within {sums:.1e}")
    if not (d <= 0.05 and sums <= 1e-5):
        raise AssertionError("int8 rows off the f32 rows or the simplex")

    # served rows against the monolithic forward, on the card and on
    # the CPU, and alone against batched (batch-composition)
    qparams = quantize_gpo_params(params)
    cpu_params = map_params(lambda a: a.cpu(), params)
    cpu = {False: cpu_params, True: quantize_gpo_params(cpu_params)}
    mono = {False: params, True: qparams}
    alone_srv = {w: PreferenceServer(params, gcfg,
                                     ServeConfig(int8_weights=w),
                                     num_options=data.num_options,
                                     device=dev) for w in (False, True)}
    worst = {"monolithic": 0.0, "cpu": 0.0, "alone": 0.0}
    for w, rows in ((False, rows32), (True, rows8)):
        for r in trace[:8]:
            ins = [torch.from_numpy(a) for a in (r.ctx_x, r.ctx_y, r.tgt_x)]
            ref = predict_preferences(mono[w], gcfg, *ins, data.num_options,
                                      device=dev).cpu().numpy()
            ref_cpu = predict_preferences(cpu[w], gcfg, *ins,
                                          data.num_options,
                                          device="cpu").numpy()
            alone_srv[w].submit(r)
            alone = alone_srv[w].step()[0].pred
            for key, other in (("monolithic", ref), ("cpu", ref_cpu),
                               ("alone", alone)):
                worst[key] = max(worst[key],
                                 float(np.abs(rows[r.rid] - other).max()))
    print(f"  served rows vs monolithic predict_preferences on the card: "
          f"max_abs={worst['monolithic']:.3e} (tol 1e-05)")
    print(f"  served rows vs the port's CPU path: max_abs="
          f"{worst['cpu']:.3e} (tol 1e-05)")
    print(f"  batch-composition independence (served alone vs in the "
          f"batch): max_abs={worst['alone']:.3e} (tol 1e-05; not bit-"
          f"exact where cuBLAS picks per-shape algorithms)")
    if max(worst.values()) > 1e-5:
        raise AssertionError(f"served rows off their references: {worst}")

    # where an engine step's time goes: device kernel time against wall
    # time, over the same cold trace under the profiler
    for w in (True, False):
        name = "int8" if w else "f32"
        prof = _profile(lambda: servers[w].run_trace(trace, clear_cache=True))
        prof["steps"] = len(servers[w].batches)
        record[f"profile_{name}"] = prof
        print(f"  {name} engine under the profiler: wall "
              f"{prof['wall_ms']:.3f}ms over {prof['steps']} steps, "
              f"{prof['kernels']} kernels, device busy "
              f"{prof['kernel_ms']:.3f}ms ({100 * prof['busy_share']:.2f}%)")
        for t in prof["top"]:
            print(f"    {t['ms']:.4f}ms  {t['launches']:5d}x  {t['name']}")
    record.update(summaries=summaries, wall_int8_s=wall8,
                  wall_f32_s=wall32)
    return record


def predict(dev, data, groups, gcfg, params) -> dict:
    """Phase 3: the quickstart's serve step through the attention
    kernel, per held-out group and batched over all of them."""
    kcfg = replace(gcfg, use_pallas_attention=True)
    g = _gen(SEED + 1)
    quick = [sample_icl_batch(g, data, int(gr), 12, 4) for gr in groups]
    evals = [sample_icl_batch(g, data, int(gr), 16, 16) for gr in groups]
    stacked = [torch.stack([getattr(b, f) for b in evals]).to(dev)
               for f in ("ctx_x", "ctx_y", "tgt_x")]

    gpo_attention_fwd.launches = 0
    int8_matmul_flat.launches = 0
    preds = [predict_preferences(params, kcfg, b.ctx_x, b.ctx_y, b.tgt_x,
                                 data.num_options, device=dev)
             for b in quick]
    batched = predict_preferences(params, kcfg, *stacked, data.num_options,
                                  device=dev)
    torch.cuda.synchronize()
    launches = gpo_attention_fwd.launches
    calls = len(quick) + 1
    if launches == 0 or int8_matmul_flat.launches != 0:
        raise AssertionError("predict_preferences did not run on the "
                             "attention kernel")

    err, scores = 0.0, []
    for b, p in zip(quick, preds):
        dense = predict_preferences(params, gcfg, b.ctx_x, b.ctx_y, b.tgt_x,
                                    data.num_options, device=dev)
        err = max(err, (p - dense).abs().max().item())
        truth = b.tgt_y.reshape(-1, data.num_options).to(dev)
        scores.append(alignment_score(p, truth).item())
    dense = predict_preferences(params, gcfg, *stacked, data.num_options,
                                device=dev)
    err = max(err, (batched - dense).abs().max().item())
    print(f"  {launches} gpo_attention_fwd launches over {calls} "
          f"predict_preferences calls ({len(quick)} groups of 12+4 "
          f"questions, then all {len(evals)} groups batched at 16+16)")
    print(f"  kernel branch vs dense branch: max_abs={err:.3e} (tol 1e-05)"
          f"; alignment score per group (random weights): "
          f"{np.round(scores, 4).tolist()}")
    if not err <= 1e-5:
        raise AssertionError("attention kernel rows off the dense rows")

    mu32, _ = gpo_apply(params, gcfg, *stacked)
    mu8, _ = gpo_apply(quantize_gpo_params(params), gcfg, *stacked)
    mu_err = (mu8 - mu32).abs().max().item()
    print(f"  int8 vs f32 predicted preference mu: max_abs={mu_err:.3e} "
          f"(tol 0.05; |mu| max {mu32.abs().max().item():.3f})")
    if not mu_err <= 0.05:
        raise AssertionError("int8 mu off the f32 mu")
    return {"launches": launches, "calls": calls}


_COUNTED = {"gpo_attention_fwd": gpo_attention_fwd,
            "gpo_attention_bwd_dq": gpo_attention_bwd_dq,
            "gpo_attention_bwd_dkdv": gpo_attention_bwd_dkdv,
            "fedavg_reduce": fedavg_reduce_flat,
            "momentum_reduce": momentum_reduce_flat,
            "trimmed_reduce": trimmed_reduce_flat,
            "pairwise_dists": pairwise_dists_flat,
            "clip_reduce": clip_reduce_flat,
            "quant_clip_reduce": quant_clip_reduce_flat,
            "topk_reduce": topk_reduce_flat,
            "int8_matmul": int8_matmul_flat}


def _counts() -> dict:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def _zero_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


def _attention_launches(gcfg, fcfg, rounds) -> dict:
    """The attention kernels' launches in ``rounds`` training rounds:
    one forward and backward per layer and local epoch, and one forward
    per layer for the round's eval."""
    steps = gcfg.num_layers * fcfg.local_epochs * rounds
    return {"gpo_attention_fwd": steps + gcfg.num_layers * rounds,
            "gpo_attention_bwd_dq": steps, "gpo_attention_bwd_dkdv": steps}


def _agreement(hist, params, other, other_params) -> dict:
    """How far two 3-round runs are apart: round losses (relative),
    eval AS / FI / CoV (absolute), final global params (max abs)."""
    loss = np.abs(np.asarray(hist.round_loss) - other.round_loss) / np.abs(
        other.round_loss)
    ev = max(float(np.abs(np.asarray(getattr(hist, k))
                          - getattr(other, k)).max())
             for k in ("eval_mean_as", "eval_fi", "eval_cov"))
    par = max((a.cpu() - b.cpu()).abs().max().item()
              for a, b in zip(tree_leaves(params), tree_leaves(other_params)))
    return {"round_loss_rel": float(loss.max()), "eval_abs": ev,
            "params_max_abs": par}


def _strategy_cfg(base: FedConfig, label: str) -> FedConfig:
    kw = dict(STRATEGIES[label])
    return replace(base, agg=AggConfig(name=kw.pop("name", label), **kw))


def _within(a: dict) -> bool:
    return (a["round_loss_rel"] <= TRAIN_TOL["round_loss_rtol"]
            and a["eval_abs"] <= TRAIN_TOL["eval_atol"]
            and a["params_max_abs"] <= TRAIN_TOL["params_max_abs"])


def train(dev, data, tr, ev) -> dict:
    """Phase 4: federated training at full width through the kernels,
    then its checkpoint served."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    # examples/quickstart.py:55-57, with eval every round
    dense = FedConfig(num_clients=len(tr), local_epochs=6, lr=3e-4,
                      eval_every=1)
    kern = replace(dense, use_pallas_attention=True,
                   use_pallas_aggregation=True)
    fed = FederatedGPO(gcfg, kern, data, tr, ev, device=dev)

    # the main path: 3 rounds through the kernels, eval every round
    _zero_counts()
    t0 = time.perf_counter()
    hist = fed.run(rounds=TRAIN_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    layers, epochs = gcfg.num_layers, kern.local_epochs
    want = {**dict.fromkeys(_COUNTED, 0),
            **_attention_launches(gcfg, kern, TRAIN_ROUNDS),
            "fedavg_reduce": TRAIN_ROUNDS}
    print(f"  {TRAIN_ROUNDS} rounds of {len(tr)} clients x {epochs} local "
          f"epochs in {wall:.3f}s; launches {launches}")
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    print(f"  round_loss {hist.round_loss}  eval AS {hist.eval_mean_as}")

    # the same trainer on the CPU (plain versions) and on the card's
    # dense path: same init and batches, drawn from the same seeds
    cpu = FederatedGPO(gcfg, kern, data, tr, ev, device="cpu")
    cpu_hist = cpu.run(rounds=TRAIN_ROUNDS)
    den = FederatedGPO(gcfg, dense, data, tr, ev, device=dev)
    den_hist = den.run(rounds=TRAIN_ROUNDS)
    agree = {"cpu": _agreement(hist, fed.global_params, cpu_hist,
                               cpu.global_params),
             "dense": _agreement(hist, fed.global_params, den_hist,
                                 den.global_params)}
    for name, a in agree.items():
        print(f"  vs the {name} run: round_loss rel {a['round_loss_rel']:.3e}"
              f" (tol {TRAIN_TOL['round_loss_rtol']:g}); eval AS/FI/CoV abs "
              f"{a['eval_abs']:.3e} (tol {TRAIN_TOL['eval_atol']:g}); params "
              f"max_abs {a['params_max_abs']:.3e} (tol "
              f"{TRAIN_TOL['params_max_abs']:g})")
        if not _within(a):
            raise AssertionError(f"the kernel run is off the {name} run")

    # training goes on: the loss falls
    t0 = time.perf_counter()
    more = fed.run(rounds=MORE_ROUNDS, log_every=5)
    more_wall = time.perf_counter() - t0
    first, last = float(np.mean(hist.round_loss)), float(
        np.mean(more.round_loss[-5:]))
    print(f"  {MORE_ROUNDS} more rounds in {more_wall:.3f}s: mean loss of "
          f"the first {TRAIN_ROUNDS} rounds {first:.5f}, of the last 5 "
          f"{last:.5f}")
    if not last < first:
        raise AssertionError("the round loss did not fall")

    # train -> checkpoint -> serve
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    path = save_checkpoint(str(ckpt_dir), TRAIN_ROUNDS + MORE_ROUNDS,
                           fed.global_params)
    like = init_gpo_params(gcfg, _gen(SEED + 7), device=dev)
    restored = restore_checkpoint(latest_checkpoint(str(ckpt_dir)), like)
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored), tree_leaves(fed.global_params))):
        raise AssertionError("the restored checkpoint differs")
    srv = PreferenceServer(restored, gcfg, ServeConfig(),
                           num_options=data.num_options, device=dev)
    trace = make_request_trace(data, list(ev), num_requests=8,
                               hit_ratio=0.5, seed=SEED + 3)
    done = srv.run_trace(trace, clear_cache=True)
    prefs = data.prefs.numpy()
    err, served_as = 0.0, []
    for c in sorted(done, key=lambda c: c.rid):
        r = trace[c.rid]
        ins = [torch.from_numpy(a) for a in (r.ctx_x, r.ctx_y, r.tgt_x)]
        mono = predict_preferences(restored, gcfg, *ins, data.num_options,
                                   device=dev).cpu().numpy()
        err = max(err, float(np.abs(c.pred - mono).max()))
        truth = torch.from_numpy(prefs[r.meta["group"], r.meta["tgt_q"]])
        served_as.append(alignment_score(torch.from_numpy(c.pred),
                                         truth).item())
    print(f"  checkpoint {Path(path).name} restored bit-equal and served: "
          f"{len(done)}/{len(trace)} requests, rows vs monolithic "
          f"predict_preferences max_abs={err:.3e} (tol 1e-05), AS per "
          f"request {np.round(served_as, 4).tolist()}")
    if len(done) != len(trace) or not err <= 1e-5:
        raise AssertionError("the trained checkpoint was not served right")

    # where a round's time goes (its eval included)
    prof = _profile(lambda: fed.run(rounds=1), "train_trace.json")
    print(f"  one round under the profiler: wall {prof['wall_ms']:.3f}ms, "
          f"{prof['kernels']} kernels, device busy {prof['kernel_ms']:.3f}ms "
          f"({100 * prof['busy_share']:.2f}%)")
    for t in prof["top"]:
        print(f"    {t['ms']:.4f}ms  {t['launches']:5d}x  {t['name']}")
    return {"config": {"clients": len(tr), "local_epochs": epochs,
                       "lr": kern.lr, "num_context": kern.num_context,
                       "num_target": kern.num_target,
                       "d_model": gcfg.d_model, "layers": layers,
                       "heads": gcfg.num_heads, "d_ff": gcfg.d_ff},
            "rounds": TRAIN_ROUNDS, "launches": launches,
            "wall_ms_per_round": wall / TRAIN_ROUNDS * 1e3,
            "round_loss": hist.round_loss, "eval_mean_as": hist.eval_mean_as,
            "eval_fi": hist.eval_fi, "agreement": agree,
            "tolerance": TRAIN_TOL, "more_rounds": MORE_ROUNDS,
            "more_wall_ms_per_round": more_wall / MORE_ROUNDS * 1e3,
            "loss_first_mean": first, "loss_last5_mean": last,
            "more_eval_mean_as_last": more.eval_mean_as[-1],
            "served": len(done), "served_as_mean": float(np.mean(served_as)),
            "profile_round": prof}


def train_strategies(dev, data, tr, ev) -> dict:
    """Phase 4, continued: every strategy of ``STRATEGIES`` for 3 rounds
    through the kernels (launch counts asserted), against the same run
    with the aggregation's plain versions on the card; median and krum
    also against their CPU runs."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    base = FedConfig(num_clients=len(tr), local_epochs=6, lr=3e-4,
                     eval_every=1, use_pallas_attention=True,
                     use_pallas_aggregation=True)
    out, real_clip = {}, pipeline.norm_clip_rows
    for label in STRATEGIES:
        kern = _strategy_cfg(base, label)
        plain = replace(kern, use_pallas_aggregation=False)
        row_norms = []
        if kern.agg.norm_bound > 0:  # read the received rows' norms
            def spy(vecs, bound):
                row_norms.append(torch.linalg.vector_norm(vecs, dim=1).cpu())
                return real_clip(vecs, bound)

            pipeline.norm_clip_rows = spy
        try:
            fed = FederatedGPO(gcfg, kern, data, tr, ev, device=dev)
            _zero_counts()
            t0 = time.perf_counter()
            hist = fed.run(rounds=TRAIN_ROUNDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
            t0 = time.perf_counter()
            den = FederatedGPO(gcfg, plain, data, tr, ev, device=dev)
            den_hist = den.run(rounds=TRAIN_ROUNDS)
            torch.cuda.synchronize()
            den_wall = time.perf_counter() - t0
        finally:
            pipeline.norm_clip_rows = real_clip
        agg_kernel = STRATEGY_KERNEL.get(label, "fedavg_reduce")
        want = {**dict.fromkeys(_COUNTED, 0),
                **_attention_launches(gcfg, kern, TRAIN_ROUNDS)}
        if agg_kernel:
            want[agg_kernel] = TRAIN_ROUNDS
        agree = {"plain": _agreement(hist, fed.global_params, den_hist,
                                     den.global_params)}
        rec = {"agg": {"name": kern.agg.name, **STRATEGIES[label]},
               "kernel": agg_kernel,
               "launches": {k: v for k, v in launches.items() if v},
               "wall_ms_per_round": wall / TRAIN_ROUNDS * 1e3,
               "plain_wall_ms_per_round": den_wall / TRAIN_ROUNDS * 1e3,
               "round_loss": hist.round_loss,
               "eval_mean_as": hist.eval_mean_as}
        if row_norms:  # the kernel run's rounds, then the plain run's
            clipped = [int((n > NORM_BOUND).sum())
                       for n in row_norms[:TRAIN_ROUNDS]]
            rec.update(norm_bound=NORM_BOUND, rows_clipped=clipped,
                       round0_row_norms=row_norms[0].tolist())
            print(f"  norm_bound {NORM_BOUND}: rows clipped per round "
                  f"{clipped} of {len(tr)} (round 0 norms "
                  f"{np.round(row_norms[0].numpy(), 4).tolist()})")
            if clipped[0] < 1:
                raise AssertionError("the norm bound clipped no row in "
                                     "round 0")
        if label in CPU_STRATEGIES:
            cpu = FederatedGPO(gcfg, kern, data, tr, ev, device="cpu")
            cpu_hist = cpu.run(rounds=TRAIN_ROUNDS)
            agree["cpu"] = _agreement(hist, fed.global_params, cpu_hist,
                                      cpu.global_params)
        rec["agreement"] = agree
        out[label] = rec
        print(f"  {label:17s} {wall / TRAIN_ROUNDS * 1e3:8.2f} ms/round "
              f"(plain aggregation {den_wall / TRAIN_ROUNDS * 1e3:8.2f}); "
              f"{agg_kernel or 'no aggregation kernel'} "
              f"x{launches.get(agg_kernel, 0) if agg_kernel else 0}; "
              + "; ".join(f"vs {k}: loss rel {a['round_loss_rel']:.2e} "
                          f"eval {a['eval_abs']:.2e} params "
                          f"{a['params_max_abs']:.2e}"
                          for k, a in agree.items())
              + f"; loss {np.round(hist.round_loss, 5).tolist()}")
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, want "
                                 f"{want}")
        for k, a in agree.items():
            if not _within(a):
                raise AssertionError(f"{label}: the kernel run is off the "
                                     f"{k} run (tolerance {TRAIN_TOL})")
    return out


def _private_cfg(base: FedConfig, label: str) -> FedConfig:
    spec = PRIVATE[label]
    return replace(base, agg=AggConfig(**spec.get("agg", {})),
                   privacy=PrivacyConfig(**spec.get("privacy", {})),
                   compression=CompressionConfig(
                       **spec.get("compression", {})))


def _cpu_draws(fcfg: FedConfig, shape: tuple, rounds: int) -> dict:
    """The release draws of ``rounds`` rounds (noise, then uniforms,
    where the config uses them), made once on the CPU from a seed, as
    numpy, for a card run and a CPU run to replay."""
    g = _gen(SEED + 11)
    priv, comp = fcfg.privacy, fcfg.compression
    return {r: (dp.client_noise(g, shape, priv.sigma).numpy()
                if priv.enabled and priv.noise_multiplier > 0 else None,
                cx.client_uniform(g, shape).numpy()
                if comp.needs_rng else None)
            for r in range(rounds)}


def _spy_levels(levels: list):
    """Record the codec's level size each round of a plain run: the
    largest int8 scale, or the largest top-k threshold. Returns the
    originals to put back."""
    real = cx.quantize_int8, cx.topk_thresholds

    def quantize(vecs, *, uniform=None):
        q, scales = real[0](vecs, uniform=uniform)
        levels.append(float(scales.max()))
        return q, scales

    def thresholds(vecs, frac):
        tau = real[1](vecs, frac)
        levels.append(float(tau.max()))
        return tau

    cx.quantize_int8, cx.topk_thresholds = quantize, thresholds
    return real


def _private_agreement(hist, fed, other, other_fed, allowance) -> dict:
    """``_agreement``, the EF residuals' max abs difference, and how
    many coordinates of params and residual lie beyond 1e-4."""
    a = _agreement(hist, fed.global_params, other, other_fed.global_params)
    diffs = [(x.cpu() - y.cpu()).abs() for x, y in zip(
        tree_leaves(fed.global_params), tree_leaves(other_fed.global_params))]
    if fed.ef_resid is not None:
        r = (fed.ef_resid.cpu() - other_fed.ef_resid.cpu()).abs()
        a["ef_resid_max_abs"] = r.max().item()
        diffs.append(r)
    a["coords_beyond_1e-4"] = int(sum((d > 1e-4).sum() for d in diffs))
    a.update(allowance)
    return a


def _private_within(a: dict) -> bool:
    """TRAIN_TOL, the params and the residual widened by the level
    allowance, and at most MAX_FLIPPED coordinates beyond 1e-4."""
    return (a["round_loss_rel"] <= TRAIN_TOL["round_loss_rtol"]
            and a["coords_beyond_1e-4"] <= MAX_FLIPPED
            and a["eval_abs"] <= TRAIN_TOL["eval_atol"]
            and a["params_max_abs"] <= TRAIN_TOL["params_max_abs"]
            + a["params_allowance"]
            and a.get("ef_resid_max_abs", 0.0)
            <= TRAIN_TOL["params_max_abs"] + a["resid_allowance"])


def train_private(dev, data, tr, ev) -> dict:
    """Phase 4, continued: the round's DP and codec stages, each
    configuration of ``PRIVATE`` for 3 rounds through the kernels (launch
    counts asserted), against the same run with the aggregation's plain
    versions on the card (the same device generator draws the noise and
    the uniforms); dp_noise and int8_ef also as a card run and a CPU run
    that replay draws made once on the CPU; the cumulative ε against the
    port's accountant.

    A codec run may flip one coordinate a round between two paths: an
    int8 scale an ulp off (norms summed in another order) flips a
    rounding decision by one level s, and near-tied magnitudes (Adam's
    first steps leave many |Δ| within an ulp of each other) may trade
    places across a top-k threshold τ. The params' bound therefore grows
    by Σ_rounds w_max·level, the residual's by Σ_rounds level, level the
    largest s or τ of the plain run's round; the coordinates beyond 1e-4
    are counted and reported."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    base = FedConfig(num_clients=len(tr), local_epochs=6, lr=3e-4,
                     eval_every=1, use_pallas_attention=True,
                     use_pallas_aggregation=True)
    out = {}
    for label in PRIVATE:
        kern = _private_cfg(base, label)
        plain = replace(kern, use_pallas_aggregation=False)
        fed = FederatedGPO(gcfg, kern, data, tr, ev, device=dev)
        _zero_counts()
        t0 = time.perf_counter()
        hist = fed.run(rounds=TRAIN_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        levels: list = []
        real = _spy_levels(levels)
        try:
            t0 = time.perf_counter()
            den = FederatedGPO(gcfg, plain, data, tr, ev, device=dev)
            den_hist = den.run(rounds=TRAIN_ROUNDS)
            torch.cuda.synchronize()
            den_wall = time.perf_counter() - t0
        finally:
            cx.quantize_int8, cx.topk_thresholds = real
        w_max = float(fed.weights.max())
        allowance = {"levels": levels,
                     "params_allowance": w_max * sum(levels),
                     "resid_allowance": sum(levels)}
        kernel = PRIVATE_KERNEL[label]
        want = {**dict.fromkeys(_COUNTED, 0),
                **_attention_launches(gcfg, kern, TRAIN_ROUNDS),
                kernel: TRAIN_ROUNDS}
        agree = {"plain": _private_agreement(hist, fed, den_hist, den,
                                             allowance)}
        acct = dp.make_accountant(kern.privacy, 1.0)
        eps_want = [] if not kern.privacy.enabled else [
            acct.epsilon(r) if acct else float("inf")
            for r in range(1, TRAIN_ROUNDS + 1)]
        if label in CPU_PRIVATE:
            draws = _cpu_draws(
                kern, (len(tr), tree_count_params(fed.global_params)),
                TRAIN_ROUNDS)
            runs = []
            for d in (dev, "cpu"):
                f = FederatedGPO(gcfg, kern, data, tr, ev, device=d,
                                 release_draws=lambda r: draws[r])
                runs.append((f.run(rounds=TRAIN_ROUNDS), f))
            agree["cpu"] = _private_agreement(*runs[0], *runs[1],
                                              allowance)
        if label in PROFILED_PRIVATE:
            prof = _profile(lambda: fed.run(rounds=1),
                            f"private_{label}_trace.json",
                            match=("row_sumsq", "row_absmax",
                                   "quant_reduce", "topk_reduce_kernel",
                                   "gatherTopK", "kth", "sort"))
            print(f"  {label}: one round under the profiler: wall "
                  f"{prof['wall_ms']:.3f}ms, {prof['kernels']} kernels, "
                  f"device busy {prof['kernel_ms']:.3f}ms "
                  f"({100 * prof['busy_share']:.2f}%); by name: "
                  + ", ".join(f"{m} {v['ms']:.4f}ms x{v['launches']}"
                              for m, v in prof["matched"].items()))
            for t in prof["top"]:
                print(f"    {t['ms']:.4f}ms  {t['launches']:5d}x  "
                      f"{t['name']}")
        rec = {"config": PRIVATE[label], "kernel": kernel,
               "launches": {k: v for k, v in launches.items() if v},
               "wall_ms_per_round": wall / TRAIN_ROUNDS * 1e3,
               "plain_wall_ms_per_round": den_wall / TRAIN_ROUNDS * 1e3,
               "round_loss": hist.round_loss,
               "eval_mean_as": hist.eval_mean_as,
               "round_eps": hist.round_eps, "agreement": agree}
        if label in PROFILED_PRIVATE:
            rec["profile_round"] = prof
        out[label] = rec
        print(f"  {label:10s} {wall / TRAIN_ROUNDS * 1e3:8.2f} ms/round "
              f"(plain aggregation {den_wall / TRAIN_ROUNDS * 1e3:8.2f}); "
              f"{kernel} x{launches[kernel]}; "
              + "; ".join(f"vs {k}: loss rel {a['round_loss_rel']:.2e} "
                          f"eval {a['eval_abs']:.2e} params "
                          f"{a['params_max_abs']:.2e} (allowance "
                          f"{a['params_allowance']:.2e}) resid "
                          f"{a.get('ef_resid_max_abs', 0.0):.2e} coords>1e-4 "
                          f"{a['coords_beyond_1e-4']}"
                          for k, a in agree.items())
              + f"; loss {np.round(hist.round_loss, 5).tolist()}; eps "
              f"{np.round(hist.round_eps, 4).tolist()}")
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, want "
                                 f"{want}")
        for k, a in agree.items():
            if not _private_within(a):
                raise AssertionError(f"{label}: the kernel run is off the "
                                     f"{k} run (tolerance {TRAIN_TOL} plus "
                                     f"the level allowance)")
        if hist.round_eps != eps_want or den_hist.round_eps != eps_want:
            raise AssertionError(f"{label}: round_eps {hist.round_eps}, "
                                 f"want {eps_want}")
        if (fed.ef_resid is None) != (not kern.compression.enabled
                                      or not kern.compression.error_feedback):
            raise AssertionError(f"{label}: EF residual carried wrongly")
    return out


def timing(dev, serve_rec, pred_rec, train_rec, strat_rec, priv_rec,
           card_name, worst) -> list:
    """Phase 5: kernel, plain and library times at main-path shapes."""
    peaks = _peaks(card_name)
    g = _gen(SEED + 2)
    out = []
    train_launches, rounds = train_rec["launches"], train_rec["rounds"]
    # each aggregation kernel's launches over the strategies phase's
    # kernel runs
    strat_launches = {k: sum(r["launches"].get(k, 0)
                             for r in strat_rec.values())
                      for k in _COUNTED}

    # every layer's shape at the largest decode and prefill of the run:
    # device time of the kernel and of cuBLAS on the dequantized weight
    by_shape = []
    for m in (serve_rec["max_decode_rows"], serve_rec["max_prefill_rows"]):
        for k, n in INT8_SHAPES[:5]:
            x, q, s = _int8_inputs(m, k, n, g, dev)
            w = q.float() * s[None, :]
            by_shape.append({
                "shape": [m, k, n],
                "ms": _time_ms(lambda: int8_matmul_flat(x, q, s))[0],
                "library_ms": _time_ms(lambda: torch.matmul(x, w))[0]})
            print(f"  int8_matmul {by_shape[-1]['shape']}: kernel "
                  f"{by_shape[-1]['ms'] * 1e3:.2f}us  library "
                  f"{by_shape[-1]['library_ms'] * 1e3:.2f}us (device)")

    m, k, n = serve_rec["max_decode_rows"], 128, 256  # decode's w1
    x, q, s = _int8_inputs(m, k, n, g, dev)
    w = q.float() * s[None, :]
    times = _timed(lambda: int8_matmul_flat(x, q, s),
                   lambda: ref_int8_matmul(x, q, s),
                   lambda: torch.matmul(x, w))
    bound, by = _bound_ms(4 * m * k + k * n + 4 * n + 4 * m * n,
                          2 * m * k * n, peaks)
    out.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:68",
        "tpu_kernel": "src/repro/kernels/quant_matmul.py::"
                      "_int8_matmul_kernel (int8_matmul_flat)",
        "launches": serve_rec["launches"],
        "launches_per_step": serve_rec["launches"] / serve_rec["steps"],
        "max_abs_err": worst["int8_matmul"],
        "shape": [m, k, n], **times, "bound_ms": bound, "bound_by": by,
        "library_call": "torch.matmul(x, dequantize_linear(w))",
        "by_shape": by_shape})

    # the forward at training's shape, where its launches come from, and
    # at predict's shape (7 held-out groups x 4 heads)
    fwd_rows = []
    for bh, s_len, nc in ATTN_SHAPES[:2]:
        q, k, v = _attn_inputs(bh, s_len, g, dev)
        pos = torch.arange(s_len, device=dev)
        mask = (pos[None, :] < nc) | (pos[None, :] == pos[:, None])
        times = _timed(lambda: gpo_attention_fwd(q, k, v, num_ctx=nc),
                       lambda: ref_gpo_attention(q, k, v, num_ctx=nc),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask))
        keys = s_len * nc + (s_len - nc)  # the band: context keys + self
        bound, by = _bound_ms(4 * bh * (4 * s_len * HEAD_DIM + s_len),
                              4 * bh * keys * HEAD_DIM, peaks)
        fwd_rows.append({"shape": [bh, s_len, nc, HEAD_DIM], **times,
                         "bound_ms": bound, "bound_by": by})
    train_row, predict_row = fwd_rows
    out.append({
        "name": "gpo_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gpo_attention_fwd.cu",
        "replaces": "src/repro/kernels/gpo_attention.py:117",
        "tpu_kernel": "src/repro/kernels/gpo_attention.py::"
                      "_gpo_fwd_kernel (_gpo_forward)",
        "launches": train_launches["gpo_attention_fwd"],
        "launches_from": "train (shape, times and bound are training's)",
        "launches_per_round": train_launches["gpo_attention_fwd"] / rounds,
        "launches_by_path": {"predict": pred_rec["launches"],
                             "train": train_launches["gpo_attention_fwd"]},
        "launches_per_call": pred_rec["launches"] / pred_rec["calls"],
        "max_abs_err": worst["gpo_attention_fwd"],
        **train_row,
        "library_call": "F.scaled_dot_product_attention(q, k, v, "
                        "attn_mask=boolean NP mask)",
        "predict_path": predict_row})

    # the backward at the training shape: 10 clients x 4 heads. No single
    # library call computes dq or dk/dv alone, so those rows have no
    # library time; SDPA's forward and backward together stand in
    # ``fwd_bwd`` beside the forward kernel and both backward kernels
    # through the GPOAttention Function (and the plain forward under
    # autograd).
    bh, s_len, nc = BWD_SHAPES[0]
    q, k, v, do = _attn_inputs(bh, s_len, g, dev, n=4)
    o, lse = gpo_attention_fwd(q, k, v, num_ctx=nc)
    delta = (do * o).sum(-1)
    pos = torch.arange(s_len, device=dev)
    mask = (pos[None, :] < nc) | (pos[None, :] == pos[:, None])
    leaf = [t.clone().requires_grad_() for t in (q, k, v)]

    def fwd_bwd(forward):
        return lambda: torch.autograd.grad(forward(*leaf), leaf, do)

    chain = {
        "kernels_ms": _time_ms(fwd_bwd(
            lambda *a: GPOAttention.apply(*a, nc)))[0],
        "plain_ms": _time_ms(fwd_bwd(
            lambda *a: ref_gpo_attention(*a, num_ctx=nc)[0]))[0],
        "library_ms": _time_ms(fwd_bwd(
            lambda *a: F.scaled_dot_product_attention(*a,
                                                      attn_mask=mask)))[0]}
    band = s_len * nc + (s_len - nc)  # allowed (query, key) pairs
    for name, kfn, pfn, n_out, per_pair, src_key in (
            ("gpo_attention_bwd_dq", gpo_attention_bwd_dq,
             ref_gpo_attention_bwd_dq, 1, 6, "223"),
            ("gpo_attention_bwd_dkdv", gpo_attention_bwd_dkdv,
             ref_gpo_attention_bwd_dkdv, 2, 8, "261")):
        ops = (q, k, v, do, lse, delta)
        times = _timed(lambda: kfn(*ops, num_ctx=nc),
                       lambda: pfn(*ops, num_ctx=nc), None)
        # q, k, v, do, lse and delta read once; each output written once
        bound, by = _bound_ms(4 * bh * ((4 + n_out) * s_len * HEAD_DIM
                                        + 2 * s_len),
                              per_pair * bh * band * HEAD_DIM, peaks)
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gpo_attention_bwd.cu",
            "replaces": f"src/repro/kernels/gpo_attention.py:{src_key}",
            "tpu_kernel": "src/repro/kernels/gpo_attention.py::"
                          f"_{name.replace('gpo_attention_', 'gpo_')}"
                          "_kernel (_gpo_backward)",
            "launches": train_launches[name],
            "launches_per_round": train_launches[name] / rounds,
            "max_abs_err": worst[name],
            "shape": [bh, s_len, nc, HEAD_DIM], **times, "bound_ms": bound,
            "bound_by": by, "library_call": None,
            "fwd_bwd": {**chain, "library_call": (
                "forward + backward of F.scaled_dot_product_attention("
                "attn_mask=boolean NP mask) through torch.autograd.grad, "
                "against kernels_ms")}})

    # the Eq. 3 reduce at the quickstart's (C, P). Inputs rotate over 4
    # copies (85 MB, beyond the 50 MB L2), so each call reads its deltas
    # from device memory.
    c, p = FEDAVG_SHAPES[0]
    xs = [torch.randn((c, p), generator=g).to(dev) for _ in range(4)]
    w = torch.rand((c,), generator=g) + 0.1
    w = (w / w.sum()).to(dev)

    def rotating(fn):
        turn = [0]

        def call():
            turn[0] += 1
            return fn(xs[turn[0] % len(xs)])

        return call

    times = _timed(rotating(lambda x: fedavg_reduce_flat(x, w)),
                   rotating(lambda x: ref_fedavg_flat(x, w)),
                   rotating(lambda x: w @ x))
    bound, by = _bound_ms(4 * (c * p + p + c), 2 * c * p, peaks)
    out.append({
        "name": "fedavg_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/agg_reduce.py:100",
        "tpu_kernel": "src/repro/kernels/agg_reduce.py::_fedavg_kernel "
                      "(fedavg_reduce_flat)",
        "launches": train_launches["fedavg_reduce"],
        "launches_per_round": train_launches["fedavg_reduce"] / rounds,
        "launches_by_path": {"train": train_launches["fedavg_reduce"],
                             "strategies": strat_launches["fedavg_reduce"]},
        "max_abs_err": worst["fedavg_reduce"],
        "shape": [c, p], **times, "bound_ms": bound, "bound_by": by,
        "library_call": "weights @ stacked (cuBLAS gemv)"})

    # the other aggregation kernels at the same (C, P), inputs rotated
    # the same way; launches from the strategies phase
    def agg_row(name, src, line, fn, times, nbytes, flops, **extra):
        bound, by = _bound_ms(nbytes, flops, peaks)
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}.cu",
                "replaces": f"src/repro/kernels/agg_reduce.py:{line}",
                "tpu_kernel": f"src/repro/kernels/agg_reduce.py::{fn}",
                "launches": strat_launches[name],
                "launches_per_round": strat_launches[name] / rounds,
                "max_abs_err": worst[name], "shape": [c, p], **times,
                "bound_ms": bound, "bound_by": by, **extra}

    m = torch.randn((p,), generator=g).to(dev)
    beta = STRATEGIES["fedavgm"]["momentum"]
    out.append(agg_row(
        "momentum_reduce", "momentum_reduce", 139,
        "_moment_kernel (momentum_reduce_flat)",
        _timed(rotating(lambda x: momentum_reduce_flat(x, w, m, beta=beta)),
               rotating(lambda x: ref_momentum_reduce_flat(x, w, m,
                                                           beta=beta)),
               rotating(lambda x: torch.addmv(m, x.T, w, beta=beta))),
        4 * (c * p + 3 * p + c), 2 * c * p + 2 * p,
        library_call="torch.addmv(m, stacked.T, w, beta=beta): beta*m + "
                     "delta in one call, without delta itself"))
    # the median's trim, (C-1)//2; trimmed_mean's trim of 1 beside it
    trim = (c - 1) // 2
    out.append(agg_row(
        "trimmed_reduce", "trimmed_reduce", 475,
        "_trim_kernel (trimmed_reduce_flat)",
        _timed(rotating(lambda x: trimmed_reduce_flat(x, w, trim=trim)),
               rotating(lambda x: ref_trimmed_flat(x, w, trim=trim)), None),
        4 * (c * p + p + c), c * c * p, trim=trim,
        library_call=None,
        sort_path_note="plain_ms is the dense path's stable torch.sort "
                       "over the clients (not one library call)",
        trim_1={"kernel_ms": _time_ms(rotating(
            lambda x: trimmed_reduce_flat(x, w, trim=1)))[0],
            "plain_ms": _time_ms(rotating(
                lambda x: ref_trimmed_flat(x, w, trim=1)))[0]}))
    out.append(agg_row(
        "pairwise_dists", "pairwise_dists", 522,
        "_pairwise_kernel (pairwise_dists_flat)",
        _timed(rotating(pairwise_dists_flat),
               rotating(ref_pairwise_sq_dists),
               rotating(lambda x: torch.cdist(x, x).square())),
        4 * c * p, c * (c + 1) * p,
        library_call="torch.cdist(x, x).square()"))

    # the DP clip and the transport codecs at the same (C, P), every
    # operand rotated over 4 copies; launches from the DP and codec phase
    priv_launches = {k: sum(r["launches"].get(k, 0)
                            for r in priv_rec.values()) for k in _COUNTED}
    # deltas of about the clip's norm, dp_noise's σ = 0.8 · 0.475
    clip = _DP["clip_norm"]
    sets = [tuple(t.to(dev) for t in (
        torch.randn((c, p), generator=g) * (clip / p ** 0.5),
        torch.randn((c, p), generator=g) * (_DP["noise_multiplier"] * clip),
        torch.randn((c, p), generator=g) * 1e-4,
        torch.rand((c, p), generator=g))) for _ in range(4)]

    def rotating_sets(fn):
        turn = [0]

        def call():
            turn[0] += 1
            return fn(*sets[turn[0] % len(sets)])

        return call

    def private_row(name, line, fn, times, nbytes, flops, **extra):
        bound, by = _bound_ms(nbytes, flops, peaks)
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": f"src/repro/kernels/agg_reduce.py:{line}",
                "tpu_kernel": f"src/repro/kernels/agg_reduce.py::{fn}",
                "launches": priv_launches[name],
                "launches_per_round": priv_launches[name] / rounds,
                "max_abs_err": worst[name], "shape": [c, p], **times,
                "bound_ms": bound, "bound_by": by, "library_call": None,
                **extra}

    # with noise (dp_noise, dp_median's release); the clip alone beside
    clip_only = _timed(
        rotating_sets(lambda x, n, r, u: clip_reduce_flat(x, w, clip=clip)),
        rotating_sets(lambda x, n, r, u: ref_clip_reduce(x, w, clip=clip)),
        None)
    out.append(private_row(
        "clip_reduce", 211,
        "_clip_reduce_kernel / _clip_reduce_noise_kernel (clip_reduce_flat)",
        _timed(rotating_sets(lambda x, n, r, u: clip_reduce_flat(
            x, w, clip=clip, noise=n)),
            rotating_sets(lambda x, n, r, u: ref_clip_reduce(
                x, w, clip=clip, noise=n)), None),
        4 * (2 * c * p + p + c), 6 * c * p,
        clip_only={"kernel_ms": clip_only["ms"],
                   "plain_ms": clip_only["plain_ms"],
                   "bound_ms": _bound_ms(4 * (c * p + p + c), 5 * c * p,
                                         peaks)[0]}))
    # every operand (dp_int8_ef's call); int8_ef's (residual and uniforms,
    # no clip) beside
    ef_only = _timed(
        rotating_sets(lambda x, n, r, u: quant_clip_reduce_flat(
            x, w, uniform=u, resid=r)),
        rotating_sets(lambda x, n, r, u: ref_quant_clip_reduce(
            x, w, uniform=u, resid=r)), None)
    out.append(private_row(
        "quant_clip_reduce", 264,
        "_quant_clip_reduce_kernel (quant_clip_reduce_flat)",
        _timed(rotating_sets(lambda x, n, r, u: quant_clip_reduce_flat(
            x, w, clip=clip, noise=n, uniform=u, resid=r)),
            rotating_sets(lambda x, n, r, u: ref_quant_clip_reduce(
                x, w, clip=clip, noise=n, uniform=u, resid=r)), None),
        4 * (5 * c * p + p + c), 14 * c * p,
        int8_ef={"kernel_ms": ef_only["ms"], "plain_ms": ef_only["plain_ms"],
                 "bound_ms": _bound_ms(4 * (4 * c * p + p + c), 10 * c * p,
                                       peaks)[0]}))
    # with the residual (topk_ef's call); the thresholds, torch.topk
    # outside the kernel in both packages, timed beside (eager)
    taus = [cx.topk_thresholds(st[0], TOPK_FRAC) for st in sets]
    turn = [0]

    def topk_call(fn):
        def call():
            turn[0] += 1
            i = turn[0] % len(sets)
            return fn(sets[i][0], w, taus[i], with_residual=True)
        return call

    thresholds_ms = _time_ms(rotating_sets(
        lambda x, n, r, u: cx.topk_thresholds(x, TOPK_FRAC)),
        graph=False)[1]
    out.append(private_row(
        "topk_reduce", 419, "_topk_kernel (topk_reduce_flat)",
        _timed(topk_call(topk_reduce_flat), topk_call(ref_topk_mask_reduce),
               None),
        4 * (2 * c * p + p + 2 * c), 5 * c * p,
        thresholds={"call": "torch.topk(|u|, k).values[:, -1], "
                            f"k = ceil({TOPK_FRAC}·P), eager",
                    "ms": thresholds_ms}))

    for r in out:
        e = r["eager_ms"]
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.2f}us")
        print(f"  {r['name']} at {r['shape']}, device (CUDA graph): kernel "
              f"{r['ms'] * 1e3:.2f}us  plain {r['plain_ms'] * 1e3:.2f}us  "
              f"library {lib}  bound {r['bound_ms'] * 1e3:.3f}us "
              f"({r['bound_by']}); eager: kernel {e['kernel'] * 1e3:.2f}us  "
              f"plain {e['plain'] * 1e3:.2f}us")
    clip_row, quant_row, topk_row = out[-3:]
    for label, extra in (("clip_reduce without noise", clip_row["clip_only"]),
                         ("quant_clip_reduce as int8_ef calls it (residual "
                          "and uniforms, no clip)", quant_row["int8_ef"])):
        print(f"  {label}, device: kernel {extra['kernel_ms'] * 1e3:.2f}us  "
              f"plain {extra['plain_ms'] * 1e3:.2f}us  bound "
              f"{extra['bound_ms'] * 1e3:.3f}us")
    print(f"  top-k thresholds ({topk_row['thresholds']['call']}): "
          f"{topk_row['thresholds']['ms'] * 1e3:.2f}us")
    print(f"  gpo_attention_fwd at predict's {predict_row['shape']}, device: "
          f"kernel {predict_row['ms'] * 1e3:.2f}us  plain "
          f"{predict_row['plain_ms'] * 1e3:.2f}us  library "
          f"{predict_row['library_ms'] * 1e3:.2f}us  bound "
          f"{predict_row['bound_ms'] * 1e3:.3f}us")
    print(f"  attention forward + backward at {[bh, s_len, nc, HEAD_DIM]}, "
          f"device: kernels (fwd, dq, dk/dv through GPOAttention) "
          f"{chain['kernels_ms'] * 1e3:.2f}us  plain under autograd "
          f"{chain['plain_ms'] * 1e3:.2f}us  SDPA fwd+bwd "
          f"{chain['library_ms'] * 1e3:.2f}us")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    dev = backend.resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32, stated
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} ({card}); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off")

    t0 = time.perf_counter()
    paths = backend.build()
    print(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.1f}s")
    for src, log in backend.BUILD_LOG.items():
        # ptxas -v: one report per kernel (trimmed_reduce has one per C)
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and " 0 bytes spill stores, 0 "
                         "bytes spill loads" not in ln})
        print(f"  {src}: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers a thread, spills: "
              f"{'; '.join(spills) or 'none'}")

    print("[1] kernels against their plain versions on the card")
    worst = check_kernels(dev)

    data = make_survey_data(SurveyConfig(), _gen(SEED))
    tr, held_out = split_groups(data, seed=SEED)
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    params = init_gpo_params(gcfg, _gen(SEED), device=dev)
    print("[2] PreferenceServer, ServeConfig() defaults, GPOConfig() width")
    serve_rec = serve(dev, data, list(held_out), gcfg, params)
    print("[3] predict_preferences through the attention kernel")
    pred_rec = predict(dev, data, held_out, gcfg, params)
    print("[4] FederatedGPO at GPOConfig() width, the quickstart's "
          "FedConfig, through the kernels")
    train_rec = train(dev, data, tr, held_out)
    print("[4b] the aggregation registry's strategies, 3 rounds each, "
          "through the kernels")
    strat_rec = train_strategies(dev, data, tr, held_out)
    print("[4c] the DP and codec stages, 3 rounds each, through the "
          "kernels")
    priv_rec = train_private(dev, data, tr, held_out)
    print("[5] timing at the main paths' shapes (CUDA events, median)")
    kernels = timing(dev, serve_rec, pred_rec, train_rec, strat_rec,
                     priv_rec, name, worst)

    print(json.dumps({"engine": {
        k: serve_rec[k] for k in ("steps", "launches", "prefill_requests",
                                  "summaries", "profile_int8",
                                  "profile_f32")}}))
    print(json.dumps({"train": train_rec}))
    print(json.dumps({"strategies": strat_rec}))
    print(json.dumps({"private": priv_rec}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
