"""Serving launcher: the GPO preference-serving engine on the GPU.

Serves the latest GPO checkpoint under ``--ckpt-dir`` (the JAX package's
``serve --gpo`` writes one in the same format) through
``core.serving.PreferenceServer`` (DESIGN.md §12): admission-controlled
queue, bucketed continuous batching, LRU prefix/KV cache over shared ICL
contexts, and optional int8 weights (``--int8``) through the int8
matmul kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --gpo --restore \
      --int8 --requests 64 --hit-ratio 0.75

``--restore`` is required: this launcher never serves random weights.
Train and save a checkpoint first, with this package
(``python -m repro_torch.launch.train --trainer gpo --ckpt-dir ...``) or
the JAX package.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
from repro_torch.configs import GPOConfig, ServeConfig
from repro_torch.core import (
    PreferenceServer,
    init_gpo_params,
    latency_summary,
    make_request_trace,
)
from repro_torch.core.fairness import alignment_score
from repro_torch.data import SurveyConfig, make_survey_data, split_groups
from repro_torch.kernels.backend import resolve_device


def _restore_params(ckpt_dir: str, gcfg: GPOConfig, seed: int,
                    device) -> dict:
    """Load the latest GPO checkpoint or fail with an actionable error:
    missing checkpoint, corrupt file and architecture mismatch each get
    their own message."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise SystemExit(
            f"--restore: no checkpoint under {ckpt_dir!r}; train and save "
            "one with python -m repro_torch.launch.train --trainer gpo "
            f"--ckpt-dir {ckpt_dir}")
    like = init_gpo_params(gcfg, torch.Generator().manual_seed(seed),
                           device=device)
    try:
        params = restore_checkpoint(path, like)
    except (OSError, ValueError, KeyError) as e:
        raise SystemExit(
            f"--restore: checkpoint {path!r} is unreadable or does not "
            f"match the GPO architecture ({type(e).__name__}: {e})") from e
    print(f"restored GPO predictor from {path}")
    return params


def serve_gpo(args) -> None:
    """Preference serving for unseen groups through the multi-tenant
    engine, with the p50/p99 latency and QPS of an open-loop trace."""
    device = resolve_device(args.device)
    if not args.restore:
        raise SystemExit(
            "serve --gpo needs --restore: this launcher does not serve "
            "random weights; train a predictor first with python -m "
            "repro_torch.launch.train --trainer gpo --ckpt-dir "
            f"{args.ckpt_dir}")
    data = make_survey_data(SurveyConfig(seed=args.seed))
    _, ev = split_groups(data, seed=args.seed)
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    params = _restore_params(args.ckpt_dir, gcfg, args.seed, device)
    scfg = ServeConfig(max_batch=args.max_batch, int8_weights=args.int8)
    server = PreferenceServer(params, gcfg, scfg,
                              num_options=data.num_options, device=device)
    trace = make_request_trace(
        data, list(ev), num_requests=args.requests,
        hit_ratio=args.hit_ratio, rate=args.rate, seed=args.seed + 7)
    # first batch builds the kernels and warms the allocator: a one-time
    # cost, not per-request serving latency
    t0 = time.time()
    server.run_trace(trace[: min(len(trace), scfg.max_batch)])
    t_warm = time.time() - t0
    server.reset(clear_cache=True)
    t0 = time.time()
    results = server.run_trace(trace)
    wall = time.time() - t0
    summary = latency_summary(results, wall)
    mode = "int8" if args.int8 else "f32"
    print(f"warm-up (kernel build + first call): {t_warm*1e3:.1f}ms")
    print(f"served {summary['completed']}/{args.requests} requests "
          f"({mode}, {server.device}) in {wall*1e3:.1f}ms over "
          f"{len(server.batches)} batches; "
          f"rejected={server.stats.rejected}")
    print(f"  p50={summary['p50_ms']:.2f}ms p99={summary['p99_ms']:.2f}ms "
          f"qps={summary['qps']:.1f} "
          f"prefix-cache hit-rate={summary['hit_rate']:.2f}")
    prefs = data.prefs.numpy()
    for c in results[: min(4, len(results))]:
        req = trace[c.rid]
        truth = prefs[req.meta["group"], req.meta["tgt_q"]]
        score = float(alignment_score(torch.from_numpy(c.pred),
                                      torch.from_numpy(truth)))
        print(f"  rid={c.rid} group={req.meta['group']} AS={score:.4f} "
              f"hit={c.cache_hit} "
              f"pred[0]={np.round(c.pred[0], 3).tolist()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpo", action="store_true",
                    help="serve the GPO preference predictor (the only "
                         "mode ported so far)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints/gpo_serve")
    ap.add_argument("--restore", action="store_true",
                    help="serve the latest GPO checkpoint (required)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--requests", type=int, default=32,
                    help="number of requests in the load trace")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="engine batch cap per decode dispatch")
    ap.add_argument("--hit-ratio", type=float, default=0.5,
                    help="fraction of requests sharing an already-seen "
                         "ICL prefix (prefix-cache pressure)")
    ap.add_argument("--rate", type=float, default=None,
                    help="offered request rate in req/s (default: all "
                         "arrive at t=0, saturation)")
    ap.add_argument("--int8", action="store_true",
                    help="quantize weights to int8 at load time and serve "
                         "through the int8 matmul kernel")
    args = ap.parse_args(argv)
    if not args.gpo:
        raise SystemExit("only --gpo serving is ported; LM serving comes "
                         "with the backbone-zoo slice")
    serve_gpo(args)


if __name__ == "__main__":
    main()
