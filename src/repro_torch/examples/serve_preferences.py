"""Preference serving through the multi-tenant engine on the port: the
trained federated predictor acts as a group-conditioned reward model
(paper §5), answering ragged requests "what would group g answer to
question q?" through ``PreferenceServer`` (DESIGN.md §12): admission
queue, bucketed continuous batching, prefix/KV cache over shared ICL
contexts, and optional int8 weights (the int8 matmul kernel). The
counterpart of ``examples/serve_preferences.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_preferences \\
      --requests 32 [--int8] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import FedConfig, GPOConfig, ServeConfig
from repro_torch.core import (
    FederatedGPO,
    PreferenceServer,
    latency_summary,
    make_request_trace,
)
from repro_torch.core.fairness import alignment_score, fairness_index
from repro_torch.data import SurveyConfig, make_survey_data, split_groups
from repro_torch.kernels.backend import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--train-rounds", type=int, default=120)
    ap.add_argument("--hit-ratio", type=float, default=0.5)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    data = make_survey_data(SurveyConfig(seed=0))
    tr, ev = split_groups(data)
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    fcfg = FedConfig(num_clients=len(tr), rounds=args.train_rounds,
                     use_pallas_attention=True, use_pallas_aggregation=True)
    fed = FederatedGPO(gcfg, fcfg, data, tr, ev, device=device)
    print(f"training {args.train_rounds} federated rounds on {device} ...")
    fed.run(rounds=args.train_rounds)

    # requests with ragged (context, target) lengths against unseen
    # groups; the hit ratio sets how many share an already-prefilled ICL
    # prefix (the repeated-group serving shape)
    server = PreferenceServer(
        fed.global_params, gcfg, ServeConfig(int8_weights=args.int8),
        num_options=data.num_options, device=device)
    trace = make_request_trace(data, list(ev), num_requests=args.requests,
                               hit_ratio=args.hit_ratio, seed=123)
    server.run_trace(trace[: min(8, len(trace))])  # kernel build, warm-up
    t0 = time.time()
    results = server.run_trace(trace)
    wall = time.time() - t0
    s = latency_summary(results, wall)

    prefs = data.prefs.numpy()
    scores = torch.tensor([
        float(alignment_score(
            torch.from_numpy(c.pred),
            torch.from_numpy(prefs[trace[c.rid].meta["group"],
                                   trace[c.rid].meta["tgt_q"]])))
        for c in results])
    s["mean_as"] = float(scores.mean())
    s["fi"] = float(fairness_index(scores))
    mode = "int8" if args.int8 else "f32"
    print(f"\nserved {s['completed']} requests ({mode}) in "
          f"{wall*1e3:.1f}ms across {len(server.batches)} batches")
    print(f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms "
          f"qps={s['qps']:.0f} prefix-cache hit-rate={s['hit_rate']:.2f}")
    print(f"mean AS={s['mean_as']:.4f}  FI={s['fi']:.4f}")
    print(f"first row: {np.round(results[0].pred[0].astype(float), 3)}")
    return s


if __name__ == "__main__":
    main()
