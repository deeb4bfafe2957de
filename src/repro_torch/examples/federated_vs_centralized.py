"""End-to-end driver of the paper's comparison (Figs. 2/4/5) on the port:
federated PluralLLM against centralized GPO on identical data, reporting
the convergence round, the alignment score and the fairness index, and
the wall time per federated round and per centralized epoch. The
counterpart of ``examples/federated_vs_centralized.py``.

  PYTHONPATH=src python -m repro_torch.examples.federated_vs_centralized \\
      --rounds 300 [--seeds 0 1] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.benchmarks.paper_experiment import run_pair_timed, summarize
from repro_torch.kernels import backend
from repro_torch.kernels.backend import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":  # the kernels' nvcc, out of the timings
        t0 = time.perf_counter()
        backend.build()
        print(f"kernels built in {time.perf_counter() - t0:.1f}s")

    results = []
    for seed in args.seeds:
        r, wall = run_pair_timed(args.rounds, seed, device=device)
        results.append(r)
        one = summarize([r])
        print(f"seed {seed} on {device}: fed {wall['fed_ms_per_round']:.1f}"
              f" ms/round, cen {wall['cen_ms_per_epoch']:.1f} ms/epoch; "
              f"convergence round fed {one['fed_convergence_round']:.0f} "
              f"cen {one['cen_convergence_round']:.0f}; final AS fed "
              f"{one['fed_final_as']:.4f} cen {one['cen_final_as']:.4f}, "
              f"FI fed {one['fed_final_fi']:.4f} cen "
              f"{one['cen_final_fi']:.4f}")
    s = summarize(results)

    print("\n=== PluralLLM vs centralized GPO "
          f"({args.rounds} rounds, {len(args.seeds)} seeds) ===")
    print(f"convergence round   : fed {s['fed_convergence_round']:.0f} "
          f"vs cen {s['cen_convergence_round']:.0f} "
          f"-> {s['convergence_speedup_pct']:.1f}% faster (paper: 46%)")
    print(f"eval alignment score: fed {s['fed_final_as']:.4f} "
          f"vs cen {s['cen_final_as']:.4f} "
          f"-> {s['alignment_improvement_pct']:+.2f}% (paper: ~+4%)")
    print(f"fairness index      : fed {s['fed_final_fi']:.4f} "
          f"vs cen {s['cen_final_fi']:.4f} "
          f"-> gap {s['fi_gap']:+.4f} (paper: parity, FI ~= 1)")

    r = results[0]
    print("\nloss curve (fed vs cen, every 25 rounds):")
    for i in range(0, args.rounds, max(25, args.rounds // 10)):
        print(f"  round {i:4d}: fed={r.fed_loss[i]:.4f} "
              f"cen={r.cen_loss[i]:.4f}")
    return s


if __name__ == "__main__":
    main()
