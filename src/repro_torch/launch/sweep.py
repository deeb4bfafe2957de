"""Run the whole (architecture x input-shape) dry-run sweep, resumably
(the reference's ``launch/sweep.py``).

  PYTHONPATH=src python -m repro_torch.launch.sweep --out build/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.sweep --multi-pod \\
      --out build/dryrun_mp.jsonl

Each pair is counted in-process on meta tensors (``dryrun.lower_pair``:
nothing is allocated, no GPU is touched); results append as JSON lines.
Already-recorded (arch, shape, multi_pod) triples are skipped, so the
sweep can be re-launched after an interruption.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback


def done_keys(path: str) -> set:
    keys = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "error" not in r:
                    keys.add((r["arch"], r["shape"], r.get("multi_pod",
                                                           False)))
    return keys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--arch", default=None, help="restrict to one arch")
    ap.add_argument("--shape", default=None, help="restrict to one shape")
    args = ap.parse_args(argv)

    from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES
    from repro_torch.launch.dryrun import lower_pair

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = done_keys(args.out)
    archs = [args.arch] if args.arch else list(ALL_ARCHS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    todo = [(a, s) for a in archs for s in shapes
            if (a, s, args.multi_pod) not in done]
    print(f"sweep: {len(todo)} pairs to run (skipping {len(done)} done)")

    for i, (arch, shape) in enumerate(todo):
        t0 = time.time()
        print(f"[{i+1}/{len(todo)}] {arch} x {shape} "
              f"multi_pod={args.multi_pod}", flush=True)
        try:
            result = lower_pair(arch, shape, multi_pod=args.multi_pod,
                                verbose=False)
            status = "ok"
        except Exception:
            result = {"arch": arch, "shape": shape,
                      "multi_pod": args.multi_pod,
                      "error": traceback.format_exc()}
            status = "ERROR"
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
        print(f"   -> {status} in {time.time()-t0:.0f}s", flush=True)
        gc.collect()
    print("sweep complete")


if __name__ == "__main__":
    main()
