"""Bit-for-bit comparison of the GPO attention, trimmed and pairwise
kernels of two source trees on one card, at the shapes whose designs
are meant to stay as they were: head widths 24 and 32, and 1 to 32
clients.

    python tools/kernel_bits.py --against DIR

builds and runs the kernels of this checkout's ``src/repro_torch`` and
of ``DIR/src/repro_torch`` (another checkout, such as a commit unpacked
with ``git archive`` into a folder that ``.gitignore`` lists), each in a
process of its own, on the same seeded inputs made on the host, and
compares every output bit for bit, NaN payloads included. Prints one
line a kernel and exits 1 on any difference. ``dump SRC OUT`` is one
tree's half: it writes that tree's outputs to ``OUT`` (``torch.save``).
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
HEAD_DIMS = (24, 32)
# (BH, S, num_ctx): the training shape (10 clients x 4 heads), predict's
# (7 groups), then ragged S and num_ctx at both ends and a long band
ATTN_SHAPES = ((40, 160, 80), (28, 160, 80), (4, 80, 60), (4, 85, 37),
               (4, 64, 0), (4, 64, 64), (4, 645, 321), (4, 37, 13))
CLIENTS = (1, 2, 3, 5, 10, 16, 17, 31, 32)
COLUMNS = (534016, 2049, 7)


def _lse_delta(q, k, v, do, nc):
    """The forward's lse and the backward's delta (rowsum(do * o)) in
    float64 on the host, so that both trees' backward kernels read the
    same operands."""
    s, hd = q.shape[1], q.shape[2]
    pos = torch.arange(s)
    keep = (pos[None, :] < nc) | (pos[None, :] == pos[:, None])
    sc = (q.double() @ k.double().transpose(1, 2)) / math.sqrt(hd)
    sc = sc.masked_fill(~keep, -math.inf)
    lse = torch.logsumexp(sc, dim=-1)
    o = torch.exp(sc - lse[..., None]) @ v.double()
    return lse.float(), (do.double() * o).sum(-1).float()


def dump(src: str, out: str) -> None:
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels.agg_reduce import (pairwise_dists_flat,
                                                trimmed_reduce_flat)
    from repro_torch.kernels.gpo_attention import (gpo_attention_bwd_dkdv,
                                                   gpo_attention_bwd_dq,
                                                   gpo_attention_fwd)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    res = {}
    for hd in HEAD_DIMS:
        for bh, s, nc in ATTN_SHAPES:
            q, k, v, do = (torch.randn((bh, s, hd), generator=g)
                           for _ in range(4))
            lse, delta = _lse_delta(q, k, v, do, nc)
            ops = [t.to(dev) for t in (q, k, v, do, lse, delta)]
            key = f"hd {hd} {bh}x{s}x{nc}"
            o, lse_k = gpo_attention_fwd(*ops[:3], num_ctx=nc)
            dk, dv = gpo_attention_bwd_dkdv(*ops, num_ctx=nc)
            res.update({
                f"gpo_attention_fwd o {key}": o,
                f"gpo_attention_fwd lse {key}": lse_k,
                f"gpo_attention_bwd_dq {key}": gpo_attention_bwd_dq(
                    *ops, num_ctx=nc),
                f"gpo_attention_bwd_dkdv dk {key}": dk,
                f"gpo_attention_bwd_dkdv dv {key}": dv})
    for c in CLIENTS:
        for p in COLUMNS:
            for ties in (False, True):
                x = torch.randn((c, p), generator=g)
                if ties:  # values on a grid of 1/2, a NaN, an infinity
                    x = torch.round(2 * x) / 2
                    x[c // 2, 1] = math.nan
                    x[c - 1, 2] = math.inf
                w = torch.rand((c,), generator=g) + 0.1
                x, w = x.to(dev), (w / w.sum()).to(dev)
                for trim in sorted({0, 1, (c - 1) // 2}):
                    if 2 * trim < c:
                        res[f"trimmed_reduce C {c} P {p} ties {ties} trim "
                            f"{trim}"] = trimmed_reduce_flat(x, w, trim=trim)
                if not ties:
                    res[f"pairwise_dists C {c} P {p}"] = \
                        pairwise_dists_flat(x)
    torch.cuda.synchronize()
    torch.save({k: t.cpu() for k, t in res.items()}, out)


def compare(a: dict, b: dict) -> bool:
    """Prints each kernel's count of bit-equal outputs; True when every
    output of ``a`` is in ``b`` with the same bits."""
    same = {}
    for key, t in a.items():
        kernel = key.split()[0]
        u = b.get(key)
        eq = (u is not None and t.shape == u.shape and t.dtype == u.dtype
              and torch.equal(t.view(torch.int32), u.view(torch.int32)))
        n, m = same.get(kernel, (0, 0))
        same[kernel] = (n + eq, m + 1)
        if not eq:
            print(f"  differs: {key}")
    for kernel, (n, m) in same.items():
        print(f"{kernel}: {n}/{m} outputs bit-equal")
    return set(a) == set(b) and all(n == m for n, m in same.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd")
    d = sub.add_parser("dump", help="one tree's outputs to a file")
    d.add_argument("src")
    d.add_argument("out")
    ap.add_argument("--against", help="the other checkout's root")
    args = ap.parse_args()
    if args.cmd == "dump":
        dump(args.src, args.out)
        return 0
    if not args.against:
        ap.error("--against DIR or dump SRC OUT")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [str(Path(tmp) / f"{n}.pt") for n in ("this", "other")]
        procs = [subprocess.Popen([sys.executable, __file__, "dump", src,
                                   out])
                 for src, out in zip((ROOT / "src",
                                      Path(args.against) / "src"), outs)]
        if any([p.wait() != 0 for p in procs]):  # wait for both
            return 1
        this, other = (torch.load(o) for o in outs)
    print(f"this checkout ({ROOT}) against {args.against}:")
    return 0 if compare(this, other) else 1


if __name__ == "__main__":
    sys.exit(main())
