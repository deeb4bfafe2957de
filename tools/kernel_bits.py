"""Bit-for-bit comparison of the kernels of two source trees on one
card, at the shapes whose designs are meant to stay as they were: the
GPO attention at head widths 24 and 32; the trimmed and pairwise
kernels at 1 to 32 clients and at 33 to 1024; the flash forward at
head widths 64 and 128; the SSD scan at chunks up to 128, p up to 64
and n up to 128; the clip and quant kernels in each design up to 4096
clients.

    python tools/kernel_bits.py --against DIR

builds and runs the kernels of this checkout's ``src/repro_torch`` and
of ``DIR/src/repro_torch`` (another checkout, such as a commit unpacked
with ``git archive`` into a folder that ``.gitignore`` lists), each in a
process of its own, on the same seeded inputs made on the host, and
compares every output bit for bit, NaN payloads included. Prints one
line a kernel and exits 1 on any difference, with one exception: a
trimmed output whose input column holds a NaN or an infinity may differ
where this checkout's output is NaN and the plain version's is NaN too
(a NaN or an infinity trimmed away makes the column NaN in the
reference, ROADMAP C.13); those are counted and printed apart. ``dump SRC OUT`` is one
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
# the select and tiled designs at P 2049
WIDE_CLIENTS = (33, 100, 1024)
# flash: (B, S, H, KV, keyword arguments) at head widths 64 and 128
FLASH_HEAD_DIMS = (64, 128)
FLASH_CASES = ((2, 257, 4, 2, {}), (1, 128, 4, 2, {"window": 7,
                                                   "softcap": 20.0}),
               (2, 100, 4, 2, {"causal": False, "kv_len": 77}),
               (1, 300, 14, 2, {}))
# SSD: (b, s, h, p, n, chunk), s a multiple of the chunk
SSD_SHAPES = ((2, 64, 3, 16, 8, 16), (2, 384, 4, 64, 128, 128),
              (2, 256, 4, 64, 64, 128), (2, 320, 4, 64, 128, 64),
              (2, 100, 4, 64, 128, 20), (1, 512, 8, 64, 128, 128),
              (2, 64, 3, 10, 12, 16), (4, 384, 48, 64, 128, 128))
# clip and quant: (C, P) through the on-chip design (10, 534016), the
# two-launch / three-pass one (48, 534016) and (4096, 8192), and small
# shapes
ROW_SHAPES = ((10, 534016), (48, 534016), (3, 2049), (1, 7), (32, 5001),
              (4096, 8192))


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
    from repro_torch.kernels.agg_reduce import (clip_reduce_flat,
                                                pairwise_dists_flat,
                                                quant_clip_reduce_flat,
                                                trimmed_reduce_flat)
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.gpo_attention import (gpo_attention_bwd_dkdv,
                                                   gpo_attention_bwd_dq,
                                                   gpo_attention_fwd)
    from repro_torch.kernels.ref import ref_trimmed_flat
    from repro_torch.kernels.ssd_scan import ssd_scan_bhsp
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
    for c, p in [(c, p) for c in CLIENTS for p in COLUMNS] + [
        (c, 2049) for c in WIDE_CLIENTS]:
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
                    key = f"C {c} P {p} ties {ties} trim {trim}"
                    res[f"trimmed_reduce {key}"] = trimmed_reduce_flat(
                        x, w, trim=trim)
                    if ties:
                        res[f"trimmed_plain {key}"] = ref_trimmed_flat(
                            x.cpu(), w.cpu(), trim=trim)
            if not ties:
                res[f"pairwise_dists C {c} P {p}"] = \
                    pairwise_dists_flat(x)
    for hd in FLASH_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for b, s, h, kv, kw in FLASH_CASES:
                q = torch.randn((b, h, s, hd), generator=g)
                k, v = (torch.randn((b, kv, s, hd), generator=g)
                        for _ in range(2))
                q, k, v = (t.to(dev, dtype) for t in (q, k, v))
                res[f"flash_attention hd {hd} {str(dtype)[6:]} {b}x{s}x{h}x"
                    f"{kv} {kw}"] = flash_attention_bhsd(q, k, v, **kw)
    for b, s, h, p, n, chunk in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, s, h, p), generator=g) * 0.5
            dt = torch.nn.functional.softplus(torch.randn((b, s, h),
                                                          generator=g))
            a_log = torch.randn((h,), generator=g) * 0.5
            bm, cm = (torch.randn((b, s, n), generator=g) * 0.5
                      for _ in range(2))
            d = torch.randn((h,), generator=g)
            y, state = ssd_scan_bhsp(
                x.to(dev, dtype), dt.to(dev), a_log.to(dev),
                bm.to(dev, dtype), cm.to(dev, dtype), d.to(dev),
                chunk=chunk, return_state=True)
            key = f"{str(dtype)[6:]} {b}x{s}x{h}x{p}x{n} chunk {chunk}"
            res[f"ssd_scan y {key}"] = y
            res[f"ssd_scan state {key}"] = state
    for c, p in ROW_SHAPES:
        x, noise, uni, resid = (torch.randn((c, p), generator=g)
                                for _ in range(4))
        x, noise, resid = x.to(dev), (0.01 * noise).to(dev), \
            (0.01 * resid).to(dev)
        uni = uni.uniform_(generator=g).to(dev)
        w = torch.rand((c,), generator=g) + 0.1
        w = (w / w.sum()).to(dev)
        # a clip that binds for some rows and not others
        clip = float(x.norm(dim=1).median())
        key = f"C {c} P {p}"
        res[f"clip_reduce noise {key}"] = clip_reduce_flat(
            x, w, clip=clip, noise=noise)
        res[f"clip_reduce {key}"] = clip_reduce_flat(x, w, clip=clip)
        for label, kw in (("int8_ef", dict(uniform=uni, resid=resid)),
                          ("dp_int8_ef", dict(clip=clip, noise=noise,
                                              uniform=uni, resid=resid)),
                          ("clip rint", dict(clip=clip))):
            red, new_resid = quant_clip_reduce_flat(x, w, **kw)
            res[f"quant_clip_reduce out {label} {key}"] = red
            if new_resid is not None:
                res[f"quant_clip_reduce resid {label} {key}"] = new_resid
        del x, noise, uni, resid
    torch.cuda.synchronize()
    torch.save({k: t.cpu() for k, t in res.items()}, out)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _nan_as_plain(key: str, t, u, a: dict) -> int:
    """The elements where the trimmed output ``t`` (this checkout's)
    differs from ``u`` (the other's) when each of them is NaN in ``t``
    and in the plain version on the same inputs; else 0."""
    plain = a.get(key.replace("trimmed_reduce", "trimmed_plain", 1))
    if plain is None or t.shape != u.shape:
        return 0
    diff = _bits(t) != _bits(u)
    ok = bool((torch.isnan(t[diff]) & torch.isnan(plain[diff])).all())
    return int(diff.sum()) if ok else 0


def compare(a: dict, b: dict) -> bool:
    """Prints each kernel's count of bit-equal outputs; True when every
    output of ``a`` (this checkout's) is in ``b`` with the same bits, or
    is a trimmed output that differs only where ``a`` is NaN as the plain
    version is (``_nan_as_plain``)."""
    same, c13 = {}, {}
    for key, t in a.items():
        kernel = key.split()[0]
        u = b.get(key)
        eq = (u is not None and t.shape == u.shape and t.dtype == u.dtype
              and torch.equal(_bits(t), _bits(u)))
        nan = (not eq and kernel == "trimmed_reduce" and u is not None
               and _nan_as_plain(key, t, u, a))
        n, m = same.get(kernel, (0, 0))
        same[kernel] = (n + eq, m + 1)
        if nan:
            c13[kernel] = c13.get(kernel, 0) + 1
            print(f"  NaN where the plain version is NaN ({nan} "
                  f"elements): {key}")
        elif not eq:
            print(f"  differs: {key}")
    for kernel, (n, m) in same.items():
        extra = (f"; the other {c13[kernel]} differ only where the output "
                 f"and the plain version are NaN" if kernel in c13 else "")
        print(f"{kernel}: {n}/{m} outputs bit-equal{extra}")
    return set(a) == set(b) and all(n + c13.get(k, 0) == m
                                    for k, (n, m) in same.items())


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
