"""The kernels' last shape limits, port against reference on the CPU:
the flash forward at head widths the CUDA sources pad or were not
first built for (1, 8, 16, 80, 96, 256), the SSD scan past its tiles (chunk
256, p 96, n 192), the clip and quant reduces past 4096 clients, the
trimmed reduce with NaN and infinities at C <= 32 (a NaN or an infinity
trimmed away makes the column NaN, as the reference's keep·w·x does),
and the trimmed and pairwise reduces past 1024 clients.

Both packages get the same numpy inputs (seeded). The reference's
wrappers run their Pallas kernels in interpret mode, each shape jitted
once; past 1024 clients the reference's ``kernels/ref.py`` functions
stand in for its trimmed kernel, whose compares unroll over C. The
port's wrappers run each kernel's plain version here. Beside them: the
premises the CUDA designs rest on (zero columns leave the attention at
the head's own scale; a chunk run as 128-row tiles and n run in
128-wide slices give the same scan) and the padding plan against the
widths the flash sources build.

Tolerances: flash 2e-5·(1 + |ref|) in f32 and 2e-2 in bf16; the SSD
scan 1e-4; clip 1e-5; quant within one int8 level and beyond 2e-5 on at
most 1% of the coordinates (C.5's allowance: a level flips where the
two packages' scales differ by an ulp); trimmed NaN where the reference
is NaN, elsewhere 1e-6; pairwise 1e-5·maxᵢ‖xᵢ‖².
"""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import agg_clip_reduce as jax_clip_reduce
from repro.kernels import agg_quant_clip_reduce as jax_quant_clip_reduce
from repro.kernels import agg_trimmed_reduce as jax_trimmed_reduce
from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import ssd_scan as jax_ssd_scan
from repro.kernels.ref import ref_pairwise_sq_dists as jax_ref_pairwise
from repro.kernels.ref import ref_trimmed_flat as jax_ref_trimmed
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_attention, ref_ssd
from repro_torch.models.ssm import ssd_chunked

ar = importlib.import_module("repro_torch.kernels.agg_reduce")
fa = importlib.import_module("repro_torch.kernels.flash_attention")
sd = importlib.import_module("repro_torch.kernels.ssd_scan")
CSRC = Path(ar.__file__).resolve().parent / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


# ------------------------------------------------------------------ flash

@pytest.mark.parametrize("hd", [1, 8, 16, 80, 96, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_at_head_width(hd, dtype):
    """ops.flash_attention against the reference's Pallas kernel, GQA
    (4 query heads on 2), causal with a window and a softcap."""
    rng = np.random.default_rng(hd)
    b, s, h, kv = 1, 64, 4, 2
    q, k, v = (rng.standard_normal((b, s, n, hd), np.float32)
               for n in (h, kv, kv))
    kw = dict(causal=True, window=33, softcap=20.0)
    want = jax_flash_attention(*(jnp.asarray(a).astype(dtype)
                                 for a in (q, k, v)), bq=64, bk=64, **kw)
    got = ops.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                for a in (q, k, v)), bq=64, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [1, 40, 100, 200])
def test_zero_columns_keep_flash_at_the_heads_own_scale(hd):
    """The padding plan's premise: q, k, v padded with zero columns to
    the built width give the head's o once the scores keep the scale
    1/√hd (the kernel takes hd beside the width; here q carries the
    ratio, since the plain version scales by its operand's width), with
    a ragged kv_len, non-causal."""
    width = fa.head_width_for(hd)
    assert width > hd
    g = torch.Generator().manual_seed(hd)
    q = torch.randn((2, 4, 37, hd), generator=g)
    k, v = (torch.randn((2, 2, 37, hd), generator=g) for _ in range(2))
    kw = dict(causal=False, kv_len=30, softcap=20.0)
    o = ref_attention(q, k, v, **kw)

    def pad(t):
        return torch.nn.functional.pad(t, (0, width - hd))

    po = ref_attention(pad(q * (width / hd) ** 0.5), pad(k), pad(v), **kw)
    assert bool((po[..., hd:] == 0).all())
    torch.testing.assert_close(po[..., :hd], o, rtol=0, atol=2e-6)


# chip_smoke.py's FLASH_BF16_ROW_TOL: the largest row error (2-norms) a
# bf16 flash output may have against the f32 plain version on the card
FLASH_BF16_ROW_TOL = 6.9e-3
# chip_smoke.py's LIMIT_FLASH_CASES: (B, S, H, KV, keyword arguments)
NARROW_CASES = ((2, 257, 4, 2, {"causal": True}),
                (1, 128, 4, 4, {"causal": True, "window": 7,
                                "softcap": 20.0}),
                (2, 100, 4, 4, {"causal": False, "kv_len": 77}))


def _bf16_parts(p: torch.Tensor, parts: int) -> torch.Tensor:
    """p as the sum of ``parts`` bf16 numbers, each the bf16 of what the
    parts before it leave (``split3_bf16`` in csrc/mma_bf16.cuh at 3)."""
    out, rest = torch.zeros_like(p), p.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out, rest = out + part.double(), rest - part
    return out


def _row_error_of_rounding(hd: int, parts: int, seed: int) -> float:
    """The largest row error, against attention in float64, of a plain
    model of the bf16 flash kernel's rounding: p to P·V in ``parts``
    bf16 parts (the kernel rounds against the running max, the model
    against the row's), l of the unrounded p, o rounded to bf16 once;
    over NARROW_CASES on bf16 inputs."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for b, s, h, kv, kw in NARROW_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, n, s, hd)))
                   .to(torch.bfloat16).double() for n in (h, kv, kv))
        k, v = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
        sc = q @ k.transpose(-1, -2) / hd ** 0.5
        if kw.get("softcap"):
            sc = kw["softcap"] * torch.tanh(sc / kw["softcap"])
        i, j = torch.arange(s)[:, None], torch.arange(s)[None]
        ok = j < kw.get("kv_len", s)
        if kw["causal"]:
            ok = ok & (j <= i)
        if kw.get("window"):
            ok = ok & (i - j < kw["window"])
        p = torch.exp(sc.masked_fill(~ok, -1e30)
                      - sc.masked_fill(~ok, -1e30).amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        exact = (p @ v) / l
        got = ((_bf16_parts(p, parts) @ v) / l).to(torch.bfloat16).double()
        rows = (torch.linalg.vector_norm(got - exact, dim=-1)
                / torch.linalg.vector_norm(exact, dim=-1).clamp_min(1e-30))
        worst = max(worst, rows.max().item())
    return worst


@pytest.mark.parametrize("hd", [1, 8, 16])
def test_narrow_heads_take_p_in_three_parts(hd):
    """The narrow kernel's premise (heads of 1 to 16 columns run at the
    built width 16, whose bf16 kernel takes p in three parts): p rounded
    once to bf16 costs a row of one number more than the card's row
    limit, and p in three bf16 parts keeps every row within it at hd 1,
    8 and 16, o's own rounding (at most 2^-8) being what is left."""
    three = _row_error_of_rounding(hd, 3, seed=hd)
    assert three <= FLASH_BF16_ROW_TOL
    assert three <= 2.0 ** -8 + 1e-4
    if hd == 1:
        assert _row_error_of_rounding(hd, 1, seed=hd) > FLASH_BF16_ROW_TOL


def test_flash_padding_plan_covers_every_head_width():
    """Every hd in 1..256 runs at the smallest built width at least hd,
    the widths parsed from the two flash sources' FLASH_WIDTHS (each
    source its own); 64 and 128 run unpadded; 0 and 257 are refused."""
    built = {}
    for name in fa.SOURCE_WIDTHS:
        text = (CSRC / f"{name}.cu").read_text()
        m = re.search(r"#define FLASH_WIDTHS ([\d, ]+)\n", text)
        built[name] = tuple(int(w) for w in m.group(1).split(","))
        assert f"{name}_launch(" in text
    assert built == fa.SOURCE_WIDTHS
    assert sorted(w for ws in built.values() for w in ws) == list(
        fa.HEAD_WIDTHS)
    assert all(w % 16 == 0 for w in fa.HEAD_WIDTHS)
    assert fa.HEAD_WIDTHS[-1] == 256
    for hd in range(1, 257):
        w = fa.head_width_for(hd)
        assert w >= hd and not any(hd <= u < w for u in fa.HEAD_WIDTHS)
    assert fa.head_width_for(64) == 64 and fa.head_width_for(128) == 128
    for bad in (0, 257):
        with pytest.raises(ValueError, match=f"head_dim {bad}"):
            fa.flash_attention_bhsd(*(torch.zeros((1, 2, 8, bad))
                                      for _ in range(3)))


# -------------------------------------------------------------------- SSD

def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [(rng.standard_normal((b, s, h, p)) * 0.5).astype(f),
            np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f),
            (rng.standard_normal(h) * 0.5).astype(f),
            (rng.standard_normal((b, s, n)) * 0.5).astype(f),
            (rng.standard_normal((b, s, n)) * 0.5).astype(f),
            rng.standard_normal(h).astype(f)]


def test_ssd_scan_matches_jax_past_the_tiles():
    """ops.ssd_scan at chunk 256, p 96 and n 192 (each past the kernels'
    128-row, 64-column and 128-state tiles) against the reference's
    Pallas kernel at chunk 256."""
    inp = _ssd_inputs(7, 1, 512, 2, 96, 192)
    want = jax_ssd_scan(*(jnp.asarray(a) for a in inp), chunk=256)
    got, state = ops.ssd_scan_with_state(*(_t(a) for a in inp), chunk=256)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)
    assert state.shape == (1, 2, 96, 192)


def test_ssd_tiles_and_slices_give_the_same_scan():
    """The premises of the CUDA designs past the tiles, on the plain
    versions: a chunk of 256 run as two 128-row pieces with the state
    carried (the chunked scan at chunk 128) is the same function as the
    scan at chunk 256; and y at n 192 is D·x plus the shares of the
    n slices [0, 128) and [128, 192), each run with D = 0, whose states
    are the state's column slices."""
    x, dt, a_log, bm, cm, d = (_t(a) for a in _ssd_inputs(9, 2, 512, 3, 96,
                                                         192))
    y, state = ref_ssd(x, dt, a_log, bm, cm, d)
    for chunk in (128, 256):
        yc, sc = ssd_chunked(x, dt, a_log, bm, cm, d, chunk=chunk)
        torch.testing.assert_close(yc, y, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(sc, state, rtol=1e-4, atol=1e-4)
    zero = torch.zeros_like(d)
    parts = [ref_ssd(x, dt, a_log, bm[..., sl].contiguous(),
                     cm[..., sl].contiguous(), zero)
             for sl in (slice(0, 128), slice(128, 192))]
    ys = parts[0][0] + parts[1][0] + x * d[None, None, :, None]
    torch.testing.assert_close(ys, y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([s for _, s in parts], dim=-1),
                               state, rtol=1e-6, atol=1e-6)


def test_ssd_wrapper_takes_any_chunk_p_and_n():
    """The contract keeps only the chunk dividing s and positive sizes:
    chunk 256 and 384, p 200 and n 300 run on the CPU."""
    for s, chunk, p, n in ((256, 256, 8, 4), (384, 384, 4, 8),
                           (32, 16, 200, 4), (32, 16, 4, 300)):
        x, dt, a_log, bm, cm, d = (_t(a) for a in _ssd_inputs(3, 1, s, 2,
                                                             p, n))
        y, state = sd.ssd_scan_bhsp(x, dt, a_log, bm, cm, d, chunk=chunk,
                                    return_state=True)
        assert y.shape == x.shape and state.shape == (1, 2, p, n)
    with pytest.raises(ValueError, match="divide"):
        sd.ssd_scan_bhsp(x, dt, a_log, bm, cm, d, chunk=24)
    assert sd.p_width_for(4, 48, 200, 132) == 64
    # the wrapper's n slice is the source's tile
    text = (CSRC / "ssd_scan.cu").read_text()
    assert sd.TILE_N == int(re.search(r"constexpr int kMaxN = (\d+);",
                                      text).group(1))


# -------------------------------------------------------- clip and quant

C_WIDE = 4100  # past the 4096 clients whose scales live in shared memory


def _rows(c, p, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((c, p)) * 3.0).astype(np.float32)
    x[::2] *= 10.0
    w = np.exp(rng.standard_normal(c)).astype(np.float32)
    w /= w.sum()
    noise = (0.3 * rng.standard_normal((c, p))).astype(np.float32)
    resid = (0.5 * rng.standard_normal((c, p))).astype(np.float32)
    uniform = rng.random((c, p), dtype=np.float32)
    return x, w, noise, resid, uniform


def _assert_levels(got, want, s_max):
    """Within one quantization level, and beyond 2e-5 on at most 1% of
    the coordinates."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 + s_max)
    off = np.abs(got - want) > 2e-5 + 2e-5 * np.abs(want)
    assert off.mean() <= 0.01, off.mean()


def test_clip_and_quant_reduces_match_jax_past_4096_clients():
    """clip_reduce_flat (with and without noise) and
    quant_clip_reduce_flat (int8 with error feedback, and with the clip
    and noise too) at 4100 clients against the reference's kernels."""
    x, w, noise, resid, uniform = _rows(C_WIDE, 24, 11)
    clip = float(np.median(np.linalg.norm(x, axis=1)))
    for nz in (None, noise):
        got = ar.clip_reduce_flat(_t(x), _t(w), clip=clip,
                                  noise=None if nz is None else _t(nz))
        want = jax_clip_reduce(jnp.asarray(x), jnp.asarray(w), clip=clip,
                               noise=None if nz is None else jnp.asarray(nz))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    s_max = float(np.abs(x).max() / 127.0)
    for kw in (dict(uniform=uniform, resid=resid),
               dict(clip=clip, noise=noise, uniform=uniform, resid=resid)):
        out, er = ar.quant_clip_reduce_flat(
            _t(x), _t(w), **{k: (_t(v) if isinstance(v, np.ndarray) else v)
                             for k, v in kw.items()})
        jout, jer = jax_quant_clip_reduce(
            jnp.asarray(x), jnp.asarray(w),
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
        _assert_levels(out.numpy(), jout, s_max)
        _assert_levels(er.numpy(), jer, s_max)


# -------------------------------------------------------- trimmed, pairwise

@pytest.mark.parametrize("c", [5, 17, 32])
def test_trimmed_nan_and_infinities_match_jax(c):
    """The register design's clients (C <= 32) with a NaN, +inf and -inf
    in some columns and a whole NaN column: the reference's kernel makes
    a column NaN wherever a NaN or an infinity is trimmed away (keep·w·x
    with keep = 0); the port's result is NaN exactly there, and the rest
    within 1e-6."""
    rng = np.random.default_rng(c)
    x = np.round(2 * rng.standard_normal((c, 40))).astype(np.float32) / 2
    x[1, 3] = np.nan
    x[c - 1, 5] = np.inf
    x[0, 7] = -np.inf
    x[c // 2, 9] = np.inf
    x[2, 9] = -np.inf
    x[:, 11] = np.nan
    w = (rng.random(c) + 0.1).astype(np.float32)
    w /= w.sum()
    for trim in sorted({1, (c - 1) // 2}):
        got = ar.trimmed_reduce_flat(_t(x), _t(w), trim=trim).numpy()
        want = np.asarray(jax_trimmed_reduce(jnp.asarray(x), jnp.asarray(w),
                                             trim=trim))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[[5, 7, 9]]).all()  # the trimmed infinities
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[np.isinf(want)],
                                      want[np.isinf(want)])


def test_trimmed_and_pairwise_match_the_reference_past_1024_clients():
    """trimmed_reduce_flat (ties on a grid of 1/2; trim 1, a tenth and
    the median) and pairwise_dists_flat at 1100 clients against the
    reference's plain functions."""
    c, p = 1100, 16
    rng = np.random.default_rng(5)
    x = np.round(2 * rng.standard_normal((c, p))).astype(np.float32) / 2
    w = (rng.random(c) + 0.1).astype(np.float32)
    w /= w.sum()
    for trim in (1, c // 10, (c - 1) // 2):
        got = ar.trimmed_reduce_flat(_t(x), _t(w), trim=trim).numpy()
        want = np.asarray(jax_ref_trimmed(jnp.asarray(x), jnp.asarray(w),
                                          trim=trim))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got = ar.pairwise_dists_flat(_t(x)).numpy()
    want = np.asarray(jax_ref_pairwise(jnp.asarray(x)))
    atol = 1e-5 * float((x * x).sum(axis=1).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert ar.pairwise_design_for(c) == "tiled"
    assert ar.trimmed_design_for(c) == "select"
