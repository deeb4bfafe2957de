"""The kernels' coverage of the reference's shapes, on the CPU: the GPO
attention and its gradients at head widths the kernels pad or were not
first built for (8, 12, 16, 40), the trimmed and pairwise reduces past
32 clients (C 33 and 64, with ties, NaN and an infinity), the padding
plan against the widths the CUDA sources build, the client caps against
the sources, the select design's survivors (a numpy model of
``csrc/trimmed_reduce.cu``'s ``trimmed_select_kernel``) against the
reference's rank predicate, the tiled pairwise design's column split,
and ``gpo_tile_counts``. The port runs each kernel's plain version
here; the reference runs its Pallas kernels in interpret mode, each
shape jitted once. Tolerances: 1e-5 for the attention's output and
1e-5·(1 + |ref|) for its gradients (float32, sums in another order);
atol 1e-5 for the trimmed mean; atol 1e-5·maxᵢ‖xᵢ‖² for the pairwise
distances (the reference's expansion form cancels); NaN and infinity
where the reference has them; the rest exact.
"""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import agg_pairwise_dists as jax_pairwise_dists
from repro.kernels import agg_trimmed_reduce as jax_trimmed_reduce
from repro.kernels import gpo_attention as jax_gpo_attention
from repro_torch.kernels import gpo_attention
from repro_torch.kernels.ref import ref_gpo_attention

jax_ga = importlib.import_module("repro.kernels.gpo_attention")
ga = importlib.import_module("repro_torch.kernels.gpo_attention")
ar = importlib.import_module("repro_torch.kernels.agg_reduce")
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


def _source_int(name: str, constant: str) -> int:
    m = re.search(rf"constexpr\s+(?:int|long long)\s+{constant}\s*=\s*(\d+)",
                  (CSRC / name).read_text())
    assert m, f"{constant} not found in {name}"
    return int(m.group(1))


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("hd", [8, 12, 16, 40])
def test_gpo_attention_and_grads_match_jax_at_head_width(hd):
    """ops.gpo_attention and its gradients (the GPOAttention Function)
    against the reference's banded Pallas forward and backward."""
    s, h, nc = 37, 2, 13
    rng = np.random.default_rng(hd)
    q, k, v, do = (rng.standard_normal((s, h, hd)).astype(np.float32)
                   for _ in range(4))

    @jax.jit
    def ref(q, k, v, do):
        o, vjp = jax.vjp(lambda a, b, c: jax_gpo_attention(
            a, b, c, num_ctx=nc), q, k, v)
        return (o, *vjp(do))

    want = [np.asarray(a) for a in ref(q, k, v, do)]
    leaf = [_t(a).requires_grad_() for a in (q, k, v)]
    o = gpo_attention(*leaf, num_ctx=nc)
    grads = torch.autograd.grad(o, leaf, _t(do))
    np.testing.assert_allclose(o.detach().numpy(), want[0], rtol=0,
                               atol=1e-5)
    for got, w in zip(grads, want[1:]):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [12, 100])
def test_zero_columns_keep_the_attention_at_the_heads_own_scale(hd):
    """The padding plan's premise: q, k, v padded with zero columns to
    the built width give the head's o and lse once the scores keep the
    scale 1/√hd (the kernels take hd beside the width; here q carries
    the ratio, since the plain version scales by its operand's width)."""
    width = ga.head_width_for(hd)
    assert width > hd
    g = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn((3, 21, hd), generator=g) for _ in range(3))
    o, lse = ref_gpo_attention(q, k, v, num_ctx=9)
    qp, kp, vp = ga._padded(width, q * (width / hd) ** 0.5, k, v)
    assert qp.shape[-1] == width
    po, plse = ref_gpo_attention(qp, kp, vp, num_ctx=9)
    (po,) = ga._sliced(hd, po)
    assert po.is_contiguous() and po.shape == o.shape
    torch.testing.assert_close(po, o, rtol=0, atol=1e-6)
    torch.testing.assert_close(plse, lse, rtol=0, atol=1e-6)


def test_padding_plan_covers_every_head_width():
    """Every hd in 1..256 runs at the smallest built width at least hd,
    the widths parsed from the CUDA sources' GPO_WIDTHS; 24 and 32 run
    unpadded; 0 and 257 are refused with the limit in the message."""
    text = (CSRC / "gpo_tiles.cuh").read_text()
    block = re.search(r"#define GPO_WIDTHS\(X\)(.*?)\n(?!\s)", text,
                      re.S).group(1)
    built = tuple(int(w) for w in re.findall(r"X\((\d+)\)", block))
    assert built == ga.HEAD_WIDTHS and ga.MAX_HEAD_DIM == 256 == built[-1]
    for src in ("gpo_attention_fwd.cu", "gpo_attention_bwd.cu"):
        assert "GPO_WIDTHS(" in (CSRC / src).read_text()
    for hd in range(1, 257):
        w = ga.head_width_for(hd)
        assert w in built and w % 8 == 0 and w >= hd
        assert not [b for b in built if hd <= b < w]
    assert ga.head_width_for(24) == 24 and ga.head_width_for(32) == 32
    for hd in (0, 257):
        with pytest.raises(ValueError, match="head_dim 1 to 256"):
            ga.head_width_for(hd)
    x = torch.zeros((1, 4, 257))
    with pytest.raises(ValueError, match="head_dim 1 to 256"):
        ga.gpo_attention_fwd(x, x, x, num_ctx=2)
    r = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="head_dim 1 to 256"):
        ga.gpo_attention_bwd_dq(x, x, x, x, r, r, num_ctx=2)


@pytest.mark.parametrize("s,bq,bk", [
    (16, 16, 16), (64, 16, 16), (128, 32, 32), (160, 32, 32),
    (256, 64, 64), (512, 128, 128), (128, 128, 128), (96, 32, 16)])
def test_gpo_tile_counts_match_the_reference(s, bq, bk):
    """Both counts over num_ctx from 0 to S, the saturated band (the
    full grid) included."""
    for nc in sorted({0, 1, 13, bk, s // 2, s - 1, s}):
        for fn in ("gpo_tile_counts", "gpo_tile_counts_bwd"):
            assert getattr(ga, fn)(s, nc, bq, bk) == \
                getattr(jax_ga, fn)(s, nc, bq, bk), (fn, s, nc, bq, bk)
    # the band saturates at num_ctx = S: both equal the full grid
    banded, full = ga.gpo_tile_counts(s, s, bq, bk)
    assert banded == full == (s // bq) * (s // bk)


# ------------------------------------------------------------------ reduces

def _deltas(c: int, p: int, seed: int) -> np.ndarray:
    """Values on a grid of 1/2 (many ties), NaN in two entries and in a
    whole column, an infinity, a -0 beside +0s."""
    rng = np.random.default_rng(seed)
    x = (np.round(2 * rng.standard_normal((c, p))) / 2).astype(np.float32)
    x[3, 5] = np.nan
    x[c // 2, 11] = np.nan
    x[:, 7] = np.nan
    x[c - 1, 13] = np.inf
    x[4, 17] = -0.0
    return x


def _weights(c: int, seed: int) -> np.ndarray:
    w = np.random.default_rng(seed).random(c).astype(np.float32) + 0.1
    return w / w.sum()


@pytest.mark.parametrize("c", [33, 64])
def test_trimmed_reduce_matches_jax_past_32_clients(c):
    x, w = _deltas(c, 300, c), _weights(c, c + 1)
    for trim in (0, 1, (c - 1) // 2):
        want = np.asarray(jax_trimmed_reduce(jnp.asarray(x), jnp.asarray(w),
                                             trim=trim))
        got = ar.trimmed_reduce_flat(_t(x), _t(w), trim=trim).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert np.isnan(want[7]) and np.isnan(want[5])


@pytest.mark.parametrize("c", [33, 64])
def test_pairwise_matches_jax_past_32_clients(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((c, 3000)).astype(np.float32)
    want = np.asarray(jax_pairwise_dists(jnp.asarray(x)))
    got = ar.pairwise_dists_flat(_t(x))
    atol = 1e-5 * float((x.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    assert torch.equal(got, got.T) and (torch.diagonal(got) == 0).all()


def _order_keys(x: np.ndarray) -> np.ndarray:
    """trimmed_reduce.cu's order_key: f32 bits in unsigned float order,
    -0 as +0."""
    b = x.view(np.uint32).copy()
    b[(b << np.uint32(1)) == 0] = 0
    neg = (b >> np.uint32(31)).astype(bool)
    return np.where(neg, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def _select_rank(keys: np.ndarray, r: np.ndarray):
    """select_rank on every column at once: the key at rank r of each
    column and its position among the clients of that key."""
    prefix = np.zeros(keys.shape[1], np.uint32)
    r = r.astype(np.int64).copy()
    for b in range(31, -1, -1):
        n = (((keys ^ prefix) >> np.uint32(b)) == 0).sum(axis=0)
        take = r >= n
        prefix = prefix | (take.astype(np.uint32) << np.uint32(b))
        r = r - n * take
    return prefix, r


def _select_model(x: np.ndarray, w: np.ndarray, trim: int):
    """(out, survivors) of trimmed_select_kernel: the two selects, then
    the walk in client order with the keep-or-zero weight."""
    c, p = x.shape
    keys = _order_keys(x)
    if trim == 0:
        kl, pl = np.zeros(p, np.uint32), np.zeros(p, np.int64)
        kh, ph = np.full(p, 0xFFFFFFFF, np.uint32), np.full(p, c)
    else:
        kl, pl = _select_rank(keys, np.full(p, trim))
        kh, ph = _select_rank(keys, np.full(p, c - 1 - trim))
    nl = np.zeros(p, np.int64)
    nh = np.zeros(p, np.int64)
    num = np.zeros(p, np.float32)
    den = np.zeros(p, np.float32)
    keep = np.zeros((c, p), bool)
    for i in range(c):
        u = keys[i]
        keep[i] = (((u > kl) | ((u == kl) & (nl >= pl)))
                   & ((u < kh) | ((u == kh) & (nh <= ph))))
        nl += u == kl
        nh += u == kh
        wc = np.where(keep[i], w[i], np.float32(0))
        with np.errstate(invalid="ignore"):
            num = (num + wc * x[i]).astype(np.float32)
        den = (den + wc).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        return num / den, keep


def _reference_survivors(x: np.ndarray, trim: int) -> np.ndarray:
    """_trim_kernel's predicate: client i's rank counts the clients j
    with x_j < x_i, or x_j == x_i and j < i."""
    c = x.shape[0]
    j = np.arange(c)[:, None, None]
    i = np.arange(c)[None, :, None]
    before = (x[:, None, :] < x[None, :, :]) | (
        (x[:, None, :] == x[None, :, :]) & (j < i))
    rank = before.sum(axis=0)
    return (rank >= trim) & (rank < c - trim)


@pytest.mark.parametrize("c", [33, 64, 97])
def test_select_model_keeps_the_reference_survivors(c):
    """The select design's survivors equal the reference predicate's
    wherever a column holds no NaN (a NaN column is NaN in both, as
    keep · w · x is NaN for a dropped NaN), and its trimmed mean is the
    plain version's, which the test above holds to the reference
    kernel."""
    x, w = _deltas(c, 120, c + 7), _weights(c, c + 8)
    clean = ~np.isnan(x).any(axis=0)
    for trim in sorted({0, 1, int(0.1 * c), (c - 1) // 2}):
        out, keep = _select_model(x, w, trim)
        want_keep = _reference_survivors(x, trim)
        np.testing.assert_array_equal(keep[:, clean], want_keep[:, clean])
        assert (keep.sum(axis=0)[clean] == c - 2 * trim).all()
        want = ar.trimmed_reduce_flat(_t(x), _t(w), trim=trim).numpy()
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


def test_client_caps_and_splits_match_the_sources():
    """Neither source caps C (no kMaxSelect, kMaxTiled, nor a
    MAX_CLIENTS in the wrapper), REGISTER_CLIENTS is their C <= 32
    designs' cap; the pairwise split is the sources' stage and chunk,
    and it keeps the f64 partials within PAIRWISE_BUDGET while one
    partial fits it, one column chunk past that."""
    assert not hasattr(ar, "MAX_CLIENTS")
    for src in ("trimmed_reduce.cu", "pairwise_dists.cu"):
        text = (CSRC / src).read_text()
        assert "kMaxSelect" not in text and "kMaxTiled" not in text
    assert ar.REGISTER_CLIENTS == 32 == _source_int(
        "trimmed_reduce.cu", "kMaxClients") == _source_int(
        "pairwise_dists.cu", "kMaxClients")
    assert ar.PAIRWISE_CHUNK == _source_int("pairwise_dists.cu", "kChunk")
    t_steps, t_warps = (_source_int("pairwise_dists.cu", k)
                        for k in ("kTSteps", "kTThreads"))
    assert ar.PAIRWISE_STAGE == 8 * t_steps * (t_warps // 32)
    for c in (1, 10, 32, 33, 64, 200, 1024, 4096, 8192):
        assert ar.trimmed_design_for(c) == (
            "registers" if c <= 32 else "select")
        assert ar.pairwise_design_for(c) == (
            "one_tile" if c <= 32 else "tiled")
        for p in (1, 4095, 4096, 534016, 4399105, 494032768):
            chunk, nb = ar.pairwise_split(c, p)
            assert nb == -(-p // chunk) and chunk >= ar.PAIRWISE_CHUNK
            if c <= 32:
                assert chunk == ar.PAIRWISE_CHUNK
            else:
                assert chunk % ar.PAIRWISE_STAGE == 0
                assert nb * c * c * 8 <= max(ar.PAIRWISE_BUDGET,
                                             c * c * 8)
                if c * c * 8 > ar.PAIRWISE_BUDGET:
                    assert nb == 1
    assert ar.pairwise_split(1024, 534016) == (16768, 32)


def test_spawn_gives_a_bare_cuda_device_its_index(monkeypatch):
    """The dry run's ``--gpo-fed`` on the card hands ``spawn`` the
    device ``cuda``: each rank sets its device by index, so a CUDA
    device without one becomes the current one."""
    mesh = importlib.import_module("repro_torch.launch.mesh")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh._rank_devices(2, "cuda") == [torch.device("cuda", 0)] * 2
    assert mesh._rank_devices(2, torch.device("cuda")) == \
        [torch.device("cuda", 0)] * 2
    assert mesh._rank_devices(2, "cpu") == [torch.device("cpu")] * 2
    assert mesh._rank_devices(1, None) == [torch.device("cuda", 0)]
