"""The pairwise-distance kernel's precision scheme, modelled on the CPU.

``csrc/pairwise_dists.cu`` computes Krum's distances from the clients'
Gram matrix G = X·Xᵀ on TF32 tensor cores: d_ij = G_ii + G_jj − 2·G_ij,
clamped at 0. Warp w of a block takes the k-steps (8 columns) w, w + 16,
... of its 4096 columns, 4 a stage of 512 columns (2 of 256 when C >
16). Each f32 value x is split on its row's grid over the warp's k-steps
of the stage: big = x rounded to a multiple of 2^(e − 9), 2^e above
their largest |x| of the row (at most 10 significant bits, a TF32
value), and small = x − big, which the tensor cores read truncated to
TF32 (``tests/test_torch_gpo_bwd_numerics.py``'s rounding helpers). All
of those bigs of a row are multiples of one step, so big·big's 32
products are exact and so is their chained sum hi: the tensor cores'
rounding toward zero never touches it. The three small terms (small·big,
big·small, small·small) come from one product and its transpose: L =
small·(big + small/2)ᵀ as two products, small·big and small·(small/2),
chained; hi and L start from zero each stage and go into the warp's f32
sums, and the block's Gram is hi + (L + Lᵀ), the warps' added in warp
order in
float64, and the blocks' in float64 in the finishing launch's order (lane
l takes blocks l, l + 32, ..., then a butterfly). The model below repeats
that arithmetic with plain PyTorch ops; it rounds L to nearest where
the tensor cores round each of its products toward zero (about 2^-33 of
a stage, which only the card measures: ``chip_smoke.py`` phase 1).

It is held to ``repro.kernels.agg_reduce.pairwise_dists_flat`` in
interpret mode within the card check's 1e-5·maxᵢ‖xᵢ‖², and to the
distances in float64: its mean error off the diagonal at most 1.5× that
of the f32 expansion form in plain PyTorch, the card check's limit. One
TF32 pass (big·big alone) misses that limit by far. Krum's selection on
the model's distances is the one on float64 distances. The model lives
here only; no path of the port runs it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gpo_bwd_numerics import _truncate_tf32

from repro.kernels.agg_reduce import pairwise_dists_flat as jax_pairwise
from repro_torch.core import aggregation

F32, F64 = torch.float32, torch.float64
F64_RATIO = 1.5  # chip_smoke.PAIRWISE_F64_RATIO
CHUNK, KSTEP, WARPS, LANES = 4096, 8, 16, 32  # the kernel's constants
SHAPES = [(10, 65536), (32, 5001)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid_split(xs: torch.Tensor):
    """xs (..., n), one row's values on one grid -> (big, small) as the
    kernel splits them: the grid 2^(e − 9) with e = the biased exponent
    of their max |x| − 126, clamped to [−116, 117]."""
    m = xs.abs().amax(-1, keepdim=True)
    q = ((m.view(torch.int32) >> 23) - 135).clamp(-116, 117)
    step = ((q + 127) << 23).view(F32)
    inv = ((127 - q) << 23).view(F32)
    big = torch.round(xs * inv) * step  # round half to even, as rintf
    return big, xs - big


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """(C, P) -> (C, blocks, k-steps a block, 8), zero-padded."""
    c, p = x.shape
    nb = -(-p // CHUNK)
    xp = torch.zeros((c, nb * CHUNK), dtype=F32)
    xp[:, :p] = x
    return xp.view(c, nb, CHUNK // KSTEP, KSTEP)


def _kernel_model(x: torch.Tensor, passes: int = 4) -> torch.Tensor:
    """(C, C) distances of the kernel's arithmetic: big·big and the three
    small terms (``passes`` 4, as hi + L + Lᵀ), or big·big alone (1)."""
    c = x.shape[0]
    cols = 512 if c <= 16 else 256  # a stage's columns
    steps = cols // KSTEP // WARPS  # a warp's k-steps a stage
    xb = _blocks(x)
    nb, nst = xb.shape[1], CHUNK // cols
    # k-step stage·cols/8 + kk·16 + w -> (stage, warp w, its k-steps)
    v = xb.view(c, nb, nst, steps, WARPS, KSTEP).transpose(3, 4)
    big, small = _grid_split(v.reshape(c, nb, nst, WARPS, steps * KSTEP))
    b64, s64 = big.double(), _truncate_tf32(small).double()
    eq = "ibswk,jbswk->bswij"
    hi = torch.einsum(eq, b64, b64)  # exact: products and chained sum
    assert torch.equal(hi.to(F32).double(), hi)
    acc_hi = torch.zeros((nb, WARPS, c, c), dtype=F32)
    acc_l = torch.zeros_like(acc_hi)
    for st in range(nst):
        acc_hi = acc_hi + hi[:, st].to(F32)
    if passes == 4:  # L = small·(big + small / 2), small·(small / 2) exact
        ell = (torch.einsum(eq, s64, b64)
               + torch.einsum(eq, s64, s64 / 2)).to(F32)
        for st in range(nst):
            acc_l = acc_l + ell[:, st]
    part = torch.zeros((nb, c, c), dtype=F64)
    for w in range(WARPS):
        ell = acc_l[:, w].double()
        part = part + (acc_hi[:, w].double() + (ell + ell.transpose(1, 2)))
    rounds = -(-nb // LANES)
    padded = torch.zeros((rounds * LANES, c, c), dtype=F64)
    padded[:nb] = part
    lanes = torch.zeros((LANES, c, c), dtype=F64)
    for r in range(rounds):
        lanes = lanes + padded[r * LANES:(r + 1) * LANES]
    idx = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ off]
    g = lanes[0]
    diag = torch.diagonal(g)
    d = (diag[:, None] + diag[None, :]) - 2.0 * g
    return d.clamp_min(0.0).to(F32)


def _f64(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    sq = (x * x).sum(dim=1)
    return (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)


def _f32_expansion(x: torch.Tensor) -> torch.Tensor:
    sq = (x * x).sum(dim=1)
    return sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)


def _ratio(got: torch.Tensor, x: torch.Tensor) -> float:
    """got's mean |error| off the diagonal against float64, over the
    f32 expansion form's."""
    want = _f64(x)
    off = ~torch.eye(x.shape[0], dtype=torch.bool)

    def err(d):
        return (d.double() - want).abs()[off].mean().item()

    return err(got) / err(_f32_expansion(x))


def _x(c: int, p: int, seed: int = 0) -> torch.Tensor:
    return torch.tensor(np.random.default_rng(1000 * c + p + seed)
                        .standard_normal((c, p)), dtype=F32)


@pytest.mark.parametrize("scale", [1.0, 3e-4, 1e-12])
def test_grid_split_is_tf32_exact_and_sums_exactly(scale):
    """On a grid of 32 values (a warp's 4 k-steps of a stage), big has at
    most 10 significant bits (a TF32 value, low 13 bits zero) and is a
    multiple of the step, small is exact and at most half a step, and
    big·big's sums over the 32 are exact in f32; zero groups and values
    far below any delta (the step's clamp) still split exactly."""
    tiny = _x(8, 4096).view(8, -1, 32) * 1e-30
    assert torch.equal(sum(_grid_split(tiny)), tiny)
    x = (_x(8, 4096) * scale).view(8, -1, 32)
    x[0, 0] = 0.0  # an all-zero group
    big, small = _grid_split(x)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.equal(big + small, x)
    m = x.abs().amax(-1, keepdim=True)
    q = ((m.view(torch.int32) >> 23) - 135).clamp(-116, 117)
    step = torch.pow(2.0, q.double())
    assert (torch.remainder(big.double(), step) == 0).all()
    assert ((big.double() / step).abs() <= 512).all()
    assert (small.double().abs() <= step / 2).all()
    sums = torch.einsum("isk,jsk->sij", big.double(), big.double())
    assert torch.equal(sums.to(F32).double(), sums)


@pytest.mark.parametrize("c,p", SHAPES)
def test_gram_model_matches_the_reference_kernel(c, p):
    x = _x(c, p)
    got = _kernel_model(x)
    want = np.asarray(jax_pairwise(jnp.asarray(x.numpy())))
    atol = 1e-5 * float((x.double() ** 2).sum(dim=1).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    assert (torch.diagonal(got) == 0).all() and torch.equal(got, got.T)


@pytest.mark.parametrize("c,p", SHAPES)
def test_gram_model_float64_error_within_the_limit(c, p):
    ratio = _ratio(_kernel_model(_x(c, p)), _x(c, p))
    print(f"({c}, {p}): {ratio:.3f}x the f32 expansion form's error")
    assert ratio <= F64_RATIO


@pytest.mark.parametrize("c,p", SHAPES)
def test_one_tf32_pass_misses_the_limit(c, p):
    """Without the small terms the distances read far above the limit:
    the card's check would catch a kernel that dropped them."""
    ratio = _ratio(_kernel_model(_x(c, p), passes=1), _x(c, p))
    print(f"({c}, {p}), one pass: {ratio:.3f}x")
    assert ratio > 10 * F64_RATIO


def test_krum_selection_on_the_model_equals_float64(monkeypatch):
    """krum_scores on the model's distances ranks a seeded 10-client
    input as it ranks it on float64 distances: the same Krum pick and
    the same multi-Krum top 3 (f = 3, as chip_smoke.py runs krum)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((10, 65536)) * 1e-3
    x[:3] += rng.standard_normal((3, 65536)) * 3e-3  # three outliers
    x = torch.tensor(x, dtype=F32)
    w = torch.full((10,), 0.1)
    ranks = {}
    for name, dists in (("model", _kernel_model), ("f64", _f64)):
        monkeypatch.setattr(aggregation, "_pairwise_sq_dists",
                            lambda v, use_pallas, d=dists: d(v))
        scores = aggregation.krum_scores(x, w, 3, use_pallas=True)
        ranks[name] = torch.argsort(scores, stable=True)[:3].tolist()
    assert ranks["model"] == ranks["f64"]
    assert not set(ranks["f64"]) & {0, 1, 2}
