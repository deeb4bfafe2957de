"""The on-chip DP clip kernel's norm order, modelled on the CPU.

``csrc/clip_reduce.cu``'s on-chip design (``csrc/on_chip_rows.cuh``)
sums each client's squared norm in another order than the TPU kernel's
sweep and the two-launch design: the split of ``quant_split`` gives each
of the ⌈P / width⌉ blocks ``width`` columns; a block takes its columns of
a row in segments of 512, lane l of a warp holding the packs of V floats
(V = 4 when P is a multiple of 4, else 1) at segment columns
(k·32 + l)·V, k = 0, 1, ..., each lane's squares summed by ``fmaf`` in
that order, the warp's 32 lanes by butterfly; the block's partial is its
segments' sums in order; after the grid barrier, lane l sums blocks l,
l + 32, ... in order, then a butterfly, and the scale is
min(1, clip / max(√sq, 1e-12)) with an IEEE root and division. The
release and reduce keep the TPU kernel's op order: y = x·s, then + n,
then out = Σ_c fmaf(w_c, y_c, out), clients in order. The model below
repeats that arithmetic with plain PyTorch ops; an ``fmaf`` is the
float64 product and sum rounded to float32, which may differ from the
card's single rounding by an ulp at times.

It is held to ``repro.kernels.agg_reduce.clip_reduce_flat`` in interpret
mode and to the port's plain version within the card check's 1e-5·(1 +
|plain|), with and without noise, at a P that takes the float4 path and
one that takes single floats. The model lives here only; no path of the
port runs it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.agg_reduce import clip_reduce_flat as jax_clip_reduce
from repro_torch.kernels.agg_reduce import QUANT_SEG, quant_split
from repro_torch.kernels.ref import ref_clip_reduce

F32, F64 = torch.float32, torch.float64
TOL = 1e-5  # chip_smoke.py phase 1's clip_reduce check: TOL·(1 + |plain|)
LANES = 32
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


def _fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).to(F32)


def _butterfly(lanes: torch.Tensor) -> torch.Tensor:
    """A warp's xor-shuffle sum over the last axis (32 lanes): lane 0's
    result, which every lane holds."""
    idx = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ off]
    return lanes[..., 0]


def _on_chip_sq(x: torch.Tensor) -> torch.Tensor:
    """(C, P) f32 -> (C,) squared norms in the on-chip kernel's order."""
    c, p = x.shape
    v = 4 if p % 4 == 0 else 1
    width, nb = quant_split(p)
    segs = -(-width // QUANT_SEG)
    packs = QUANT_SEG // (LANES * v)
    xp = torch.zeros((c, nb * width), dtype=F32)
    xp[:, :p] = x  # zeros past P add nothing: fmaf(0, 0, acc) == acc
    xs = torch.zeros((c, nb, segs * QUANT_SEG), dtype=F32)
    xs[..., :width] = xp.view(c, nb, width)
    xs = xs.view(c, nb, segs, packs, LANES, v)
    acc = torch.zeros((c, nb, segs, LANES), dtype=F32)
    for k in range(packs):
        for e in range(v):
            val = xs[:, :, :, k, :, e]
            acc = _fmaf(val, val, acc)
    seg = _butterfly(acc)  # (C, nb, segs)
    part = torch.zeros((c, nb), dtype=F32)
    for s in range(segs):
        part = part + seg[:, :, s]
    rounds = -(-nb // LANES)
    padded = torch.zeros((c, rounds * LANES), dtype=F32)
    padded[:, :nb] = part
    lanes = torch.zeros((c, LANES), dtype=F32)
    for r in range(rounds):
        lanes = lanes + padded[:, r * LANES:(r + 1) * LANES]
    return _butterfly(lanes)


def _on_chip_model(x, w, clip, noise=None):
    """(P,) from the on-chip kernel's arithmetic, and its (C,) scales."""
    norm = torch.sqrt(_on_chip_sq(x))
    scale = torch.clamp(torch.tensor(clip, dtype=F32)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    y = x * scale[:, None]
    if noise is not None:
        y = y + noise
    out = torch.zeros(x.shape[1], dtype=F32)
    for c in range(x.shape[0]):
        out = _fmaf(w[c].expand_as(out), y[c], out)
    return out, scale


def _inputs(c, p):
    """Deltas with every other client 10x larger (half the rows above the
    median clip), normalised weights and noise, as f32 tensors."""
    rng = np.random.default_rng(100 * c + p)
    x = rng.standard_normal((c, p)).astype(np.float32)
    x[::2] *= 10.0
    w = (rng.random(c) + 0.1).astype(np.float32)
    w /= w.sum()
    noise = (0.3 * rng.standard_normal((c, p))).astype(np.float32)
    clip = float(np.median(np.linalg.norm(x, axis=1)))
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(
        noise), clip


@pytest.mark.parametrize("with_noise", [False, True])
@pytest.mark.parametrize("c,p", SHAPES)
def test_on_chip_model_matches_the_reference_kernel(c, p, with_noise):
    x, w, noise, clip = _inputs(c, p)
    n = noise if with_noise else None
    got, scale = _on_chip_model(x, w, clip, n)
    want = np.asarray(jax_clip_reduce(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), clip=clip,
        noise=None if n is None else jnp.asarray(n.numpy()), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    plain = ref_clip_reduce(x, w, clip=clip, noise=n)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)
    # about half of the rows clipped, each scale within float error of
    # the one from the norms in float64
    norm64 = torch.linalg.vector_norm(x.double(), dim=1)
    scale64 = torch.clamp(clip / norm64, max=1.0)
    assert 0 < int((scale < 1).sum()) < c
    np.testing.assert_allclose(scale.double().numpy(), scale64.numpy(),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("c,p", SHAPES)
def test_on_chip_norm_order_is_the_kernel_grid(c, p):
    """The model's blocks cover P with the quant split, and its squared
    norms agree with the plain version's sum and with float64 to float
    error."""
    x, _, _, _ = _inputs(c, p)
    width, nb = quant_split(p)
    assert (nb - 1) * width < p <= nb * width
    sq = _on_chip_sq(x)
    plain = (x * x).sum(dim=1)
    np.testing.assert_allclose(sq.numpy(), plain.numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        sq.double().numpy(), (x.double() ** 2).sum(dim=1).numpy(),
        rtol=1e-6)
