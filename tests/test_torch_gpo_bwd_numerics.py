"""The GPO attention backward kernels' precision scheme, modelled on the
CPU.

``csrc/gpo_attention_bwd.cu`` runs every product of the backward
(q·kᵀ, do·vᵀ, ds·k, dsᵀ·q, pᵀ·do) on TF32 tensor cores in 3xTF32: each
f32 operand x becomes big = tf32(x) (round to nearest on the 13 dropped
mantissa bits, ties away from zero, as ``cvt.rna.tf32.f32``) and
small = x − big, which the tensor cores read with its low 13 bits
ignored (truncated to TF32), and the three products small·big,
big·small and big·big are summed into an f32 accumulator. p, ds and a
target row's own key (a dot product on the CUDA cores) are f32. The
model below repeats that rounding with plain PyTorch ops, from the f32
forward's lse and the f32 delta = rowsum(do·o) as the card gets them,
and is held to the closed-form backward ``ref_gpo_attention_bwd`` run in
float64: dq, dk and dv within 1e-5·(1 + |plain|), the card check's
limit. One TF32 pass
(big·big alone) reads far above that limit, which shows that the limit
guards the split. The model sums in f32 as the CUDA cores do; the
tensor cores' own sums round toward zero, which the kernels confine to
one k-step of 8 (q·kᵀ, do·vᵀ) or one stage of 8 rows (the
accumulations) and which only the card measures (``PERF.md`` §6). The
model lives here only; no path of the port runs it.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import ref_gpo_attention, ref_gpo_attention_bwd

TOL = 1e-5  # the card check, 1e-5·(1 + |plain|)
F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: add half of the dropped 13 bits to the magnitude, then clear
    them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def _truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as the tensor cores read an f32 register: the low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(F32)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor,
             passes: int) -> torch.Tensor:
    """einsum ``eq`` of f32 a and b as the tensor cores sum it: 3xTF32
    (``passes`` 3) or one TF32 pass (1), in f32."""
    ab, bb = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ab, bb)
    if passes == 3:
        a_small, b_small = _truncate_tf32(a - ab), _truncate_tf32(b - bb)
        out = (torch.einsum(eq, a_small, bb)
               + torch.einsum(eq, ab, b_small)) + out
    return out


def _kernel_model(q, k, v, do, lse, delta, num_ctx: int, passes: int = 3):
    """(dq, dk, dv) of the kernels' arithmetic, f32 throughout: the
    context band on the tensor cores, each target's own key on the CUDA
    cores."""
    s_len, hd = q.shape[-2:]
    scale = 1.0 / math.sqrt(hd)
    kc, vc = k[:, :num_ctx], v[:, :num_ctx]
    # context keys, read by every query
    s = _product("bid,bjd->bij", q, kc, passes) * scale
    p = torch.exp(s - lse[..., None])
    dp = _product("bid,bjd->bij", do, vc, passes)
    ds = p * (dp - delta[..., None]) * scale
    dq = _product("bij,bjd->bid", ds, kc, passes)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dk[:, :num_ctx] = _product("bij,bid->bjd", ds, q, passes)
    dv[:, :num_ctx] = _product("bij,bid->bjd", p, do, passes)
    # a target's own key, in f32 on the CUDA cores
    t = slice(num_ctx, s_len)
    s_own = (q[:, t] * k[:, t]).sum(-1) * scale
    p_own = torch.exp(s_own - lse[:, t])
    ds_own = p_own * ((do[:, t] * v[:, t]).sum(-1) - delta[:, t]) * scale
    dq[:, t] += ds_own[..., None] * k[:, t]
    dk[:, t] = ds_own[..., None] * q[:, t]
    dv[:, t] = p_own[..., None] * do[:, t]
    return dq, dk, dv


def _case(bh: int, s: int, num_ctx: int, hd: int):
    """(model inputs in f32, plain (dq, dk, dv) in float64) from a
    numpy seed; lse and delta from the f32 forward, as on the card."""
    rng = np.random.default_rng(1000 * s + 10 * num_ctx + hd)
    q, k, v, do = (torch.tensor(rng.standard_normal((bh, s, hd)),
                                dtype=F32) for _ in range(4))
    o, lse = ref_gpo_attention(q, k, v, num_ctx=num_ctx)
    delta = (do * o).sum(-1)
    wide = [t.to(F64) for t in (q, k, v, do)]
    o64, lse64 = ref_gpo_attention(*wide[:3], num_ctx=num_ctx)
    plain = ref_gpo_attention_bwd(*wide[:3], o64, lse64.to(F64), wide[3],
                                  num_ctx=num_ctx)
    return (q, k, v, do, lse, delta), plain


def _share_of_limit(got, plain) -> float:
    """max |got − plain| / (TOL·(1 + |plain|)): at most 1 passes."""
    return ((got.to(F64) - plain).abs()
            / (TOL * (1 + plain.abs()))).max().item()


# (BH, S, num_ctx): chip_smoke.py's BWD_SHAPES, training's 10 clients x 4
# heads first, then ragged S and num_ctx at both ends and a long S
SHAPES = [(40, 160, 80), (4, 80, 60), (4, 85, 37), (4, 64, 0), (4, 64, 64),
          (4, 645, 321)]


def test_tf32_rounds_to_nearest_with_ties_away_from_zero_or_truncates():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0, 0.0], dtype=F32)
    want = torch.tensor([1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
                         3.0, 0.0], dtype=F32)
    assert torch.equal(_tf32(x), want)
    assert torch.equal(_truncate_tf32(x), torch.tensor(
        [1.0, 1 + 2 ** -10, -1.0, 1.0, 3.0, 0.0], dtype=F32))
    y = torch.tensor(np.random.default_rng(0).standard_normal(1000),
                     dtype=F32)
    assert ((_tf32(y) - y).abs() <= y.abs() * 2 ** -11).all()
    assert ((_truncate_tf32(y) - y).abs() < y.abs() * 2 ** -10).all()


@pytest.mark.parametrize("hd", [32, 24])
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_holds_dq_dk_dv_to_the_float64_backward(shape, hd):
    ops, plain = _case(*shape, hd)
    got = _kernel_model(*ops, num_ctx=shape[2])
    shares = [_share_of_limit(g, w) for g, w in zip(got, plain)]
    print(f"{shape} hd={hd}: dq, dk, dv at {shares} of the limit")
    assert max(shares) <= 1.0


@pytest.mark.parametrize("hd", [32, 24])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[-1]])
def test_one_tf32_pass_misses_the_limit(shape, hd):
    """Without the small terms every gradient with a context band reads
    far above 1e-5·(1 + |plain|): the card's check would catch a kernel
    that dropped the split."""
    ops, plain = _case(*shape, hd)
    got = _kernel_model(*ops, num_ctx=shape[2], passes=1)
    shares = [_share_of_limit(g, w) for g, w in zip(got, plain)]
    print(f"{shape} hd={hd}, one pass: dq, dk, dv at {shares} of the limit")
    assert min(shares) > 10.0
