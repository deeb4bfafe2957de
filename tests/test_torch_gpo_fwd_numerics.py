"""The GPO attention forward kernel's precision scheme, modelled on the
CPU.

``csrc/gpo_attention_fwd.cu`` runs both products of the forward, the
scores q·kᵀ over the context keys and p·v, on TF32 tensor cores in
3xTF32, as the backward does (``tests/test_torch_gpo_bwd_numerics.py``
models that split and reuses its rounding helpers here); the softmax, a
target row's own key (a dot product on the CUDA cores) and the final
division are f32. The model below repeats that rounding with plain
PyTorch ops and is held to ``ref_gpo_attention`` run in float64 (which
rounds its scores once to f32, 2^-24 relative, far below the limit): o
and lse within 1e-5·(1 + |plain|), the card check's limit. One TF32 pass
(big·big alone) reads far above that limit, which shows that the limit
guards the split. The model takes the softmax over all of a row's keys
at once; the kernel's online softmax over four warps' shares and its
tensor-core sums, which round toward zero, are measured on the card
(``chip_smoke.py`` phase 1, ``PERF.md`` §6). The model lives here only;
no path of the port runs it.
"""
import math

import numpy as np
import pytest
import torch
from test_torch_gpo_bwd_numerics import _product

from repro_torch.kernels.ref import ref_gpo_attention

TOL = 1e-5  # the card check, 1e-5·(1 + |plain|)
F32, F64 = torch.float32, torch.float64
NEG_INF = -1e30  # the kernel's mask value


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kernel_model(q, k, v, num_ctx: int, passes: int = 3):
    """(o, lse) of the forward kernel's arithmetic, f32 throughout: the
    context band on the tensor cores, each target's own key on the CUDA
    cores."""
    s_len, hd = q.shape[-2:]
    scale = 1.0 / math.sqrt(hd)
    t = slice(num_ctx, s_len)
    kc, vc = k[:, :num_ctx], v[:, :num_ctx]
    s = _product("bid,bjd->bij", q, kc, passes) * scale
    m = torch.full(q.shape[:2], NEG_INF, dtype=F32)
    if num_ctx:
        m = s.amax(-1)
    s_own = (q[:, t] * k[:, t]).sum(-1) * scale
    m[:, t] = torch.maximum(m[:, t], s_own)
    p = torch.exp(s - m[..., None])
    p_own = torch.exp(s_own - m[:, t])
    l = p.sum(-1)
    l[:, t] += p_own
    o = _product("bij,bjd->bid", p, vc, passes)
    o[:, t] += p_own[..., None] * v[:, t]
    l = l.clamp_min(1e-30)
    return o / l[..., None], m + torch.log(l)


def _case(bh: int, s: int, num_ctx: int, hd: int):
    """(q, k, v in f32, plain (o, lse) in float64) from a numpy seed."""
    rng = np.random.default_rng(1000 * s + 10 * num_ctx + hd)
    q, k, v = (torch.tensor(rng.standard_normal((bh, s, hd)), dtype=F32)
               for _ in range(3))
    plain = ref_gpo_attention(*(t.to(F64) for t in (q, k, v)),
                              num_ctx=num_ctx)
    return (q, k, v), plain


def _share_of_limit(got, plain) -> float:
    """max |got − plain| / (TOL·(1 + |plain|)): at most 1 passes."""
    plain = plain.to(F64)
    return ((got.to(F64) - plain).abs()
            / (TOL * (1 + plain.abs()))).max().item()


# (BH, S, num_ctx): training's 10 clients x 4 heads, then ragged S and
# num_ctx (chip_smoke.py's ATTN_SHAPES)
SHAPES = [(40, 160, 80), (4, 85, 37)]


@pytest.mark.parametrize("hd", [32, 24])
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_holds_o_and_lse_to_the_float64_forward(shape, hd):
    ops, plain = _case(*shape, hd)
    got = _kernel_model(*ops, num_ctx=shape[2])
    shares = [_share_of_limit(g, w) for g, w in zip(got, plain)]
    print(f"{shape} hd={hd}: o, lse at {shares} of the limit")
    assert max(shares) <= 1.0


@pytest.mark.parametrize("hd", [32, 24])
@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_pass_misses_the_limit(shape, hd):
    """Without the small terms o and lse each read more than five
    times 1e-5·(1 + |plain|) (o far more; lse's error is one score's):
    the card's check would catch a kernel that dropped the split."""
    ops, plain = _case(*shape, hd)
    got = _kernel_model(*ops, num_ctx=shape[2], passes=1)
    shares = [_share_of_limit(g, w) for g, w in zip(got, plain)]
    print(f"{shape} hd={hd}, one pass: o, lse at {shares} of the limit")
    assert min(shares) > 5.0
