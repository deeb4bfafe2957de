"""The port's kernel modules against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions (and the wrappers' layouts) to the
JAX kernels, which run in Pallas interpret mode here. The CUDA kernels
themselves are held to the same plain versions on the card by
``chip_smoke.py``. Tolerance: atol 1e-5 in float32 (different reduction
orders, same math); quantization is bit-equal.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gpo_attention as jax_gpo_attention
from repro.kernels import int8_matmul as jax_int8_matmul
from repro.kernels import quantize_linear as jax_quantize_linear
from repro.kernels.ref import ref_gpo_attention as jax_ref_gpo_attention
from repro_torch.kernels import (
    dequantize_linear,
    gpo_attention,
    int8_matmul,
    quantize_linear,
)
from repro_torch.kernels.ref import ref_gpo_attention, ref_int8_matmul

# the submodules, not the same-named functions the package re-exports
qm = importlib.import_module("repro_torch.kernels.quant_matmul")
ga = importlib.import_module("repro_torch.kernels.gpo_attention")

ATOL = 1e-5


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


@pytest.mark.parametrize("shape", [(66, 128), (128, 1), (256, 128),
                                   (2, 128, 256), (4098, 128)])
def test_quantize_linear_bit_equal(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    if shape[-1] > 1:
        w[..., 1] = 0.0  # an all-zero column takes the scale floor
    ref = jax_quantize_linear(jnp.asarray(w))
    port = quantize_linear(_t(w))
    assert port.q.dtype == torch.int8 and port.scale.dtype == torch.float32
    np.testing.assert_array_equal(port.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(dequantize_linear(port).numpy(),
                                  np.asarray(ref.q, np.float32)
                                  * np.asarray(ref.scale)[..., None, :])


@pytest.mark.parametrize("k", [66, 128, 256, 4098])
@pytest.mark.parametrize("n", [1, 128, 256])
def test_int8_matmul_matches_jax(k, n):
    rng = np.random.default_rng(k * 1000 + n)
    x = rng.standard_normal((37, k)).astype(np.float32)
    ql = jax_quantize_linear(jnp.asarray(
        rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)))
    want = np.asarray(jax_int8_matmul(jnp.asarray(x), ql.q, ql.scale))
    q, s = _t(ql.q), _t(ql.scale)
    got = qm.int8_matmul_flat(_t(x), q, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the public wrapper flattens any leading axes into one call
    lead = int8_matmul(_t(x[:36].reshape(4, 9, k)), q, s)
    np.testing.assert_allclose(lead.reshape(36, n).numpy(), want[:36],
                               rtol=0, atol=ATOL)


def test_int8_matmul_shape_errors():
    q = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        qm.int8_matmul_flat(torch.zeros((3, 7)), q, torch.ones(4))
    with pytest.raises(ValueError):
        qm.int8_matmul_flat(torch.zeros((3, 8)), q, torch.ones(3))


def test_cpu_tensors_take_the_plain_versions_uncounted():
    """On CPU tensors a wrapper runs its plain version and counts no
    kernel launch."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((5, 16)).astype(np.float32))
    ql = quantize_linear(_t(rng.standard_normal((16, 8)).astype(np.float32)))
    q3 = _t(rng.standard_normal((6, 20, 32)).astype(np.float32))
    before = (qm.int8_matmul_flat.launches, ga.gpo_attention_fwd.launches)
    assert torch.equal(qm.int8_matmul_flat(x, ql.q, ql.scale),
                       ref_int8_matmul(x, ql.q, ql.scale))
    o, lse = ga.gpo_attention_fwd(q3, q3, q3, num_ctx=7)
    ro, rl = ref_gpo_attention(q3, q3, q3, num_ctx=7)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert (qm.int8_matmul_flat.launches,
            ga.gpo_attention_fwd.launches) == before


def _masked_lse(q, k, num_ctx):
    """logsumexp over the allowed keys only, in float64."""
    s = q.shape[-2]
    sc = np.einsum("...qd,...kd->...qk", q.astype(np.float64),
                   k.astype(np.float64)) / np.sqrt(q.shape[-1])
    pos = np.arange(s)
    allowed = (pos[None, :] < num_ctx) | (pos[None, :] == pos[:, None])
    sc = np.where(allowed, sc, -np.inf)
    mx = sc.max(-1, keepdims=True)
    return (mx + np.log(np.exp(sc - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("s,h,hd,num_ctx", [
    (40, 2, 32, 24),   # aligned
    (37, 4, 32, 13),   # ragged S and num_ctx
    (80, 4, 32, 60),   # the quickstart's serve step
    (30, 2, 16, 0),    # no context: every row attends only to itself
    (30, 2, 16, 30),   # all context
])
def test_gpo_attention_matches_jax(s, h, hd, num_ctx):
    rng = np.random.default_rng(s * 100 + num_ctx)
    q, k, v = (rng.standard_normal((s, h, hd)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_gpo_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), num_ctx=num_ctx))
    got = gpo_attention(_t(q), _t(k), _t(v), num_ctx=num_ctx)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the kernel's own layout (BH, S, hd), with lse
    qh, kh, vh = (a.transpose(1, 0, 2).copy() for a in (q, k, v))
    o, lse = ga.gpo_attention_fwd(_t(qh), _t(kh), _t(vh), num_ctx=num_ctx)
    ref = np.asarray(jax_ref_gpo_attention(jnp.asarray(qh), jnp.asarray(kh),
                                           jnp.asarray(vh), num_ctx=num_ctx))
    np.testing.assert_allclose(o.numpy(), ref, rtol=0, atol=ATOL)
    assert lse.dtype == torch.float32 and lse.shape == (h, s)
    np.testing.assert_allclose(lse.numpy(), _masked_lse(qh, kh, num_ctx),
                               rtol=0, atol=ATOL)


def test_gpo_attention_batch_axis_matches_per_group_jax():
    """(B, S, H, hd) in one call equals the JAX wrapper group by group."""
    rng = np.random.default_rng(7)
    b, s, h, hd, m = 3, 45, 4, 32, 25
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    got = gpo_attention(_t(q), _t(k), _t(v), num_ctx=m).numpy()
    for i in range(b):
        want = jax_gpo_attention(jnp.asarray(q[i]), jnp.asarray(k[i]),
                                 jnp.asarray(v[i]), num_ctx=m)
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_gpo_attention_fwd_refuses_a_view_the_kernel_cannot_copy(name):
    """The forward kernel copies 16 bytes at a time (cp.async): a
    contiguous view that starts 2 floats into its storage is refused by
    name on the CPU, as on the card, before any launch; 4 floats in
    takes the plain version."""
    a = torch.ones((2, 10, 32))
    for off in (2, 4):
        view = torch.as_strided(torch.ones(a.numel() + off), a.shape,
                                a.stride(), off)
        assert view.is_contiguous() and view.storage_offset() == off
        ops = {"q": a, "k": a, "v": a, name: view}
        if off == 2:
            with pytest.raises(ValueError, match=f"{name} starts 2 floats"):
                ga.gpo_attention_fwd(**ops, num_ctx=4)
        else:
            o, lse = ga.gpo_attention_fwd(**ops, num_ctx=4)
            ro, rl = ref_gpo_attention(a, a, a, num_ctx=4)
            assert torch.equal(o, ro) and torch.equal(lse, rl)


def test_gpo_attention_bad_num_ctx_raises():
    x = torch.zeros((2, 10, 8))
    with pytest.raises(ValueError):
        ga.gpo_attention_fwd(x, x, x, num_ctx=11)
    with pytest.raises(ValueError):
        ga.gpo_attention_fwd(x, x[:, :9], x, num_ctx=3)

