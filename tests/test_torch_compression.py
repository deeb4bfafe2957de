"""The port's delta transport (DESIGN.md §10) against the JAX package's,
on the CPU: the ``quant_clip_reduce`` and ``topk_reduce`` kernel
wrappers (their plain versions here; the JAX kernels in Pallas interpret
mode), the int8 codec, the top-k thresholds and ``transport_delta_flat``
with the port's and the reference's aggregators. The inputs are numpy
arrays from a seed; noise and rounding uniforms too, handed to both.

Tolerances: rtol 2e-5, atol 2e-5 for the weighted sums (the reference
test's); the int8 paths add one quantization level, atol 2e-5 + s_max
(s_max = max|u| / 127 over the clients), with at most 1% of the
coordinates beyond 2e-5: the norms are summed in another order, and the
reference divides by 127 as XLA compiles it (a reciprocal multiply,
one ulp off the IEEE quotient at times), so a scale can differ by an ulp
and legally flip a rounding decision by one level. Top-k thresholds,
masks and residuals are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AggConfig as JaxAggConfig
from repro.configs import CompressionConfig as JaxCompressionConfig
from repro.configs import PrivacyConfig as JaxPrivacyConfig
from repro.core import compression as jax_cx
from repro.core import make_aggregator as jax_make_aggregator
from repro.kernels import agg_quant_clip_reduce as jax_quant_clip_reduce
from repro.kernels import agg_topk_reduce as jax_topk_reduce
from repro.kernels.ref import ref_topk_reduce as jax_ref_topk_reduce
from repro_torch.configs import (
    AggConfig,
    CompressionConfig,
    PrivacyConfig,
)
from repro_torch.core import compression as cx
from repro_torch.core.aggregation import make_aggregator
from repro_torch.kernels import agg_quant_clip_reduce, agg_topk_reduce
from repro_torch.kernels.agg_reduce import (
    QUANT_SPLIT,
    quant_design_for,
    quant_smem_bytes,
    quant_split,
)
from repro_torch.kernels.ref import (
    ref_quant_clip_reduce,
    ref_topk_mask_reduce,
    ref_topk_reduce,
)

TOL = dict(rtol=2e-5, atol=2e-5)


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


def _inputs(c, p, seed):
    """Deltas (every other client 10x larger), softmax weights, noise,
    a residual and uniforms, as numpy float32."""
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


QUANT_VARIANTS = ["plain", "clip", "clip_noise_ef", "ef_stochastic",
                  "rtn_noise_ef"]


def _quant_kw(variant, x, noise, resid, uniform):
    clip = float(np.median(np.linalg.norm(x, axis=1)))
    return {
        "plain": dict(),
        "clip": dict(clip=clip),
        "clip_noise_ef": dict(clip=clip, noise=noise, resid=resid),
        "ef_stochastic": dict(uniform=uniform, resid=resid),
        # round half to even with every other operand
        "rtn_noise_ef": dict(clip=clip, noise=noise, resid=resid,
                             uniform=None),
    }[variant]


@pytest.mark.parametrize("c,p", [(2, 100), (5, 1000), (16, 4097)])
@pytest.mark.parametrize("variant", QUANT_VARIANTS)
def test_quant_clip_reduce_matches_jax(c, p, variant):
    """The wrapper's plain version against the reference's fused kernel
    in interpret mode, in every operand combination (the reference
    test's four, plus round-to-nearest with clip, noise and residual)."""
    x, w, noise, resid, uniform = _inputs(c, p, seed=c * 7 + p)
    kw = _quant_kw(variant, x, noise, resid, uniform)
    out, er = agg_quant_clip_reduce(
        _t(x), _t(w), **{k: (_t(v) if isinstance(v, np.ndarray) else v)
                         for k, v in kw.items()})
    jout, jer = jax_quant_clip_reduce(
        jnp.asarray(x), jnp.asarray(w),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items() if v is not None})
    s_max = float(np.abs(x).max() / 127.0)
    _assert_levels(out.numpy(), jout, s_max)
    assert (er is None) == (jer is None) == ("resid" not in kw)
    if er is not None:
        _assert_levels(er.numpy(), jer, s_max)
    # the plain version is the wrapper's CPU path, and the port's codec
    # stage by stage gives the same rows
    pout, per = ref_quant_clip_reduce(_t(x), _t(w), **{
        k: (_t(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()})
    assert torch.equal(out, pout)


# an H100 SXM's multiprocessors and opt-in shared memory a block
SXM = (132, 232448)


@pytest.mark.parametrize("c,p,card,want", [
    (10, 534016, SXM, "on_chip"),  # the quickstart's (C, P): 128 blocks
    (32, 534016, SXM, "three_pass"),  # 68 MB of u
    (48, 534016, SXM, "three_pass"),
    (10, 534016, (114, 232448), "three_pass"),  # H100 PCIe: 114 SMs
    (3, 2049, (114, 232448), "on_chip"),  # 103 blocks fit there
    (13, 534016, SXM, "on_chip"),  # the last C that fits at this P
    (14, 534016, SXM, "three_pass"),
    (10, 534016, (128, 232448), "on_chip"),  # one block an SM, exactly
    (10, 534016, (127, 232448), "three_pass"),
    # the block's shared memory, exactly and a byte short
    (10, 534016, (132, quant_smem_bytes(10, 4172)), "on_chip"),
    (10, 534016, (132, quant_smem_bytes(10, 4172) - 1), "three_pass"),
])
def test_quant_design_choice(c, p, card, want):
    """On chip where the blocks fit at once, one a multiprocessor, each
    with its (C, width) tile of u; three passes elsewhere."""
    assert quant_design_for(c, p, *card) == want


@pytest.mark.parametrize("p", [1, 7, 8, 2049, 5001, 534016, 534017,
                               10 ** 8])
def test_quant_column_split_depends_on_p_alone(p):
    """The split is a function of P: the same width and blocks whatever
    card runs it (the design differs, the bits do not), at most
    QUANT_SPLIT blocks of a multiple of 4 columns that cover P."""
    width, blocks = quant_split(p)
    assert width % 4 == 0 and blocks <= QUANT_SPLIT
    assert (blocks - 1) * width < p <= blocks * width
    designs = {sms: quant_design_for(10, p, sms, 232448)
               for sms in (114, 132, 10 ** 4)}
    assert designs[10 ** 4] == "on_chip" or quant_smem_bytes(
        10, width) > 232448
    if p == 534016:
        assert (width, blocks) == (4172, 128)
        assert designs == {114: "three_pass", 132: "on_chip",
                           10 ** 4: "on_chip"}


def test_quant_clip_reduce_rejects_noise_without_clip():
    x = torch.ones((3, 8))
    w = torch.full((3,), 1.0 / 3)
    with pytest.raises(ValueError, match="clip"):
        agg_quant_clip_reduce(x, w, noise=torch.zeros((3, 8)))
    with pytest.raises(ValueError, match="shapes"):
        agg_quant_clip_reduce(x, w, resid=torch.zeros((3, 9)))


def test_quantize_int8_rounds_half_to_even_like_jax():
    """z on exact half values: round-to-nearest breaks ties to even
    (jnp.round and torch.round; CUDA's roundf would not)."""
    # absmax 127 gives scale 1, so z == x exactly
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                    -126.5, 0.0], np.float32)
    x = np.stack([row, row / 2])
    q, s = cx.quantize_int8(_t(x))
    jq, js = jax_cx.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        q[0].numpy(), [127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 0])
    np.testing.assert_array_equal(
        cx.dequantize_int8(q, s).numpy(),
        np.asarray(jax_cx.dequantize_int8(jq, js)))


def test_quantize_int8_stochastic_and_zero_rows_match_jax():
    x, _, _, _, uniform = _inputs(4, 333, seed=11)
    x[1] = 0.0  # an all-zero client quantizes to exact zeros
    q, s = cx.quantize_int8(_t(x), uniform=_t(uniform))
    jq, js = jax_cx.quantize_int8(jnp.asarray(x),
                                  uniform=jnp.asarray(uniform))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # one level at most, where the reference's reciprocal-multiplied
    # scale flips a floor
    assert np.abs(q.numpy().astype(int) - np.asarray(jq)).max() <= 1
    assert (q[1] == 0).all() and s[1].item() == 1e-30 * np.float32(1)


@pytest.mark.parametrize("c,p,frac", [(2, 100, 0.5), (5, 1000, 0.01),
                                      (9, 4097, 0.1)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_topk_reduce_matches_jax(c, p, frac, with_residual):
    x, w, _, _, _ = _inputs(c, p, seed=p)
    tau = cx.topk_thresholds(_t(x), frac)
    jtau = jax_cx.topk_thresholds(jnp.asarray(x), frac)
    np.testing.assert_array_equal(tau.numpy(), np.asarray(jtau))
    out, er = agg_topk_reduce(_t(x), _t(w), tau,
                              with_residual=with_residual)
    jout, jer = jax_topk_reduce(jnp.asarray(x), jnp.asarray(w), jtau,
                                with_residual=with_residual)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    if with_residual:
        np.testing.assert_array_equal(er.numpy(), np.asarray(jer))
    else:
        assert er is None and jer is None
    # the frac= oracle: the threshold from a full sort
    rout, rer = ref_topk_reduce(_t(x), _t(w), frac=frac)
    jrout, jrer = jax_ref_topk_reduce(jnp.asarray(x), jnp.asarray(w),
                                      frac=frac)
    np.testing.assert_allclose(rout.numpy(), np.asarray(jrout), **TOL)
    np.testing.assert_array_equal(rer.numpy(), np.asarray(jrer))


def test_topk_thresholds_on_ties_and_zero_rows():
    """The k-th largest magnitude is unique however ties are ordered:
    a row of one repeated magnitude keeps every entry, a zero row has
    threshold 0 and keeps its zeros, a row with a tie across the k-th
    place keeps all the tied entries."""
    p = 64
    x = np.zeros((4, p), np.float32)
    x[0] = np.where(np.arange(p) % 2 == 0, 0.25, -0.25)  # all tied
    x[2] = np.linspace(-1.0, 1.0, p).astype(np.float32)
    x[3, :10] = [3.0, -3.0, 3.0, 2.0, -2.0, 2.0, 2.0, 1.0, 0.0, 0.0]
    w = np.full(4, 0.25, np.float32)
    for frac in (0.05, 0.1, 0.5):
        tau = cx.topk_thresholds(_t(x), frac)
        jtau = jax_cx.topk_thresholds(jnp.asarray(x), frac)
        np.testing.assert_array_equal(tau.numpy(), np.asarray(jtau))
        assert tau[0].item() == 0.25 and tau[1].item() == 0.0
        out, er = agg_topk_reduce(_t(x), _t(w), tau, with_residual=True)
        jout, jer = jax_topk_reduce(jnp.asarray(x), jnp.asarray(w), jtau,
                                    with_residual=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_array_equal(er.numpy(), np.asarray(jer))
        assert not er[0].any() and not er[1].any()
    # frac 0.05 keeps k = 4 entries of row 3: the 3s and every tied 2
    kept = ref_topk_mask_reduce(_t(x), _t(w), cx.topk_thresholds(_t(x),
                                                                  0.05),
                                with_residual=True)[1][3] == 0
    assert int(kept[:8].sum()) == 7


def test_error_feedback_residual_is_exact_codec_error():
    x, _, _, resid, uniform = _inputs(3, 128, seed=2)
    for comp in (CompressionConfig(kind="int8"),
                 CompressionConfig(kind="topk", topk_frac=0.05)):
        t, new_r = cx.ef_compress_flat(_t(x), _t(uniform), comp,
                                       _t(resid))
        np.testing.assert_allclose((t + new_r).numpy(), x + resid,
                                   rtol=1e-5, atol=1e-6)
        t2, new_r2 = cx.ef_compress_flat(_t(x), _t(uniform), comp,
                                         _t(resid))
        assert torch.equal(t, t2) and torch.equal(new_r, new_r2)


TRANSPORT_CASES = {
    "int8": dict(comp=dict(kind="int8")),
    "int8_rtn_no_ef": dict(comp=dict(kind="int8", stochastic=False,
                                     error_feedback=False)),
    "dp_int8_ef": dict(comp=dict(kind="int8"),
                       priv=dict(clip_norm=2.0, noise_multiplier=0.5)),
    "topk_ef": dict(comp=dict(kind="topk", topk_frac=0.05)),
    "dp_topk_median": dict(comp=dict(kind="topk", topk_frac=0.05),
                           priv=dict(clip_norm=2.0, noise_multiplier=0.5),
                           agg="median"),
    "int8_median": dict(comp=dict(kind="int8"), agg="median"),
}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("case", sorted(TRANSPORT_CASES))
def test_transport_delta_flat_matches_jax(case, use_pallas):
    """DP release → EF / codec → reduce, against the reference's jnp
    path (its noise and uniforms drawn from its own keys and handed to
    the port), through the plain paths or the kernels' wrappers."""
    import jax

    spec = TRANSPORT_CASES[case]
    c, p = 5, 700
    x, w, _, resid, _ = _inputs(c, p, seed=len(case))
    comp_kw, priv_kw = spec["comp"], spec.get("priv", {})
    name = spec.get("agg", "fedavg")
    jcomp = JaxCompressionConfig(**comp_kw)
    jpriv = JaxPrivacyConfig(**priv_kw)
    keys = jax.random.split(jax.random.PRNGKey(len(case)), c)
    jagg = jax_make_aggregator(JaxAggConfig(name=name), num_clients=c)
    r = resid if jcomp.error_feedback else None
    jout, jr = jax_cx.transport_delta_flat(
        jnp.asarray(x), jnp.asarray(w), keys, jpriv, jcomp, jagg,
        None if r is None else jnp.asarray(r))
    from repro.core import privacy as jax_dp
    noise = (np.asarray(jax_dp.client_noise(keys, (c, p), jpriv.sigma))
             if jpriv.enabled and jpriv.noise_multiplier > 0 else None)
    uniform = (np.asarray(jax_cx.client_uniform(keys, (c, p)))
               if jcomp.needs_rng else None)
    agg = make_aggregator(AggConfig(name=name), num_clients=c,
                          use_pallas=use_pallas)
    out, new_r = cx.transport_delta_flat(
        _t(x), _t(w), None if noise is None else _t(noise),
        None if uniform is None else _t(uniform),
        PrivacyConfig(**priv_kw), CompressionConfig(**comp_kw), agg,
        None if r is None else _t(r), use_pallas=use_pallas)
    u = np.abs(x).max() + (np.abs(r).max() if r is not None else 0.0)
    if noise is not None:
        u += np.abs(noise).max()
    level = float(u / 127.0) if comp_kw["kind"] == "int8" else 0.0
    _assert_levels(out.numpy(), jout, level)
    assert (new_r is None) == (jr is None) == (r is None)
    if new_r is not None:
        _assert_levels(new_r.numpy(), jr, level)


def test_compression_config_needs_rng_matches_reference():
    for kw in (dict(kind="int8"), dict(kind="int8", stochastic=False),
               dict(kind="topk"), dict()):
        assert (CompressionConfig(**kw).needs_rng
                == JaxCompressionConfig(**kw).needs_rng)


def test_transport_rejects_a_disabled_codec():
    agg = make_aggregator(AggConfig(), num_clients=2)
    with pytest.raises(ValueError, match="kind"):
        cx.transport_delta_flat(torch.ones((2, 4)), torch.ones(2) / 2,
                                None, None, PrivacyConfig(),
                                CompressionConfig(), agg, None)
