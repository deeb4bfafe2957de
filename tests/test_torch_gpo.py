"""The port's GPO predictor, layers, alignment metrics and survey data
against the JAX package's, on the CPU and on the same weights.

Weights are drawn by the JAX package and carried over with
``params_from_numpy``; inputs are numpy arrays from a seed. The port's
kernel branch runs the attention kernel's plain version here, the JAX
branch its Pallas kernel in interpret mode. Tolerance: atol 1e-5 and
rtol 1e-5 in float32 (the same ops in another summation order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import GPOConfig as JaxGPOConfig
from repro.core import fairness as jax_fairness
from repro.core import gpo as jax_gpo
from repro.core.serving import quantize_gpo_params as jax_quantize
from repro.data import SurveyConfig as JaxSurveyConfig
from repro.data import split_groups as jax_split_groups
from repro_torch.checkpoint.checkpoint import _leaves
from repro_torch.configs import GPOConfig
from repro_torch.core import (
    GPOPrefix,
    fairness,
    gpo_apply,
    gpo_decode,
    gpo_prefill,
    init_gpo_params,
    params_from_numpy,
    predict_preferences,
)
from repro_torch.core.gpo import _key_mask, _np_mask
from repro_torch.data import (
    SurveyConfig,
    make_survey_data,
    sample_icl_batch,
    split_groups,
)
from repro_torch.kernels import QuantizedLinear
from repro_torch.models.layers import rms_norm

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(d_embed=16, d_model=32, num_layers=2, num_heads=4, d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    return GPOConfig(**kw), JaxGPOConfig(**kw)


def _weights(jcfg, seed=0, int8=False):
    """JAX params (f32 or quantized) and the port's copy on the CPU."""
    p = jax_gpo.init_gpo_params(jcfg, jax.random.PRNGKey(seed))
    if int8:
        p = jax_quantize(p)
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


def _icl(d_embed, m, t, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(batch + (m, d_embed)).astype(np.float32),
            rng.uniform(size=batch + (m,)).astype(np.float32),
            rng.standard_normal(batch + (t, d_embed)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# init and layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("learn_sigma", [False, True])
def test_init_gpo_params_matches_reference_structure(learn_sigma):
    cfg, jcfg = _cfgs(learn_sigma=learn_sigma)
    port = init_gpo_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    ref = jax_gpo.init_gpo_params(jcfg, jax.random.PRNGKey(0))
    ref_leaves = {jax.tree_util.keystr(p): leaf for p, leaf in
                  jax.tree_util.tree_flatten_with_path(ref)[0]}
    port_leaves = dict(_leaves(port))
    assert list(port_leaves) == list(ref_leaves)  # names and leaf order
    for name, leaf in port_leaves.items():
        assert tuple(leaf.shape) == ref_leaves[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == str(ref_leaves[name].dtype)
        assert leaf.device.type == "cpu"
    for norm in (port["final_norm"], port["layers"].ln1, port["layers"].ln2):
        assert torch.count_nonzero(norm) == 0
    for name, w in port_leaves.items():
        if w.dim() < 2 or "ln" in name:
            continue
        sigma = 1.0 / math.sqrt(w.shape[-2])
        assert w.abs().max() <= 2 * sigma * (1 + 1e-6), name
        if w.numel() >= 4096:  # a ±2σ truncated normal has std 0.880σ
            assert abs(w.std().item() / sigma - 0.880) < 0.03, name


def test_init_gpo_params_seeded():
    cfg = GPOConfig(**SMALL)
    a, b = (init_gpo_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_leaves(a), _leaves(b)))


def test_rms_norm_matches_reference():
    from repro.models.layers import rms_norm as jax_rms_norm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    _close(rms_norm(*_t(x, scale), 1e-6),
           jax_rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))


def test_masks_match_reference():
    assert np.array_equal(_np_mask(5, 7).numpy(),
                          np.asarray(jax_gpo._np_mask(5, 7)))
    assert np.array_equal(_key_mask(9, 4).numpy(),
                          np.asarray(jax_gpo._key_mask(9, 4)))
    assert _key_mask(9, None) is None
    both = _key_mask(6, torch.tensor([0, 6])).numpy()
    assert not both[0].any() and both[1].all()


# ---------------------------------------------------------------------------
# the forward paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", [False, True], ids=["dense", "kernel"])
@pytest.mark.parametrize("width", ["small", "default"])
def test_gpo_apply_matches_jax(kernel, width):
    # "default": GPOConfig()'s widths at two layers
    kw = SMALL if width == "small" else dict(num_layers=2)
    cfg, jcfg = _cfgs(use_pallas_attention=kernel, **kw)
    jp, tp = _weights(jcfg)
    ctx_x, ctx_y, tgt_x = _icl(cfg.d_embed, 30, 25)
    mu_ref, ls_ref = jax_gpo.gpo_apply(jp, jcfg, ctx_x, ctx_y, tgt_x)
    mu, ls = gpo_apply(tp, cfg, *_t(ctx_x, ctx_y, tgt_x))
    assert ls is None and ls_ref is None
    _close(mu, mu_ref)


def test_gpo_apply_batch_axis_and_learn_sigma_match_vmapped_jax():
    cfg, jcfg = _cfgs(learn_sigma=True, **SMALL)
    jp, tp = _weights(jcfg, seed=1)
    ctx_x, ctx_y, tgt_x = _icl(cfg.d_embed, 12, 9, seed=1, batch=(3,))
    mu_ref, ls_ref = jax.vmap(
        lambda a, b, c: jax_gpo.gpo_apply(jp, jcfg, a, b, c))(
            ctx_x, ctx_y, tgt_x)
    mu, ls = gpo_apply(tp, cfg, *_t(ctx_x, ctx_y, tgt_x))
    _close(mu, mu_ref)
    _close(ls, ls_ref)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_prefill_decode_ragged_match_jax(int8):
    """Batched prefill with ragged ctx_len (one padded group has
    ctx_len 0) and decode against it, against the JAX functions group by
    group; every row finite, padded ones included."""
    cfg, jcfg = _cfgs(**SMALL)
    jp, tp = _weights(jcfg, seed=2, int8=int8)
    m, t = 20, 10
    ctx_x, ctx_y, tgt_x = _icl(cfg.d_embed, m, t, seed=2, batch=(3,))
    lens = np.array([20, 7, 0])
    pre = gpo_prefill(tp, cfg, *_t(ctx_x, ctx_y), ctx_len=torch.tensor(lens))
    assert pre.k.shape == (3, cfg.num_layers, m, cfg.num_heads,
                           cfg.head_dim)
    assert torch.isfinite(pre.k).all() and torch.isfinite(pre.v).all()
    mu = gpo_decode(tp, cfg, pre, *_t(tgt_x), ctx_len=torch.tensor(lens))[0]
    assert torch.isfinite(mu).all()
    # the JAX package's own batching of these functions (vmap, as its
    # serving engine does)
    ref = jax.jit(jax.vmap(lambda cx, cy, n: jax_gpo.gpo_prefill(
        jp, jcfg, cx, cy, ctx_len=n)))(ctx_x, ctx_y, lens)
    _close(pre.k, ref.k)
    _close(pre.v, ref.v)
    mu_ref = jax.jit(jax.vmap(lambda k, v, tx, n: jax_gpo.gpo_decode(
        jp, jcfg, jax_gpo.GPOPrefix(k, v), tx, ctx_len=n)[0]))(
            ref.k, ref.v, tgt_x, lens)
    _close(mu, mu_ref)


def test_prefill_decode_unbatched_equals_apply():
    cfg, jcfg = _cfgs(**SMALL)
    _, tp = _weights(jcfg, seed=3)
    ctx_x, ctx_y, tgt_x = _t(*_icl(cfg.d_embed, 15, 10, seed=3))
    pre = gpo_prefill(tp, cfg, ctx_x, ctx_y)
    assert isinstance(pre, GPOPrefix) and pre.num_ctx == 15
    mu, _ = gpo_decode(tp, cfg, pre, tgt_x)
    mu_ref, _ = gpo_apply(tp, cfg, ctx_x, ctx_y, tgt_x)
    np.testing.assert_allclose(mu.numpy(), mu_ref.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kernel", [False, True], ids=["dense", "kernel"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_predict_preferences_matches_jax(kernel, int8):
    cfg, jcfg = _cfgs(use_pallas_attention=kernel, **SMALL)
    jp, tp = _weights(jcfg, seed=4, int8=int8)
    ctx_x, ctx_y, tgt_x = _icl(cfg.d_embed, 20, 15, seed=4)
    ref = jax_gpo.predict_preferences(jp, jcfg, ctx_x, ctx_y, tgt_x, 5)
    rows = predict_preferences(tp, cfg, ctx_x, ctx_y, tgt_x, 5,
                               device="cpu")
    assert rows.shape == (3, 5)
    _close(rows, ref)
    np.testing.assert_allclose(rows.sum(-1).numpy(), 1.0, atol=1e-6)


def test_params_from_numpy_quantized_leaves():
    _, jcfg = _cfgs(**SMALL)
    _, tp = _weights(jcfg, int8=True)
    assert isinstance(tp["in_proj"], QuantizedLinear)
    assert isinstance(tp["layers"].w1, QuantizedLinear)
    assert tp["layers"].w1.q.dtype == torch.int8
    assert tp["layers"].w1.scale.shape == (2, 64)
    assert tp["layers"].ln1.dtype == torch.float32


# ---------------------------------------------------------------------------
# alignment metrics and survey data
# ---------------------------------------------------------------------------
def test_fairness_metrics_match_reference():
    rng = np.random.default_rng(5)
    p = rng.dirichlet(np.ones(5), size=7).astype(np.float32)
    q = rng.dirichlet(np.ones(5), size=7).astype(np.float32)
    q[0] = [1, 0, 0, 0, 0]  # a zero entry stays safe
    tp, tq = _t(p, q)
    _close(fairness.kl_divergence(tp, tq), jax_fairness.kl_divergence(p, q))
    _close(fairness.js_distance(tp, tq), jax_fairness.js_distance(p, q))
    _close(fairness.alignment_score(tp, tq),
           jax_fairness.alignment_score(p, q))
    assert fairness.alignment_score(tp, tp).item() == pytest.approx(1.0)


def test_split_groups_matches_reference():
    assert SurveyConfig() == SurveyConfig(**vars(JaxSurveyConfig()))
    # the split reads only the number of groups
    data = make_survey_data(SurveyConfig(num_questions=16))
    for seed in (0, 3):
        for a, b in zip(split_groups(data, seed=seed),
                        jax_split_groups(data, seed=seed)):
            np.testing.assert_array_equal(a, b)


def test_survey_data_structure_and_icl_sampling():
    cfg = SurveyConfig(num_groups=6, num_questions=40)
    data = make_survey_data(cfg, torch.Generator().manual_seed(1))
    assert data.phi.shape == (40, 5, cfg.d_embed)
    torch.testing.assert_close(data.phi.norm(dim=-1), torch.ones(40, 5))
    torch.testing.assert_close(data.prefs.sum(-1), torch.ones(6, 40))
    assert torch.equal(data.sizes, data.mask.sum(1))
    assert (data.sizes >= max(8, int(0.6 * 40) // 2)).all()
    b = sample_icl_batch(torch.Generator().manual_seed(2), data, 3, 6, 4)
    assert b.ctx_x.shape == (30, cfg.d_embed) and b.tgt_y.shape == (20,)
    qs = b.tgt_q[::5]
    assert data.mask[3, qs].all()
    assert len(set(qs.tolist())) == 4
    assert b.num_options == 5
