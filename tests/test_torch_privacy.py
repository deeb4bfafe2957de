"""The port's DP pipeline (DESIGN.md §9) against the JAX package's, on
the CPU: the ``clip_reduce`` kernel wrapper (its plain version here; the
JAX kernel in Pallas interpret mode), the clip and release functions
with the reference's own noise handed over as numpy, the Rényi
accountant, and the adaptive-aggregation guard.

Tolerances: rtol 2e-5, atol 2e-5 for the clip reduce and the released
rows (the reference test's: float32 norms and weighted sums in another
order); the accountant to rtol 1e-12 (the same float64 formula); the
clip scales to 1e-6 relative (norms summed in another order).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AggConfig as JaxAggConfig
from repro.configs import CompressionConfig as JaxCompressionConfig
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import PrivacyConfig as JaxPrivacyConfig
from repro.core import make_aggregator as jax_make_aggregator
from repro.core import privacy as jax_dp
from repro.core.pipeline import make_pipeline as jax_make_pipeline
from repro.kernels import agg_clip_reduce as jax_clip_reduce
from repro.kernels.ref import ref_clip_reduce as jax_ref_clip_reduce
from repro_torch.configs import (
    AggConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
    PrivacyConfig,
)
from repro_torch.core import FederatedGPO
from repro_torch.core import privacy as dp
from repro_torch.core.aggregation import make_aggregator
from repro_torch.core.pipeline import make_pipeline
from repro_torch.data import SurveyConfig, make_survey_data, split_groups
from repro_torch.kernels import agg_clip_reduce
from repro_torch.kernels.ref import ref_clip_reduce
from repro_torch.utils.pytree import tree_count_params

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(c, p, seed):
    """Deltas with every other client 10x larger (half the rows above a
    median clip), softmax weights and noise, as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, p)).astype(np.float32)
    x[::2] *= 10.0
    w = np.exp(rng.standard_normal(c)).astype(np.float32)
    w /= w.sum()
    noise = (0.3 * rng.standard_normal((c, p))).astype(np.float32)
    clip = float(np.median(np.linalg.norm(x, axis=1)))
    return x, w, noise, clip


@pytest.mark.parametrize("c,p", [(2, 100), (5, 1000), (9, 4097)])
@pytest.mark.parametrize("with_noise", [False, True])
def test_clip_reduce_matches_jax(c, p, with_noise):
    x, w, noise, clip = _inputs(c, p, seed=c + p)
    n = noise if with_noise else None
    out = agg_clip_reduce(_t(x), _t(w), clip=clip,
                          noise=None if n is None else _t(n))
    jout = jax_clip_reduce(jnp.asarray(x), jnp.asarray(w), clip=clip,
                           noise=None if n is None else jnp.asarray(n))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    jref = jax_ref_clip_reduce(jnp.asarray(x), jnp.asarray(w), clip=clip,
                               noise=None if n is None else jnp.asarray(n))
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **TOL)
    # the wrapper's CPU path is the plain version
    assert torch.equal(out, ref_clip_reduce(
        _t(x), _t(w), clip=clip, noise=None if n is None else _t(n)))


def test_clip_reduce_rejects_a_disabled_clip_and_bad_shapes():
    x, w = torch.ones((3, 8)), torch.full((3,), 1.0 / 3)
    for clip in (0.0, -1.0):
        with pytest.raises(ValueError, match="clip"):
            agg_clip_reduce(x, w, clip=clip)
    with pytest.raises(ValueError, match="shapes"):
        agg_clip_reduce(x, w, clip=1.0, noise=torch.zeros((3, 7)))


@pytest.mark.parametrize("clip_norm,z", [(0.5, 0.0), (0.5, 0.8),
                                         (1e6, 0.8)],
                         ids=["clip_only", "tight", "generous"])
def test_release_matches_jax_with_its_noise(clip_norm, z):
    """clip_scales, privatize_flat and clip_noise_reduce (plain and
    through the kernel wrapper), against the reference fed the same
    per-client keys, whose noise goes to the port as numpy."""
    c, p = 6, 513
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((c, p))).astype(np.float32)
    x[2] = 0.0  # a zero delta keeps scale 1
    w = np.full(c, 1.0 / c, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), c)
    jpriv = JaxPrivacyConfig(clip_norm=clip_norm, noise_multiplier=z)
    priv = PrivacyConfig(clip_norm=clip_norm, noise_multiplier=z)
    assert priv.sigma == jpriv.sigma
    noise = (_t(jax_dp.client_noise(keys, (c, p), jpriv.sigma))
             if z > 0 else None)
    np.testing.assert_allclose(
        dp.clip_scales(_t(x), clip_norm).numpy(),
        np.asarray(jax_dp.clip_scales(jnp.asarray(x), clip_norm)),
        rtol=1e-6, atol=0)
    assert dp.clip_scales(_t(x), clip_norm)[2].item() == 1.0
    rel = dp.privatize_flat(_t(x), noise, priv)
    jrel = jax_dp.privatize_flat(jnp.asarray(x), keys, jpriv)
    np.testing.assert_allclose(rel.numpy(), np.asarray(jrel), **TOL)
    jout = jax_dp.clip_noise_reduce(jnp.asarray(x), jnp.asarray(w), keys,
                                    jpriv)
    for use_pallas in (False, True):
        out = dp.clip_noise_reduce(_t(x), _t(w), noise, priv,
                                   use_pallas=use_pallas)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("name", ["fedavg", "median"])
def test_private_delta_flat_matches_jax(name):
    """The linear family fuses clip and noise into the weighted sum, the
    robust family trims the privatized rows (through the trimmed
    kernel's wrapper with ``use_pallas``)."""
    c, p = 5, 400
    rng = np.random.default_rng(9)
    x = rng.standard_normal((c, p)).astype(np.float32)
    w = np.full(c, 1.0 / c, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), c)
    jpriv = JaxPrivacyConfig(clip_norm=5.0, noise_multiplier=0.6)
    jagg = jax_make_aggregator(JaxAggConfig(name=name), num_clients=c)
    jout = jax_dp.private_delta_flat(jnp.asarray(x), jnp.asarray(w), keys,
                                     jpriv, jagg)
    noise = _t(jax_dp.client_noise(keys, (c, p), jpriv.sigma))
    for use_pallas in (False, True):
        agg = make_aggregator(AggConfig(name=name), num_clients=c,
                              use_pallas=use_pallas)
        out = dp.private_delta_flat(
            _t(x), _t(w), noise,
            PrivacyConfig(clip_norm=5.0, noise_multiplier=0.6), agg,
            use_pallas=use_pallas)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_release_refuses_a_noised_config_without_noise():
    priv = PrivacyConfig(clip_norm=1.0, noise_multiplier=0.5)
    with pytest.raises(ValueError, match="noise"):
        dp.privatize_flat(torch.ones((2, 4)), None, priv)


def test_client_noise_is_sigma_scaled_and_seeded():
    shape = (4, 20000)
    a = dp.client_noise(torch.Generator().manual_seed(5), shape, 0.38)
    b = dp.client_noise(torch.Generator().manual_seed(5), shape, 0.38)
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert abs(a.std().item() - 0.38) < 0.01 and abs(a.mean().item()) < 0.01


@pytest.mark.parametrize("q", [1.0, 0.3, 0.05])
@pytest.mark.parametrize("z", [0.8, 1.1, 3.0])
def test_accountant_matches_jax(q, z):
    orders = PrivacyConfig().accountant_orders
    assert orders == JaxPrivacyConfig().accountant_orders
    np.testing.assert_allclose(dp.rdp_sampled_gaussian(q, z, orders),
                               jax_dp.rdp_sampled_gaussian(q, z, orders),
                               rtol=1e-12, atol=0)
    acct = dp.RdpAccountant(z, q, 1e-5)
    jacct = jax_dp.RdpAccountant(z, q, 1e-5)
    for steps in (0, 1, 3, 150, 1300):
        assert acct.epsilon(steps) == pytest.approx(jacct.epsilon(steps),
                                                    rel=1e-12)


def test_accountant_edges_and_gating_match_jax():
    assert dp.RdpAccountant(0.0, 1.0).epsilon(5) == float("inf")
    with pytest.raises(ValueError, match="sampling rate"):
        dp.rdp_sampled_gaussian(1.5, 1.0, (2, 3))
    with pytest.raises(ValueError, match="orders"):
        dp.rdp_sampled_gaussian(0.5, 1.0, (1, 2))
    rdp = np.linspace(0.1, 3.0, 5)
    assert dp.eps_from_rdp(rdp, range(2, 7), 1e-6) == pytest.approx(
        jax_dp.eps_from_rdp(rdp, range(2, 7), 1e-6), rel=1e-12)
    for kw in (dict(), dict(clip_norm=1.0),
               dict(clip_norm=1.0, noise_multiplier=1.0)):
        port = dp.make_accountant(PrivacyConfig(**kw), 0.5)
        ref = jax_dp.make_accountant(JaxPrivacyConfig(**kw), 0.5)
        assert (port is None) == (ref is None)
        if port is not None:
            assert port.epsilon(7) == pytest.approx(ref.epsilon(7),
                                                    rel=1e-12)


def _guard_cfgs(**kw):
    priv = dict(clip_norm=1.0, noise_multiplier=0.8)
    return (FedConfig(agg=AggConfig(name="adaptive"),
                      privacy=PrivacyConfig(**priv), **kw),
            JaxFedConfig(agg=JaxAggConfig(name="adaptive"),
                         privacy=JaxPrivacyConfig(**priv), **kw))


def test_adaptive_plus_noise_warns_like_jax():
    for cfg, check in zip(_guard_cfgs(), (dp.check_adaptive_privacy,
                                          jax_dp.check_adaptive_privacy)):
        with pytest.warns(UserWarning, match="side-channel"):
            check(cfg)


def test_adaptive_plus_noise_raises_under_strict_privacy_like_jax():
    for cfg, check in zip(_guard_cfgs(strict_privacy=True),
                          (dp.check_adaptive_privacy,
                           jax_dp.check_adaptive_privacy)):
        with pytest.raises(ValueError, match="side-channel"):
            check(cfg)


def test_adaptive_guard_silent_when_benign():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dp.check_adaptive_privacy(FedConfig(
            agg=AggConfig(name="adaptive"),
            privacy=PrivacyConfig(clip_norm=1.0)))
        dp.check_adaptive_privacy(FedConfig(
            privacy=PrivacyConfig(clip_norm=1.0, noise_multiplier=0.8)))


@pytest.mark.parametrize("priv,comp", [
    ({}, {}), (dict(clip_norm=0.5), {}), ({}, dict(kind="topk")),
    (dict(clip_norm=0.5, noise_multiplier=1.0), dict(kind="int8"))])
def test_round_pipeline_stages_match_jax(priv, comp):
    kw = dict(privacy=PrivacyConfig(**priv),
              compression=CompressionConfig(**comp))
    jkw = dict(privacy=JaxPrivacyConfig(**priv),
               compression=JaxCompressionConfig(**comp))
    pipe = make_pipeline(FedConfig(**kw), agg=make_aggregator(
        AggConfig(), num_clients=3))
    jpipe = jax_make_pipeline(JaxFedConfig(**jkw), agg=jax_make_aggregator(
        JaxAggConfig(), num_clients=3))
    assert pipe.stages() == jpipe.stages()


def _small_fed(fcfg_kw, **hooks):
    data = make_survey_data(SurveyConfig(num_groups=5, num_questions=20,
                                         d_embed=8))
    tr, ev = split_groups(data)
    cfg = GPOConfig(d_embed=8, d_model=16, num_layers=1, num_heads=2,
                    d_ff=16)
    fcfg = FedConfig(num_clients=len(tr), local_epochs=1, num_context=4,
                     num_target=4, eval_every=1, **fcfg_kw)
    return FederatedGPO(cfg, fcfg, data, tr, ev, device="cpu", **hooks)


def test_round_eps_counts_across_runs_and_draws_are_seeded():
    """ε composes over every round the trainer ran, across run() calls;
    without replay the noise comes from a generator seeded by
    FedConfig.seed, so two trainers agree bit for bit, with and without
    the kernels' wrappers (the same draws on one device)."""
    priv = PrivacyConfig(clip_norm=0.05, noise_multiplier=0.8)
    fed = _small_fed(dict(privacy=priv))
    acct = dp.RdpAccountant(0.8, 1.0, priv.target_delta)
    assert fed.run(rounds=2).round_eps == [acct.epsilon(1),
                                           acct.epsilon(2)]
    assert fed.run(rounds=1).round_eps == [acct.epsilon(3)]
    runs = [_small_fed(dict(privacy=priv, use_pallas_aggregation=k))
            for k in (False, True, True)]
    hists = [f.run(rounds=2) for f in runs]
    assert hists[1].round_loss == hists[2].round_loss
    np.testing.assert_allclose(hists[0].round_loss, hists[1].round_loss,
                               rtol=1e-6)
    clip_only = _small_fed(dict(privacy=PrivacyConfig(clip_norm=0.05)))
    assert clip_only.run(rounds=2).round_eps == [float("inf")] * 2


def test_release_draws_hook_replays_noise():
    """The hook's noise replaces the generator's: a zero-noise replay of
    a noised config equals the clip-only run."""
    clip_only = _small_fed(dict(privacy=PrivacyConfig(clip_norm=0.05)))
    shape = (len(clip_only.train_groups),
             tree_count_params(clip_only.global_params))
    zero = _small_fed(
        dict(privacy=PrivacyConfig(clip_norm=0.05, noise_multiplier=0.8)),
        release_draws=lambda r: (np.zeros(shape, np.float32), None))
    assert (zero.run(rounds=2).round_loss
            == clip_only.run(rounds=2).round_loss)
