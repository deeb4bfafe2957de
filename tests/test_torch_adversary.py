"""The port's adversary stage (``core/adversary.py``, the attack stage of
``core/pipeline.py``) against the JAX package's, on the CPU.

Unit parity on the same numpy inputs: the attacker mask from the
reference's own per-client uniforms (exact count, ties by client index),
each delta attack with the reference's attack noise (ALIE's honest
moments included), ``flip_preferences``, the stage flags and the
defense-composition guard. Then three replayed rounds of three delta
attacks (sign_flip × krum, alie × median, gaussian × FedAvg with a norm
bound), the port replaying the reference's init, batches, attacker masks
and noise (``attack_draws=``), held by
``test_torch_train.py``'s tolerances (round losses rtol 1e-4, eval and
params atol 1e-4). Tolerances of the unit checks: the mask and the
sign, scale and identity attacks exact; the gaussian attack 1e-6 (one
multiply-add); ALIE and its moments 1e-5 (sums over rows in another
order, a square root). label_flip × FedAvg is replayed under faults in
``test_torch_availability.py`` (one reference compile fewer).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AdversaryConfig as JaxAdversaryConfig
from repro.configs import AggConfig as JaxAggConfig
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import PrivacyConfig as JaxPrivacyConfig
from repro.core import adversary as jax_byz
from repro.core.aggregation import make_aggregator as jax_make_aggregator
from repro.core.pipeline import make_pipeline as jax_make_pipeline
from repro_torch.configs import (
    AdversaryConfig,
    AggConfig,
    FedConfig,
    GPOConfig,
    PrivacyConfig,
)
from repro_torch.core import FederatedGPO, make_aggregator
from repro_torch.core import adversary as byz
from repro_torch.core.pipeline import make_pipeline
from test_torch_train import (
    FED,
    SMALL,
    _assert_runs_agree,
    _jax_setup,
    _stage_pair,
)

KINDS = ("sign_flip", "scaled", "gaussian", "alie", "none", "label_flip")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's runs: the suite runs several
    workers on the CPU's cores, and a thread pool the size of the
    machine in each oversubscribes them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c,f", [(8, 3), (5, 0), (4, 9), (64, 16)])
def test_attacker_mask_from_the_reference_draws(c, f):
    """The reference's per-client uniforms give the reference's mask:
    exactly min(f, C) attackers."""
    bk = jax_byz.fold_byz_key(jax.random.PRNGKey(c + f))
    u = np.asarray(jax_byz.attacker_draws(bk, c))
    mask = byz.attacker_mask(torch.tensor(u), f)
    assert mask.dtype == torch.bool and int(mask.sum()) == min(f, c)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jax_byz.attacker_mask(bk, c, f)))


def test_attacker_mask_ties_resolve_in_client_order():
    """Tied draws: the stable double argsort ranks them by client index,
    as jnp.argsort does."""
    u = np.array([0.5, 0.2, 0.5, 0.2, 0.9, 0.5, 0.2], np.float32)
    for f in range(len(u) + 1):
        want = np.asarray(jnp.argsort(jnp.argsort(jnp.asarray(u))) < f)
        got = byz.attacker_mask(torch.from_numpy(u), f).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.sum() == f


def test_attacker_draws_are_uniform_per_client():
    g = torch.Generator().manual_seed(0)
    u = byz.attacker_draws(g, 10)
    assert u.shape == (10,) and bool(((u >= 0) & (u < 1)).all())
    assert not torch.equal(u, byz.attacker_draws(g, 10))


@pytest.mark.parametrize("kind", KINDS)
def test_attacks_match_the_reference(kind):
    c, p = 6, 37
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((c, p)).astype(np.float32)
    mask = np.array([True, False, True, False, False, False])
    bk = jax_byz.fold_byz_key(jax.random.PRNGKey(2))
    gids = jnp.arange(c)
    kw = dict(kind=kind, num_attackers=2, scale=7.0, noise_std=0.3,
              alie_z=1.5)
    want = np.asarray(jax_byz.apply_attack(
        jnp.asarray(vecs), jnp.asarray(mask), JaxAdversaryConfig(**kw), bk,
        gids))
    noise = np.asarray(jax_byz.attack_noise(bk, gids, p))
    got = byz.apply_attack(torch.from_numpy(vecs), torch.from_numpy(mask),
                           AdversaryConfig(**kw), torch.tensor(noise))
    tol = {"gaussian": 1e-6, "alie": 1e-5}.get(kind, 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.numpy()[~mask], vecs[~mask])
    if kind == "alie":  # the colluders ship one row
        np.testing.assert_array_equal(got.numpy()[0], got.numpy()[2])


def test_honest_stats_match_the_reference():
    rng = np.random.default_rng(4)
    vecs = (rng.standard_normal((9, 50)) * 1e-2 + 3e-2).astype(np.float32)
    mask = np.zeros(9, bool)
    mask[[1, 4, 8]] = True
    want = jax_byz.honest_stats(jnp.asarray(vecs), jnp.asarray(mask))
    got = byz.honest_stats(torch.from_numpy(vecs), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert bool((got[1] >= 0).all())


def test_attack_rows_do_not_depend_on_the_cohort():
    """A client's corrupted row depends only on its own delta and its row
    of the population's draws: the cohort's rows of the full attack are
    the attack of the cohort alone (gaussian: the noise is drawn (C, P)
    and sliced; the reference's keyed-by-global-id property)."""
    c, p = 8, 17
    fed_cfg = FedConfig(adversary=AdversaryConfig(kind="gaussian",
                                                  num_attackers=3))
    pipe = make_pipeline(fed_cfg, agg=make_aggregator(AggConfig(),
                                                      num_clients=c),
                         num_clients=c)
    g = torch.Generator().manual_seed(5)
    vecs = torch.randn((c, p), generator=g)
    mask = byz.attacker_mask(byz.attacker_draws(g, c), 3)
    noise = torch.randn((c, p), generator=g)
    full = pipe.attack_rows(vecs, pipe.attack_draws(mask, noise))
    sub = torch.tensor([1, 4, 6])
    part = pipe.attack_rows(vecs[sub], pipe.attack_draws(mask, noise, sub))
    assert torch.equal(full[sub], part)
    assert not torch.equal(full, vecs)
    with pytest.raises(ValueError, match="population"):
        pipe.attack_draws(mask[:5], noise)


def test_flip_preferences_matches_the_reference():
    rng = np.random.default_rng(9)
    y = rng.dirichlet(np.ones(4), size=5).astype(np.float32).reshape(-1)
    got = byz.flip_preferences(torch.from_numpy(y), 4).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_byz.flip_preferences(jnp.asarray(y), 4)))
    rows = got.reshape(5, 4)
    np.testing.assert_allclose(rows.sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(np.argmax(y.reshape(5, 4), -1),
                                  np.argmin(rows, -1))


@pytest.mark.parametrize("adv,agg", [
    (dict(), dict()),
    (dict(kind="sign_flip", num_attackers=2), dict(name="krum")),
    (dict(kind="label_flip", num_attackers=2), dict()),
    (dict(kind="alie", num_attackers=0), dict(norm_bound=0.5)),
    (dict(), dict(name="median"))])
def test_stage_flags_match_the_reference(adv, agg):
    jcfg = JaxFedConfig(adversary=JaxAdversaryConfig(**adv),
                        agg=JaxAggConfig(**agg))
    cfg = FedConfig(adversary=AdversaryConfig(**adv), agg=AggConfig(**agg))
    jp = jax_make_pipeline(jcfg, agg=jax_make_aggregator(
        jcfg.agg, num_clients=6), num_clients=6)
    p = make_pipeline(cfg, agg=make_aggregator(cfg.agg, num_clients=6),
                      num_clients=6)
    for name in ("attack_delta", "flip_data", "restructured"):
        assert getattr(p, name) == getattr(jp, name), name
    assert p.stages() == jp.stages()


@pytest.mark.parametrize("strict", [False, True])
def test_defense_composition_guard(strict):
    """A defended DP run under adaptive aggregation warns (strict
    privacy: raises) in both packages; a loss-free rule does not."""
    kw = dict(kind="sign_flip", num_attackers=1)
    priv = dict(clip_norm=1.0, noise_multiplier=0.8)

    def cfgs(name):
        return (JaxFedConfig(adversary=JaxAdversaryConfig(**kw),
                             agg=JaxAggConfig(name=name),
                             privacy=JaxPrivacyConfig(**priv),
                             strict_privacy=strict),
                FedConfig(adversary=AdversaryConfig(**kw),
                          agg=AggConfig(name=name),
                          privacy=PrivacyConfig(**priv),
                          strict_privacy=strict))

    for cfg, check in zip(cfgs("adaptive"), (
            jax_byz.check_defense_composition,
            byz.check_defense_composition)):
        if strict:
            with pytest.raises(ValueError, match="adaptive"):
                check(cfg)
        else:
            with pytest.warns(UserWarning, match="adaptive"):
                check(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        byz.check_defense_composition(cfgs("median")[1])
    _, port_data, tr, ev = _jax_setup()
    cfg = FedConfig(num_clients=len(tr), **FED, adversary=AdversaryConfig(
        **kw), agg=AggConfig(name="adaptive"), privacy=PrivacyConfig(
        **priv), strict_privacy=strict)
    if strict:
        with pytest.raises(ValueError, match="adaptive"):
            FederatedGPO(GPOConfig(**SMALL), cfg, port_data, tr, ev,
                         device="cpu")
    else:
        with pytest.warns(UserWarning, match="adaptive"):
            FederatedGPO(GPOConfig(**SMALL), cfg, port_data, tr, ev,
                         device="cpu")


# ---------------------------------------------------------------------------
# replayed rounds
# ---------------------------------------------------------------------------
# a bound under the attacked rows' norms at this size (the honest rows
# lie near 0.08 after two Adam steps), so the gaussian rows are clipped
ATTACKS = {
    "sign_flip-krum": dict(adversary=dict(kind="sign_flip",
                                          num_attackers=1),
                           agg=dict(name="krum", num_malicious=1)),
    "alie-median": dict(adversary=dict(kind="alie", num_attackers=1),
                        agg=dict(name="median")),
    "gaussian-fedavg-norm_bound": dict(
        adversary=dict(kind="gaussian", num_attackers=1, noise_std=0.01),
        agg=dict(norm_bound=0.1)),
}


@pytest.mark.parametrize("label", list(ATTACKS))
def test_attacked_rounds_match_the_reference(label):
    fed, jfed, h, jh, _ = _stage_pair(ATTACKS[label], rounds=3)
    assert len(h.round_loss) == 3 and h.round_survivors == []
    _assert_runs_agree(h, jh, fed.global_params, jfed.global_params)
    assert int(fed.server_state.step) == int(jfed.server_state.step) == 3


def test_train_launcher_attack_flags(capsys, monkeypatch):
    """--attack, --attackers and --attack-scale reach the FedConfig:
    --attackers sets both the simulated attackers and the defense's f;
    one round on the CPU at GPOConfig() width."""
    from repro_torch.launch import train

    built = []

    def spy(gcfg, fcfg, *a, **k):
        built.append(fcfg)
        return FederatedGPO(gcfg, fcfg, *a, **k)

    monkeypatch.setattr(train, "FederatedGPO", spy)
    train.main(["--trainer", "gpo", "--rounds", "1", "--device", "cpu",
                "--agg", "krum", "--attack", "scaled", "--attackers", "2",
                "--attack-scale", "30"])
    assert built[0].adversary == AdversaryConfig(kind="scaled",
                                                 num_attackers=2, scale=30.0)
    assert built[0].agg.num_malicious == 2
    assert "1 rounds on cpu (krum)" in capsys.readouterr().out
