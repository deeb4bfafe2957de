"""Partial participation (``FedConfig.batch_groups``) and per-round
optimizer resets in the port's round, on the CPU.

The reference's five subsampling tests (``tests/test_subsampling.py``)
run against the port: the port draws its cohorts from its own training
generator, so where the reference replays its key chain the port's
tests read the cohort the round recorded (``History.round_participants``).
Then replayed parity with the JAX package: two rounds at batch_groups=3
of the 4 training clients, the port replaying the reference's cohorts,
batches and DP noise (``participants=``, ``batches=``,
``release_draws=``), for FedAvg, adaptive, DP noise (ε at q = m/C) and
``reset_opt_each_round``, the port through its kernel wrappers (their
plain versions on CPU tensors), the reference on its dense path (Pallas
interpret mode is the slow part of the JAX package's CPU runs); the
tolerances of ``test_torch_train.py``'s replayed rounds (round losses
rtol 1e-4, eval and params atol 1e-4, ε rtol 1e-12).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import AggConfig as JaxAggConfig
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import GPOConfig as JaxGPOConfig
from repro.configs import PrivacyConfig as JaxPrivacyConfig
from repro.core import FederatedGPO as JaxFederatedGPO
from repro_torch.configs import (
    AggConfig,
    FedConfig,
    GPOConfig,
    PrivacyConfig,
)
from repro_torch.core import AGGREGATORS, FederatedGPO, make_aggregator
from repro_torch.core import privacy as dp
from repro_torch.data import SurveyConfig, make_survey_data, split_groups
from repro_torch.utils.pytree import tree_leaves
from test_torch_train import (
    DP,
    FED,
    SMALL,
    _assert_runs_agree,
    _fed_draws,
    _jax_cohorts,
    _jax_release_draws,
    _jax_setup,
    _np_tree,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's runs: the suite runs several
    workers on the CPU's cores, and a thread pool the size of the
    machine in each oversubscribes them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(batch_groups, **kw):
    """The reference test's setup (10 groups, 50 questions, seed 4, one
    layer), the port's population drawn from the same SurveyConfig."""
    data = make_survey_data(SurveyConfig(
        num_groups=10, num_questions=50, d_embed=24, seed=4))
    tr, ev = split_groups(data, seed=4)
    gcfg = GPOConfig(d_embed=24, d_model=32, num_layers=1, num_heads=2,
                     d_ff=64)
    fcfg = FedConfig(num_clients=len(tr), rounds=10, local_epochs=2,
                     batch_groups=batch_groups, num_context=6, num_target=6,
                     eval_every=5, seed=4, **kw)
    return FederatedGPO(gcfg, fcfg, data, tr, ev, device="cpu")


def _touched(fed) -> list:
    return sorted(np.nonzero(fed.opt_states.step.numpy() > 0)[0].tolist())


def test_subsampled_round_learns():
    fed = _setup(batch_groups=3)
    hist = fed.run(rounds=12)
    assert len(hist.round_loss) == 12
    assert [len(c) for c in hist.round_participants] == [3] * 12
    assert all(len(set(c)) == 3 for c in hist.round_participants)
    assert hist.round_loss[-1] < hist.round_loss[0]


def test_full_participation_unchanged():
    """batch_groups=0 is the paper's all-clients protocol; a batch_groups
    above C clips to C and runs the same round."""
    h1 = _setup(batch_groups=0).run(rounds=5)
    h2 = _setup(batch_groups=10_000).run(rounds=5)
    np.testing.assert_allclose(h1.round_loss, h2.round_loss, rtol=1e-5)
    assert h1.round_participants == h2.round_participants == []


def test_batch_groups_one():
    """The cohort of one client a round trains (its weight renormalizes
    to 1) and advances exactly that client's Adam state."""
    fed = _setup(batch_groups=1)
    hist = fed.run(rounds=1, engine="loop")
    assert np.isfinite(hist.round_loss).all()
    (cohort,) = hist.round_participants
    assert _touched(fed) == cohort
    assert int(fed.opt_states.step[cohort[0]]) == fed.fed_cfg.local_epochs
    hist2 = fed.run(rounds=8, engine="scan")
    assert np.isfinite(hist2.round_loss).all()


def test_batch_groups_equals_num_clients_is_full_participation():
    """batch_groups == C draws no cohort, so the training stream and the
    results are bit-equal to full participation."""
    fed_full = _setup(batch_groups=0)
    h_full = fed_full.run(rounds=4)
    fed_c = _setup(batch_groups=len(fed_full.train_groups))
    h_c = fed_c.run(rounds=4)
    assert h_full.round_loss == h_c.round_loss  # floats, bit-for-bit
    for a, b in zip(tree_leaves(fed_full.global_params),
                    tree_leaves(fed_c.global_params)):
        assert torch.equal(a, b)


def test_sampled_sets_deterministic_across_engines():
    """Same seed, the same cohorts in both drivers: observed through the
    Adam states that advanced and the recorded cohort; a replayed cohort
    (``participants=``) is the one that trains."""
    observed = {}
    for engine in ("loop", "scan"):
        fed = _setup(batch_groups=3)
        hist = fed.run(rounds=1, engine=engine)
        (cohort,) = hist.round_participants
        assert _touched(fed) == sorted(cohort) and len(cohort) == 3
        observed[engine] = cohort
    assert observed["loop"] == observed["scan"]
    ref = _setup(batch_groups=3)
    given = [1, 4, 0]
    fed = FederatedGPO(ref.gpo_cfg, ref.fed_cfg, ref.data, ref.train_groups,
                       ref.eval_groups, device="cpu",
                       participants=lambda r: given)
    assert fed.run(rounds=1).round_participants == [given]
    assert _touched(fed) == sorted(given)


@pytest.mark.parametrize("name", AGGREGATORS.names())
@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_every_reduce_at_one_row_returns_the_row(name, kernels):
    """batch_groups=1 hands each strategy's reduce one row of weight 1:
    every rule returns that row (the trim depth and Krum's neighbour
    count clamp as in the reference)."""
    agg = make_aggregator(AggConfig(name=name, num_malicious=1),
                          num_clients=10, use_pallas=kernels)
    x = torch.randn((1, 37), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(agg.reduce_flat(x, torch.ones(1)).numpy(),
                               x[0].numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# replayed parity with the JAX package
# ---------------------------------------------------------------------------
SETUPS = {
    "fedavg": {},
    "adaptive": dict(agg=dict(name="adaptive", fair_temp=1.0)),
    "dp_noise": dict(privacy=DP),
    "reset_opt": dict(reset_opt_each_round=True),
}
ROUNDS = 2


@pytest.mark.parametrize("label", list(SETUPS))
def test_subsampled_rounds_match_jax_on_replayed_draws(label):
    spec = dict(SETUPS[label])
    agg, priv = spec.pop("agg", {}), spec.pop("privacy", {})
    data, port_data, tr, ev = _jax_setup()
    jfcfg = JaxFedConfig(num_clients=len(tr), engine="loop", **FED,
                         batch_groups=3, **spec, agg=JaxAggConfig(**agg),
                         privacy=JaxPrivacyConfig(**priv))
    jfed = JaxFederatedGPO(JaxGPOConfig(**SMALL), jfcfg, data, tr, ev)
    fcfg = FedConfig(num_clients=len(tr), **FED, batch_groups=3, **spec,
                     use_pallas_attention=True, use_pallas_aggregation=True,
                     agg=AggConfig(**agg), privacy=PrivacyConfig(**priv))
    cohorts = _jax_cohorts(fcfg, len(tr), ROUNDS)
    train, evals = _fed_draws(data, fcfg, tr, ev, rounds=ROUNDS)
    draws = _jax_release_draws(jfed, rounds=ROUNDS)
    fed = FederatedGPO(GPOConfig(**SMALL), fcfg, port_data, tr, ev,
                       device="cpu", init_params=_np_tree(jfed.global_params),
                       participants=lambda r: cohorts[r][0],
                       batches=lambda r, e: train[r, e],
                       eval_batches=lambda r: evals[r],
                       release_draws=lambda r: draws[r])
    jh = jfed.run(rounds=ROUNDS)
    h = fed.run(rounds=ROUNDS)
    assert h.round_participants == [cohorts[r][0].tolist()
                                    for r in range(ROUNDS)]
    # 4 clients, 3 a round: some client trains in both rounds
    assert len(set(h.round_participants[0]) & set(
        h.round_participants[1])) >= 2
    _assert_runs_agree(h, jh, fed.global_params, jfed.global_params)
    # each client's Adam state: its step count and moments
    np.testing.assert_array_equal(fed.opt_states.step.numpy(),
                                  np.asarray(jfed.opt_states.step))
    for a, b in zip(tree_leaves(fed.opt_states.mu),
                    jax.tree_util.tree_leaves(jfed.opt_states.mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    if label == "adaptive":
        for key in ("ema", "seen"):
            np.testing.assert_allclose(
                fed.server_state.scores[key].numpy(),
                np.asarray(jfed.server_state.scores[key]), rtol=1e-5,
                atol=0)
    if priv:
        acct = dp.RdpAccountant(DP["noise_multiplier"], 3 / len(tr),
                                fcfg.privacy.target_delta)
        np.testing.assert_allclose(h.round_eps, jh.round_eps, rtol=1e-12)
        np.testing.assert_allclose(
            h.round_eps, [acct.epsilon(r + 1) for r in range(ROUNDS)],
            rtol=1e-12)
        # subsampling amplifies: below the full-participation ε
        full = dp.RdpAccountant(DP["noise_multiplier"], 1.0,
                                fcfg.privacy.target_delta)
        assert h.round_eps[-1] < full.epsilon(ROUNDS)
    if label == "reset_opt":  # every stored state is one round's
        assert set(fed.opt_states.step.tolist()) <= {0, FED["local_epochs"]}
