"""The port's availability stage (``core/availability.py`` and the fault
round of ``core/federated.py``) against the JAX package's, on the CPU.

Unit parity on the same inputs: a planted multi-round trace of
``round_schedule`` and ``advance_fault_state`` on the reference's own
fault draws (the straggler buffer's lifecycle and the crash-rejoin gate
included), ``staleness_discount``, ``masked_mean_weights`` and
``masked_robust_reduce_flat`` (zero survivors give zeros). Then four
replayed rounds of a faulted FedAvg (with a label_flip attacker) and
FedBuff, each with 3 of the 4 clients a round and the int8 codec with
error feedback, the port replaying the reference's init, cohorts,
batches, rounding uniforms, attacker masks and fault draws
(``attack_draws=``, ``fault_draws=``): round losses rtol 1e-4, eval, params,
EF residual and the straggler buffer atol 1e-4 (``test_torch_train.py``'s
tolerances), the survivor counts and the schedule's host state exact.
Deterministic planted cases: a crashed client's EF row and optimizer
state frozen, a zero-survivor round leaving params and server state bit
for bit, the disabled stages bit-equal to a default run, and the
accountant at q = (m/C) · release_rate. Unit tolerances: exact for the
schedule and the state, rtol 1e-6 for the discounts (a power: an ulp
apart) and the masked weights and reduces (divisions, sums in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AvailabilityConfig as JaxAvailabilityConfig
from repro.core import availability as jax_av
from repro_torch.configs import (
    AdversaryConfig,
    AggConfig,
    AvailabilityConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
    HierarchyConfig,
    PrivacyConfig,
)
from repro_torch.core import FederatedGPO
from repro_torch.core import availability as av
from repro_torch.utils.pytree import tree_leaves
from test_torch_train import (
    FED,
    SMALL,
    _assert_runs_agree,
    _jax_setup,
    _stage_pair,
)

TRACE_CFG = dict(online_prob=0.8, crash_prob=0.2, straggler_prob=0.5,
                 max_staleness=3, rejoin_rounds=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's runs: the suite runs several
    workers on the CPU's cores, and a thread pool the size of the
    machine in each oversubscribes them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------
def test_schedule_and_state_follow_the_reference_over_a_trace():
    """Twelve rounds at C = 16 on the reference's fault draws, the same
    released rows and weights sent each round: every schedule field and
    the state after each advance equal the reference's, and the trace
    holds a straggler buffered, busy and landing late, and a crash
    offline for its rejoin rounds."""
    c, p, rounds = 16, 5, 12
    jcfg = JaxAvailabilityConfig(**TRACE_CFG)
    js, s = jax_av.init_fault_state(c, p), av.init_fault_state(c, p)
    rng = np.random.default_rng(0)
    seen = {"landed_late": 0, "busy": 0, "rejoin_wait": 0}
    for r in range(rounds):
        d = jax_av.fault_draws(jax_av.fold_fault_key(jax.random.PRNGKey(r)),
                               c, jcfg)
        online = np.asarray(d.online)
        seen["busy"] += int(((s.pending_due.numpy() > r) & online).sum())
        seen["rejoin_wait"] += int(((s.offline_until.numpy() > r)
                                    & online).sum())
        jsched = jax_av.round_schedule(
            jax_av.fold_fault_key(jax.random.PRNGKey(r)), js, jcfg, c)
        sched = av.round_schedule(av.FaultDraws(*(_t(a) for a in d)), s)
        for name, a, b in zip(av.RoundSchedule._fields, sched, jsched):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        sent = rng.standard_normal((c, p)).astype(np.float32)
        w = rng.uniform(0.01, 0.2, c).astype(np.float32)
        js = jax_av.advance_fault_state(js, jsched, jnp.asarray(sent),
                                        jnp.asarray(w), 2)
        s = av.advance_fault_state(s, sched, _t(sent), _t(w), 2)
        assert s.round == int(js.round) == r + 1
        for name in av.FaultState._fields[1:]:
            np.testing.assert_array_equal(getattr(s, name).numpy(),
                                          np.asarray(getattr(js, name)),
                                          name)
        seen["landed_late"] += int((sched.arrive & (sched.staleness >= 2))
                                   .sum())
    assert all(seen.values()), seen


def test_fault_draws_thresholds_and_delays():
    cfg = AvailabilityConfig(**TRACE_CFG)
    g = torch.Generator().manual_seed(0)
    d = av.fault_draws(g, 4096, cfg)
    assert d.delay.dtype == torch.int32
    assert int(d.delay.min()) == 1 and int(d.delay.max()) == 3
    for got, want in ((d.online, 0.8), (d.crash, 0.2), (d.straggle, 0.5)):
        assert got.dtype == torch.bool
        assert abs(float(got.float().mean()) - want) < 0.03
    g2 = torch.Generator().manual_seed(0)
    assert all(torch.equal(a, b)
               for a, b in zip(d, av.fault_draws(g2, 4096, cfg)))
    none = av.fault_draws(g, 64, AvailabilityConfig(straggler_prob=0.5))
    assert not none.straggle.any()  # max_staleness 0: no straggler


def test_staleness_discount_and_masked_weights_match_the_reference():
    tau = np.arange(6, dtype=np.int32)
    for power in (0.0, 0.5, 1.5):
        np.testing.assert_allclose(
            av.staleness_discount(_t(tau), power).numpy(),
            np.asarray(jax_av.staleness_discount(jnp.asarray(tau), power)),
            rtol=1e-6, atol=0)
    w = np.array([0.1, 0.3, 0.2, 0.4], np.float32)
    for mask in ([True, False, True, True], [False] * 4, [True] * 4):
        mask = np.array(mask)
        got = av.masked_mean_weights(_t(w), _t(mask)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jax_av.masked_mean_weights(jnp.asarray(w),
                                                       jnp.asarray(mask))),
            rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,frac", [("median", 0.0),
                                       ("trimmed_mean", 0.1),
                                       ("trimmed_mean", 0.3)])
@pytest.mark.parametrize("survivors", [10, 7, 4, 1, 0])
def test_masked_robust_reduce_matches_the_reference(name, frac, survivors):
    """Random rows with planted ties, the survivors first ``survivors``
    of a fixed permutation."""
    c, p = 10, 41
    rng = np.random.default_rng(survivors)
    x = rng.standard_normal((c, p)).astype(np.float32)
    x[3] = x[5]  # ties across rows
    x[:, :4] = 0.5
    w = rng.uniform(0.05, 1.0, c).astype(np.float32)
    mask = np.zeros(c, bool)
    mask[rng.permutation(c)[:survivors]] = True
    got = av.masked_robust_reduce_flat(_t(x), _t(w), _t(mask), name=name,
                                       trim_frac=frac).numpy()
    want = np.asarray(jax_av.masked_robust_reduce_flat(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask), name=name,
        trim_frac=frac))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if survivors == 0:
        assert not got.any()


# ---------------------------------------------------------------------------
# replayed fault rounds, one reference run per configuration, shared
# ---------------------------------------------------------------------------
FAULTY = dict(online_prob=0.8, crash_prob=0.2, straggler_prob=0.6,
              max_staleness=2)
FAULT_RUNS = {
    "fedavg": dict(agg=dict(), avail=FAULTY, batch_groups=3,
                   compression=dict(kind="int8"),
                   adversary=dict(kind="label_flip", num_attackers=1)),
    "fedbuff": dict(agg=dict(name="fedbuff", buffer_k=2), avail=FAULTY,
                    batch_groups=3, compression=dict(kind="int8")),
}
ROUNDS = 4
_RUNS = {}


def _run(label):
    if label not in _RUNS:
        _RUNS[label] = _stage_pair(FAULT_RUNS[label], rounds=ROUNDS)
    return _RUNS[label]


@pytest.mark.parametrize("label", list(FAULT_RUNS))
def test_fault_rounds_match_the_reference(label):
    fed, jfed, h, jh, _ = _run(label)
    assert h.round_survivors == jh.round_survivors
    _assert_runs_agree(h, jh, fed.global_params, jfed.global_params)
    np.testing.assert_allclose(fed.ef_resid.numpy(), np.asarray(
        jfed.ef_resid), rtol=0, atol=1e-4)
    for a, b in zip(tree_leaves(fed.opt_states),
                    jax.tree_util.tree_leaves(jfed.opt_states)):
        if a.dtype == torch.int32 or a.dtype == torch.int64:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("label", list(FAULT_RUNS))
def test_fault_state_and_server_state_match_the_reference(label):
    fed, jfed, h, jh, faults = _run(label)
    s, js = fed.fault_state, jfed.fault_state
    assert s.round == int(js.round) == ROUNDS
    for name in ("offline_until", "pending_due", "pending_birth"):
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      np.asarray(getattr(js, name)))
    np.testing.assert_allclose(s.pending_weight.numpy(),
                               np.asarray(js.pending_weight), rtol=1e-6)
    np.testing.assert_allclose(s.pending.numpy(), np.asarray(js.pending),
                               rtol=0, atol=1e-4)
    state, jstate = fed.server_state, jfed.server_state
    assert int(state.step) == int(jstate.step)
    if label == "fedbuff":
        for k in ("count", "mass"):
            np.testing.assert_allclose(float(state.scores[k]),
                                       float(jstate.scores[k]), rtol=1e-6)
        for a, b in zip(tree_leaves(state.m),
                        jax.tree_util.tree_leaves(jstate.m)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4)
    # the draws planted a buffered straggler that landed, and a round
    # that absorbed nothing, within the run
    strag = sum(int(np.asarray(f[2]).sum()) for f in faults.values())
    assert strag > 0 and 0 in h.round_survivors


# ---------------------------------------------------------------------------
# planted cases, the port alone
# ---------------------------------------------------------------------------
def _planted(cfg_kw, draws, rounds=1):
    """A port trainer whose fault draws come from ``draws`` (round ->
    (online, crash, straggle, delay) lists), run ``rounds`` rounds."""
    _, port_data, tr, ev = _jax_setup()
    fcfg = FedConfig(num_clients=len(tr), **FED, **cfg_kw)
    fed = FederatedGPO(GPOConfig(**SMALL), fcfg, port_data, tr, ev,
                       device="cpu", fault_draws=lambda r: draws[r])
    return fed


def test_crashed_and_offline_clients_keep_their_ef_rows_and_adam_state():
    """Client 0 crashes after training, client 1 is offline, clients 2
    and 3 release: only 2 and 3 advance their EF21 rows and Adam
    states."""
    draws = {0: ([True, False, True, True], [True, False, False, False],
                 [False] * 4, [1] * 4)}
    fed = _planted(dict(avail=AvailabilityConfig(online_prob=0.9,
                                                 crash_prob=0.1),
                        compression=CompressionConfig(kind="int8")), draws)
    h = fed.run(rounds=1)
    assert h.round_survivors == [2]
    active = fed.ef_resid.abs().amax(dim=1) > 0
    assert active.tolist() == [False, False, True, True]
    assert fed.opt_states.step.tolist() == [0, 0, 2, 2]
    assert fed.fault_state.offline_until.tolist() == [1, 0, 0, 0]


@pytest.mark.parametrize("agg", ["fedbuff", "adaptive", "median"])
def test_zero_survivor_round_is_a_no_op(agg):
    """Every client offline in round 0, then every client a straggler in
    round 1 (none lands yet): params and server state bit for bit, the
    stragglers buffered."""
    off = ([False] * 4, [False] * 4, [False] * 4, [1] * 4)
    strag = ([True] * 4, [False] * 4, [True] * 4, [2] * 4)
    fed = _planted(dict(avail=AvailabilityConfig(
        online_prob=0.5, straggler_prob=0.5, max_staleness=2),
        agg=AggConfig(name=agg)), {0: off, 1: strag})
    params = [p.clone() for p in tree_leaves(fed.global_params)]
    state = [t.clone() for t in tree_leaves(fed.server_state)]
    h = fed.run(rounds=2)
    assert h.round_survivors == [0, 0] and len(h.round_loss) == 2
    assert all(torch.equal(a, b) for a, b in zip(
        params, tree_leaves(fed.global_params)))
    assert all(torch.equal(a, b) for a, b in zip(
        state, tree_leaves(fed.server_state)))
    assert fed.fault_state.pending_due.tolist() == [3] * 4
    assert bool((fed.fault_state.pending.abs().amax(dim=1) > 0).all())


def test_disabled_stages_are_bit_equal_and_draw_nothing():
    """Stage configs that are present but off (no attacker, benign
    availability, one edge) run the default round bit for bit, create
    none of the stages' generators and call none of their hooks."""
    _, port_data, tr, ev = _jax_setup()
    runs, calls = [], []
    for kw in ({}, dict(adversary=AdversaryConfig(kind="sign_flip"),
                        avail=AvailabilityConfig(max_staleness=3,
                                                 rejoin_rounds=2),
                        hierarchy=HierarchyConfig(num_edges=1))):
        fcfg = FedConfig(num_clients=len(tr), **FED, **kw)
        fed = FederatedGPO(GPOConfig(**SMALL), fcfg, port_data, tr, ev,
                           device="cpu",
                           attack_draws=lambda r: calls.append(r),
                           fault_draws=lambda r: calls.append(r))
        s = fed._streams(fcfg.seed + 1)
        assert s.byz is s.attack_noise is s.fault is None
        h = fed.run(rounds=2)
        assert fed.fault_state is None and h.round_survivors == []
        runs.append((h.round_loss, tree_leaves(fed.global_params)))
    assert not calls and runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_accountant_at_the_realized_participation():
    """q = (m/C) · release_rate in both packages, and a smaller ε."""
    from repro.configs import FedConfig as JaxFedConfig
    from repro.configs import GPOConfig as JaxGPOConfig
    from repro.configs import PrivacyConfig as JaxPrivacyConfig
    from repro.core import FederatedGPO as JaxFederatedGPO

    data, port_data, tr, ev = _jax_setup()
    priv = dict(clip_norm=1.0, noise_multiplier=0.8)
    avail = dict(online_prob=0.8, crash_prob=0.25)
    feds = {}
    for faulty in (False, True):
        fcfg = FedConfig(num_clients=len(tr), **FED, batch_groups=3,
                         privacy=PrivacyConfig(**priv),
                         avail=AvailabilityConfig(**avail) if faulty
                         else AvailabilityConfig())
        feds[faulty] = FederatedGPO(GPOConfig(**SMALL), fcfg, port_data,
                                    tr, ev, device="cpu")
    jfed = JaxFederatedGPO(
        JaxGPOConfig(**SMALL), JaxFedConfig(
            num_clients=len(tr), **FED, batch_groups=3,
            privacy=JaxPrivacyConfig(**priv),
            avail=JaxAvailabilityConfig(**avail)), data, tr, ev)
    q = feds[True]._accountant.sampling_rate
    assert q == jfed._accountant.sampling_rate == 3 / 4 * 0.8 * 0.75
    assert feds[False]._accountant.sampling_rate == 3 / 4
    assert (feds[True]._accountant.epsilon(100)
            == jfed._accountant.epsilon(100)
            < feds[False]._accountant.epsilon(100))


@pytest.mark.parametrize("name", ["adaptive", "fedbuff"])
def test_fault_mode_server_updates_match_the_reference(name):
    """The fault round's extra arguments to the server step: adaptive's
    ``mask`` (rows outside it keep their ema and seen) and fedbuff's
    realized ``mass`` and ``released`` count, two steps of each against
    the reference's on the same numpy inputs (rtol 1e-6)."""
    from repro.configs import AggConfig as JaxAggConfig
    from repro.core.aggregation import make_aggregator as jax_make

    from repro_torch.core import make_aggregator

    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((3, 2)).astype(np.float32),
              "b": rng.standard_normal((2,)).astype(np.float32)}
    cfg = dict(name=name, buffer_k=3)
    jagg = jax_make(JaxAggConfig(**cfg), num_clients=5)
    agg = make_aggregator(AggConfig(**cfg), num_clients=5)
    jg = {k: jnp.asarray(v) for k, v in params.items()}
    g = {k: _t(v) for k, v in params.items()}
    js, s = jagg.init(jg), agg.init(g)
    for step in range(2):
        delta = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        idx = np.array([0, 2, 3]) if step == 0 else np.array([1, 2, 4])
        losses = rng.uniform(0.1, 1.0, 3).astype(np.float32)
        kw, jkw = {}, {}
        if name == "adaptive":
            mask = np.array([True, False, True])
            kw, jkw = dict(mask=_t(mask)), dict(mask=jnp.asarray(mask))
        else:
            mass, rel = np.float32(0.4 + step), float(2 - step)
            kw = dict(mass=torch.tensor(mass), released=rel)
            jkw = dict(mass=jnp.asarray(mass), released=rel)
        jg, js = jagg.apply(js, jg, {k: jnp.asarray(v)
                                     for k, v in delta.items()},
                            losses=jnp.asarray(losses),
                            idx=jnp.asarray(idx), **jkw)
        g, s = agg.apply(s, g, {k: _t(v) for k, v in delta.items()},
                         losses=_t(losses), idx=_t(idx), **kw)
    for a, b in zip(tree_leaves(g) + tree_leaves(s),
                    jax.tree_util.tree_leaves(jg)
                    + jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    if name == "adaptive":  # client 2 trained twice, released never
        assert s.scores["seen"].tolist() == [1.0, 1.0, 0.0, 1.0, 1.0]
