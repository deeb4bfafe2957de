"""The fault round captured (``core/federated.py::_fault_body``), on the
CPU.

Under ``FedConfig.avail`` the round's schedule lives on the device
(``core/availability.py``): the fault draws are staged with the round's
operands, the survivor count, the trim depth and the zero-survivor gate
are tensors, and the body reads nothing back to the host. So the scan
engine captures it like any other round. Here the captured driver is
rehearsed on the CPU (``test_torch_scan_engine._Rehearsal``: a "graph"
replays by calling its function again) and must equal ``engine="loop"``
bit for bit, ``round_survivors`` and the fault state included: for
fedavg, fedbuff, median, adaptive, int8 with error feedback, 3 of 4
clients with resets and label_flip; in ``log_every`` blocks and resumed
across two ``run`` calls; after a hook that raises; and through a
zero-survivor round. The body runs on the meta device (a meta tensor
refuses ``.item()``, ``.cpu()`` and ``float()``). The device trim depth
equals the host's integer formula for every survivor count, and one
replayed run is held to the reference's fused fault scan
(``fault_block_fn``) within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AvailabilityConfig as JaxAvailabilityConfig
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import GPOConfig as JaxGPOConfig
from repro.core import FederatedGPO as JaxFederatedGPO
from repro.data import SurveyData as JaxSurveyData
from repro_torch.configs import (
    AdversaryConfig,
    AggConfig,
    AvailabilityConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
)
from repro_torch.core import FederatedGPO, History, federated
from repro_torch.core import availability as av
from repro_torch.data import SurveyConfig, make_survey_data, split_groups
from repro_torch.utils.pytree import tree_count_params, tree_leaves
from test_torch_scan_engine import (
    BASE,
    GCFG,
    _assert_equal,
    _data,
    _history,
    _Rehearsal,
)
from test_torch_train import (
    FED,
    SMALL,
    _assert_runs_agree,
    _fed_draws,
    _jax_cohorts,
    _jax_stage_draws,
    _np_tree,
)

# dropout 0.2, crashes, stragglers landing up to 2 rounds late, a
# crashed client back after one round
FAULTY = AvailabilityConfig(online_prob=0.8, crash_prob=0.2,
                            straggler_prob=0.6, max_staleness=2,
                            rejoin_rounds=1)
CONFIGS = {
    "fedavg": {},
    "fedbuff": dict(agg=AggConfig(name="fedbuff", buffer_k=2)),
    "median": dict(agg=AggConfig(name="median")),
    "adaptive": dict(agg=AggConfig(name="adaptive", fair_temp=1.0)),
    "int8_ef": dict(compression=CompressionConfig(kind="int8")),
    "fedavg-sub3-reset": dict(batch_groups=3, reset_opt_each_round=True),
    "label_flip-fedavg": dict(adversary=AdversaryConfig(
        kind="label_flip", num_attackers=1)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def rehearse(monkeypatch):
    """Route the scan engine on the CPU through ``_Rehearsal``."""
    monkeypatch.setattr(federated, "_CapturedRound", _Rehearsal)
    monkeypatch.setattr(FederatedGPO, "_captures", lambda self: True)


def _fed(data, tr, ev, fault_draws=None, **kw) -> FederatedGPO:
    fcfg = FedConfig(num_clients=len(tr),
                     **{**BASE, "avail": FAULTY, **kw})
    return FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu",
                        fault_draws=fault_draws)


def _state(fed) -> list:
    """The trainer's whole state, the fault state's fields included."""
    return [None if x is None else x.clone()
            for x in tree_leaves(fed._state())]


def _engines(label: str, runs, monkeypatch, **kw) -> dict:
    """(History of each run, state) after the runs ``runs`` (a list of
    (rounds, log_every)) of one trainer, under the loop and under the
    rehearsed captured round."""
    data, tr, ev = _data()
    out = {}
    for engine in ("loop", "captured"):
        with monkeypatch.context() as m:
            if engine == "captured":
                m.setattr(federated, "_CapturedRound", _Rehearsal)
                m.setattr(FederatedGPO, "_captures", lambda self: True)
            fed = _fed(data, tr, ev, **{**CONFIGS[label], **kw})
            hists = [fed.run(rounds=n, log_every=every,
                             engine=engine.replace("captured", "scan"))
                     for n, every in runs]
            if engine == "captured":
                assert isinstance(fed.captured_round, _Rehearsal)
                assert fed.captured_round.replays == sum(n for n, _ in runs)
            else:
                assert fed.captured_round is None
        out[engine] = ([_history(h) for h in hists], _state(fed))
    return out


@pytest.mark.parametrize("label", list(CONFIGS))
def test_captured_fault_round_equals_the_loop(label, monkeypatch):
    """Params, Adam states, server state, EF residual, fault state and
    History (``round_survivors`` included) after 3 rounds and 2 more
    from the advanced state: the rehearsed captured round and the
    loop. The run must hold a straggler landing and a round that drops
    someone."""
    out = _engines(label, [(3, 0), (2, 0)], monkeypatch)
    hists = out["loop"][0]
    survivors = hists[0][-1] + hists[1][-1]
    assert len(survivors) == 5 and np.isfinite(hists[0][0]).all()
    assert min(survivors) < max(survivors)
    _assert_equal(out["captured"], out["loop"])


@pytest.mark.parametrize("rounds,log_every", [(4, 2), (3, 2)],
                         ids=["chunks", "chunk_and_remainder"])
def test_fault_log_every_blocks_equal_the_loop(rounds, log_every,
                                               monkeypatch):
    """``log_every`` blocks of the captured fault round (the last one
    shorter): each block's survivors are read with its losses."""
    out = _engines("fedavg-sub3-reset", [(rounds, log_every)], monkeypatch)
    assert len(out["loop"][0][0][-1]) == rounds
    _assert_equal(out["captured"], out["loop"])


def test_a_raising_hook_keeps_the_completed_rounds(rehearse):
    """A ``fault_draws=`` hook that raises in round 2 of a 4-round run:
    ``run`` raises, the trainer holds round 1's state, its fault state
    (the stragglers its rounds buffered, the crash gates) included, and
    the next ``run`` goes on as a trainer that ran 2 rounds does, its
    survivors too."""
    data, tr, ev = _data()
    gen = torch.Generator().manual_seed(3)
    draws = {r: tuple(a.numpy() for a in av.fault_draws(gen, len(tr),
                                                        FAULTY))
             for r in range(4)}
    fail = {"round": 2}

    def hook(r):
        if r == fail["round"]:
            raise RuntimeError("the scheduler died")
        return draws[r]

    fed = _fed(data, tr, ev, fault_draws=hook)
    with pytest.raises(RuntimeError, match="scheduler died"):
        fed.run(rounds=4)
    ref = _fed(data, tr, ev, fault_draws=hook)
    h_ref = ref.run(rounds=2, engine="loop")
    _assert_equal(_state(fed), _state(ref))
    assert int(fed.fault_state.round) == 2 and fed._rounds_elapsed == 2
    assert len(h_ref.round_survivors) == 2
    fail["round"] = None
    h = fed.run(rounds=2)
    h_ref = ref.run(rounds=2, engine="loop")
    _assert_equal((_history(h), _state(fed)), (_history(h_ref), _state(ref)))


@pytest.mark.parametrize("agg", ["fedavgm", "fedbuff", "adaptive", "median"])
def test_zero_survivor_round_under_capture(agg, rehearse):
    """Every client releases in the first run's round, then every client
    is offline in the second run's: the second run replays the same
    graph and leaves params and server state bit for bit, its survivors
    [0]; the loop agrees."""
    data, tr, ev = _data()
    c = len(tr)
    phase = {"offline": False}

    def hook(r):
        online = not phase["offline"]
        return [online] * c, [False] * c, [False] * c, [1] * c

    runs = {}
    for engine in ("scan", "loop"):
        phase["offline"] = False
        fed = _fed(data, tr, ev, agg=AggConfig(name=agg), fault_draws=hook)
        first = fed.run(rounds=1, engine=engine)
        before = [t.clone() for t in tree_leaves(fed.global_params)
                  + tree_leaves(fed.server_state)]
        phase["offline"] = True
        second = fed.run(rounds=1, engine=engine)
        after = tree_leaves(fed.global_params) + tree_leaves(
            fed.server_state)
        assert first.round_survivors == [c] and second.round_survivors == [0]
        _assert_equal(after, before)
        assert int(fed.server_state.step) == 1
        runs[engine] = (_history(first), _history(second), _state(fed))
    assert fed.captured_round is None
    _assert_equal(runs["scan"], runs["loop"])


META = {
    "fedavg": {},
    "median-sub3": dict(agg=AggConfig(name="median"), batch_groups=3),
    "fedbuff": CONFIGS["fedbuff"],
    "adaptive-sub3-reset": dict(agg=CONFIGS["adaptive"]["agg"],
                                batch_groups=3, reset_opt_each_round=True),
    "int8_ef-replayed": CONFIGS["int8_ef"],
    "label_flip-fedavg": CONFIGS["label_flip-fedavg"],
}


@pytest.mark.parametrize("label", list(META))
def test_fault_body_runs_on_the_meta_device(label):
    """One staged fault round, its operands (the fault draws included),
    state (the fault state included) and survey tables on the meta
    device, kernels off: it must finish, so it reads nothing back to the
    host. The release uniforms come in as operands (replayed)."""
    data, tr, ev = _data()
    fcfg = FedConfig(num_clients=len(tr), **{
        **BASE, "avail": FAULTY, **META[label],
        "use_pallas_attention": False, "use_pallas_aggregation": False})
    m = min(fcfg.batch_groups or len(tr), len(tr))

    def draws(r):
        shape = (m, tree_count_params(fed.global_params))
        return None, np.full(shape, 0.5, np.float32)

    fed = FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu",
                       release_draws=draws if label.endswith("replayed")
                       else None)
    meta = torch.device("meta")
    s = fed._streams(fcfg.seed + 1)
    ops = federated._on(fed._stage(0, s, History()), meta)
    assert isinstance(ops.faults, av.FaultDraws)
    fed._tables = federated._on(fed._tables, meta)
    state, loss, released = fed._fault_body(
        federated._on(fed._state(), meta), ops, s)
    assert loss.device == meta and loss.shape == ()
    assert released.device == meta and released.shape == ()
    assert all(x is None or x.device == meta for x in tree_leaves(state))
    assert state.fault.round.shape == ()


@pytest.mark.parametrize("name,frac", [("median", 0.0), ("trimmed_mean", 0.1),
                                       ("trimmed_mean", 0.3),
                                       ("trimmed_mean", 0.45)])
def test_device_trim_depth_equals_the_host_ints(name, frac):
    """k from the device count, for every n in 0..C (C 10 and 33),
    equals the host's integer formula (the product in float32), and the
    masked reduce through it equals the reduce at that host k on random
    rows with ties."""
    frac32 = torch.tensor(frac, dtype=torch.float32)
    for c in (10, 33):
        rng = np.random.default_rng(c)
        x = torch.from_numpy(rng.standard_normal((c, 23)).astype(np.float32))
        x[2] = x[4]
        w = torch.from_numpy(rng.uniform(0.05, 1.0, c).astype(np.float32))
        for n in range(c + 1):
            host = max(n - 1, 0) // 2
            if name == "trimmed_mean":
                host = min(int(frac32 * n), host)
            k = av.trim_depth(torch.tensor(n), name, frac)
            assert k.dtype == torch.int64 and int(k) == host, (c, n)
            mask = torch.zeros(c, dtype=torch.bool)
            mask[torch.from_numpy(rng.permutation(c)[:n])] = True
            got = av.masked_robust_reduce_flat(x, w, mask, name=name,
                                               trim_frac=frac)
            order = torch.argsort(torch.where(mask[:, None], x, torch.inf),
                                  dim=0, stable=True)
            xs = torch.take_along_dim(x, order, dim=0)
            ws = torch.where(mask, w, 0.0)[order]
            ranks = torch.arange(c)[:, None]
            keep = (ranks >= host) & (ranks < n - host)
            num = torch.where(keep, ws * xs, 0.0).sum(dim=0)
            den = torch.where(keep, ws, 0.0).sum(dim=0)
            want = torch.where(den > 0.0, num / torch.clamp(den, min=1e-12),
                               0.0)
            assert torch.equal(got, want), (c, n)


def test_tree_where_selects_leafwise():
    new = {"a": torch.tensor([1.0, float("nan")]), "b": torch.tensor(3)}
    old = {"a": torch.tensor([-0.0, 2.0]), "b": torch.tensor(4)}
    keep_old = av.tree_where(torch.tensor(False), new, old)
    _assert_equal(tree_leaves(keep_old), tree_leaves(old))
    take_new = av.tree_where(torch.tensor(True), new, old)
    assert torch.equal(take_new["b"], new["b"])
    assert torch.isnan(take_new["a"][1]) and take_new["a"][0] == 1.0


def test_replayed_captured_fault_round_matches_the_reference_scan():
    """The reference's ``engine="scan"`` under faults (its fused
    ``fault_block_fn``) with 3 of its 4 clients a round for 4 rounds,
    and the port's rehearsed captured fault round, replaying its init,
    cohorts, batches and fault draws: survivors and the schedule's
    state exact, losses rtol 1e-4, eval, params and the straggler
    buffer atol 1e-4. One layer and one local epoch, as the reference's
    compile is the cost."""
    rounds, widths = 4, {**SMALL, "num_layers": 1}
    fed_kw = {**FED, "local_epochs": 1}
    avail = dict(online_prob=0.8, crash_prob=0.2, straggler_prob=0.6,
                 max_staleness=2)
    port_data = make_survey_data(SurveyConfig(num_groups=6,
                                              num_questions=30, d_embed=16))
    data = JaxSurveyData(*(jnp.asarray(a.numpy()) for a in port_data))
    tr, ev = split_groups(port_data)
    jfcfg = JaxFedConfig(num_clients=len(tr), engine="scan", batch_groups=3,
                         avail=JaxAvailabilityConfig(**avail), **fed_kw)
    jfed = JaxFederatedGPO(JaxGPOConfig(**widths), jfcfg, data, tr, ev)
    fcfg = FedConfig(num_clients=len(tr), batch_groups=3,
                     avail=AvailabilityConfig(**avail), **fed_kw,
                     use_pallas_attention=True, use_pallas_aggregation=True)
    cohorts = _jax_cohorts(fcfg, len(tr), rounds)
    train, evals = _fed_draws(data, fcfg, tr, ev, rounds=rounds)
    _, faults = _jax_stage_draws(jfcfg, len(tr), 0, rounds)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(federated, "_CapturedRound", _Rehearsal)
        m.setattr(FederatedGPO, "_captures", lambda self: True)
        fed = FederatedGPO(GPOConfig(**widths), fcfg, port_data, tr, ev,
                           device="cpu",
                           init_params=_np_tree(jfed.global_params),
                           participants=lambda r: cohorts[r][0],
                           batches=lambda r, e: train[r, e],
                           eval_batches=lambda r: evals[r],
                           fault_draws=faults.__getitem__)
        h = fed.run(rounds=rounds, engine="scan")
        assert fed.captured_round.replays == rounds
    jh = jfed.run(rounds=rounds, engine="scan")
    assert h.round_survivors == jh.round_survivors
    strag = sum(int(np.asarray(f[2]).sum()) for f in faults.values())
    assert strag > 0 and min(h.round_survivors) < 3
    _assert_runs_agree(h, jh, fed.global_params, jfed.global_params)
    s, js = fed.fault_state, jfed.fault_state
    assert int(s.round) == int(js.round) == rounds
    for name in ("offline_until", "pending_due", "pending_birth"):
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      np.asarray(getattr(js, name)))
    np.testing.assert_allclose(s.pending.numpy(), np.asarray(js.pending),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(fed.opt_states.step.numpy(),
                                  np.asarray(jfed.opt_states.step))
    for a, b in zip(tree_leaves(fed.opt_states.mu),
                    jax.tree_util.tree_leaves(jfed.opt_states.mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
