"""The port's ``engine="scan"`` (``core/federated.py``), on the CPU.

The reference's scan-engine tests (``tests/test_scan_engine.py``) run
against the port. On a CUDA device the scan engine replays a captured
round (``_CapturedRound``); on the CPU it runs the per-round driver.
Here the captured driver is rehearsed on the CPU: ``_Rehearsal``
replaces the CUDA graph with a callable that runs the captured function
again on the same static state and operands, so everything but the
graph itself (the static state copied in and out, the staged operands,
the outputs cloned after each replay, the one read a block, the
generators re-seeded in place) runs as on the card. The rehearsed scan
engine must equal ``engine="loop"`` bit for bit; the round body
must run on the meta device (a meta tensor refuses ``.item()``,
``.cpu()``, ``.tolist()`` and ``float()``: the CPU's stand-in for "no
host sync under capture"); and one replayed run (3 of 4 clients a
round, 4 rounds) is held to the reference's ``engine="scan"`` within
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    HierarchyConfig,
    PrivacyConfig,
)
from repro_torch.core import FederatedGPO, History, federated
from repro_torch.data import (
    ICLDraw,
    SurveyConfig,
    make_survey_data,
    sample_icl_batches,
    split_groups,
)
from repro_torch.utils.pytree import tree_count_params, tree_leaves
from test_torch_train import (
    FED,
    SMALL,
    _assert_runs_agree,
    _fed_draws,
    _jax_cohorts,
    _np_tree,
)

GCFG = GPOConfig(d_embed=16, d_model=32, num_layers=1, num_heads=2, d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Rehearsal(federated._CapturedRound):
    """The captured driver on the CPU: a "graph" replays by running its
    function again; no streams, no device sync."""

    def _sync(self) -> None:
        pass

    def _warm_up(self, fn):
        return fn()

    def _capture(self, fn, gens=(), pool=None):
        class Graph:
            def replay(self):
                fn()

            def pool(self):
                return None

        return Graph()


@pytest.fixture
def rehearse(monkeypatch):
    """Route the scan engine on the CPU through ``_Rehearsal``."""
    monkeypatch.setattr(federated, "_CapturedRound", _Rehearsal)
    monkeypatch.setattr(FederatedGPO, "_captures", lambda self: True)


def _data(seed: int = 5):
    data = make_survey_data(SurveyConfig(num_groups=8, num_questions=40,
                                         d_embed=16, seed=seed))
    tr, ev = split_groups(data, seed=seed)
    return data, tr, ev


BASE = dict(local_epochs=2, num_context=4, num_target=4, eval_every=2,
            seed=5, use_pallas_attention=True, use_pallas_aggregation=True)
# the stacked engine's non-fault rounds: each strategy family, DP, the
# codecs, an attack, partial participation with resets, and two edges
CONFIGS = {
    "fedavg": {},
    "fedavg-sub3-reset": dict(batch_groups=3, reset_opt_each_round=True),
    "fedavgm": dict(agg=AggConfig(name="fedavgm", momentum=0.9)),
    "fedadam": dict(agg=AggConfig(name="fedadam", beta1=0.9, beta2=0.99,
                                  tau=1e-2, server_lr=0.1)),
    "krum": dict(agg=AggConfig(name="krum", num_malicious=1)),
    "median": dict(agg=AggConfig(name="median")),
    "dp_noise": dict(privacy=PrivacyConfig(clip_norm=0.5,
                                           noise_multiplier=0.8)),
    "int8_ef": dict(compression=CompressionConfig(kind="int8")),
    "topk_ef": dict(compression=CompressionConfig(kind="topk",
                                                  topk_frac=0.05)),
    "label_flip-fedavg": dict(adversary=AdversaryConfig(
        kind="label_flip", num_attackers=1)),
    "median-2-edges": dict(agg=AggConfig(name="median"), batch_groups=4,
                           hierarchy=HierarchyConfig(num_edges=2)),
}


def _fed(data, tr, ev, **kw) -> FederatedGPO:
    fcfg = FedConfig(num_clients=len(tr), **{**BASE, **kw})
    return FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu")


def _state(fed) -> list:
    return [None if x is None else x.clone() for x in tree_leaves(
        (fed.global_params, fed.opt_states, fed.server_state, fed.ef_resid))]


def _history(h: History) -> tuple:
    return (h.round_loss, h.eval_rounds, [np.asarray(s) for s in
                                          h.eval_scores],
            h.eval_mean_as, h.eval_fi, h.eval_cov, h.round_eps,
            h.round_participants, h.round_survivors)


def _assert_equal(a, b) -> None:
    """Bit for bit: tensors, arrays, floats and nested sequences."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _runs(data, tr, ev, engine, rounds=3, log_every=0, **kw):
    fed = _fed(data, tr, ev, **kw)
    h = fed.run(rounds=rounds, log_every=log_every, engine=engine)
    return fed, h


@pytest.mark.parametrize("label", list(CONFIGS))
def test_scan_equals_loop_bit_for_bit(label, monkeypatch):
    """Params, Adam states, server state, EF residual and History after
    2 rounds and 1 more: the rehearsed captured round and the loop."""
    data, tr, ev = _data()
    out = {}
    for engine in ("loop", "captured"):
        with monkeypatch.context() as m:
            if engine == "captured":
                m.setattr(federated, "_CapturedRound", _Rehearsal)
                m.setattr(FederatedGPO, "_captures", lambda self: True)
            fed, h = _runs(data, tr, ev, engine.replace("captured", "scan"),
                           rounds=2, **CONFIGS[label])
            h2 = fed.run(rounds=1, engine=engine.replace("captured", "scan"))
            if engine == "captured":
                assert isinstance(fed.captured_round, _Rehearsal)
                # once a round and once an eval round: 2 + 1 rounds,
                # evals at rounds 0, 1 and 0
                assert fed.captured_round.replays == 3
                assert fed.captured_round.eval_replays == 3
            else:
                assert fed.captured_round is None
        out[engine] = (_history(h), _history(h2), _state(fed))
    assert np.isfinite(out["loop"][0][0]).all()
    _assert_equal(out["captured"], out["loop"])


def test_fault_round_runs_the_loop_under_scan(rehearse):
    """The fault round keeps its schedule on the host: under "scan",
    where the round would be captured, it runs the per-round driver,
    bit for bit the loop's, and captures nothing."""
    data, tr, ev = _data()
    avail = AvailabilityConfig(online_prob=0.8, straggler_prob=0.5,
                               max_staleness=2)
    got = _runs(data, tr, ev, "scan", avail=avail)
    want = _runs(data, tr, ev, "loop", avail=avail)
    assert got[0].captured_round is None
    assert got[1].round_survivors
    _assert_equal((_history(got[1]), _state(got[0])),
                  (_history(want[1]), _state(want[0])))


@pytest.mark.parametrize("rounds,log_every", [(4, 2), (3, 2)],
                         ids=["chunks", "chunk_and_remainder"])
def test_log_every_blocks_equal_one_block(rounds, log_every, rehearse,
                                          capsys):
    """``log_every`` splits the run into blocks (the last one shorter)
    of the one captured round; the streams run on across them, so the
    run equals one block, and the eval lines still print as the blocks
    end."""
    data, tr, ev = _data()
    one = _runs(data, tr, ev, "scan", rounds=rounds, batch_groups=3)
    capsys.readouterr()
    blocks = _runs(data, tr, ev, "scan", rounds=rounds, log_every=log_every,
                   batch_groups=3)
    assert "[fed] round" in capsys.readouterr().out
    _assert_equal((_history(one[1]), _state(one[0])),
                  (_history(blocks[1]), _state(blocks[0])))
    assert blocks[0].captured_round.replays == rounds


@pytest.mark.parametrize("engine", ["scan", "loop"])
def test_zero_rounds_returns_an_empty_history(engine):
    data, tr, ev = _data()
    fcfg = FedConfig(num_clients=len(tr), rounds=0, local_epochs=1,
                     num_context=4, num_target=4)
    fed = FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu")
    before = _state(fed)
    h = fed.run(engine=engine)
    assert h.round_loss == [] and h.eval_rounds == []
    _assert_equal(_state(fed), before)


def test_scan_off_cuda_runs_the_loop():
    """Off CUDA there are no graphs: "scan" runs the per-round driver,
    captures nothing and equals the loop."""
    data, tr, ev = _data()
    scan = _runs(data, tr, ev, "scan", rounds=2, batch_groups=3)
    loop = _runs(data, tr, ev, "loop", rounds=2, batch_groups=3)
    assert scan[0].captured_round is None
    _assert_equal((_history(scan[1]), _state(scan[0])),
                  (_history(loop[1]), _state(loop[0])))


def test_scan_is_the_default_and_resumes(rehearse):
    """``FedConfig.engine`` defaults to "scan"; a second ``run`` goes on
    from the advanced state (the server's step counts every round,
    chunked or not), as the loop's second run does."""
    assert FedConfig().engine == "scan"
    data, tr, ev = _data()
    fed, loop = _fed(data, tr, ev), _fed(data, tr, ev)
    h1 = fed.run(rounds=3)
    assert len(h1.round_loss) == 3 and h1.eval_rounds == [0, 2]
    h2 = fed.run(rounds=3, log_every=2)
    assert isinstance(fed.captured_round, _Rehearsal)
    assert int(fed.server_state.step) == 6
    assert np.mean(h2.round_loss) < np.mean(h1.round_loss)
    want = [loop.run(rounds=3, engine="loop"),
            loop.run(rounds=3, log_every=2, engine="loop")]
    _assert_equal([_history(h1), _history(h2), _state(fed)],
                  [_history(want[0]), _history(want[1]), _state(loop)])


def test_kernel_path_scan_equals_loop_and_the_dense_path(rehearse):
    """Through the kernel wrappers (their plain versions on CPU tensors)
    the rehearsed scan engine equals the loop; both stay within the
    reference test's tolerance of the dense, leafwise run."""
    data, tr, ev = _data()
    scan = _runs(data, tr, ev, "scan")
    loop = _runs(data, tr, ev, "loop")
    _assert_equal((_history(scan[1]), _state(scan[0])),
                  (_history(loop[1]), _state(loop[0])))
    dense = _runs(data, tr, ev, "scan", use_pallas_attention=False,
                  use_pallas_aggregation=False)
    np.testing.assert_allclose(scan[1].round_loss, dense[1].round_loss,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(scan[1].eval_mean_as, dense[1].eval_mean_as,
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(scan[0].global_params),
                    tree_leaves(dense[0].global_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


def test_a_hook_that_raises_leaves_the_last_completed_round(rehearse):
    """A ``batches=`` hook that raises in round 2 of a 4-round run (one
    block of the captured round): ``run`` raises, the trainer holds
    round 1's state (the accountant counts 2 rounds), and the next
    ``run`` trains from there, as a trainer that ran 2 rounds does."""
    data, tr, ev = _data()
    priv = PrivacyConfig(clip_norm=0.5, noise_multiplier=0.8)
    fcfg = FedConfig(num_clients=len(tr), **{**BASE, "privacy": priv})
    gen = torch.Generator().manual_seed(11)
    batches = {(r, e): sample_icl_batches(
        gen, data, tr, fcfg.num_context, fcfg.num_target)
        for r in range(4) for e in range(fcfg.local_epochs)}
    fail = {"round": 2}

    def hook(r, e):
        if r == fail["round"]:
            raise RuntimeError("the data loader died")
        return batches[r, e]

    fed = FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu",
                       batches=hook)
    with pytest.raises(RuntimeError, match="data loader died"):
        fed.run(rounds=4)
    ref = FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu",
                       batches=hook)
    ref.run(rounds=2, engine="loop")
    _assert_equal(_state(fed), _state(ref))
    assert fed._rounds_elapsed == ref._rounds_elapsed == 2
    fail["round"] = None
    h = fed.run(rounds=2)
    h_ref = ref.run(rounds=2, engine="loop")
    assert np.isfinite(h.round_loss).all()
    _assert_equal((_history(h), _state(fed)), (_history(h_ref), _state(ref)))


META = {
    "fedavg": {},
    "fedavg-sub3-reset": CONFIGS["fedavg-sub3-reset"],
    "fedavgm": CONFIGS["fedavgm"],
    "adaptive": dict(agg=AggConfig(name="adaptive", fair_temp=1.0)),
    "krum": CONFIGS["krum"],
    "median-2-edges": CONFIGS["median-2-edges"],
    "dp_noise-replayed": CONFIGS["dp_noise"],
    "int8_ef-replayed": CONFIGS["int8_ef"],
    "topk_ef": CONFIGS["topk_ef"],
    "sign_flip-krum": dict(agg=AggConfig(name="krum", num_malicious=1),
                           adversary=AdversaryConfig(kind="sign_flip",
                                                     num_attackers=1)),
    "label_flip-fedavg": CONFIGS["label_flip-fedavg"],
}


@pytest.mark.parametrize("label", list(META))
def test_round_body_runs_on_the_meta_device(label):
    """One staged round body, its operands, state and survey tables on
    the meta device, kernels off (a wrapper refuses meta tensors): it
    must finish, so it reads nothing back to the host, the gather of
    its staged indices included. The release draws come in as operands
    (replayed), as the meta device has no generator."""
    data, tr, ev = _data()
    kw = dict(META[label], use_pallas_attention=False,
              use_pallas_aggregation=False)
    fcfg = FedConfig(num_clients=len(tr), **{**BASE, **kw})
    m = min(fcfg.batch_groups or len(tr), len(tr))

    def draws(r):
        shape = (m, tree_count_params(fed.global_params))
        return np.zeros(shape, np.float32), np.full(shape, 0.5, np.float32)

    fed = FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu",
                       release_draws=draws if label.endswith("replayed")
                       else None)
    meta = torch.device("meta")
    s = fed._streams(fcfg.seed + 1)
    ops = federated._on(fed._stage(0, s, History()), meta)
    assert isinstance(ops.batches, ICLDraw)  # gathered in the body
    fed._tables = federated._on(fed._tables, meta)
    state, loss = fed._round_body(federated._on(fed._state(), meta), ops, s)
    assert loss.device == meta and loss.shape == ()
    assert all(x is None or x.device == meta for x in tree_leaves(state))
    scores = fed._eval_body(state.params,
                            federated._on(fed._eval_host(0, s), meta))
    assert scores.device == meta and scores.shape == (len(ev),)


def test_captured_round_holds_the_callers_state_and_captures_once(
        rehearse):
    """The captured round copies the trainer's state in at every run: a
    params tree put back between runs (a checkpoint restored) is where
    the next run starts, and the caller's tensors are not written. A
    trainer captures once: a longer run replays the same graphs."""
    data, tr, ev = _data()
    fed = _fed(data, tr, ev)
    start = federated._clone(fed.global_params)
    fed.run(rounds=2)
    first = fed.captured_round
    assert first.replays == 2
    ref = _fed(data, tr, ev)
    (ref.global_params, ref.opt_states, ref.server_state) = (
        federated._clone(start), federated._clone(fed.opt_states),
        federated._clone(fed.server_state))
    restored = federated._clone(start)
    fed.global_params = restored
    h = fed.run(rounds=1)
    assert fed.captured_round is first and first.replays == 3
    _assert_equal(tree_leaves(restored), tree_leaves(start))
    h_ref = ref.run(rounds=1, engine="loop")
    _assert_equal((_history(h), _state(fed)), (_history(h_ref), _state(ref)))
    fed.run(rounds=4)
    assert fed.captured_round is first and first.replays == 7


def test_staged_operands_refuse_another_round_shape(rehearse):
    """A round whose operands differ from the captured round's (here a
    hook's batch with one context point less) is refused, not run."""
    data, tr, ev = _data()
    fcfg = FedConfig(num_clients=len(tr), **BASE)
    gen = torch.Generator().manual_seed(3)
    good = sample_icl_batches(gen, data, tr, 4, 4)
    bad = good._replace(ctx_x=good.ctx_x[:, 1:], ctx_y=good.ctx_y[:, 1:])
    fed = FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu",
                       batches=lambda r, e: good if r == 0 else bad)
    with pytest.raises(ValueError, match="the captured round's"):
        fed.run(rounds=2)
    assert fed._rounds_elapsed == 1


def test_replayed_scan_matches_the_reference_scan():
    """The reference's ``engine="scan"`` (its fused ``lax.scan`` block)
    with 3 of its 4 clients a round for 4 rounds, and the port's scan
    engine through the rehearsed captured round, replaying its init,
    cohorts and batches: the tolerances of ``test_torch_train.py``'s
    replayed rounds (losses rtol 1e-4, eval and params atol 1e-4). One
    layer and one local epoch, as the reference's compile is the cost."""
    rounds, widths = 4, {**SMALL, "num_layers": 1}
    fed_kw = {**FED, "local_epochs": 1}
    # the population of test_torch_train.py's _jax_setup, drawn by the
    # port and handed to the reference as arrays
    port_data = make_survey_data(SurveyConfig(num_groups=6,
                                              num_questions=30, d_embed=16))
    data = JaxSurveyData(*(jnp.asarray(a.numpy()) for a in port_data))
    tr, ev = split_groups(port_data)
    jfed = JaxFederatedGPO(JaxGPOConfig(**widths), JaxFedConfig(
        num_clients=len(tr), engine="scan", batch_groups=3, **fed_kw), data,
        tr, ev)
    fcfg = FedConfig(num_clients=len(tr), batch_groups=3, **fed_kw,
                     use_pallas_attention=True, use_pallas_aggregation=True)
    cohorts = _jax_cohorts(fcfg, len(tr), rounds)
    train, evals = _fed_draws(data, fcfg, tr, ev, rounds=rounds)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(federated, "_CapturedRound", _Rehearsal)
        m.setattr(FederatedGPO, "_captures", lambda self: True)
        fed = FederatedGPO(GPOConfig(**widths), fcfg, port_data, tr, ev,
                           device="cpu",
                           init_params=_np_tree(jfed.global_params),
                           participants=lambda r: cohorts[r][0],
                           batches=lambda r, e: train[r, e],
                           eval_batches=lambda r: evals[r])
        h = fed.run(rounds=rounds, engine="scan")
        assert fed.captured_round.replays == rounds
    jh = jfed.run(rounds=rounds, engine="scan")
    assert h.round_participants == [cohorts[r][0].tolist()
                                    for r in range(rounds)]
    _assert_runs_agree(h, jh, fed.global_params, jfed.global_params)
    np.testing.assert_array_equal(fed.opt_states.step.numpy(),
                                  np.asarray(jfed.opt_states.step))
    for a, b in zip(tree_leaves(fed.opt_states.mu),
                    jax.tree_util.tree_leaves(jfed.opt_states.mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_pallas_aggregation_scan_matches_the_leafwise_scan():
    """The scan engine with the aggregation kernel (its plain version on
    CPU tensors) against the leafwise weighted sum, 4 rounds."""
    data, tr, ev = _data()
    a = _runs(data, tr, ev, "scan", rounds=4, use_pallas_aggregation=False)
    b = _runs(data, tr, ev, "scan", rounds=4)
    np.testing.assert_allclose(a[1].round_loss, b[1].round_loss, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.stack(a[1].eval_scores),
                               np.stack(b[1].eval_scores), rtol=1e-4,
                               atol=1e-5)
