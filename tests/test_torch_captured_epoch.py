"""Index staging and the captured centralized epoch, on the CPU.

* The draws: ``sample_icl_indices`` (one 2-D ``torch.multinomial``) and
  ``gather_icl_batch`` equal the per-group ``sample_icl_batch`` loop bit
  for bit, and leave the generator where the loop leaves it.
* The staging: an unreplayed ``FederatedGPO`` or ``CentralizedGPO`` run,
  which stages its draws as indices and gathers them in the device
  half, equals bit for bit the same run fed the same draws, made by the
  per-group loop, as whole batches through the replay hooks.
* The captured epoch: ``CentralizedGPO``'s ``engine="scan"`` through
  the rehearsed capture machine (``test_torch_scan_engine._Rehearsal``,
  whose "graph" replays by calling its function again) equals
  ``engine="loop"`` bit for bit, in one block and in ``log_every``
  blocks, on a second ``run`` that resumes, with the ``batches=`` hook,
  and after a hook that raises; and the epoch body runs on the meta
  device (a meta tensor refuses ``.item()``, ``.cpu()`` and ``float()``:
  the CPU's stand-in for "no host sync under capture").
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import FedConfig
from repro_torch.core import CentralizedGPO, FederatedGPO, federated
from repro_torch.data import (
    ICLBatch,
    ICLDraw,
    SurveyConfig,
    gather_icl_batch,
    make_survey_data,
    sample_icl_batch,
    sample_icl_indices,
)
from repro_torch.utils.pytree import tree_leaves
from test_torch_scan_engine import (
    GCFG,
    _assert_equal,
    _data,
    _history,
    _Rehearsal,
    _state,
)

NC, NT = 4, 4


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
    """Route the centralized scan engine on the CPU through the
    rehearsed capture machine."""
    monkeypatch.setattr(federated, "_CapturedRound", _Rehearsal)
    monkeypatch.setattr(CentralizedGPO, "_captures", lambda self: True)


def _stack(batches) -> ICLBatch:
    return ICLBatch(*(torch.stack([getattr(b, f) for b in batches])
                      for f in ICLBatch._fields[:-1]),
                    num_options=batches[0].num_options)


def _population(full: bool):
    """17 groups of 40 questions; with ``full`` group 3 answers exactly
    NC + NT of them, so a draw takes every one."""
    data = make_survey_data(SurveyConfig(num_groups=17, num_questions=40,
                                         d_embed=8, seed=2))
    if full:
        mask = data.mask.clone()
        mask[3] = False
        mask[3, 5:5 + NC + NT] = True
        data = data._replace(mask=mask, sizes=mask.sum(dim=1))
    return data


GROUPS = {"one": [6], "four": [0, 9, 3, 9], "all17": list(range(17))[::-1],
          "full": [3, 3, 11]}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("groups", list(GROUPS))
def test_index_draws_equal_the_per_group_draws(groups, seed):
    data = _population(groups == "full")
    g = GROUPS[groups]
    gen_loop, gen_idx = (torch.Generator().manual_seed(seed)
                         for _ in range(2))
    want = _stack([sample_icl_batch(gen_loop, data, i, NC, NT) for i in g])
    q = sample_icl_indices(gen_idx, data, g, NC, NT)
    assert q.shape == (len(g), NC + NT) and q.dtype == torch.int64
    got = gather_icl_batch(data.phi, data.prefs, torch.tensor(g), q, NC)
    _assert_equal(list(got), list(want))
    assert torch.equal(gen_idx.get_state(), gen_loop.get_state())
    if groups == "full":  # every answered question, each once
        assert sorted(q[0].tolist()) == list(range(5, 5 + NC + NT))


def test_gather_takes_any_leading_shape():
    """An (E, m, nq) draw over (m,) groups gathers at once into the E
    epochs' client-stacked batches, each epoch's as its own gather."""
    data = _population(False)
    groups = torch.tensor([4, 0, 16])
    q = sample_icl_indices(torch.Generator().manual_seed(3), data,
                           groups.repeat(2), NC, NT).reshape(2, 3, -1)
    stack = gather_icl_batch(data.phi, data.prefs, groups, q, NC)
    for e in range(2):
        want = gather_icl_batch(data.phi, data.prefs, groups, q[e], NC)
        _assert_equal([f[e] for f in stack[:-1]], list(want[:-1]))


BASE = dict(local_epochs=2, num_context=NC, num_target=NT, eval_every=2,
            seed=5, use_pallas_attention=True, use_pallas_aggregation=True)


def _whole_round_draws(data, fcfg, tr, ev, rounds):
    """What an unreplayed FederatedGPO run draws, made by the per-group
    loop from its generators in its order (each round's cohort, then
    its E epochs' batches; the eval batches on the eval generator):
    (cohorts, {(round, epoch): batch}, {round: eval batch})."""
    gen_train, gen_eval = federated._generators(fcfg.seed + 1)
    c = len(tr)
    m = min(fcfg.batch_groups or c, c)
    cohorts, train, evals = {}, {}, {}
    for r in range(rounds):
        idx = (torch.randperm(c, generator=gen_train)[:m] if m < c
               else torch.arange(c))
        cohorts[r] = idx.numpy()
        for e in range(fcfg.local_epochs):
            train[r, e] = _stack([sample_icl_batch(gen_train, data,
                                                   int(tr[i]), NC, NT)
                                  for i in idx])
        if r % fcfg.eval_every == 0 or r == rounds - 1:
            evals[r] = _stack([sample_icl_batch(gen_eval, data, int(g), NC,
                                                NT) for g in ev])
    return cohorts, train, evals


@pytest.mark.parametrize("kw", [{}, dict(batch_groups=3,
                                         reset_opt_each_round=True)],
                         ids=["fedavg", "sub3-reset"])
def test_index_staged_rounds_equal_whole_batches(kw):
    data, tr, ev = _data()
    fcfg = FedConfig(num_clients=len(tr), **{**BASE, **kw})
    staged = FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu")
    h = staged.run(rounds=3, engine="loop")
    cohorts, train, evals = _whole_round_draws(data, fcfg, tr, ev, 3)
    whole = FederatedGPO(GCFG, fcfg, data, tr, ev, device="cpu",
                         participants=lambda r: cohorts[r],
                         batches=lambda r, e: train[r, e],
                         eval_batches=lambda r: evals[r])
    h_whole = whole.run(rounds=3, engine="loop")
    _assert_equal((_history(h), _state(staged)),
                  (_history(h_whole), _state(whole)))


def _cen(data, tr, ev, **kw) -> CentralizedGPO:
    fcfg = FedConfig(num_clients=len(tr), **BASE)
    return CentralizedGPO(GCFG, fcfg, data, tr, ev, device="cpu", **kw)


def _cen_state(cen) -> list:
    return [x.clone() for x in tree_leaves(cen._state())]


def _whole_epoch_draws(data, fcfg, tr, ev, epochs):
    """What an unreplayed CentralizedGPO run draws, made by the per-group
    loop: each epoch's group order, then one batch a step in that order;
    the eval batches on the eval generator. ({(epoch, step): batch},
    {epoch: eval batch})."""
    gen_train, gen_eval = federated._generators(fcfg.seed + 2)
    steps, evals = {}, {}
    for e in range(epochs):
        order = tr[torch.randperm(len(tr), generator=gen_train).numpy()]
        for i, g in enumerate(order):
            steps[e, i] = sample_icl_batch(gen_train, data, int(g), NC, NT)
        if e % fcfg.eval_every == 0 or e == epochs - 1:
            evals[e] = _stack([sample_icl_batch(gen_eval, data, int(g), NC,
                                                NT) for g in ev])
    return steps, evals


def test_index_staged_epochs_equal_whole_batches():
    data, tr, ev = _data()
    staged = _cen(data, tr, ev)
    h = staged.run(epochs=3, engine="loop")
    steps, evals = _whole_epoch_draws(data, staged.fed_cfg, tr, ev, 3)
    whole = _cen(data, tr, ev, batches=lambda e, i: steps[e, i],
                 eval_batches=lambda e: evals[e])
    h_whole = whole.run(epochs=3, engine="loop")
    _assert_equal((_history(h), _cen_state(staged)),
                  (_history(h_whole), _cen_state(whole)))


def _hooks(data, tr, ev, epochs):
    gen = torch.Generator().manual_seed(11)
    steps = {(e, i): sample_icl_batch(gen, data, int(tr[(i + e) % len(tr)]),
                                      NC, NT)
             for e in range(epochs) for i in range(len(tr))}
    evals = {e: _stack([sample_icl_batch(gen, data, int(g), NC, NT)
                        for g in ev]) for e in range(epochs)}
    return dict(batches=lambda e, i: steps[e, i],
                eval_batches=lambda e: evals[e])


@pytest.mark.parametrize("case", ["whole", "blocks", "hook"])
def test_captured_epoch_equals_loop(case, monkeypatch, capsys):
    """3 epochs in one block (or in blocks of 2 epochs, or replaying the
    hooks' whole batches), then a second ``run`` of 2 that resumes: the
    rehearsed captured epoch and the loop, histories and params and
    Adam state bit for bit, the graphs replayed once an epoch and once
    an eval epoch, the eval lines printed as the blocks end."""
    data, tr, ev = _data()
    log_every = 2 if case == "blocks" else 0
    kw = _hooks(data, tr, ev, 3) if case == "hook" else {}
    out = {}
    for engine in ("loop", "captured"):
        cen = _cen(data, tr, ev, **kw)
        with monkeypatch.context() as m:
            if engine == "captured":
                m.setattr(federated, "_CapturedRound", _Rehearsal)
                m.setattr(CentralizedGPO, "_captures", lambda self: True)
            run = "loop" if engine == "loop" else "scan"
            h = cen.run(epochs=3, log_every=log_every, engine=run)
            h2 = cen.run(epochs=2, log_every=log_every, engine=run)
        if engine == "captured":
            graph = cen.captured_round
            assert isinstance(graph, _Rehearsal)
            # evals at epochs 0 and 2, then 0 and 1
            assert (graph.replays, graph.eval_replays) == (5, 4)
        else:
            assert cen.captured_round is None
        out[engine] = (_history(h), _history(h2), _cen_state(cen))
        if log_every:
            assert "[cen] epoch" in capsys.readouterr().out
    assert np.isfinite(out["loop"][0][0]).all()
    _assert_equal(out["captured"], out["loop"])


def test_a_hook_that_raises_leaves_the_last_completed_epoch(rehearse):
    """A ``batches=`` hook that raises in epoch 2 of a 4-epoch block:
    ``run`` raises, the trainer holds epoch 1's state, and the next run
    goes on from there as the loop's does."""
    data, tr, ev = _data()
    hooks = _hooks(data, tr, ev, 4)
    fail = {"epoch": 2}

    def batches(e, i):
        if e == fail["epoch"]:
            raise RuntimeError("the data loader died")
        return hooks["batches"](e, i)

    cen = _cen(data, tr, ev, batches=batches,
               eval_batches=hooks["eval_batches"])
    with pytest.raises(RuntimeError, match="data loader died"):
        cen.run(epochs=4)
    ref = _cen(data, tr, ev, **hooks)
    ref.run(epochs=2, engine="loop")
    _assert_equal(_cen_state(cen), _cen_state(ref))
    fail["epoch"] = None
    h = cen.run(epochs=2)
    _assert_equal((_history(h), _cen_state(cen)),
                  (_history(ref.run(epochs=2, engine="loop")),
                   _cen_state(ref)))


def test_scan_off_cuda_runs_the_loop_and_refuses_an_unknown_engine():
    data, tr, ev = _data()
    scan, loop = _cen(data, tr, ev), _cen(data, tr, ev)
    _assert_equal(_history(scan.run(epochs=2)),
                  _history(loop.run(epochs=2, engine="loop")))
    assert scan.captured_round is None
    with pytest.raises(ValueError, match="unknown engine"):
        scan.run(epochs=1, engine="fused")


def test_epoch_body_runs_on_the_meta_device():
    """One staged epoch body and eval, their operands, state and survey
    tables on the meta device, kernels off (a wrapper refuses meta
    tensors): they must finish, so they read nothing back to the host,
    the gathers included."""
    data, tr, ev = _data()
    fcfg = FedConfig(num_clients=len(tr), **{
        **BASE, "use_pallas_attention": False,
        "use_pallas_aggregation": False})
    cen = CentralizedGPO(GCFG, fcfg, data, tr, ev, device="cpu")
    meta = torch.device("meta")
    s = cen._streams(fcfg.seed + 2)
    ops = federated._on(cen._stage_epoch(0, s.train), meta)
    assert isinstance(ops, ICLDraw) and ops.q.shape == (len(tr), NC + NT)
    cen._tables = federated._on(cen._tables, meta)
    state, loss = cen._epoch_body(federated._on(cen._state(), meta), ops)
    assert loss.device == meta and loss.shape == ()
    assert all(x.device == meta for x in tree_leaves(state))
    scores = cen._eval_body(state.params,
                            federated._on(cen._eval_host(0, s), meta))
    assert scores.device == meta and scores.shape == (len(ev),)

