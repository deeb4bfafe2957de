"""The port's sharded round (``core/federated.py::make_sharded_round``,
driven by ``ShardedGPO``) against its stacked round (``FederatedGPO``)
on the CPU, over gloo, at test widths (d_model 32, one layer, C 8).

A process group for each W of 1, 2 and 4 (W 1 in the test's process,
the others spawned) runs every configuration of ``RUNS`` on a one-axis
host mesh, each from the same
seed as the stacked run it is held to (the engines draw the same values
for the whole population; each process keeps its rows), and W 4 also
runs ``EDGE_RUNS`` on ``make_edge_mesh(2, 2)``. Tolerances:

* every process ends the run with the same global params, bit for bit;
* at W 1 the sharded run equals the stacked one bit for bit: params,
  server state, EF residual, in-flight rows and client losses;
* at W 2 and 4, within 1e-5 (float32 sums over the processes
  reassociated): params, server state, EF residual, in-flight rows,
  client losses (relative); survivors and ε equal. Codec runs widen the
  params and the residual by their codec level a round (the largest
  int8 scale or top-k threshold the stacked run saw): a reassociated
  sum moves the next round's rows by ~1e-9, which can flip an int8
  rounding decision or swap a top-k near-tie; with int8 at two edges
  the sharded round also quantizes each edge's candidate for the cross-
  edge hop, which the stacked round does not (half a level).

The byte contracts of DESIGN.md §10, §11 and §14 are read from each
process's collective ledger, the rows of ``BENCH_comm.json`` and
``BENCH_hier.json`` whose reference tests fail on this JAX (ROADMAP
C.6). A planted fault: a process that raises inside a round makes
``spawn`` raise within its deadline.
"""
import time
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

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
from repro_torch.core import FederatedGPO, ShardedGPO, make_sharded_round
from repro_torch.core import compression as cx
from repro_torch.data import SurveyConfig, SurveyData, make_survey_data
from repro_torch.launch.mesh import make_edge_mesh, make_host_mesh, spawn
from repro_torch.utils.pytree import tree_count_params, tree_leaves

C, ROUNDS = 8, 2
GCFG = GPOConfig(d_embed=16, d_model=32, num_layers=1, num_heads=1,
                 d_ff=64)
BASE = FedConfig(num_clients=C, local_epochs=2, num_context=4,
                 num_target=4, use_pallas_attention=True,
                 use_pallas_aggregation=True)
# a DP clip under most clients' round-0 delta norms at this size
_DP = {"clip_norm": 0.045, "noise_multiplier": 0.8}
_BYZ = {"num_attackers": 2}
# a planted schedule: round 0 client 7 offline, client 2 crashes, 1 and
# 5 straggle one round (buffered on processes 0 and 2 of 4); round 1
# client 0 offline, client 3 straggles, and 1 and 5 land
FAULT_DRAWS = {
    0: (~np.eye(C, dtype=bool)[7], np.eye(C, dtype=bool)[2],
        np.isin(np.arange(C), [1, 5]), np.ones(C, np.int32)),
    1: (~np.eye(C, dtype=bool)[0], np.zeros(C, bool),
        np.eye(C, dtype=bool)[3], np.ones(C, np.int32)),
}
_FAULTS = {"online_prob": 0.8, "crash_prob": 0.2, "straggler_prob": 0.5,
           "max_staleness": 1}
# the configurations of chip_smoke.py phase 4g (b), at test width
RUNS = {
    "fedavg": {},
    "fedavg-plain": {"plain": True},
    "fedavgm": {"agg": {"name": "fedavgm", "momentum": 0.9}},
    "adaptive": {"agg": {"name": "adaptive", "fair_temp": 1.0}},
    "fedbuff": {"agg": {"name": "fedbuff"}},
    "median": {"agg": {"name": "median"}},
    "krum": {"agg": {"name": "krum", "num_malicious": 2}},
    "dp_noise": {"privacy": _DP},
    "int8_ef": {"compression": {"kind": "int8"}},
    "topk_ef": {"compression": {"kind": "topk", "topk_frac": 0.01}},
    "dp_int8_ef": {"privacy": _DP, "compression": {"kind": "int8"}},
    "alie-median": {"adversary": {"kind": "alie", **_BYZ},
                    "agg": {"name": "median"}},
    "sign_flip-krum": {"adversary": {"kind": "sign_flip", **_BYZ},
                       "agg": {"name": "krum", "num_malicious": 2}},
    "gaussian-norm_bound": {"adversary": {"kind": "gaussian", **_BYZ},
                            "agg": {"norm_bound": 0.02}},
    "label_flip": {"adversary": {"kind": "label_flip", **_BYZ}},
    "faults-fedavg": {"avail": {"online_prob": 0.5, "max_staleness": 1},
                      "planted": True},
    "faults-median": {"avail": _FAULTS, "agg": {"name": "median"}},
    # for the byte contracts: the robust family under DP and under int8
    "dp_median": {"privacy": _DP, "agg": {"name": "median"}},
    "int8-median": {"compression": {"kind": "int8"},
                    "agg": {"name": "median"}},
}
# and of phase 4g (c): two edges of two processes
EDGE_RUNS = {
    "hier-fedavg": {"hierarchy": {"num_edges": 2}},
    "hier-median": {"hierarchy": {"num_edges": 2},
                    "agg": {"name": "median"}},
    "hier-int8-median": {"hierarchy": {"num_edges": 2},
                         "agg": {"name": "median"},
                         "compression": {"kind": "int8"}},
}
SPECS = {**RUNS, **EDGE_RUNS}
CODEC = ("int8_ef", "topk_ef", "dp_int8_ef", "int8-median",
         "hier-int8-median")
WORLDS = (1, 2, 4)


def _cfg(label: str) -> FedConfig:
    spec = SPECS[label]
    cfg = replace(
        BASE, agg=AggConfig(**spec.get("agg", {})),
        privacy=PrivacyConfig(**spec.get("privacy", {})),
        compression=CompressionConfig(**spec.get("compression", {})),
        adversary=AdversaryConfig(**spec.get("adversary", {})),
        avail=AvailabilityConfig(**spec.get("avail", {})),
        hierarchy=HierarchyConfig(**spec.get("hierarchy", {})))
    if spec.get("plain"):
        cfg = replace(cfg, use_pallas_attention=False,
                      use_pallas_aggregation=False)
    return cfg


def _hooks(label: str) -> dict:
    if SPECS[label].get("planted"):
        return {"fault_draws": FAULT_DRAWS.__getitem__}
    return {}


def _data():
    data = make_survey_data(SurveyConfig(num_groups=C + 2,
                                         num_questions=30, d_embed=16),
                            torch.Generator().manual_seed(0))
    return data, np.arange(C), np.arange(C, C + 2)


def _np(tree) -> list:
    return [t.detach().cpu().numpy().copy() for t in tree_leaves(tree)]


def _state(run) -> dict:
    """What a run ends with, as numpy."""
    fault = run.fault_state
    return {"params": _np(run.global_params),
            "server": _np(run.server_state),
            "resid": None if run.ef_resid is None
            else run.ef_resid.numpy().copy(),
            "pending": None if fault is None else fault.pending.numpy().copy()}


def _run_rank(rank, device, labels, edge_labels):
    """One process of a group: every configuration, each from the seed;
    its state, its clients' losses, survivors, ε and collective
    ledger."""
    torch.set_num_threads(1)
    data, tr, _ = _data()
    meshes = {"host": make_host_mesh(device=device)}
    if edge_labels:
        meshes["edge"] = make_edge_mesh(2, 2, device=device)
    out = {}
    for label in labels + edge_labels:
        mesh = meshes["edge" if label in EDGE_RUNS else "host"]
        run = ShardedGPO(GCFG, _cfg(label), data, tr, mesh, **_hooks(label))
        digests, real = [], run._round_fn

        def round_fn(*a, real=real, digests=digests, **k):
            res = real(*a, **k)  # each round's params, as bytes
            digests.append(b"".join(x.tobytes() for x in _np(res.params)))
            return res

        run._round_fn = round_fn
        hist = run.run(ROUNDS)
        out[label] = {**_state(run), "digests": digests,
                      "rows": (run.rows.start, run.rows.stop),
                      "losses": hist.client_losses,
                      "survivors": hist.round_survivors,
                      "eps": hist.round_eps,
                      "ledger": [(c.op, c.axes, c.nbytes, c.staged)
                                 for c in run.comm.ledger]}
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{W: [each process's results]}: W 1 in this process (a one-rank
    gloo group; a process start costs more than its runs), one spawned
    group for each other W."""
    store = tmp_path_factory.mktemp("store") / "store"
    threads = torch.get_num_threads()
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        out = {1: [_run_rank(0, torch.device("cpu"), list(RUNS), [])]}
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)
    for w in WORLDS[1:]:
        edge = list(EDGE_RUNS) if w == 4 else []
        out[w] = spawn(w, _run_rank, list(RUNS), edge, backend="gloo",
                       device="cpu", timeout=60, deadline=240)
    return out


@pytest.fixture(scope="module")
def stacked():
    """{label: (the stacked run's state, History, codec levels a round)}
    on the CPU from the same seed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    data, tr, ev = _data()
    real = cx.quantize_int8, cx.topk_thresholds
    out = {}
    try:
        for label in SPECS:
            levels = []

            def quantize(vecs, *, uniform=None):
                q, scales = real[0](vecs, uniform=uniform)
                levels.append(float(scales.max()))
                return q, scales

            def thresholds(vecs, frac):
                tau = real[1](vecs, frac)
                levels.append(float(tau.max()))
                return tau

            cx.quantize_int8, cx.topk_thresholds = quantize, thresholds
            fed = FederatedGPO(GCFG, replace(_cfg(label), eval_every=ROUNDS),
                               data, tr, ev, device="cpu", **_hooks(label))
            hist = fed.run(rounds=ROUNDS)
            out[label] = (_state(fed), hist, levels,
                          float(fed.weights.max()))
    finally:
        cx.quantize_int8, cx.topk_thresholds = real
        torch.set_num_threads(threads)
    return out


def _cases():
    return [(w, label) for w in WORLDS for label in RUNS] + \
        [(4, label) for label in EDGE_RUNS]


@pytest.mark.parametrize("w,label", _cases())
def test_sharded_round_matches_stacked(sharded, stacked, w, label):
    ranks = sharded[w]
    want, hist, levels, w_max = stacked[label]
    first = ranks[0][label]
    # every process ends every round with the same global model
    assert len(first["digests"]) == ROUNDS
    assert all(r[label]["digests"] == first["digests"] for r in ranks)
    assert [r[label]["rows"] for r in ranks] == [
        (i * C // w, (i + 1) * C // w) for i in range(w)]
    losses = np.concatenate([np.stack(r[label]["losses"]) for r in ranks],
                            axis=1)  # (rounds, C)
    got = {"params": first["params"], "server": first["server"],
           "resid": None if first["resid"] is None else np.concatenate(
               [r[label]["resid"] for r in ranks]),
           "pending": None if first["pending"] is None else np.concatenate(
               [r[label]["pending"] for r in ranks])}
    assert first["survivors"] == hist.round_survivors
    assert first["eps"] == hist.round_eps
    assert (got["resid"] is None) == (want["resid"] is None)
    assert (got["pending"] is None) == (want["pending"] is None)
    if w == 1:
        for key in ("params", "server"):
            for a, b in zip(got[key], want[key]):
                assert np.array_equal(a, b), key
        for key in ("resid", "pending"):
            if want[key] is not None:
                assert np.array_equal(got[key], want[key]), key
        if not SPECS[label].get("avail"):
            assert [float(torch.from_numpy(x).mean()) for x in losses] \
                == hist.round_loss
        return
    level = sum(levels) if label in CODEC else 0.0
    tol = {"params": 1e-5 + w_max * level, "server": 1e-5 + w_max * level,
           "resid": 1e-5 + level, "pending": 1e-5}
    if label == "hier-int8-median":  # the candidates' own rounding
        tol["params"] = tol["server"] = 1e-5 + level
    for key in ("params", "server"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol[key],
                                       err_msg=key)
    for key in ("resid", "pending"):
        if want[key] is not None:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=tol[key], err_msg=key)
    if not SPECS[label].get("avail"):
        # with int8 at two edges the later rounds train from params a
        # candidate's rounding apart: round 0's losses only
        n = 1 if label == "hier-int8-median" else ROUNDS
        np.testing.assert_allclose(losses.mean(axis=1)[:n],
                                   hist.round_loss[:n], rtol=1e-5)


def _calls(sharded, label, w=2):
    """The collective calls of one process's run, by round (the ledger
    split evenly over the rounds)."""
    ledger = sharded[w][0][label]["ledger"]
    assert len(ledger) % ROUNDS == 0
    n = len(ledger) // ROUNDS
    return [ledger[i * n:(i + 1) * n] for i in range(ROUNDS)]


def _p():
    from repro_torch.core import init_gpo_params
    return tree_count_params(init_gpo_params(
        GCFG, torch.Generator().manual_seed(0), device="cpu"))


@pytest.mark.parametrize("label", [
    "fedavg", "fedavg-plain", "fedavgm", "fedbuff", "dp_noise", "int8_ef",
    "topk_ef", "dp_int8_ef", "gaussian-norm_bound", "label_flip",
    "adaptive", "faults-fedavg", "hier-fedavg"])
def test_linear_family_makes_one_all_reduce_a_round(sharded, label):
    """DESIGN.md §10, §11, §14: the linear family's round is ONE
    all-reduce of the P float32 partial sum, whatever the codec, the
    norm bound, the attack, the faults or the edges, plus the losses'
    all-gather for adaptive."""
    w = 4 if label in EDGE_RUNS else 2
    axes = ("edge", "data") if label in EDGE_RUNS else ("data",)
    p = _p()
    for calls in _calls(sharded, label, w):
        want = [("psum", axes, 4 * p, False)]
        if label == "adaptive":
            want.append(("all_gather", axes, 4 * C, False))
        assert calls == want


@pytest.mark.parametrize("label", ["median", "krum", "sign_flip-krum",
                                   "dp_median"])
def test_robust_family_gathers_the_rows(sharded, label):
    """The robust family gathers its C rows of P float32 and the C
    weights, once a round (ALIE's attack would add its moments' sums)."""
    p = _p()
    for calls in _calls(sharded, label):
        assert calls == [("all_gather", ("data",), 4 * C * p, False),
                         ("all_gather", ("data",), 4 * C, False)]


def test_faulted_robust_round_gathers_the_blended_rows(sharded):
    """Under faults the robust family gathers the blended f32 rows once a
    round that absorbed one (the weights are the same on every
    process)."""
    run = sharded[2][0]["faults-median"]
    want = [("all_gather", ("data",), 4 * C * _p(), False)] * sum(
        n > 0 for n in run["survivors"])
    assert want and run["ledger"] == want


def test_int8_robust_round_gathers_a_quarter_of_the_bytes(sharded):
    """Under the int8 codec the robust family gathers the int8 payload
    and the f32 scales in place of the f32 rows: about 4x fewer bytes
    (BENCH_comm.json sharded_allgather.reduction 3.996 at its P)."""
    p = _p()
    for calls in _calls(sharded, "int8-median"):
        assert calls == [("all_gather", ("data",), C * p, False),
                         ("all_gather", ("data",), 4 * C, False),
                         ("all_gather", ("data",), 4 * C, False)]
    f32 = 4 * C * p + 4 * C
    int8 = C * p + 8 * C
    assert 3.99 < f32 / int8 < 4.0


@pytest.mark.parametrize("label,cross", [("hier-median", 4),
                                         ("hier-int8-median", 1)])
def test_two_hop_gathers_edge_rows_then_candidates(sharded, label, cross):
    """The two hops on make_edge_mesh(2, 2) (DESIGN.md §14): C/E rows
    within each edge, then E candidate rows across the edges, (C/E)x
    fewer bytes than the flat gather (BENCH_hier.json
    cross_edge_reduction 2.0 at C 8, E 4); under the int8 codec the
    candidates cross as int8, another 4x (int8_cross_edge_reduction
    8.0 there)."""
    p, e = _p(), 2
    flat = 4 * C * p
    for calls in _calls(sharded, label, 4):
        assert calls[:2] == [("all_gather", ("data",), 4 * (C // e) * p,
                              False),
                             ("all_gather", ("data",), 4 * (C // e), False)]
        rows = [c for c in calls[2:] if c[2] >= p]
        assert rows == [("all_gather", ("edge",), cross * e * p, False)]
        assert flat / rows[0][2] == (C // e) * 4 // cross
        assert all(c[1] == ("edge",) for c in calls[2:])


def _replay_rank(rank, device, arrays, widths, fed, runs):
    """A process of tests/test_torch_sharded_ref.py's group (defined
    here, where no JAX is imported): for each aggregation of ``runs``,
    one round from the given params and batches (``batches=``) on a
    host mesh, through the kernel wrappers; the new global params."""
    torch.set_num_threads(1)
    data = SurveyData(*(torch.from_numpy(a) for a in arrays))
    mesh = make_host_mesh(device=device)
    out = {}
    for name, (init, batches) in runs.items():
        fcfg = replace(BASE, **fed, agg=AggConfig(name=name))
        run = ShardedGPO(GPOConfig(**widths), fcfg, data,
                         np.arange(fed["num_clients"]), mesh,
                         init_params=init,
                         batches=lambda r, e, b=batches: b[e])
        run.run(1)
        out[name] = _np(run.global_params)
    return out


def _raising_rank(rank, device, fail_round):
    """A process group whose rank 1 raises in the middle of a round,
    after its local training, while rank 0 waits in the all-reduce."""
    data, tr, _ = _data()
    run = ShardedGPO(GCFG, BASE, data, tr, make_host_mesh(device=device))
    if rank == 1:
        real = run.agg.reduce_flat
        calls = []

        def reduce_flat(vecs, weights):
            calls.append(1)
            if len(calls) > fail_round:
                raise RuntimeError("planted fault in rank 1")
            return real(vecs, weights)

        run._round_fn = make_sharded_round(
            GCFG, BASE, run.comm.mesh, ("data",), opt=run.opt,
            agg=replace(run.agg, reduce_flat=reduce_flat), comm=run.comm)
    run.run(ROUNDS)
    return "finished"


def test_a_rank_that_raises_fails_spawn_within_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException,
                       match="planted fault in rank 1"):
        spawn(2, _raising_rank, 1, backend="gloo", device="cpu",
              timeout=30, deadline=60)
    assert time.monotonic() - t0 < 60


def test_spawn_refuses_devices_the_machine_lacks():
    """No fallback: a world asking for more CUDA devices than there are
    raises before any process starts."""
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="is not on this machine"):
        spawn(n + 1, _raising_rank, 0, backend="gloo")
