"""The paper's experiment on the port (``repro_torch.benchmarks.
paper_experiment`` and the three examples) against the JAX package's,
on the CPU.

* ``summarize``: equal to the reference's on the same ``RunResult``s
  (rtol 1e-12; the same numpy arithmetic).
* A replayed pair at a small width (d_model 48, 2 heads: head_dim 24,
  one layer),
  the experiment's ``FedConfig`` otherwise: 3 federated rounds and 3
  centralized epochs, the port replaying the reference's init and draws;
  the ``RunResult`` fields within the replayed rounds' tolerances
  (losses rtol 1e-4, AS / FI / scores atol 1e-4).
* The statistical check of unreplayed runs is
  ``test_torch_experiment_stats.py`` (its own file, for the clock).
* ``load_or_run`` caches under ``build/results`` and touches nothing
  else; each example's ``main`` at a tiny size with ``--device cpu``,
  and raising without a card when no device is named.
"""
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest
import torch

from benchmarks import paper_experiment as jax_pe
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import GPOConfig as JaxGPOConfig
from repro.core import CentralizedGPO as JaxCentralizedGPO
from repro.core import FederatedGPO as JaxFederatedGPO
from repro.data import SurveyConfig as JaxSurveyConfig
from repro.data import make_survey_data as jax_make_survey_data
from repro.data import split_groups as jax_split_groups
from repro_torch.benchmarks import paper_experiment as pe
from repro_torch.configs import FedConfig, GPOConfig
from repro_torch.core import CentralizedGPO, FederatedGPO
from repro_torch.data import SurveyData
from test_torch_train import _cen_draws, _fed_draws, _np_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]


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
# summarize
# ---------------------------------------------------------------------------
def _random_results(rng, n, rounds, evals, groups):
    def curve():
        c = np.cumsum(rng.normal(-0.01, 0.05, rounds)) + 1.0
        return c.tolist()

    out = []
    for _ in range(n):
        out.append({
            "fed_loss": curve(), "cen_loss": curve(),
            "eval_rounds": list(range(0, rounds, rounds // evals)),
            **{k: rng.uniform(0.3, 1.0, evals).tolist()
               for k in ("fed_as", "cen_as", "fed_fi", "cen_fi")},
            "fed_scores_last": rng.uniform(0.3, 1.0, groups).tolist(),
            "cen_scores_last": rng.uniform(0.3, 1.0, groups).tolist()})
    return out


def test_run_result_fields_match_the_reference():
    assert [f.name for f in dataclasses.fields(pe.RunResult)] == \
        [f.name for f in dataclasses.fields(jax_pe.RunResult)]


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 4), (2, 3)])
def test_summarize_matches_the_reference(seed, n):
    raw = _random_results(np.random.default_rng(seed), n, 60, 6, 7)
    raw[0]["cen_loss"] = sorted(raw[0]["cen_loss"])  # a diverging curve
    got = pe.summarize([pe.RunResult(**r) for r in raw])
    want = jax_pe.summarize([jax_pe.RunResult(**r) for r in raw])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the replayed pair
# ---------------------------------------------------------------------------
SMALL_WIDTHS = dict(d_model=48, num_layers=1, num_heads=2, d_ff=96)


def _jax_result(hist_f, hist_c) -> "jax_pe.RunResult":
    """The reference's RunResult of two histories, as its run_pair
    builds it (benchmarks/paper_experiment.py:55-62)."""
    return jax_pe.RunResult(
        fed_loss=hist_f.round_loss, cen_loss=hist_c.round_loss,
        eval_rounds=hist_f.eval_rounds,
        fed_as=hist_f.eval_mean_as, cen_as=hist_c.eval_mean_as,
        fed_fi=hist_f.eval_fi, cen_fi=hist_c.eval_fi,
        fed_scores_last=np.asarray(hist_f.eval_scores[-1]).tolist(),
        cen_scores_last=np.asarray(hist_c.eval_scores[-1]).tolist())


def test_replayed_pair_matches_the_reference():
    rounds, seed = 3, 1
    data = jax_make_survey_data(JaxSurveyConfig(
        num_groups=8, num_questions=60, d_embed=16, seed=seed))
    tr, ev = jax_split_groups(data, train_frac=0.6, seed=seed)
    port_data = SurveyData(*(torch.from_numpy(np.array(a)) for a in data))
    jgcfg = JaxGPOConfig(d_embed=16, **SMALL_WIDTHS)
    jfcfg = JaxFedConfig(num_clients=len(tr), rounds=rounds, seed=seed,
                         engine="loop", **pe.FED_SETTINGS)
    jfed = JaxFederatedGPO(jgcfg, jfcfg, data, tr, ev)
    jcen = JaxCentralizedGPO(jgcfg, jfcfg, data, tr, ev)
    init = _np_tree(jfed.global_params)  # the pair's common init
    want = _jax_result(jfed.run(rounds=rounds), jcen.run(epochs=rounds))

    gcfg = GPOConfig(d_embed=16, **SMALL_WIDTHS)
    fcfg = FedConfig(num_clients=len(tr), rounds=rounds, seed=seed,
                     use_pallas_attention=True, use_pallas_aggregation=True,
                     **pe.FED_SETTINGS)
    train, fed_evals = _fed_draws(data, fcfg, tr, ev, rounds)
    steps, cen_evals = _cen_draws(data, fcfg, tr, ev, rounds)
    fed = FederatedGPO(gcfg, fcfg, port_data, tr, ev, device="cpu",
                       init_params=init, batches=lambda r, e: train[r, e],
                       eval_batches=lambda r: fed_evals[r])
    cen = CentralizedGPO(gcfg, fcfg, port_data, tr, ev, device="cpu",
                         init_params=init, batches=lambda e, i: steps[e, i],
                         eval_batches=lambda e: cen_evals[e])
    got = pe.result_from_histories(fed.run(rounds=rounds),
                                   cen.run(epochs=rounds))
    assert got.eval_rounds == want.eval_rounds == [0, rounds - 1]
    for k in ("fed_loss", "cen_loss"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-4, atol=0, err_msg=k)
    for k in ("fed_as", "cen_as", "fed_fi", "cen_fi", "fed_scores_last",
              "cen_scores_last"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-4, err_msg=k)
    s, ws = pe.summarize([got]), jax_pe.summarize([want])
    for k in ("fed_convergence_round", "cen_convergence_round"):
        assert s[k] == ws[k]


# ---------------------------------------------------------------------------
# load_or_run's cache, and the examples
# ---------------------------------------------------------------------------
def test_load_or_run_caches_only_under_build(tmp_path, monkeypatch):
    assert pe.RESULTS_DIR == ROOT / "build" / "results"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    calls, touched = [], []
    fake = _random_results(np.random.default_rng(3), 4, 20, 2, 7)

    def run_pair(rounds, seed, **kw):
        calls.append((rounds, seed))
        return pe.RunResult(**fake[seed])

    recording = []
    for name in ("exists", "read_text", "write_text", "mkdir", "open",
                 "glob", "iterdir"):
        real = getattr(pathlib.Path, name)

        def spy(self, *a, _real=real, **k):
            if recording:
                touched.append(pathlib.Path(self))
            return _real(self, *a, **k)

        monkeypatch.setattr(pathlib.Path, name, spy)
    cache = tmp_path / "build" / "results"
    monkeypatch.setattr(pe, "RESULTS_DIR", cache)
    monkeypatch.setattr(pe, "run_pair", run_pair)
    monkeypatch.chdir(tmp_path)
    recording.append(True)
    first = pe.load_or_run(rounds=20, seeds=(0, 1))
    again = pe.load_or_run(rounds=20, seeds=(0, 1))
    pe.load_or_run(rounds=20, seeds=(2,))  # other seeds: run again
    recording.clear()
    assert calls == [(20, 0), (20, 1), (20, 2)]  # the second: the cache
    assert again == first == [pe.RunResult(**fake[s]) for s in (0, 1)]
    assert [p.relative_to(tmp_path).as_posix()
            for p in tmp_path.rglob("*") if p.is_file()] == \
        ["build/results/torch_paper_run_20.json"]
    # the cache file, or the cache directory and its parents (mkdir)
    assert touched and all(cache in (p, *p.parents) or p in cache.parents
                           for p in touched)
    assert not any("paper_" in p.name and "torch" not in p.name
                   for p in touched)


EXAMPLES = {
    "federated_vs_centralized": (["--rounds", "2", "--seeds", "0"],
                                 "=== PluralLLM vs centralized GPO (2 "
                                 "rounds, 1 seeds) ==="),
    "quickstart": (["--rounds", "1"], "unseen group"),
    "serve_preferences": (["--train-rounds", "1", "--requests", "4"],
                          "served 4 requests (f32)"),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys):
    argv, line = EXAMPLES[name]
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = mod.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert line in text
    if name == "federated_vs_centralized":  # summarize's numbers
        assert "convergence_speedup_pct" in out
        assert np.isfinite(list(out.values())).all()
        assert "ms/round" in text and "ms/epoch" in text
    elif name == "quickstart":
        assert 0.0 < out <= 1.0
    else:
        assert out["completed"] == 4 and 0.0 < out["mean_as"] <= 1.0
        assert 0.0 < out["fi"] <= 1.0 and out["p99_ms"] >= out["p50_ms"]


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_needs_a_card_unless_told_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(EXAMPLES[name][0])
