"""The paper's experiment on the port: one (federated, centralized) pair
of runs on identical data, split and seed feeds Fig. 2 (convergence),
Fig. 4 (alignment) and Fig. 5 (fairness). The counterpart of
``benchmarks/paper_experiment.py``, with its widths and ``FedConfig``,
through the hand-written kernels (the GPO attention forward and backward
and the FedAvg reduce; on CPU tensors their plain versions).

Results cache as JSON under the git-ignored ``build/results/``
(``torch_paper_run_<rounds>.json``), never under ``results/``: the JAX
package's ``load_or_run`` reuses any ``results/paper_*.json``, so a port
file there would stand in for its result.

Scale: the paper runs 1300 rounds; the benchmark default is 400 rounds
over four seeds (§4.1's protocol).
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np

from repro_torch.configs import FedConfig, GPOConfig
from repro_torch.core import CentralizedGPO, FederatedGPO
from repro_torch.core.fairness import convergence_round
from repro_torch.data import SurveyConfig, make_survey_data, split_groups

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "results"
# the reference's widths and FedConfig (benchmarks/paper_experiment.py:
# 46-53): head_dim 24
GPO_WIDTHS = dict(d_model=96, num_layers=3, num_heads=4, d_ff=192)
FED_SETTINGS = dict(local_epochs=6, lr=3e-4, eval_every=10, num_context=12,
                    num_target=12)


@dataclass
class RunResult:
    fed_loss: list
    cen_loss: list
    eval_rounds: list
    fed_as: list
    cen_as: list
    fed_fi: list
    cen_fi: list
    fed_scores_last: list
    cen_scores_last: list


def make_pair(rounds: int, seed: int, num_groups: int = 17,
              num_questions: int = 120, d_embed: int = 48, *, device=None,
              widths: dict = GPO_WIDTHS, settings: dict = FED_SETTINGS):
    """The pair's trainers (``FederatedGPO``, ``CentralizedGPO``) on the
    population and 60/40 split of ``seed``, both from the same initial
    params, through the kernels. ``widths`` and ``settings`` (the
    GPOConfig widths and FedConfig fields) default to the reference's."""
    data = make_survey_data(SurveyConfig(
        num_groups=num_groups, num_questions=num_questions,
        d_embed=d_embed, seed=seed))
    tr, ev = split_groups(data, train_frac=0.6, seed=seed)
    gcfg = GPOConfig(d_embed=d_embed, **widths)
    fcfg = FedConfig(num_clients=len(tr), rounds=rounds, seed=seed,
                     use_pallas_attention=True, use_pallas_aggregation=True,
                     **settings)
    return (FederatedGPO(gcfg, fcfg, data, tr, ev, device=device),
            CentralizedGPO(gcfg, fcfg, data, tr, ev, device=device))


def result_from_histories(hist_f, hist_c) -> RunResult:
    """A pair's ``RunResult`` from its federated and centralized
    ``History``."""
    return RunResult(
        fed_loss=list(hist_f.round_loss), cen_loss=list(hist_c.round_loss),
        eval_rounds=list(hist_f.eval_rounds),
        fed_as=list(hist_f.eval_mean_as), cen_as=list(hist_c.eval_mean_as),
        fed_fi=list(hist_f.eval_fi), cen_fi=list(hist_c.eval_fi),
        fed_scores_last=np.asarray(hist_f.eval_scores[-1]).tolist(),
        cen_scores_last=np.asarray(hist_c.eval_scores[-1]).tolist())


def run_pair_timed(rounds: int, seed: int, num_groups: int = 17,
                   num_questions: int = 120, d_embed: int = 48, *,
                   device=None) -> tuple:
    """``run_pair``'s result and the host's wall milliseconds per
    federated round and per centralized epoch (evals included; each
    round's loss is read back, so the clock covers the card's work)."""
    fed, cen = make_pair(rounds, seed, num_groups, num_questions, d_embed,
                         device=device)
    t0 = time.perf_counter()
    hist_f = fed.run(rounds=rounds)
    t1 = time.perf_counter()
    hist_c = cen.run(epochs=rounds)
    t2 = time.perf_counter()
    return result_from_histories(hist_f, hist_c), {
        "fed_ms_per_round": (t1 - t0) / rounds * 1e3,
        "cen_ms_per_epoch": (t2 - t1) / rounds * 1e3}


def run_pair(rounds: int, seed: int, num_groups: int = 17,
             num_questions: int = 120, d_embed: int = 48, *,
             device=None) -> RunResult:
    """One seed of the experiment: ``rounds`` federated rounds and as
    many centralized epochs."""
    return run_pair_timed(rounds, seed, num_groups, num_questions, d_embed,
                          device=device)[0]


def load_or_run(rounds: int = 400, seeds=(0, 1, 2, 3),
                tag: str = "torch_paper_run", *,
                device=None) -> list[RunResult]:
    """Paper protocol: results over four random seeds (§4.1), read from
    ``RESULTS_DIR/<tag>_<rounds>.json`` when it holds these seeds, else
    run and written there."""
    path = RESULTS_DIR / f"{tag}_{rounds}.json"
    seeds = [int(s) for s in seeds]
    if path.exists():
        cached = json.loads(path.read_text())
        if cached["seeds"] == seeds:
            return [RunResult(**r) for r in cached["results"]]
    results = [run_pair(rounds, s, device=device) for s in seeds]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"seeds": seeds,
                                "results": [asdict(r) for r in results]}))
    return results


def summarize(results: list[RunResult]) -> dict:
    """The paper's three headline numbers, averaged over seeds."""
    speedups, as_improvements, fi_gaps = [], [], []
    fed_conv, cen_conv = [], []
    for r in results:
        rf = convergence_round(np.asarray(r.fed_loss))
        rc = convergence_round(np.asarray(r.cen_loss))
        fed_conv.append(rf)
        cen_conv.append(rc)
        speedups.append(100.0 * (rc - rf) / max(rc, 1))
        as_improvements.append(
            100.0 * (r.fed_as[-1] - r.cen_as[-1]) / max(r.cen_as[-1], 1e-9))
        fi_gaps.append(r.fed_fi[-1] - r.cen_fi[-1])
    return {
        "fed_convergence_round": float(np.mean(fed_conv)),
        "cen_convergence_round": float(np.mean(cen_conv)),
        "convergence_speedup_pct": float(np.mean(speedups)),
        "alignment_improvement_pct": float(np.mean(as_improvements)),
        "fed_final_as": float(np.mean([r.fed_as[-1] for r in results])),
        "cen_final_as": float(np.mean([r.cen_as[-1] for r in results])),
        "fed_final_fi": float(np.mean([r.fed_fi[-1] for r in results])),
        "cen_final_fi": float(np.mean([r.cen_fi[-1] for r in results])),
        "fi_gap": float(np.mean(fi_gaps)),
    }
