"""The port's edge hierarchy (``RoundPipeline.hier_reduce_flat``,
DESIGN.md §14) against the JAX package's, on the CPU.

Unit parity: the client→edge→server reduce of the same (8, P) rows and
weights at 2 and 4 edges for FedAvg, median, trimmed mean and krum, the
port through its kernel wrappers (their plain versions on CPU tensors),
within 1e-6 (sums in another order). Then three replayed rounds of
median at 2 edges against the reference's ``engine="loop"``, held by
``test_torch_train.py``'s tolerances (round losses rtol 1e-4, eval and
params atol 1e-4). Then the guards: the edges must divide the round's m
participants (m = min(batch_groups or C, C), both packages alike), and
the hierarchy does not compose with the fault simulator; and a linear
rule at 2 edges is the flat reduce.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AggConfig as JaxAggConfig
from repro.configs import AvailabilityConfig as JaxAvailabilityConfig
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import GPOConfig as JaxGPOConfig
from repro.configs import HierarchyConfig as JaxHierarchyConfig
from repro.core import FederatedGPO as JaxFederatedGPO
from repro.core.aggregation import make_aggregator as jax_make_aggregator
from repro.core.pipeline import make_pipeline as jax_make_pipeline
from repro.data import SurveyConfig as JaxSurveyConfig
from repro.data import make_survey_data as jax_make_survey_data
from repro_torch.configs import (
    AggConfig,
    AvailabilityConfig,
    FedConfig,
    GPOConfig,
    HierarchyConfig,
)
from repro_torch.core import FederatedGPO, make_aggregator
from repro_torch.core.pipeline import make_pipeline
from repro_torch.data import SurveyData
from repro_torch.utils.pytree import tree_leaves
from test_torch_train import (
    FED,
    SMALL,
    _assert_runs_agree,
    _jax_setup,
    _stage_pair,
)

RULES = {"fedavg": {}, "median": {}, "trimmed_mean": {"trim_frac": 0.25},
         "krum": {"num_malicious": 1}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's runs: the suite runs several
    workers on the CPU's cores, and a thread pool the size of the
    machine in each oversubscribes them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pipes(name, num_edges, c):
    agg = dict(name=name, **RULES[name])
    jcfg = JaxFedConfig(agg=JaxAggConfig(**agg),
                        hierarchy=JaxHierarchyConfig(num_edges=num_edges))
    cfg = FedConfig(agg=AggConfig(**agg), use_pallas_aggregation=True,
                    hierarchy=HierarchyConfig(num_edges=num_edges))
    jp = jax_make_pipeline(jcfg, agg=jax_make_aggregator(
        jcfg.agg, num_clients=c), num_clients=c)
    p = make_pipeline(cfg, agg=make_aggregator(
        cfg.agg, num_clients=c, use_pallas=True), num_clients=c)
    return jp, p


@pytest.mark.parametrize("num_edges", [2, 4])
@pytest.mark.parametrize("name", list(RULES))
def test_hier_reduce_matches_the_reference(name, num_edges):
    c, p = 8, 53
    rng = np.random.default_rng(num_edges)
    rows = rng.standard_normal((c, p)).astype(np.float32)
    rows[6] *= 20.0  # an outlier in the last edge
    w = rng.uniform(0.5, 1.5, c).astype(np.float32)
    w /= w.sum()
    jp, pp = _pipes(name, num_edges, c)
    assert pp.restructured and jp.restructured
    want = np.asarray(jp.hier_reduce_flat(jnp.asarray(rows),
                                          jnp.asarray(w)))
    got = pp.hier_reduce_flat(torch.from_numpy(rows),
                              torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    flat = pp.agg.reduce_flat(torch.from_numpy(rows),
                              torch.from_numpy(w)).numpy()
    if name == "fedavg":  # the edge partials sum to the flat moment
        np.testing.assert_allclose(got, flat, rtol=1e-5, atol=1e-6)


def test_median_at_two_edges_matches_the_reference_over_rounds():
    fed, jfed, h, jh, _ = _stage_pair(
        dict(agg=dict(name="median"), hierarchy=dict(num_edges=2)),
        rounds=3)
    _assert_runs_agree(h, jh, fed.global_params, jfed.global_params)
    assert fed._pipe.restructured and h.round_survivors == []


def _ten_clients():
    """A survey of 17 groups with 10 training clients (the quickstart's
    population), at the small test widths."""
    data = jax_make_survey_data(JaxSurveyConfig(num_groups=17,
                                                num_questions=30,
                                                d_embed=16))
    port = SurveyData(*(torch.from_numpy(np.array(a)) for a in data))
    return data, port, np.arange(10), np.arange(10, 17)


@pytest.mark.parametrize("batch_groups,num_edges,ok", [
    (4, 4, True), (5, 2, False), (0, 2, True), (0, 4, False),
    (3, 3, True)])
def test_hierarchy_is_validated_against_the_round_participants(
        batch_groups, num_edges, ok):
    """The edges partition the round's m participants: C = 10 with m = 4
    takes 4 edges (where 4 does not divide C), m = 5 does not take 2
    (where 2 divides C); both packages alike."""
    data, port, tr, ev = _ten_clients()
    kw = dict(num_clients=10, batch_groups=batch_groups, **FED)
    builds = [
        lambda: JaxFederatedGPO(JaxGPOConfig(**SMALL), JaxFedConfig(
            hierarchy=JaxHierarchyConfig(num_edges=num_edges), **kw),
            data, tr, ev),
        lambda: FederatedGPO(GPOConfig(**SMALL), FedConfig(
            hierarchy=HierarchyConfig(num_edges=num_edges), **kw), port,
            tr, ev, device="cpu")]
    for build in builds:
        if ok:
            build()
        else:
            with pytest.raises(ValueError, match="participant count"):
                build()


def test_hierarchy_does_not_compose_with_faults():
    data, port, tr, ev = _jax_setup()
    kw = dict(num_clients=len(tr), **FED)
    with pytest.raises(ValueError, match="does not compose"):
        JaxFederatedGPO(JaxGPOConfig(**SMALL), JaxFedConfig(
            hierarchy=JaxHierarchyConfig(num_edges=2),
            avail=JaxAvailabilityConfig(online_prob=0.5), **kw),
            data, tr, ev)
    with pytest.raises(ValueError, match="does not compose"):
        FederatedGPO(GPOConfig(**SMALL), FedConfig(
            hierarchy=HierarchyConfig(num_edges=2),
            avail=AvailabilityConfig(online_prob=0.5), **kw), port, tr, ev,
            device="cpu")


def test_linear_hierarchy_run_is_the_flat_run():
    """FedAvg at 2 edges sums the edge partials of the global weights:
    the same rounds as the flat reduce, within float32 reassociation."""
    _, port, tr, ev = _jax_setup()
    out = []
    for e in (1, 2):
        fed = FederatedGPO(GPOConfig(**SMALL), FedConfig(
            num_clients=len(tr), **FED, use_pallas_aggregation=True,
            hierarchy=HierarchyConfig(num_edges=e)), port, tr, ev,
            device="cpu")
        out.append((fed.run(rounds=3), tree_leaves(fed.global_params)))
    np.testing.assert_allclose(out[0][0].round_loss, out[1][0].round_loss,
                               rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
