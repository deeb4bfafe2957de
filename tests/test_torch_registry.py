"""Every strategy of the port's aggregation registry against the JAX
package's, on the CPU: ``make_aggregator(cfg).step`` for each registered
name, leafwise and through the kernels (the port's plain versions here,
the JAX kernels in Pallas interpret mode), two steps in a row so that
the momentum and moment trees, the adaptive scores and the fedbuff
buffer carry over. Tolerances:

* 1e-6 for the linear strategies and the trimmed ones (weighted sums
  over four clients in another order);
* 1e-5 for fedadam, fedyogi and geomedian (a division by √v + τ, and by
  the Weiszfeld distances);
* krum and multi_krum must choose the reference's rows (one client's
  delta lies far from the others), then hold 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AggConfig as JaxAggConfig
from repro.configs import GPOConfig as JaxGPOConfig
from repro.core import aggregation as jax_aggregation
from repro.core import gpo as jax_gpo
from repro_torch.configs import AggConfig
from repro_torch.core import AGGREGATORS, params_from_numpy
from repro_torch.core.adversary import norm_clip_rows
from repro_torch.core.aggregation import krum_scores, make_aggregator
from repro_torch.utils.pytree import tree_leaves, tree_ravel_clients

C = 4
FAR = 3  # the client whose deltas lie far from the others
SMALL = dict(d_embed=16, d_model=32, num_layers=2, num_heads=2, d_ff=64)
# hyperparameters that exercise each mechanism (bench_round.py's
# AGG_SWEEP, with the trim on at C = 4 and a fedbuff buffer that
# flushes only every second round)
CASES = {
    "fedavg": dict(server_lr=0.7),
    "fedprox": dict(prox_mu=0.01),
    "fedavgm": dict(momentum=0.9, server_lr=0.7),
    "fedadam": dict(tau=1e-2, server_lr=1e-2),
    "fedyogi": dict(tau=1e-2, server_lr=1e-2),
    "trimmed_mean": dict(trim_frac=0.3),
    "median": dict(),
    "adaptive": dict(fair_temp=1.0, fair_decay=0.9),
    "fedbuff": dict(buffer_k=6),
    "krum": dict(num_malicious=1),
    "multi_krum": dict(num_malicious=1, multi_krum_m=2),
    "geomedian": dict(),
}
LOOSE = {"fedadam", "fedyogi", "geomedian"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup():
    """Global params, two rounds of client-stacked deltas (client FAR
    30x off), weights and per-client losses, as JAX trees and the
    port's."""
    jglob = jax_gpo.init_gpo_params(JaxGPOConfig(**SMALL),
                                    jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def deltas():
        def leaf(x):
            d = 1e-2 * rng.standard_normal((C,) + x.shape)
            d[FAR] *= 30.0
            return jnp.asarray(d.astype(np.float32))

        return jax.tree_util.tree_map(leaf, jglob)

    jdeltas = [deltas(), deltas()]
    sizes = rng.integers(8, 120, C)
    w = (sizes / sizes.sum()).astype(np.float32)
    losses = [rng.uniform(0.5, 2.0, C).astype(np.float32) for _ in range(2)]
    port = (params_from_numpy(_np_tree(jglob), "cpu"),
            [params_from_numpy(_np_tree(d), "cpu") for d in jdeltas])
    return (jglob, jdeltas), port, w, losses


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _assert_states_agree(state, jstate, tol):
    assert int(state.step) == int(jstate.step)
    for slot in ("m", "v"):
        ours, theirs = getattr(state, slot), getattr(jstate, slot)
        if isinstance(ours, torch.Tensor):
            assert ours.shape == () and float(ours) == float(theirs) == 0.0
            continue
        for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            _close(a.numpy(), b, tol)
    if isinstance(state.scores, dict):
        assert sorted(state.scores) == sorted(jstate.scores)
        for key, val in state.scores.items():
            _close(val.numpy(), jstate.scores[key], tol)


def test_registry_names_match_the_reference():
    assert AGGREGATORS.names() == jax_aggregation.AGGREGATORS.names() \
        == sorted(CASES)


@pytest.mark.parametrize("kernel", [False, True], ids=["leafwise", "kernel"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_aggregator_step_matches_jax(name, kernel):
    (jglob, jdeltas), (glob, deltas), w, losses = _setup()
    kw = CASES[name]
    jagg = jax_aggregation.make_aggregator(
        JaxAggConfig(name=name, **kw), num_clients=C, use_pallas=kernel)
    agg = make_aggregator(AggConfig(name=name, **kw), num_clients=C,
                          use_pallas=kernel)
    assert (agg.linear, agg.needs_losses, agg.buffered) == (
        jagg.linear, jagg.needs_losses, jagg.buffered)
    tol = 1e-5 if name in LOOSE else 1e-6
    jstate, state = jagg.init(jglob), agg.init(glob)
    for r in range(2):
        if name in ("krum", "multi_krum"):
            vecs = tree_ravel_clients(deltas[r])
            scores = krum_scores(vecs, torch.from_numpy(w), 1,
                                 use_pallas=kernel)
            jscores = jax_aggregation.krum_scores(
                jnp.asarray(vecs.numpy()), jnp.asarray(w), 1,
                use_pallas=kernel)
            order = torch.argsort(scores, stable=True).tolist()
            assert order == np.argsort(np.asarray(jscores),
                                       kind="stable").tolist()
            assert order[-1] == FAR  # the far row scores worst
        kwargs = dict(losses=jnp.asarray(losses[r])) if name == "adaptive" \
            else {}
        jglob, jstate = jagg.step(jstate, jglob, jdeltas[r], jnp.asarray(w),
                                  **kwargs)
        if kwargs:
            kwargs = dict(losses=torch.from_numpy(losses[r]))
        glob, state = agg.step(state, glob, deltas[r], torch.from_numpy(w),
                               **kwargs)
        for a, b in zip(tree_leaves(glob), jax.tree_util.tree_leaves(jglob)):
            assert a.shape == b.shape
            _close(a.numpy(), b, tol)
        _assert_states_agree(state, jstate, tol)
    if name == "fedbuff":  # flushed in round 2, not in round 1
        assert float(state.scores["count"]) == 0.0
    if name == "adaptive":
        assert (state.scores["seen"] == 1.0).all()


def test_unknown_strategy_raises_naming_the_known_ones():
    with pytest.raises(KeyError, match="unknown aggregator 'fedsgd'.*krum"):
        make_aggregator(AggConfig(name="fedsgd"), num_clients=3)


def test_launcher_refuses_a_strategy_outside_the_registry(capsys):
    from repro_torch.launch import train

    with pytest.raises(SystemExit):
        train.main(["--agg", "fedsgd", "--device", "cpu"])
    err = capsys.readouterr().err
    assert all(name in err for name in AGGREGATORS.names())


def test_norm_clip_rows_matches_jax():
    from repro.core.adversary import norm_clip_rows as jax_clip

    x = np.random.default_rng(2).standard_normal((5, 333)).astype(np.float32)
    x[2] = 0.0  # a zero row keeps scale 1
    x[4] *= 1e-3  # a row under the bound is not scaled
    got = norm_clip_rows(torch.from_numpy(x), 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_clip(
        jnp.asarray(x), 3.0)), rtol=1e-6, atol=1e-7)
    norms = torch.linalg.vector_norm(got, dim=1)
    assert (norms <= 3.0 * (1 + 1e-6)).all() and norms[2] == 0.0
    assert torch.equal(got[4], torch.from_numpy(x[4]))
