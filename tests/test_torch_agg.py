"""The port's aggregation kernels and FedAvg path against the JAX
package's, on the CPU: the wrappers of the ``fedavg_reduce``,
``momentum_reduce``, ``trimmed_reduce`` and ``pairwise_dists`` kernels
(their plain versions here; the JAX kernels in Pallas interpret mode),
the params-tree helpers that ravel clients in the reference's leaf
order, Eq. 2-3, and the ``fedavg`` aggregator. Tolerances: 1e-6 for the
weighted sums and the trimmed mean (float32 sums over at most ten
clients, in another order); atol 1e-5·maxᵢ‖xᵢ‖² for the pairwise
distances (the reference kernel's expansion form cancels, the port's
plain version takes the difference form); the raveled order and the
weights are exact.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AggConfig as JaxAggConfig
from repro.configs import GPOConfig as JaxGPOConfig
from repro.core import aggregation as jax_aggregation
from repro.core import fedavg as jax_fedavg
from repro.core import gpo as jax_gpo
from repro.kernels import agg_momentum_reduce as jax_momentum_reduce
from repro.kernels import agg_pairwise_dists as jax_pairwise_dists
from repro.kernels import agg_trimmed_reduce as jax_trimmed_reduce
from repro.kernels import fedavg_reduce as jax_fedavg_reduce
from repro.kernels import fedavg_reduce_tree as jax_fedavg_reduce_tree
from repro.utils import pytree as jax_pytree
from repro_torch.configs import AggConfig
from repro_torch.core import params_from_numpy
from repro_torch.core.aggregation import make_aggregator
from repro_torch.core.fedavg import (
    broadcast_to_clients,
    fedavg_flat,
    fedavg_stacked,
    normalize_weights,
)
from repro_torch.kernels import (
    agg_momentum_reduce,
    agg_pairwise_dists,
    agg_trimmed_reduce,
    fedavg_reduce,
    fedavg_reduce_tree,
)
from repro_torch.kernels.ref import (
    ref_fedavg_flat,
    ref_momentum_reduce_flat,
    ref_pairwise_sq_dists,
    ref_trimmed_flat,
)
from repro_torch.utils.pytree import (
    tree_count_params,
    tree_index,
    tree_leaves,
    tree_ravel_clients,
    tree_sq_norm,
    tree_sub,
    tree_unflatten_from_vector,
)

ar = importlib.import_module("repro_torch.kernels.agg_reduce")

TOL = dict(rtol=1e-6, atol=1e-6)
SMALL = dict(d_embed=16, d_model=32, num_layers=2, num_heads=2, d_ff=64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _clients(c: int, seed: int = 0):
    """c different GPO param trees, stacked on a leading client axis, as
    the JAX tree and the port's."""
    jcfg = JaxGPOConfig(**SMALL)
    trees = [jax_gpo.init_gpo_params(jcfg, jax.random.PRNGKey(seed + i))
             for i in range(c)]
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstack),
                             "cpu")
    return jstack, port


def _weights(c: int, seed: int = 1) -> np.ndarray:
    sizes = np.random.default_rng(seed).integers(8, 120, c)
    return (sizes / sizes.sum()).astype(np.float32)


@pytest.mark.parametrize("c", [1, 3, 10])
@pytest.mark.parametrize("p", [7, 2049, 5000])
def test_fedavg_reduce_flat_matches_jax(c, p):
    """P not a multiple of the TPU kernel's 2048 block, nor of 4."""
    rng = np.random.default_rng(c * 10000 + p)
    x = rng.standard_normal((c, p)).astype(np.float32)
    w = _weights(c, seed=p)
    want = np.asarray(jax_fedavg_reduce(jnp.asarray(x), jnp.asarray(w)))
    before = ar.fedavg_reduce_flat.launches
    got = ar.fedavg_reduce_flat(_t(x), _t(w))
    assert got.shape == (p,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, ref_fedavg_flat(_t(x), _t(w)))
    assert torch.equal(fedavg_reduce(_t(x), _t(w)), got)
    assert ar.fedavg_reduce_flat.launches == before  # CPU: no launch


@pytest.mark.parametrize("c", [1, 3, 10])
def test_fedavg_reduce_tree_matches_jax(c):
    jstack, port = _clients(c)
    w = _weights(c)
    want = jax_fedavg_reduce_tree(jstack, jnp.asarray(w))
    got = fedavg_reduce_tree(port, _t(w))
    for g, wt in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == wt.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), **TOL)


def test_ravel_clients_uses_the_reference_leaf_order():
    jstack, port = _clients(3)
    want = np.asarray(jax_pytree.tree_ravel_clients(jstack))
    got = tree_ravel_clients(port)
    np.testing.assert_array_equal(got.numpy(), want)
    like = tree_index(port, 0)
    assert tree_count_params(like) == got.shape[1] == \
        jax_pytree.tree_count_params(jax_pytree.tree_index(jstack, 0))
    back = tree_unflatten_from_vector(got[1], like)
    for a, b in zip(tree_leaves(back), tree_leaves(tree_index(port, 1))):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="parameters"):
        tree_unflatten_from_vector(got[1, :-1], like)
    np.testing.assert_allclose(
        tree_sq_norm(tree_sub(tree_index(port, 0), tree_index(port, 1))),
        float(jax_pytree.tree_sq_norm(jax_pytree.tree_sub(
            jax_pytree.tree_index(jstack, 0),
            jax_pytree.tree_index(jstack, 1)))), rtol=1e-6)


@pytest.mark.parametrize("sizes", [[12, 40, 7], [0, 0, 0], [5]])
def test_normalize_weights_matches_jax(sizes):
    want = np.asarray(jax_fedavg.normalize_weights(jnp.asarray(sizes)))
    got = normalize_weights(torch.tensor(sizes))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fedavg_stacked_flat_and_broadcast_match_jax():
    jstack, port = _clients(4)
    w = _weights(4)
    for port_fn, jax_fn in ((fedavg_stacked, jax_fedavg.fedavg_stacked),
                            (fedavg_flat, jax_fedavg.fedavg_flat)):
        got = port_fn(port, _t(w))
        want = jax_fn(jstack, jnp.asarray(w))
        for g, wt in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(wt), **TOL)
    one = tree_index(port, 2)
    spread = broadcast_to_clients(one, 5)
    for a, b in zip(tree_leaves(spread), tree_leaves(one)):
        assert a.shape == (5,) + b.shape and torch.equal(a[4], b)
    a0 = tree_leaves(spread)[0]
    a0[0].add_(1.0)  # each client owns its copy
    assert not torch.equal(a0[0], a0[1])


@pytest.mark.parametrize("kernel", [False, True], ids=["leafwise", "kernel"])
def test_fedavg_aggregator_step_matches_jax(kernel):
    """weigh -> reduce -> apply of the fedavg strategy on client deltas,
    with the server learning rate off its default."""
    jstack, port = _clients(3)
    jglob = jax.tree_util.tree_map(lambda x: x[0] * 0.5, jstack)
    glob = params_from_numpy(jax.tree_util.tree_map(np.asarray, jglob),
                             "cpu")
    w = _weights(3)
    jagg = jax_aggregation.make_aggregator(
        JaxAggConfig(server_lr=0.7), num_clients=3, use_pallas=kernel)
    agg = make_aggregator(AggConfig(server_lr=0.7), num_clients=3,
                          use_pallas=kernel)
    jnew, jstate = jagg.step(jagg.init(jglob), jglob, jstack,
                             jnp.asarray(w))
    new, state = agg.step(agg.init(glob), glob, port, _t(w))
    assert int(state.step) == int(jstate.step) == 1
    for g, wt in zip(tree_leaves(new), jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), **TOL)
    vecs = tree_ravel_clients(port)
    np.testing.assert_allclose(
        agg.reduce_flat(vecs, _t(w)).numpy(),
        np.asarray(jagg.reduce_flat(jnp.asarray(vecs.numpy()),
                                    jnp.asarray(w))), **TOL)


def test_fedavg_reduce_shape_and_contract_errors():
    x = torch.zeros((3, 10))
    with pytest.raises(ValueError, match="shapes"):
        ar.fedavg_reduce_flat(x, torch.ones(4))
    with pytest.raises(ValueError, match="shapes"):
        ar.fedavg_reduce_flat(x[0], torch.ones(3))
    with pytest.raises(ValueError, match="contiguous"):
        ar.fedavg_reduce_flat(torch.zeros((10, 3)).T, torch.ones(3))
    with pytest.raises(ValueError, match="expected torch.float32"):
        ar.fedavg_reduce_flat(x.double(), torch.ones(3))


# P not a multiple of 4 (the kernels' float4 path) nor of the TPU
# kernels' 2048 block
RAGGED_P = [7, 5001]


def _deltas(c: int, p: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((c, p)).astype(
        np.float32)


@pytest.mark.parametrize("c", [3, 10])
@pytest.mark.parametrize("p", RAGGED_P)
@pytest.mark.parametrize("beta", [0.0, 0.9])
def test_momentum_reduce_flat_matches_jax(c, p, beta):
    x = _deltas(c, p, seed=c * 100 + p)
    m = _deltas(1, p, seed=p + 1)[0]
    w = _weights(c, seed=p)
    jd, jnm = jax_momentum_reduce(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(m), beta=beta)
    before = ar.momentum_reduce_flat.launches
    d, nm = ar.momentum_reduce_flat(_t(x), _t(w), _t(m), beta=beta)
    assert d.shape == nm.shape == (p,) and nm.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(nm.numpy(), np.asarray(jnp.asarray(jnm)),
                               **TOL)
    pd, pnm = ref_momentum_reduce_flat(_t(x), _t(w), _t(m), beta=beta)
    assert torch.equal(d, pd) and torch.equal(nm, pnm)
    od, onm = agg_momentum_reduce(_t(x), _t(w), _t(m), beta=beta)
    assert torch.equal(od, d) and torch.equal(onm, nm)
    # the delta output is Eq. 3's reduce
    np.testing.assert_allclose(d.numpy(), fedavg_reduce(_t(x), _t(w)).numpy(),
                               **TOL)
    assert ar.momentum_reduce_flat.launches == before  # CPU: no launch


@pytest.mark.parametrize("c,trim", [(3, 1), (10, 1), (10, 4)])
@pytest.mark.parametrize("p", RAGGED_P)
def test_trimmed_reduce_flat_matches_jax(c, trim, p):
    """trim = (C−1)//2 (3, 1 and 10, 4) is the coordinate-wise median."""
    x = _deltas(c, p, seed=c * 100 + p + trim)
    w = _weights(c, seed=p + trim)
    want = np.asarray(jax_trimmed_reduce(jnp.asarray(x), jnp.asarray(w),
                                         trim=trim))
    before = ar.trimmed_reduce_flat.launches
    got = ar.trimmed_reduce_flat(_t(x), _t(w), trim=trim)
    assert got.shape == (p,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, ref_trimmed_flat(_t(x), _t(w), trim=trim))
    assert torch.equal(agg_trimmed_reduce(_t(x), _t(w), trim=trim), got)
    assert ar.trimmed_reduce_flat.launches == before


def test_trimmed_reduce_ties_match_jax():
    """Duplicate values across clients: ranks break ties by client index
    (a stable sort), in the port's plain version as in the TPU kernel."""
    x = np.array([[1.0, 2.0], [1.0, 2.0], [0.0, 3.0], [1.0, 2.0]],
                 np.float32)
    w = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    want = np.asarray(jax_trimmed_reduce(jnp.asarray(x), jnp.asarray(w),
                                         trim=1))
    got = ar.trimmed_reduce_flat(_t(x), _t(w), trim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # survivors: clients 0 and 1 in column 0 (values 1, 1), clients 1
    # and 3 in column 1 (values 2, 2): both weighted means are exact
    np.testing.assert_array_equal(got.numpy(), [1.0, 2.0])


@pytest.mark.parametrize("c", [1, 3, 10])
@pytest.mark.parametrize("p", RAGGED_P)
def test_pairwise_dists_flat_matches_jax(c, p):
    x = _deltas(c, p, seed=c * 100 + p + 7)
    want = np.asarray(jax_pairwise_dists(jnp.asarray(x)))
    before = ar.pairwise_dists_flat.launches
    got = ar.pairwise_dists_flat(_t(x))
    assert got.shape == (c, c) and got.dtype == torch.float32
    atol = 1e-5 * float((x.astype(np.float64) ** 2).sum(axis=1).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    assert torch.equal(got, ref_pairwise_sq_dists(_t(x)))
    assert torch.equal(agg_pairwise_dists(_t(x)), got)
    assert (got >= 0).all() and torch.equal(got, got.T)
    assert (torch.diagonal(got) == 0).all()
    assert ar.pairwise_dists_flat.launches == before


def test_new_kernel_wrappers_shape_trim_and_contract_errors():
    x = torch.zeros((4, 10))
    with pytest.raises(ValueError, match="trim=2 must satisfy"):
        ar.trimmed_reduce_flat(x, torch.ones(4), trim=2)
    with pytest.raises(ValueError, match="trim=-1 must satisfy"):
        ar.trimmed_reduce_flat(x, torch.ones(4), trim=-1)
    with pytest.raises(ValueError, match="shapes"):
        ar.trimmed_reduce_flat(x, torch.ones(3), trim=1)
    with pytest.raises(ValueError, match="shapes"):
        ar.momentum_reduce_flat(x, torch.ones(4), torch.zeros(9), beta=0.9)
    with pytest.raises(ValueError, match="shapes"):
        ar.momentum_reduce_flat(x[0], torch.ones(4), torch.zeros(10),
                                beta=0.9)
    with pytest.raises(ValueError, match="shapes"):
        ar.pairwise_dists_flat(x[0])
    # the kernels' cap on C, held on the CPU too
    big = torch.zeros((ar.MAX_CLIENTS + 1, 10))
    with pytest.raises(ValueError, match="holds 1 to 32"):
        ar.trimmed_reduce_flat(big, torch.ones(ar.MAX_CLIENTS + 1), trim=1)
    with pytest.raises(ValueError, match="holds 1 to 32"):
        ar.pairwise_dists_flat(big)
    with pytest.raises(ValueError, match="holds 1 to 32"):
        ar.pairwise_dists_flat(torch.zeros((0, 10)))
    with pytest.raises(ValueError, match="contiguous"):
        ar.momentum_reduce_flat(torch.zeros((10, 4)).T, torch.ones(4),
                                torch.zeros(10), beta=0.9)
    with pytest.raises(ValueError, match="contiguous"):
        ar.pairwise_dists_flat(torch.zeros((10, 4)).T)
    with pytest.raises(ValueError, match="expected torch.float32"):
        ar.trimmed_reduce_flat(x.double(), torch.ones(4), trim=1)
    with pytest.raises(ValueError, match="expected torch.float32"):
        ar.momentum_reduce_flat(x, torch.ones(4), torch.zeros(10).double(),
                                beta=0.9)
