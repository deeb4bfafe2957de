"""The sharded round as a whole against the JAX package's: the
reference's ``make_sharded_round`` on a one-device mesh (built as
``tests/test_aggregation.py::test_sharded_round_matches_stacked`` builds
it, in this process) against the port's round on four gloo processes
(``ShardedGPO`` on ``make_host_mesh``, through the kernel wrappers'
plain versions), from the reference's params (the ``.npz`` bridge's
numpy tree) and its batches (rebuilt from its per-client keys: each key
split into one a local epoch, as its ``_make_local_train`` does), for
FedAvg and the median, one round each: the global params within 1e-4,
and the four processes' equal to the bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import AggConfig as JaxAggConfig
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import GPOConfig as JaxGPOConfig
from repro.core.aggregation import make_aggregator as jax_make_aggregator
from repro.core.fedavg import broadcast_to_clients as jax_broadcast
from repro.core.fedavg import normalize_weights as jax_normalize_weights
from repro.core.federated import make_sharded_round as jax_sharded_round
from repro.core.gpo import init_gpo_params as jax_init_gpo_params
from repro.data import SurveyConfig as JaxSurveyConfig
from repro.data import make_survey_data as jax_make_survey_data
from repro.data import sample_icl_batch as jax_sample_icl_batch
from repro.optim import adam as jax_adam
from repro_torch.launch.mesh import spawn
from test_torch_sharded import _replay_rank
from test_torch_train import _np_tree, _stack

C, EPOCHS = 8, 2
WIDTHS = dict(d_embed=16, d_model=32, num_layers=1, num_heads=1, d_ff=64)
FED = dict(num_clients=C, local_epochs=EPOCHS, lr=1e-3, num_context=4,
           num_target=4)
AGGS = ("fedavg", "median")


def _reference(name: str, data):
    """The reference's sharded round on one device: (its initial params
    as numpy, each local epoch's client-stacked batch, its initial and
    its new global params as numpy leaves)."""
    fcfg = JaxFedConfig(**FED, agg=JaxAggConfig(name=name))
    gcfg = JaxGPOConfig(**WIDTHS)
    opt = jax_adam(fcfg.lr)
    agg = jax_make_aggregator(fcfg.agg, num_clients=C)
    params = jax_init_gpo_params(gcfg, jax.random.PRNGKey(0))
    groups = jnp.arange(C, dtype=jnp.int32)
    weights = jax_normalize_weights(data.sizes[groups])
    keys = jax.random.split(jax.random.PRNGKey(1), C)
    client_params = jax_broadcast(params, C)
    mesh = jax.make_mesh((1,), ("data",))
    round_fn = jax_sharded_round(gcfg, fcfg, data, mesh, opt=opt, agg=agg)
    out = jax.jit(round_fn)(client_params, jax.vmap(opt.init)(client_params),
                            keys, groups, weights, agg.init(params))
    ekeys = [jax.random.split(k, EPOCHS) for k in keys]
    batches = [_stack([jax_sample_icl_batch(ekeys[c][e], data, c, 4, 4)
                       for c in range(C)]) for e in range(EPOCHS)]
    init = _np_tree(params)
    layers = init["layers"]  # plain numpy for the port's processes
    init["layers"] = layers if isinstance(layers, dict) else dict(
        layers._asdict())
    return (init, batches,
            [np.asarray(x) for x in jax.tree_util.tree_leaves(params)],
            [np.asarray(x)[0] for x in jax.tree_util.tree_leaves(out[0])])


@pytest.fixture(scope="module")
def rounds():
    data = jax_make_survey_data(JaxSurveyConfig(num_groups=C + 2,
                                                num_questions=30,
                                                d_embed=16))
    ref = {name: _reference(name, data) for name in AGGS}
    arrays = tuple(np.array(a) for a in data)
    ranks = spawn(4, _replay_rank, arrays, WIDTHS, FED,
                  {n: (init, b) for n, (init, b, _, _) in ref.items()},
                  backend="gloo", device="cpu", timeout=60, deadline=240)
    return ref, ranks


@pytest.mark.parametrize("name", AGGS)
def test_four_process_round_matches_the_reference(rounds, name):
    ref, ranks = rounds
    init, want = ref[name][2:]
    got = ranks[0][name]
    for other in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(got, other[name]))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    # the round moved the params: the comparison is not of the init
    assert max(float(np.abs(a - i).max()) for a, i in zip(got, init)) > 1e-4
