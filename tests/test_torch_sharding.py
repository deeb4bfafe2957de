"""The sharding rules, port against reference, spec for spec.

The reference's functions read only a mesh's ``shape`` and
``axis_names``, so they run here on ``jax.sharding.AbstractMesh`` (no
devices; Auto axes) of the production shapes, (16, 16) and (2, 16, 16),
and on (3, 5), whose axes divide none of the archs' dims; the port's on
``MeshShape`` of the same shapes. Every arch's params (``fsdp`` on and
off), Adam and Adafactor states, train and prefill batches, and decode
caches (decode_32k, and long_500k's batch of one) are compared leaf for
leaf by their ``keystr`` path. The activation rules (``default_rules``,
``logical_axis_size``, the ``prefers_*`` pair) and ``shard_batch`` are
held to the reference's too. The reference's trees are shapes
(``jax.eval_shape``), made once per arch.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

import repro.configs as jc
from repro.data.lm_data import shard_batch as jax_shard_batch
from repro.launch import mesh as jax_mesh
from repro.launch import sharding as js
from repro.launch import specs as jspecs
from repro.models import partitioning as jax_part
from repro.optim import adafactor as jax_adafactor
import repro_torch.configs as pc
from repro_torch.checkpoint.checkpoint import _leaves
from repro_torch.data.lm_data import shard_batch
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import sharding as ps
from repro_torch.launch import specs as pspecs
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import partitioning as part
from repro_torch.optim import adafactor

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "3x5": ((3, 5), ("data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), MeshShape(sizes, axes)


def _ref_specs(tree) -> dict:
    """keystr -> spec tuple of a tree of the reference's NamedShardings."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in leaves}


def _port_specs(tree) -> dict:
    return {path: tuple(s.spec) for path, s in _leaves(tree)}


_TREES = {}


def _trees(arch):
    """(reference cfg, reference param shapes, port cfg, port meta
    params), made once per arch."""
    if arch not in _TREES:
        jcfg, cfg = jc.get_arch(arch), pc.get_arch(arch)
        _TREES[arch] = (jcfg, jspecs.params_specs(jcfg), cfg,
                        pspecs.params_specs(cfg))
    return _TREES[arch]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(pc.ALL_ARCHS))
def test_params_and_optimizer_states_match(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, jp, cfg, p = _trees(arch)
    for fsdp in (True, False):
        jshard = js.params_shardings(jp, jcfg, jmesh, fsdp=fsdp)
        shard = ps.params_shardings(p, cfg, mesh, fsdp=fsdp)
        want, got = _ref_specs(jshard), _port_specs(shard)
        assert got == want, fsdp
        assert all(isinstance(s, ps.NamedSharding) and s.mesh is mesh
                   for _, s in _leaves(shard))
        # Adam: step replicated, the moments mirror the params
        assert _port_specs(ps.adam_state_shardings(shard, mesh)) == \
            _ref_specs(js.adam_state_shardings(jshard, jmesh))
        # Adafactor's factored moments, over the state's own shapes
        jstate = jax.eval_shape(jax_adafactor(1e-3).init, jp)
        state = adafactor(1e-3).init(p)
        jaf = js.adafactor_state_shardings(jshard, jp, jmesh)
        af = ps.adafactor_state_shardings(shard, p, mesh)
        assert _port_specs(af) == _ref_specs(jaf)
        # every spec fits its leaf: the per-device shard divides evenly
        spec_of = _port_specs(af)
        for path, leaf in _leaves(state):
            ps.per_device_shape(tuple(leaf.shape), spec_of[path], mesh)
        assert [path for path, _ in _leaves(state)] == [
            jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(jstate)[0]]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(pc.ALL_ARCHS))
def test_batches_and_caches_match(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, _, cfg, _ = _trees(arch)
    jaxes, axes = jax_mesh.data_axes(jmesh), port_mesh.data_axes(mesh)
    assert jaxes == axes
    for shape_name in ("train_4k", "prefill_32k"):
        jshape, shape = jc.INPUT_SHAPES[shape_name], pc.INPUT_SHAPES[shape_name]
        jb = jspecs.input_specs(jcfg, jshape)["batch"]
        b = pspecs.input_specs(cfg, shape)["batch"]
        assert {k: tuple(v.spec) for k, v in ps.batch_shardings(
            b, mesh, axes).items()} == {k: tuple(v.spec) for k, v in
                                        js.batch_shardings(jb, jmesh,
                                                           jaxes).items()}
    for shape_name in ("decode_32k", "long_500k"):
        jshape, shape = jc.INPUT_SHAPES[shape_name], pc.INPUT_SHAPES[shape_name]
        jcache = jspecs.cache_specs(jspecs.serving_config(jcfg, jshape),
                                    jshape)
        cache = pspecs.cache_specs(pspecs.serving_config(cfg, shape), shape)
        got = ps.cache_shardings(cache, cfg, mesh, axes)
        want = js.cache_shardings(jcache, jcfg, jmesh, jaxes)
        assert {k: tuple(v.spec) for k, v in got.items()} == \
            {k: tuple(v.spec) for k, v in want.items()}, shape_name


@pytest.mark.parametrize("mesh_name", list(MESHES) + ["edge"])
def test_round_state_shardings_match(mesh_name):
    """The federated round's replicated server state, client-stacked
    deltas, fault state and Byzantine key."""
    if mesh_name == "edge":
        sizes, axes = (2, 4), ("edge", "data")
        jmesh, mesh = AbstractMesh(sizes, axes), MeshShape(sizes, axes)
    else:
        jmesh, mesh = _meshes(mesh_name)
    server = {"m": {"w": np.zeros((3, 4)), "b": np.zeros(3)},
              "step": np.zeros(())}
    tserver = {"m": {"w": torch.zeros(3, 4), "b": torch.zeros(3)},
               "step": torch.zeros(())}
    assert _port_specs(ps.server_state_shardings(tserver, mesh)) == \
        _ref_specs(js.server_state_shardings(server, jmesh))
    assert tuple(ps.client_delta_sharding(mesh).spec) == \
        tuple(js.client_delta_sharding(jmesh).spec)
    caxes = port_mesh.client_axes(mesh)
    assert caxes == jax_mesh.client_axes(jmesh)
    assert _port_specs(ps.fault_state_shardings(mesh, caxes)) == \
        _ref_specs(js.fault_state_shardings(jmesh, caxes))
    assert tuple(ps.byz_key_sharding(mesh).spec) == \
        tuple(js.byz_key_sharding(jmesh).spec)


@pytest.mark.parametrize("mesh_name", list(MESHES) + ["1x1", "2x4", "1x3"])
def test_activation_rules_match(mesh_name):
    if mesh_name in MESHES:
        jmesh, mesh = _meshes(mesh_name)
    else:
        sizes = tuple(int(n) for n in mesh_name.split("x"))
        jmesh = AbstractMesh(sizes, ("data", "model"))
        mesh = MeshShape(sizes, ("data", "model"))
    assert part.default_rules(mesh) == jax_part.default_rules(jmesh)
    assert port_mesh.model_axis_size(mesh) == jax_mesh.model_axis_size(jmesh)
    names = sorted(part.default_rules(mesh)) + ["unknown"]
    heads = [(h, kv) for h in (1, 4, 14, 16, 32, 56, 64)
             for kv in (1, 2, 4, 8, 16) if kv <= h and h % kv == 0]
    with part.activation_sharding(mesh), \
            jax_part.activation_sharding(jmesh):
        for name in names:
            assert part.logical_axis_size(name) == \
                jax_part.logical_axis_size(name), name
        for h, kv in heads:
            assert part.prefers_repeat_kv(h, kv) == \
                jax_part.prefers_repeat_kv(h, kv), (h, kv)
            assert part.prefers_q_sharding(h, kv) == \
                jax_part.prefers_q_sharding(h, kv), (h, kv)
    # outside the context: sizes 1, no layout branch
    assert part.logical_axis_size("capacity") == 1
    assert not part.prefers_repeat_kv(64, 8)


def test_production_mesh_is_the_references_layout():
    for multi_pod in (False, True):
        mesh = port_mesh.make_production_mesh(multi_pod=multi_pod)
        want = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
            ((16, 16), ("data", "model"))
        assert (tuple(mesh.shape.values()), mesh.axis_names) == want
        assert list(mesh.shape) == list(mesh.axis_names)
        assert port_mesh.model_axis_size(mesh) == 16


def test_shard_batch_splits_as_the_reference():
    """On one device the reference's placement holds the whole batch
    under P('data'); on a (4, 2) mesh each data coordinate's block has
    the reference's shard shape, and the blocks in order are the
    batch."""
    batch = {"tokens": torch.arange(8 * 6, dtype=torch.int32).reshape(8, 6),
             "labels": torch.arange(8 * 6, dtype=torch.int32).reshape(8, 6)}
    jout = jax_shard_batch({k: v.numpy() for k, v in batch.items()},
                           jax.make_mesh((1, 1), ("data", "model")))
    one = shard_batch(batch, MeshShape((1, 1), ("data", "model")), index=0)
    for k in batch:
        assert tuple(jout[k].sharding.spec) == ("data",)
        np.testing.assert_array_equal(
            np.asarray(jout[k].addressable_shards[0].data), one[k].numpy())
    jmesh, mesh = AbstractMesh((4, 2), ("data", "model")), \
        MeshShape((4, 2), ("data", "model"))
    parts = [shard_batch(batch, mesh, index=i) for i in range(4)]
    for k, v in batch.items():
        want = JaxNamedSharding(jmesh, JaxP("data")).shard_shape(
            tuple(v.shape))
        assert all(tuple(p[k].shape) == want for p in parts)
        assert torch.equal(torch.cat([p[k] for p in parts]), v)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"tokens": torch.zeros(6, 2)}, mesh, index=0)


def test_specs_print_and_compare_as_tuples():
    assert ps.P("data", None) == ("data", None)
    assert repr(ps.P(("pod", "data"), None)) == "P(('pod', 'data'), None)"
    assert ps.per_device_shape((32, 12), ps.P(("pod", "data")),
                               MeshShape((2, 16), ("pod", "data"))) == (1, 12)
    with pytest.raises(ValueError, match="does not divide"):
        ps.per_device_shape((6,), ps.P("model"), MeshShape((4,), ("model",)))
