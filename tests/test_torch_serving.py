"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve one request trace over the same weights (carried
with ``params_from_numpy``) and the same survey arrays: rows agree
within atol 1e-5 (float32, another summation order), and the batch log
and the counters are identical, because scheduling depends only on
queue order. Within the port a cache hit is bit-equal to a miss.
"""
from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from repro.configs import GPOConfig as JaxGPOConfig
from repro.configs import ServeConfig as JaxServeConfig
from repro.core import PreferenceServer as JaxServer
from repro.core import init_gpo_params as jax_init
from repro.core import make_request_trace as jax_trace
from repro.core import quantize_gpo_params as jax_quantize
from repro.data import SurveyConfig, make_survey_data
from repro_torch.configs import GPOConfig, ServeConfig
from repro_torch.core import (
    PreferenceServer,
    Request,
    latency_summary,
    make_request_trace,
    params_from_numpy,
    quantize_gpo_params,
)
from repro_torch.kernels import QuantizedLinear

GKW = dict(d_embed=16, d_model=32, num_layers=2, num_heads=4, d_ff=64)
SKW = dict(max_batch=4, batch_buckets=(1, 2, 4), ctx_buckets=(20, 40),
           tgt_buckets=(10, 20), cache_entries=16)
TRACE = dict(num_requests=11, hit_ratio=0.5, num_context=(2, 6),
             num_target=(1, 3), seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    data = make_survey_data(SurveyConfig(num_groups=6, num_questions=40,
                                         d_embed=16))
    jp = jax_init(JaxGPOConfig(**GKW), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return data, jp, tp


def _server(tp, int8=False, **kw):
    return PreferenceServer(tp, GPOConfig(**GKW),
                            ServeConfig(int8_weights=int8, **{**SKW, **kw}),
                            num_options=5, device="cpu")


def test_request_trace_equals_reference(world):
    data = world[0]
    for kw in (TRACE, dict(num_requests=20, hit_ratio=0.75, rate=100.0,
                           seed=1)):
        ref = jax_trace(data, [0, 2, 4], **kw)
        port = make_request_trace(data, [0, 2, 4], **kw)
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            assert (a.rid, a.prefix_key, a.arrival, a.deadline) == \
                (b.rid, b.prefix_key, b.arrival, b.deadline)
            for f in ("ctx_x", "ctx_y", "tgt_x"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.meta["group"] == b.meta["group"]
            np.testing.assert_array_equal(a.meta["tgt_q"], b.meta["tgt_q"])


def test_quantize_gpo_params_bit_equal(world):
    _, jp, tp = world
    ref = jax_quantize(jp)
    port = quantize_gpo_params(tp)
    assert isinstance(port["head"], QuantizedLinear)
    assert not isinstance(port["layers"].ln2, QuantizedLinear)
    for name in ("in_proj", "head"):
        np.testing.assert_array_equal(port[name].q.numpy(),
                                      np.asarray(ref[name].q))
        np.testing.assert_array_equal(port[name].scale.numpy(),
                                      np.asarray(ref[name].scale))
    for f in ("wq", "wk", "wv", "wo", "w1", "w2"):
        pq, rq = getattr(port["layers"], f), getattr(ref["layers"], f)
        assert pq.q.shape == (2,) + rq.q.shape[1:]
        np.testing.assert_array_equal(pq.q.numpy(), np.asarray(rq.q))
        np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(rq.scale))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_engine_matches_reference_engine(world, int8):
    data, jp, tp = world
    trace = make_request_trace(data, [0, 1, 3, 5], **TRACE)
    ref_srv = JaxServer(jp, JaxGPOConfig(**GKW),
                        JaxServeConfig(int8_weights=int8, **SKW),
                        num_options=5)
    ref = {c.rid: c for c in ref_srv.run_trace(trace)}
    srv = _server(tp, int8)
    port = {c.rid: c for c in srv.run_trace(trace)}
    # the batch log, field for field
    assert [asdict(b) for b in srv.batches] == \
        [asdict(b) for b in ref_srv.batches]
    assert asdict(srv.stats) == asdict(ref_srv.stats)
    assert port.keys() == ref.keys() and len(port) == 11
    for rid, c in port.items():
        assert c.cache_hit == ref[rid].cache_hit
        assert c.batch_index == ref[rid].batch_index
        assert c.pred.shape == ref[rid].pred.shape
        np.testing.assert_allclose(c.pred, ref[rid].pred, rtol=0, atol=1e-5)
        np.testing.assert_allclose(c.pred.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_prefix_cache_hit_bit_equal_to_miss(world, int8):
    data, _, tp = world
    trace = make_request_trace(data, [0, 1, 3, 5], **TRACE)
    srv = _server(tp, int8)
    cold = {c.rid: c for c in srv.run_trace(trace, clear_cache=True)}
    warm = srv.run_trace(trace, clear_cache=False)
    assert all(c.cache_hit for c in warm)
    assert srv.stats.prefills == 0
    for c in warm:
        assert np.array_equal(c.pred, cold[c.rid].pred)
    summary = latency_summary(warm, 1.0)
    assert summary["completed"] == 11 and summary["hit_rate"] == 1.0


def _request(rid, seed, prefix_key=None):
    rng = np.random.default_rng(seed)
    return Request(rid=rid,
                   ctx_x=rng.standard_normal((10, 16)).astype(np.float32),
                   ctx_y=rng.uniform(size=10).astype(np.float32),
                   tgt_x=rng.standard_normal((5, 16)).astype(np.float32),
                   prefix_key=prefix_key)


def test_admission_eviction_and_deadlines(world):
    tp = world[2]
    srv = _server(tp, max_queue=2)
    assert [srv.submit(_request(i, i)) for i in range(4)] == \
        [True, True, False, False]
    assert srv.stats.rejected == 2 and srv.queue_depth == 2
    assert sorted(c.rid for c in srv.step()) == [0, 1]

    srv = _server(tp, max_batch=1, batch_buckets=(1,), cache_entries=2)
    for i, key in enumerate(["a", "b", "c", "a"]):
        srv.submit(_request(i, 50 + i, prefix_key=key))
        srv.step()
    assert srv.stats.evictions == 2
    assert srv.stats.cache_hits == 0 and srv.stats.cache_misses == 4

    srv = _server(tp)
    head, stale, live = _request(0, 70), _request(1, 71), _request(2, 72)
    head.deadline, stale.deadline = srv.now() + 60.0, -1.0
    for r in (head, stale, live):
        srv.submit(r)
    assert [c.rid for c in srv.step()] == [0, 2]
    assert srv.stats.expired == 1


def test_engine_keeps_cache_entries_on_its_device(world):
    data, _, tp = world
    srv = _server(tp)
    srv.run_trace(make_request_trace(data, [0, 1], **TRACE))
    k, v, n = next(iter(srv._cache.values()))
    assert isinstance(k, torch.Tensor) and k.device == srv.device
    assert k.shape[0] == 2 and isinstance(n, int)


def test_tgt_bucket_must_hold_whole_questions(world):
    with pytest.raises(ValueError):
        PreferenceServer(world[2], GPOConfig(**GKW),
                         ServeConfig(tgt_buckets=(7,)), num_options=5,
                         device="cpu")
