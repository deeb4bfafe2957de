"""The models' layout branches under an ``activation_sharding`` context,
port against reference on the CPU.

A context changes what the models compute in two places, and the
reference picks each from the mesh's shape alone: the MoE dispatch runs
``nb = logical_axis_size("capacity")`` token blocks, each with its own
capacity (``models/moe.py``); the plain attention repeats K and V to the
full head count where ``prefers_repeat_kv`` (``models/attention.py``).
The reference's query-sharded branch, where ``prefers_q_sharding``,
only places ``shard_act`` constraints; the port, whose ``shard_act`` is
the identity, must compute the same values there. The reference runs jitted under its own
``activation_sharding`` of a ``jax.sharding.AbstractMesh`` of the same
shape (Auto axes, no devices: its ``shard_act`` constraints lower on the
one CPU device), the port under ``MeshShape``. The smoke weights and
tokens are ``test_torch_zoo_dense.py``'s; the tolerance is its 1e-4 of
the largest |logit|. The port's attention takes its plain branch
(``use_kernels=False``): the flash kernel handles GQA itself and takes
no layout from the context.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.models import forward as jax_forward
from repro.models import partitioning as jax_part
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import forward
from repro_torch.models import partitioning as part
from test_torch_backbone import _rel
from test_torch_zoo_dense import TOL, _model

AXES = ("data", "model")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference(arch, sizes, decode_at=None, **changes):
    """The reference's jitted forward under its context (traced inside
    it): the full logits, and where ``decode_at`` is given a prefill of
    that many tokens and one decode step's logits."""
    jcfg, jparams, _, _, tokens = _model(arch, **changes)
    with jax_part.activation_sharding(AbstractMesh(sizes, AXES)):
        out = {"full": np.asarray(jax.jit(lambda p, t: jax_forward(
            p, jcfg, tokens=t))(jparams, jnp.asarray(tokens))[0])}
        if decode_at is not None:
            n = tokens.shape[1]
            _, cache, _ = jax.jit(lambda p, t: jax_forward(
                p, jcfg, tokens=t, prefill_len=n))(
                jparams, jnp.asarray(tokens[:, :decode_at]))
            lg, _, _ = jax.jit(lambda p, t, c: jax_forward(
                p, jcfg, tokens=t, cache=c, cache_pos=decode_at))(
                jparams, jnp.asarray(tokens[:, decode_at:decode_at + 1]),
                cache)
            out["decode"] = np.asarray(lg)
    return out


def _port(arch, sizes, decode_at=None, **changes):
    _, _, cfg, params, tokens = _model(arch, **changes)
    t = torch.from_numpy(tokens)
    with part.activation_sharding(MeshShape(sizes, AXES)):
        out = {"full": forward(params, cfg, tokens=t,
                               use_kernels=False)[0].numpy()}
        if decode_at is not None:
            _, cache, _ = forward(params, cfg, tokens=t[:, :decode_at],
                                  prefill_len=t.shape[1], use_kernels=False)
            lg, _, _ = forward(params, cfg,
                               tokens=t[:, decode_at:decode_at + 1],
                               cache=cache, cache_pos=decode_at)
            out["decode"] = lg.numpy()
    return out


@pytest.mark.parametrize("sizes,nb,factor", [((2, 1), 2, 4.0),
                                             ((4, 2), 4, 4.0),
                                             ((4, 2), 4, 1.0)])
def test_moe_token_blocks_match_the_reference(sizes, nb, factor):
    """granite-moe's smoke variant with nb blocks: drop-free at its
    factor 4.0 (the blocks change the buffers, not the kept pairs), and
    at factor 1.0, where each block's own capacity drops other pairs
    than one block's would (the logits then differ from the one-block
    run's, and still match the reference's)."""
    arch, kw = "granite-moe-3b-a800m", {"moe_capacity_factor": factor}
    with part.activation_sharding(MeshShape(sizes, AXES)):
        assert part.logical_axis_size("capacity") == nb
    with jax_part.activation_sharding(AbstractMesh(sizes, AXES)):
        assert jax_part.logical_axis_size("capacity") == nb
    got = _port(arch, sizes, **kw)["full"]
    want = _reference(arch, sizes, **kw)["full"]
    assert _rel(got, want) < TOL
    if factor == 1.0:
        one_block = _port(arch, (1, 1), **kw)["full"]
        assert _rel(one_block, want) > 100 * TOL


@pytest.mark.parametrize("sizes,branch", [((2, 4), "repeat_kv"),
                                          ((1, 3), "q_sharded")])
def test_attention_layout_branches_match_the_reference(sizes, branch):
    """qwen2's smoke variant, 4 query heads over 2 KV heads: a model axis
    of 4 divides the query heads and not the KV heads (repeat-KV), one of
    3 divides neither (query-sharded); the full forward and a decode
    step against a prefilled cache."""
    _, _, cfg, _, _ = _model("qwen2-0.5b")
    h, kv = cfg.num_heads, cfg.num_kv_heads
    with part.activation_sharding(MeshShape(sizes, AXES)):
        flags = (part.prefers_repeat_kv(h, kv), part.prefers_q_sharding(h, kv))
    assert flags == {"repeat_kv": (True, False),
                     "q_sharded": (False, True)}[branch]
    got = _port("qwen2-0.5b", sizes, decode_at=16)
    want = _reference("qwen2-0.5b", sizes, decode_at=16)
    for mode in ("full", "decode"):
        assert _rel(got[mode], want[mode]) < TOL, mode


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-0.5b"])
def test_without_a_context_nothing_changes(arch):
    """Outside a context every size is 1 and no layout branch is taken;
    a (1, 1) mesh changes no value either, bit for bit."""
    assert part.logical_axis_size("capacity") == 1
    assert not part.prefers_repeat_kv(4, 2)
    assert not part.prefers_q_sharding(4, 2)
    _, _, cfg, params, tokens = _model(arch)
    t = torch.from_numpy(tokens)
    plain = forward(params, cfg, tokens=t, use_kernels=False)[0]
    with part.activation_sharding(MeshShape((1, 1), AXES)):
        inside = forward(params, cfg, tokens=t, use_kernels=False)[0]
    assert torch.equal(plain, inside)
    x = torch.randn(2, 3)
    assert part.shard_act(x, ("batch", "embed")) is x
