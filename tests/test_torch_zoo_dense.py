"""The backbones past qwen2 and mamba2, port against reference on the
CPU: each registered arch's config field for field, and qwen3-32b
(qk-norm, q_dim 8192 beside d_model 5120) through the forward, prefill
and decode, and greedy decoding. The gemmas' and the MoE archs' files
(``test_torch_zoo_gemma.py``, ``test_torch_zoo_ring.py``,
``test_torch_zoo_moe.py``) use this file's weights, reference calls and
checks.

The smoke variants (f32) run the same weights in both packages: numpy
draws each leaf of the reference's tree (its shapes from
``jax.eval_shape`` of the reference's ``init_params``; the norm scales
random too, so a scale applied in the wrong place shows), and the tree
goes to the port through ``params_from_reference``. Tokens come from
numpy. S is 24, past the smoke windows of 16, so the local layers'
windows bite. The reference runs jitted, one compile a configuration
and shape. Tolerances are on the max-abs difference relative to the
largest |logit|: 1e-4, as ``tests/test_torch_backbone.py`` and the
reference's ``tests/test_ring_cache.py`` hold them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import get_arch as jax_get_arch
from repro.configs import override as jax_override
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.trainer import greedy_decode as jax_greedy_decode
from repro.core.trainer import make_prefill_step as jax_make_prefill_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro_torch import configs as port_configs
from repro_torch.configs import get_arch, override, smoke_variant
from repro_torch.core import greedy_decode, make_prefill_step
from repro_torch.models import forward, params_from_reference
from test_torch_backbone import _numpy_tree, _rel

B, S, P = 2, 24, 12  # the reference's tests/test_ring_cache.py
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_params(jcfg, seed: int):
    """The reference's params tree for ``jcfg`` drawn with numpy: the
    embedding N(0, 0.02²), each matrix N(0, 1/fan_in) (fan_in its
    second-to-last axis), each vector (norm scales, biases) N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name == "['embed']":
            a = 0.02 * rng.standard_normal(leaf.shape)
        elif len(leaf.shape) >= 3 or name == "['lm_head']":
            a = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return jnp.asarray(a, leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def reference_fns(jcfg):
    """The reference's forward modes, jitted once for ``jcfg``."""
    return {
        "full": jax.jit(lambda p, t: jax_forward(p, jcfg, tokens=t)),
        "prefill": jax.jit(lambda p, t, n: jax_forward(
            p, jcfg, tokens=t, prefill_len=n), static_argnums=2),
        "decode": jax.jit(lambda p, t, c, pos: jax_forward(
            p, jcfg, tokens=t, cache=c, cache_pos=pos)),
    }


# XLA's CPU backend at optimisation level 0 compiles the reference in
# about half the time (the hybrid's prefill 6.1 -> 2.7 s on one core);
# its results hold to the port within the same 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def reference_run(model, first_inputs, rest_tokens, greedy: int) -> dict:
    """The reference's prefill of ``first_inputs`` (a dict of
    ``forward``'s keywords, numpy) into an S cache, then its decode of
    ``rest_tokens`` (B, n) teacher forced and, from the prefill again,
    of ``greedy`` greedy tokens: the prefill's logits and cache, the
    forced decode's logits and final cache, the greedy tokens (B, 1 +
    greedy). Prefill and decode compile once each (``FAST_COMPILE``)."""
    jcfg, jparams = model[:2]
    inputs = {k: jnp.asarray(v) for k, v in first_inputs.items()}
    prefill = jax.jit(lambda p, inp: jax_forward(
        p, jcfg, prefill_len=S, **inp)).lower(jparams, inputs).compile(
        FAST_COMPILE)
    logits, cache, _ = prefill(jparams, inputs)
    p = logits.shape[1]
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    step = jax.jit(lambda prm, t, c, pos: jax_forward(
        prm, jcfg, tokens=t, cache=c, cache_pos=pos)).lower(
        jparams, tok, cache, jnp.asarray(p, jnp.int32)).compile(
        FAST_COMPILE)

    def decode(t, c, pos):
        return step(jparams, t, c, jnp.asarray(pos, jnp.int32))

    forced, c = [], cache
    for i in range(rest_tokens.shape[1]):
        lg, c, _ = decode(jnp.asarray(rest_tokens[:, i:i + 1]), c, p + i)
        forced.append(np.asarray(lg[:, 0]))
    toks, g = [tok], cache
    for i in range(greedy):
        lg, g, _ = decode(tok, g, p + i)
        tok = jnp.argmax(lg[:, 0], axis=-1).astype(jnp.int32)[:, None]
        toks.append(tok)
    return {"logits": np.asarray(logits), "cache": cache,
            "forced": np.stack(forced, 1), "forced_cache": c,
            "greedy": np.concatenate([np.asarray(t) for t in toks], 1)}


_MODELS = {}


def _model(arch, ring=False, **changes):
    """(reference cfg, reference params, port cfg, port params, tokens)
    for the smoke variant of ``arch``; ``ring``: one local:global period
    and a tail layer, the ring cache on (the reference's ring test's
    configuration); ``changes``: config fields overridden in both."""
    key = (arch, ring, tuple(sorted(changes.items())))
    if key not in _MODELS:
        jcfg = jax_smoke_variant(jax_get_arch(arch))
        cfg = smoke_variant(get_arch(arch))
        if ring:
            n = len(cfg.window_pattern) + 1
            jcfg = jax_override(jcfg, ring_cache=True, num_layers=n)
            cfg = override(cfg, ring_cache=True, num_layers=n)
        if changes:
            jcfg = jax_override(jcfg, **changes)
            cfg = override(cfg, **changes)
        jparams = reference_params(jcfg, 2)
        params = params_from_reference(cfg, _numpy_tree(jparams),
                                       device="cpu")
        tokens = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, S), dtype=np.int32)
        _MODELS[key] = (jcfg, jparams, cfg, params, tokens)
    return _MODELS[key]


def decode_against_reference(jcfg, jparams, cfg, params, tokens, prefill,
                             cache_len, steps):
    """The port's and the reference's prefill of ``prefill`` tokens into
    a ``cache_len`` cache, then their decode of the next ``steps``
    tokens: (port logits, reference logits, port cache, reference
    cache), the logits (B, steps, V)."""
    fns = reference_fns(jcfg)
    t = torch.from_numpy(tokens)
    _, cache, _ = forward(params, cfg, tokens=t[:, :prefill],
                          prefill_len=cache_len)
    _, jcache, _ = fns["prefill"](jparams, jnp.asarray(tokens[:, :prefill]),
                                  cache_len)
    got, want = [], []
    for pos in range(prefill, prefill + steps):
        lg, cache, _ = forward(params, cfg, tokens=t[:, pos:pos + 1],
                               cache=cache, cache_pos=pos)
        jlg, jcache, _ = fns["decode"](
            jparams, jnp.asarray(tokens[:, pos:pos + 1]), jcache,
            jnp.asarray(pos, jnp.int32))
        got.append(lg[:, 0].numpy())
        want.append(np.asarray(jlg[:, 0]))
    return np.stack(got, 1), np.stack(want, 1), cache, jcache


def greedy_against_reference(jcfg, jparams, cfg, params, tokens, steps):
    """``make_prefill_step`` and ``greedy_decode`` in both packages:
    (port last logits, reference last logits, port tokens (B, 1 + steps),
    reference tokens)."""
    s = tokens.shape[1]
    jlast, jcache = jax.jit(jax_make_prefill_step(jcfg, s + steps))(
        jparams, {"tokens": jnp.asarray(tokens)})
    jfirst = jnp.argmax(jlast, axis=-1).astype(jnp.int32)[:, None]
    jtoks, _ = jax_greedy_decode(jcfg, jparams, jcache, jfirst, s, steps)
    last, cache = make_prefill_step(cfg, s + steps)(
        params, {"tokens": torch.from_numpy(tokens)})
    first = torch.argmax(last, dim=-1)[:, None]
    toks, _ = greedy_decode(cfg, params, cache, first, s, steps)
    return (last, jlast, torch.cat([first, toks], 1).numpy(),
            np.concatenate([np.asarray(jfirst), np.asarray(jtoks)], 1))


@pytest.mark.parametrize("arch", list(port_configs.ALL_ARCHS))
def test_arch_config_equals_the_reference_field_for_field(arch):
    port, ref = get_arch(arch), jax_get_arch(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.source == ref.source


def test_the_remaining_archs_stay_pending():
    """None is pending any more: the port registers exactly the
    reference's ten archs, in its order, and refuses none of them."""
    assert port_configs.ALL_ARCHS == jax_configs.ALL_ARCHS
    assert len(port_configs.ALL_ARCHS) == 10
    assert not hasattr(port_configs, "PENDING_ARCHS")
    for arch in port_configs.ALL_ARCHS:
        assert get_arch(arch).name == arch


def check_forward(arch, use_kernels, **changes):
    """The full forward's logits and aux loss against the reference's
    (and the SSM families' final states, which both return there)."""
    jcfg, jparams, cfg, params, tokens = _model(arch, **changes)
    want, jstates, jaux = reference_fns(jcfg)["full"](jparams,
                                                      jnp.asarray(tokens))
    got, cache, aux = forward(params, cfg, tokens=torch.from_numpy(tokens),
                              use_kernels=use_kernels)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    assert aux.shape == () and aux.dtype == torch.float32
    if jstates is None:
        assert cache is None
    else:
        assert set(cache) == set(jstates)
        for key in cache:
            assert _rel(cache[key].numpy(), np.asarray(jstates[key])) < TOL
    assert abs(float(aux) - float(jaux)) <= TOL * max(abs(float(jaux)), 1.0)
    assert (float(aux) == 0.0) == (not cfg.is_moe)
    assert _rel(got, want) < TOL


def check_decode(arch, **changes):
    """Prefill P tokens, decode the rest one at a time: the logits hold
    to the reference's decode and to the port's own teacher-forced
    forward, and the caches to the reference's."""
    jcfg, jparams, cfg, params, tokens = _model(arch, **changes)
    got, want, cache, jcache = decode_against_reference(
        jcfg, jparams, cfg, params, tokens, P, S, S - P)
    full, _, _ = forward(params, cfg, tokens=torch.from_numpy(tokens))
    assert _rel(got, want) < TOL
    assert _rel(got, full[:, P:S].numpy()) < 1e-5
    assert set(cache) == set(jcache)
    for key in cache:
        assert _rel(cache[key].numpy(), np.asarray(jcache[key])) < TOL


def check_greedy(arch, **changes):
    last, jlast, toks, jtoks = greedy_against_reference(
        *_model(arch, **changes), 8)
    assert _rel(last, jlast) < TOL
    np.testing.assert_array_equal(toks, jtoks)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_logits_match_jax(use_kernels):
    check_forward("qwen3-32b", use_kernels)


def test_prefill_then_decode_matches_jax_and_teacher_forcing():
    check_decode("qwen3-32b")


def test_greedy_tokens_match_jax():
    check_greedy("qwen3-32b")
