"""The LM-serving slice of the backbone zoo, port against reference on
the CPU: qwen2-0.5b (dense GQA) and mamba2-780m (pure SSD).

The reference's params (``repro.models.init_params``) go to the port
through ``params_from_reference``, so both packages run the same
weights; tokens come from numpy. Tolerances are on the max-abs
difference relative to the largest |logit|. The smoke variants are f32,
so the port's two branches (the kernels' plain versions and the model's
own plain path) both hold to 1e-4; the full-width models are only built
on the meta device.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import override as jax_override
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.trainer import greedy_decode as jax_greedy_decode
from repro.core.trainer import make_prefill_step as jax_make_prefill_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro_torch.configs import ATTN, MAMBA, get_arch, override, smoke_variant
from repro_torch.core import greedy_decode, make_prefill_step
from repro_torch.models import (
    forward,
    init_cache,
    init_params,
    params_from_reference,
)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-0.5b", "mamba2-780m"]
B, S, P = 2, 16, 8  # test_decode_consistency.py's batch, length, prompt
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


def _numpy_tree(tree, leaf=np.asarray):
    """The reference's params as nested dicts of numpy arrays (of
    ``leaf(x)`` for each leaf x)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, leaf) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _numpy_tree(getattr(tree, f), leaf)
                for f in tree._fields}
    return leaf(tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


_MODELS = {}


def _model(arch):
    """(reference cfg, reference params, port cfg, port params, tokens)
    for the smoke variant of ``arch``, built once per worker."""
    if arch not in _MODELS:
        jcfg = jax_smoke_variant(jax_get_arch(arch))
        cfg = smoke_variant(get_arch(arch))
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
        params = params_from_reference(cfg, _numpy_tree(jparams),
                                       device="cpu")
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S), dtype=np.int32)
        _MODELS[arch] = (jcfg, jparams, cfg, params, tokens)
    return _MODELS[arch]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, use_kernels):
    jcfg, jparams, cfg, params, tokens = _model(arch)
    want, _, _ = jax_forward(jparams, jcfg, tokens=jnp.asarray(tokens))
    got, cache, aux = forward(params, cfg, tokens=torch.from_numpy(tokens),
                              use_kernels=use_kernels)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    # a full mamba pass returns its final states, as the reference's does
    assert (cache is None) == (arch == "qwen2-0.5b") and float(aux) == 0.0
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax_and_teacher_forcing(arch):
    """Prefill P tokens into an S-long cache, decode the rest one token
    at a time: the logits hold to the reference's decode and to the
    port's own teacher-forced forward (test_decode_consistency.py's
    invariant)."""
    jcfg, jparams, cfg, params, tokens = _model(arch)
    t = torch.from_numpy(tokens)
    _, cache, _ = forward(params, cfg, tokens=t[:, :P], prefill_len=S)
    _, jcache, _ = jax_forward(jparams, jcfg,
                               tokens=jnp.asarray(tokens[:, :P]),
                               prefill_len=S)
    got, want = [], []
    for pos in range(P, S):
        lg, cache, _ = forward(params, cfg, tokens=t[:, pos:pos + 1],
                               cache=cache, cache_pos=pos)
        jlg, jcache, _ = jax_forward(
            jparams, jcfg, tokens=jnp.asarray(tokens[:, pos:pos + 1]),
            cache=jcache, cache_pos=jnp.asarray(pos, jnp.int32))
        got.append(lg[:, 0].numpy())
        want.append(np.asarray(jlg[:, 0]))
    full, _, _ = forward(params, cfg, tokens=t)
    assert _rel(np.stack(got, 1), np.stack(want, 1)) < TOL
    assert _rel(np.stack(got, 1), full[:, P:S].numpy()) < 1e-5
    for key in cache:  # the caches the two packages hold after decoding
        assert _rel(cache[key].numpy(), np.asarray(jcache[key])) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    jcfg, jparams, cfg, params, tokens = _model(arch)
    steps = S - P
    jlast, jcache = jax_make_prefill_step(jcfg, S + steps)(
        jparams, {"tokens": jnp.asarray(tokens)})
    jfirst = jnp.argmax(jlast, axis=-1).astype(jnp.int32)[:, None]
    jtoks, _ = jax_greedy_decode(jcfg, jparams, jcache, jfirst, S, steps)
    last, cache = make_prefill_step(cfg, S + steps)(
        params, {"tokens": torch.from_numpy(tokens)})
    assert _rel(last, jlast) < TOL
    first = torch.argmax(last, dim=-1)[:, None]
    toks, _ = greedy_decode(cfg, params, cache, first, S, steps)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


@pytest.mark.parametrize("arch", ARCHS + [
    "qwen3-32b", "gemma2-27b", "gemma3-27b", "granite-moe-3b-a800m",
    "grok-1-314b", "zamba2-1.2b", "whisper-small", "llava-next-34b"])
def test_full_width_params_have_the_reference_shapes(arch):
    """Every arch at full width built on the meta device (post-norms, the
    MoE's f32 router, zamba2's shared block, whisper's encoder and cross
    attention, llava's untied head included): every leaf's shape and
    dtype equals the reference's, abstractly."""
    want = _numpy_tree(jax.eval_shape(
        lambda k: jax_init_params(jax_get_arch(arch), k),
        jax.random.PRNGKey(0)), leaf=lambda x: x)
    got = init_params(get_arch(arch), None, device="meta")

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{path}/{k}")
        else:
            yield path, tree

    got_l, want_l = dict(leaves(got)), dict(leaves(want))
    assert got_l.keys() == want_l.keys()
    for path, t in got_l.items():
        w = want_l[path]
        if t is None:
            assert w is None, path
            continue
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(w.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), path
    n = sum(t.numel() for t in got_l.values() if t is not None)
    assert n == sum(int(np.prod(w.shape)) for w in want_l.values()
                    if w is not None)


def test_bridge_refuses_a_tree_of_another_shape():
    jcfg, jparams, cfg, _, _ = _model("qwen2-0.5b")
    tree = _numpy_tree(jparams)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(cfg, tree, device="cpu")
    tree = _numpy_tree(jparams)
    tree["layers"]["attn"]["bq"] = None
    with pytest.raises(ValueError, match="bq"):
        params_from_reference(cfg, tree, device="cpu")


def test_init_cache_matches_the_prefill_cache():
    for arch in ARCHS:
        _, _, cfg, params, tokens = _model(arch)
        _, cache, _ = forward(params, cfg, tokens=torch.from_numpy(
            tokens[:, :P]), prefill_len=S)
        empty = init_cache(cfg, B, S, device="cpu")
        assert {k: (v.shape, v.dtype) for k, v in cache.items()} == {
            k: (v.shape, v.dtype) for k, v in empty.items()}


def test_unported_architectures_raise_naming_the_roadmap():
    """Every registered arch runs now. What stays refused is what the
    reference refuses too: a per-layer pattern that mixes attention and
    Mamba2 layers (zamba2 mixes through its shared block instead), with
    the reference's message; an unknown name raises ``KeyError``."""
    mixed = override(smoke_variant(get_arch("zamba2-1.2b")),
                     block_pattern=(MAMBA, ATTN), shared_attn_every=0)
    jmixed = jax_override(jax_smoke_variant(jax_get_arch("zamba2-1.2b")),
                          block_pattern=(MAMBA, ATTN), shared_attn_every=0)
    with pytest.raises(ValueError, match="mixed per-layer patterns") as got:
        init_params(mixed, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="mixed per-layer patterns") as want:
        jax_init_params(jmixed, jax.random.PRNGKey(0))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mixed per-layer patterns"):
        init_cache(mixed, B, S, device="cpu")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_serve_cli_rehearses_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-0.5b", "--smoke", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=qwen2-0.5b-smoke batch=4 prompt=16 "
                               "generated=16 device=cpu")
    seqs = [ln for ln in lines if ln.startswith("  seq")]
    assert len(seqs) == 4 and all(len(ast.literal_eval(s.split(": ")[1])) == 16
                                  for s in seqs)
