"""The ring cache of gemma2-27b and gemma3-27b (``ring_cache=True``),
port against reference on the CPU, after the reference's
``tests/test_ring_cache.py``: the ring decode against the port's
full-cache decode and the reference's ring decode, ``ring_cache_from_full``
array for array, the footprint at full width on the meta device, and
the full cache's refusal past its end beside the ring's wrap. The
weights, tokens and tolerances are ``tests/test_torch_zoo_dense.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import override as jax_override
from repro.models.transformer import init_ring_cache as jax_init_ring_cache
from repro.models.transformer import ring_cache_from_full as \
    jax_ring_cache_from_full
from repro_torch.configs import get_arch, override
from repro_torch.models import forward, init_cache
from repro_torch.models.transformer import (
    init_ring_cache,
    ring_cache_from_full,
    uses_ring_cache,
)
from test_torch_backbone import _rel
from test_torch_zoo_dense import (  # noqa: F401
    B,
    P,
    S,
    TOL,
    _model,
    _one_torch_thread,
    reference_fns,
)

GEMMAS = ["gemma2-27b", "gemma3-27b"]


def _ring_runs(arch):
    """The port's prefill of P tokens, its full-cache decode and its ring
    decode of the rest, and the reference's ring decode of the same."""
    jcfg, jparams, cfg, params, tokens = _model(arch, ring=True)
    base = override(cfg, ring_cache=False)
    t = torch.from_numpy(tokens)
    _, full, _ = forward(params, base, tokens=t[:, :P], prefill_len=S)
    ring = ring_cache_from_full(cfg, full, P - 1, B, S)
    _, jfull, _ = reference_fns(jax_override(jcfg, ring_cache=False))[
        "prefill"](jparams, jnp.asarray(tokens[:, :P]), S)
    jring = jax_ring_cache_from_full(jcfg, jfull, P - 1, B, S)
    ring_step = reference_fns(jcfg)["decode"]
    out = {"full": [], "ring": [], "ref_ring": []}
    for pos in range(P, S):
        step = t[:, pos:pos + 1]
        lg, full, _ = forward(params, base, tokens=step, cache=full,
                              cache_pos=pos)
        out["full"].append(lg[:, 0].numpy())
        lg, ring, aux = forward(params, cfg, tokens=step, cache=ring,
                                cache_pos=pos)
        assert float(aux) == 0.0
        out["ring"].append(lg[:, 0].numpy())
        jlg, jring, _ = ring_step(jparams, jnp.asarray(tokens[:, pos:pos + 1]),
                                  jring, jnp.asarray(pos, jnp.int32))
        out["ref_ring"].append(np.asarray(jlg[:, 0]))
    return {k: np.stack(v, 1) for k, v in out.items()}, ring, jring


@pytest.mark.parametrize("arch", GEMMAS)
def test_ring_decode_matches_full_cache_and_the_reference(arch):
    """One local:global period and a tail layer (so the tail's path
    runs), the ring wrapping past the smoke window of 16: the ring decode
    against the port's full-cache decode and the reference's ring
    decode, and the rings the two packages hold after it."""
    cfg = _model(arch, ring=True)[2]
    assert uses_ring_cache(cfg) and cfg.num_layers % len(
        cfg.window_pattern) == 1
    logits, ring, jring = _ring_runs(arch)
    assert _rel(logits["ring"], logits["full"]) < TOL
    assert _rel(logits["ring"], logits["ref_ring"]) < TOL
    assert set(ring) == set(jring) == {"ring_k", "ring_v", "glob_k",
                                       "glob_v", "tail_k", "tail_v"}
    for key in ring:
        assert _rel(ring[key].numpy(), np.asarray(jring[key])) < TOL


@pytest.mark.parametrize("cache_pos", [P - 1, S - 5])
@pytest.mark.parametrize("arch", GEMMAS)
def test_ring_cache_from_full_matches_the_reference_layout(arch, cache_pos):
    """``ring_cache_from_full`` array for array against the reference's,
    before the window's end and past it (S - 5 = 19 > 16: the ring has
    wrapped), from each package's prefill of S tokens."""
    jcfg, jparams, cfg, params, tokens = _model(arch, ring=True)
    _, full, _ = forward(params, override(cfg, ring_cache=False),
                         tokens=torch.from_numpy(tokens), prefill_len=S)
    _, jfull, _ = reference_fns(jax_override(jcfg, ring_cache=False))[
        "prefill"](jparams, jnp.asarray(tokens), S)
    got = ring_cache_from_full(cfg, full, cache_pos, B, S)
    want = jax_ring_cache_from_full(jcfg, jfull, cache_pos, B, S)
    assert set(got) == set(want)
    empty = init_cache(cfg, B, S, device="cpu")
    for key in got:
        assert tuple(got[key].shape) == tuple(want[key].shape) == tuple(
            empty[key].shape), key
        assert got[key].dtype == empty[key].dtype == torch.float32
        assert _rel(got[key].numpy(), np.asarray(want[key])) < TOL, key


def test_ring_cache_memory_footprint_at_full_width():
    """gemma3-27b at full width, 32k context, on the meta device: the
    ring layout holds under 0.3 of the full cache's positions (the
    reference's bound), and each array has the reference's abstract
    shape."""
    cfg = override(get_arch("gemma3-27b"), ring_cache=True)
    jcfg = jax_override(jax_get_arch("gemma3-27b"), ring_cache=True)
    max_seq = 32768
    ring = init_ring_cache(cfg, 1, max_seq, device="meta")
    want = jax.eval_shape(lambda: jax_init_ring_cache(jcfg, 1, max_seq))
    assert {k: tuple(v.shape) for k, v in ring.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    full_elems = cfg.num_layers * max_seq
    ring_elems = sum(v.numel() for v in ring.values()) // (
        2 * cfg.num_kv_heads * cfg.head_dim)
    assert ring_elems < 0.3 * full_elems, (ring_elems, full_elems)
    assert all(v.dtype == torch.bfloat16 for v in ring.values())


def test_ring_wraps_but_the_global_cache_refuses_past_its_end():
    """A local layer's ring wraps by design; a global layer's full cache
    refuses a position past its end (the reference clamps instead)."""
    jcfg, jparams, cfg, params, tokens = _model("gemma2-27b", ring=True)
    t = torch.from_numpy(tokens)
    _, full, _ = forward(params, override(cfg, ring_cache=False),
                         tokens=t[:, :P], prefill_len=P + 1)
    ring = ring_cache_from_full(cfg, full, P - 1, B, P + 1)
    _, ring, _ = forward(params, cfg, tokens=t[:, P:P + 1], cache=ring,
                         cache_pos=P)
    with pytest.raises(IndexError):
        forward(params, cfg, tokens=t[:, P + 1:P + 2], cache=ring,
                cache_pos=P + 1)
