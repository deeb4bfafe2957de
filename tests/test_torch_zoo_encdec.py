"""whisper-small's encoder-decoder and llava-next-34b's embeddings input,
port against reference on the CPU, on their smoke variants (f32):

* whisper: the bidirectional encoder (2 layers over 32 stub frames,
  through the flash kernel's plain version, non-causal), each decoder
  layer's cross-attention on the encoder's K/V, and the decode cache that
  keeps them fixed while the self-attention cache grows;
* llava: the prefill from ``embeds`` (B, S, d), decode from tokens
  through its untied head.

Each runs the forward, prefill then S - P decode steps (and the port's
own teacher-forced forward), greedy tokens, ``hidden_states`` (through
the head, as ``test_torch_zoo_hybrid.py`` holds it), ``init_cache``
against the prefill cache and the reference's layout, and
``params_from_reference`` on the new trees; and ``encoder_self_attend``
(also at a ragged S, which the kernel's wrapper pads), ``cross_kv`` and
``cross_attend`` alone against the reference's functions. The reference
runs once an arch (``test_torch_zoo_dense.py::reference_run``: two
compiles). Weights and tolerances are ``tests/test_torch_zoo_dense.py``'s:
1e-4 relative to the largest |value|. The frame and patch embeddings are
numpy draws, N(0, 1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models import init_cache as jax_init_cache
from repro_torch.core import greedy_decode, make_prefill_step
from repro_torch.models import (
    forward,
    hidden_states,
    init_cache,
    params_from_reference,
)
from repro_torch.models import attention
from test_torch_backbone import _numpy_tree, _rel
from test_torch_zoo_dense import (  # noqa: F401
    B,
    P,
    S,
    TOL,
    _model,
    _one_torch_thread,
    reference_run,
)

ARCHS = ["whisper-small", "llava-next-34b"]
GREEDY = 8  # greedy tokens after the first


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """``forward``'s inputs for the whole sequence, as numpy: whisper's
    tokens and frames, llava's embeddings; and the tokens decode feeds."""
    _, _, cfg, _, tokens = _model(arch)
    rng = np.random.default_rng(3)
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model))
        return {"tokens": tokens, "enc_embeds": frames.astype(np.float32)}
    return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32)}


def _prefix(inputs, n):
    """The inputs of a prefill of the first ``n`` positions."""
    return {k: v if k == "enc_embeds" else v[:, :n] for k, v in inputs.items()}


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's run (``reference_run``): the prefill of the first
    P positions, S - P tokens decoded teacher forced, GREEDY greedy."""
    model = _model(arch)
    tokens = model[4]
    return reference_run(model, _prefix(_inputs(arch), P), tokens[:, P:],
                         GREEDY)


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, use_kernels):
    """The full forward over the first P positions (whisper's frames
    through the encoder) against the reference's prefill of them."""
    _, _, cfg, params, _ = _model(arch)
    got, cache, aux = forward(params, cfg,
                              **_torch(_prefix(_inputs(arch), P)),
                              use_kernels=use_kernels)
    assert got.shape == (B, P, cfg.vocab_size) and got.dtype == torch.float32
    assert cache is None and float(aux) == 0.0
    assert _rel(got, _reference(arch)["logits"]) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax_and_teacher_forcing(arch):
    """Prefill P positions (llava from embeddings), then decode the other
    S - P tokens one at a time: the logits hold to the reference's
    decode and to the port's own forward over the whole sequence
    (llava's: the prefix's embeddings, then the decoded tokens' rows of
    ``embed``), and the cache to the reference's: whisper's cross K/V
    unchanged by decode, its self-attention K/V written at each
    position."""
    _, _, cfg, params, tokens = _model(arch)
    inputs = _inputs(arch)
    ref = _reference(arch)
    _, cache, _ = forward(params, cfg, **_torch(_prefix(inputs, P)),
                          prefill_len=S)
    fixed = {k: cache[k].clone() for k in cache if k.startswith("cross")}
    t = torch.from_numpy(tokens)
    got = []
    for pos in range(P, S):
        lg, cache, _ = forward(params, cfg, tokens=t[:, pos:pos + 1],
                               cache=cache, cache_pos=pos)
        got.append(lg[:, 0].numpy())
    got = np.stack(got, 1)
    assert _rel(got, ref["forced"]) < TOL
    whole = _torch(inputs)
    if "embeds" in whole:
        whole["embeds"] = torch.cat(
            [whole["embeds"][:, :P], params["embed"][t[:, P:]]], 1)
    full, _, _ = forward(params, cfg, **whole)
    assert _rel(got, full[:, P:].numpy()) < 1e-5
    assert set(cache) == set(ref["forced_cache"])
    for key in cache:
        assert _rel(cache[key].numpy(),
                    np.asarray(ref["forced_cache"][key])) < TOL
    assert set(fixed) == ({"cross_k", "cross_v"} if cfg.is_encoder_decoder
                          else set())
    for key, before in fixed.items():
        assert torch.equal(cache[key], before)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    """``make_prefill_step`` on the batch dict (whisper's tokens and
    frames; llava's embeddings), then ``greedy_decode``, against the
    reference's prefill and greedy decode steps."""
    _, _, cfg, params, _ = _model(arch)
    ref = _reference(arch)
    last, cache = make_prefill_step(cfg, S)(
        params, _torch(_prefix(_inputs(arch), P)))
    assert _rel(last, ref["logits"][:, -1]) < TOL
    first = torch.argmax(last, dim=-1)[:, None]
    toks, _ = greedy_decode(cfg, params, cache, first, P, GREEDY)
    np.testing.assert_array_equal(torch.cat([first, toks], 1).numpy(),
                                  ref["greedy"])


@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_match_jax(arch):
    """The final normed states of the first P positions, through the
    head (whisper's tied ``embed``, llava's ``lm_head``; each (256, 512),
    injective on the states), against the reference's logits there."""
    _, _, cfg, params, _ = _model(arch)
    ref = _reference(arch)
    for use_kernels in (True, False):
        with torch.no_grad():
            got, aux = hidden_states(params, cfg,
                                     **_torch(_prefix(_inputs(arch), P)),
                                     use_kernels=use_kernels)
        assert got.shape == (B, P, cfg.d_model) and float(aux) == 0.0
        assert _rel(got @ _head(cfg, params), ref["logits"]) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_the_prefill_cache(arch):
    """Exactly the prefill cache's keys, shapes and dtypes (whisper's
    cross K/V at ``enc_seq_len``), and the reference's layout."""
    jcfg, _, cfg, params, _ = _model(arch)
    _, cache, _ = forward(params, cfg, **_torch(_prefix(_inputs(arch), P)),
                          prefill_len=S)
    layout = {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
    assert layout == {k: (tuple(v.shape), v.dtype)
                      for k, v in init_cache(cfg, B, S, device="cpu").items()}
    want = jax.eval_shape(lambda: jax_init_cache(jcfg, B, S))
    assert {k: (shape, str(dtype).removeprefix("torch."))
            for k, (shape, dtype) in layout.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    if cfg.is_encoder_decoder:
        assert layout["cross_k"][0] == (cfg.num_layers, B, cfg.enc_seq_len,
                                        cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_on_the_new_trees(arch):
    """whisper's encoder and per-layer cross-attention, llava's untied
    head: the bridge takes the reference's tree leaf for leaf and refuses
    one with a leaf missing."""
    _, jparams, cfg, params, _ = _model(arch)
    tree = _numpy_tree(jparams)
    if cfg.is_encoder_decoder:
        assert set(params["encoder"]) == {"layers", "norm"}
        assert {"ln_cross", "cross"} <= set(params["layers"])
        assert set(params["layers"]["cross"]) == {"wq", "wk", "wv", "wo"}
        assert params["encoder"]["layers"]["ln1"].shape[0] == cfg.enc_layers
        del tree["layers"]["cross"]["wk"]
        missing = "wk"
    else:
        assert params["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
        del tree["lm_head"]
        missing = "lm_head"
    with pytest.raises(ValueError, match=missing):
        params_from_reference(cfg, tree, device="cpu")


def _whisper_layer(part):
    """whisper's smoke weights: the encoder's first layer's self-attention
    (``"encoder"``) or the decoder's first layer's cross-attention
    (``"cross"``), as the port's and the reference's NamedTuples."""
    _, jparams, _, params, _ = _model("whisper-small")
    if part == "encoder":
        jp = jax.tree.map(lambda a: a[0],
                          jparams["encoder"]["layers"]["attn"])
        p = {k: None if v is None else v[0]
             for k, v in params["encoder"]["layers"]["attn"].items()}
        return attention.AttnParams(**p), jax_attention.AttnParams(*jp)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["cross"])
    p = {k: v[0] for k, v in params["layers"]["cross"].items()}
    return attention.CrossAttnParams(**p), jax_attention.CrossAttnParams(*jp)


@functools.lru_cache(maxsize=None)
def _reference_encoder(s):
    """x (B, s, d) and the reference's ``encoder_self_attend`` of it,
    jitted once a shape."""
    _, _, cfg, _, _ = _model("whisper-small")
    _, jp = _whisper_layer("encoder")
    x = np.random.default_rng(4).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)
    fn = jax.jit(lambda p, x: jax_attention.encoder_self_attend(p, x, cfg))
    return x, np.asarray(fn(jp, jnp.asarray(x)))


@pytest.mark.parametrize("s", [32, 30])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_encoder_self_attend_matches_jax(use_kernel, s):
    """Bidirectional attention; at S 30 the kernel's wrapper pads to its
    block and masks the padded keys, which the reference's plain path
    never sees."""
    _, _, cfg, _, _ = _model("whisper-small")
    p, _ = _whisper_layer("encoder")
    x, want = _reference_encoder(s)
    got = attention.encoder_self_attend(p, torch.from_numpy(x), cfg,
                                        use_kernel=use_kernel)
    assert got.shape == x.shape and _rel(got, want) < TOL


def test_cross_kv_and_cross_attend_match_jax():
    """The encoder's K/V (S_enc 32) and a decoder prompt's attention on
    them (S 24 queries: Sq != Sk), and one decode query's."""
    _, _, cfg, _, _ = _model("whisper-small")
    p, jp = _whisper_layer("cross")
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)).astype(
        np.float32)
    xs = [rng.standard_normal((B, sq, cfg.d_model)).astype(np.float32)
          for sq in (S, 1)]

    @jax.jit
    def reference(jp, enc, xs):
        jk, jv = jax_attention.cross_kv(jp, enc, cfg)
        return jk, jv, [jax_attention.cross_attend(jp, x, jk, jv, cfg)
                        for x in xs]

    jk, jv, wants = reference(jp, jnp.asarray(enc),
                              [jnp.asarray(x) for x in xs])
    k, v = attention.cross_kv(p, torch.from_numpy(enc), cfg)
    assert k.shape == (B, cfg.enc_seq_len, cfg.num_kv_heads, cfg.head_dim)
    assert _rel(k, jk) < TOL and _rel(v, jv) < TOL
    for x, want in zip(xs, wants):
        got = attention.cross_attend(p, torch.from_numpy(x), k, v, cfg)
        assert got.shape == x.shape and _rel(got, want) < TOL
