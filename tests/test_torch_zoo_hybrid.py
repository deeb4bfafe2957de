"""The zamba2 hybrid, port against reference on the CPU: a Mamba2 trunk
with ONE shared-weight attention+MLP block applied after every
``shared_attn_every`` trunk layers, then the tail of the trunk.

Three configurations of the smoke variant (f32, shared_attn_every 2):
its own 2 layers (one super-block, no tail), 5 layers (two super-blocks
and a one-layer tail) and 1 layer (no shared block at all, as an f32 run
of 2 layers every 6 would be). Each holds to the reference through the
forward (logits and final states), prefill then decode (logits, the SSM,
conv and shared caches), greedy tokens, ``hidden_states``, and
``init_cache``'s layout, with ``tests/test_torch_zoo_dense.py``'s
weights and tolerances (1e-4 relative to the largest |logit|).

The reference runs once a configuration (``_reference``, through
``test_torch_zoo_dense.py::reference_run``): its jitted prefill of P tokens into an S cache, then its jitted decode, teacher
forced over the rest of the S tokens and greedy for 8 more; two
compiles a configuration, which every test of it reads. The forward's
and ``hidden_states``' P positions are held to that prefill's logits
(``hidden_states`` through the tied head: with vocab 512 over d_model
256 the head is injective, so the logits pin the states).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import init_cache as jax_init_cache
from repro.models import transformer as jax_transformer
from repro_torch.core import greedy_decode, make_prefill_step
from repro_torch.models import (
    forward,
    hidden_states,
    init_cache,
    params_from_reference,
    transformer,
)
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

ARCH = "zamba2-1.2b"
CONFIGS = {"one-block": {}, "tail": {"num_layers": 5},
           "no-block": {"num_layers": 1}}


GREEDY = 8  # greedy tokens after the first


@functools.lru_cache(maxsize=None)
def _reference(which):
    model = _model(ARCH, **CONFIGS[which])
    tokens = model[4]
    return reference_run(model, {"tokens": tokens[:, :P]}, tokens[:, P:],
                         GREEDY)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_forward_logits_and_states_match_jax(which, use_kernels):
    """The full forward over P tokens: its logits and the final SSM and
    conv states, which both packages return there, against the
    reference's prefill of the same tokens."""
    _, _, cfg, params, tokens = _model(ARCH, **CONFIGS[which])
    ref = _reference(which)
    got, states, aux = forward(params, cfg,
                               tokens=torch.from_numpy(tokens[:, :P]),
                               use_kernels=use_kernels)
    assert got.shape == (B, P, cfg.vocab_size) and float(aux) == 0.0
    assert _rel(got, ref["logits"]) < TOL
    assert set(states) == {"ssm", "conv"}
    for key in states:
        assert _rel(states[key], np.asarray(ref["cache"][key])) < TOL


@pytest.mark.parametrize("which", list(CONFIGS))
def test_prefill_then_decode_matches_jax_and_teacher_forcing(which):
    """Prefill P tokens, decode the other S - P one at a time: the logits
    hold to the reference's decode and to the port's own forward over
    all S, and the SSM, conv and shared caches to the reference's."""
    _, _, cfg, params, tokens = _model(ARCH, **CONFIGS[which])
    ref = _reference(which)
    t = torch.from_numpy(tokens)
    _, cache, _ = forward(params, cfg, tokens=t[:, :P], prefill_len=S)
    got = []
    for pos in range(P, S):
        lg, cache, _ = forward(params, cfg, tokens=t[:, pos:pos + 1],
                               cache=cache, cache_pos=pos)
        got.append(lg[:, 0].numpy())
    got = np.stack(got, 1)
    full, _, _ = forward(params, cfg, tokens=t)
    assert _rel(got, ref["forced"]) < TOL
    assert _rel(got, full[:, P:S].numpy()) < 1e-5
    assert set(cache) == set(ref["forced_cache"])
    for key in cache:
        want = np.asarray(ref["forced_cache"][key])
        assert cache[key].shape == want.shape
        # no-block's shared caches are empty: (0, B, S, KV, hd)
        assert want.size == 0 or _rel(cache[key].numpy(), want) < TOL


@pytest.mark.parametrize("which", list(CONFIGS))
def test_greedy_tokens_match_jax(which):
    """``make_prefill_step`` then ``greedy_decode`` against the
    reference's prefill and greedy decode steps."""
    _, _, cfg, params, tokens = _model(ARCH, **CONFIGS[which])
    ref = _reference(which)
    last, cache = make_prefill_step(cfg, S)(
        params, {"tokens": torch.from_numpy(tokens[:, :P])})
    assert _rel(last, ref["logits"][:, -1]) < TOL
    first = torch.argmax(last, dim=-1)[:, None]
    toks, _ = greedy_decode(cfg, params, cache, first, P, GREEDY)
    np.testing.assert_array_equal(torch.cat([first, toks], 1).numpy(),
                                  ref["greedy"])


@pytest.mark.parametrize("which", list(CONFIGS))
def test_hidden_states_match_jax(which):
    """The final normed states of P tokens, through the tied head,
    against the reference's logits there (``embed`` (512, 256) is
    injective on the states)."""
    _, _, cfg, params, tokens = _model(ARCH, **CONFIGS[which])
    ref = _reference(which)
    for use_kernels in (True, False):
        with torch.no_grad():
            got, aux = hidden_states(params, cfg,
                                     torch.from_numpy(tokens[:, :P]),
                                     use_kernels=use_kernels)
        assert got.shape == (B, P, cfg.d_model) and float(aux) == 0.0
        assert _rel(got @ params["embed"].T, ref["logits"]) < TOL


@pytest.mark.parametrize("which", list(CONFIGS))
def test_init_cache_matches_the_prefill_cache(which):
    """``init_cache`` gives exactly the prefill cache's keys, shapes and
    dtypes, and the reference's ``init_cache`` layout; decode writes that
    cache in place (the same tensors come back, the shared block's keys
    written at the decoded position only)."""
    jcfg, _, cfg, params, tokens = _model(ARCH, **CONFIGS[which])
    t = torch.from_numpy(tokens)
    _, cache, _ = forward(params, cfg, tokens=t[:, :P], prefill_len=S)
    empty = init_cache(cfg, B, S, device="cpu")
    layout = {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
    assert layout == {k: (tuple(v.shape), v.dtype)
                      for k, v in empty.items()}
    want = jax.eval_shape(lambda: jax_init_cache(jcfg, B, S))
    assert {k: (shape, str(dtype).removeprefix("torch."))
            for k, (shape, dtype) in layout.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    k_super, n_super, tail = transformer._zamba_split(cfg)
    assert (k_super, n_super, tail) == jax_transformer._zamba_split(jcfg)
    assert cache["shared_k"].shape[0] == n_super
    before = {k: v.clone() for k, v in cache.items()}
    _, out, _ = forward(params, cfg, tokens=t[:, P:P + 1], cache=cache,
                        cache_pos=P)
    assert out is cache and all(out[k] is cache[k] for k in cache)
    for name in ("shared_k", "shared_v"):
        changed = (cache[name] != before[name]).any(dim=(0, 1, 3, 4))
        assert changed.nonzero().flatten().tolist() == ([P] if n_super
                                                        else [])


def test_params_from_reference_on_the_hybrid_tree():
    """The bridge takes the reference's tree with its shared block, and
    refuses it without."""
    jcfg, jparams, cfg, params, _ = _model(ARCH, **CONFIGS["tail"])
    assert set(params) == {"embed", "final_norm", "layers", "shared_attn"}
    assert set(params["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    assert torch.equal(params["shared_attn"]["attn"]["wq"], torch.from_numpy(
        np.array(jparams["shared_attn"]["attn"].wq)))
    tree = _numpy_tree(jparams)
    del tree["shared_attn"]
    with pytest.raises(ValueError, match="shared_attn"):
        params_from_reference(cfg, tree, device="cpu")
