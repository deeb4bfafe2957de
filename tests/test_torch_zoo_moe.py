"""The MoE backbones, port against reference on the CPU: grok-1-314b (8
experts, top-2; granite-moe-3b-a800m in ``test_torch_zoo_granite.py``)
on its smoke variant (4 experts, top-2, capacity factor 4: no token
dropped) through the forward with its aux loss, prefill and decode, and
greedy decoding, with ``tests/test_torch_zoo_dense.py``'s weights,
checks and tolerances; and ``models/moe.py`` alone: ``moe_ffn`` against
the reference's where the capacity drops tokens (factor 1.0) and where
it drops none (4.0), ``expert_capacity`` over a sweep, and the top-k's
tie order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.models import moe
from test_torch_backbone import _rel
from test_torch_zoo_dense import (  # noqa: F401
    TOL,
    _one_torch_thread,
    check_decode,
    check_forward,
    check_greedy,
)

MOES = ["grok-1-314b"]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", MOES)
def test_forward_logits_and_aux_match_jax(arch, use_kernels):
    check_forward(arch, use_kernels)


@pytest.mark.parametrize("arch", MOES)
def test_prefill_then_decode_matches_jax_and_teacher_forcing(arch):
    check_decode(arch)


@pytest.mark.parametrize("arch", MOES)
def test_greedy_tokens_match_jax(arch):
    check_greedy(arch)


def _moe_inputs(seed, b, s, d, e, ff, skew):
    """numpy params and x; ``skew`` adds one direction to every token, so
    the router favours some experts over others."""
    rng = np.random.default_rng(seed)
    params = {
        "router": rng.standard_normal((d, e)) / np.sqrt(d),
        "w_gate": rng.standard_normal((e, d, ff)) / np.sqrt(d),
        "w_up": rng.standard_normal((e, d, ff)) / np.sqrt(d),
        "w_down": rng.standard_normal((e, ff, d)) / np.sqrt(ff),
    }
    x = rng.standard_normal((b, s, d)) + skew * rng.standard_normal(d)
    return {k: v.astype(np.float32) for k, v in params.items()}, \
        x.astype(np.float32)


def _both(params, x, e, k, factor):
    """(port out, port aux, reference out, reference aux)."""
    got, aux = moe.moe_ffn(
        moe.MoEParams(**{n: torch.from_numpy(a) for n, a in params.items()}),
        torch.from_numpy(x), e, k, 0.01, factor)
    want, jaux = jax_moe.moe_ffn(
        jax_moe.MoEParams(**{n: jnp.asarray(a) for n, a in params.items()}),
        jnp.asarray(x), e, k, 0.01, factor)
    return got, aux, np.asarray(want), float(jaux)


def _dropped(params, x, e, k, factor) -> int:
    """Pairs past their expert's capacity, counted in numpy in token
    order."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ params["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :k].reshape(-1)
    cap = jax_moe.expert_capacity(x.shape[0] * x.shape[1], e, k, factor)
    return int(np.maximum(np.bincount(top, minlength=e) - cap, 0).sum())


@pytest.mark.parametrize("factor,drops", [(1.0, True), (4.0, False)])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 3)])
def test_moe_ffn_matches_jax_with_and_without_drops(e, k, factor, drops):
    params, x = _moe_inputs(3, 2, 24, 64, e, 96, skew=1.5)
    n_dropped = _dropped(params, x, e, k, factor)
    assert (n_dropped > 0) == drops, n_dropped
    got, aux, want, jaux = _both(params, x, e, k, factor)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    assert abs(float(aux) - jaux) < TOL * jaux


@pytest.mark.parametrize("t,e,k,factor", [
    (1, 4, 2, 1.25), (48, 4, 2, 1.0), (48, 4, 2, 4.0), (8192, 32, 8, 1.25),
    (8192, 8, 2, 1.25), (64, 8, 2, 1.25), (4, 32, 8, 1.25),
    (1000, 7, 3, 1.1), (65536, 64, 6, 2.0)])
def test_expert_capacity_matches_jax(t, e, k, factor):
    cap = moe.expert_capacity(t, e, k, factor)
    assert cap == jax_moe.expert_capacity(t, e, k, factor)
    assert cap % 8 == 0 and cap >= t * k / e * factor


def test_top_k_breaks_ties_to_the_lower_expert_as_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        vals, idx = moe.top_k(torch.from_numpy(probs), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_ffn_on_exact_router_ties_matches_jax():
    """Experts 2 and 3 have expert 0's and 1's router columns, so every
    token's choice is a tie: both packages take the lower experts."""
    params, x = _moe_inputs(4, 2, 16, 64, 4, 96, skew=0.0)
    params["router"][:, 2:] = params["router"][:, :2]
    got, aux, want, jaux = _both(params, x, 4, 2, 4.0)
    assert _rel(got, want) < TOL
    assert abs(float(aux) - jaux) < TOL * jaux
