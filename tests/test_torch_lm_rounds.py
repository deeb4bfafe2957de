"""The federated backbone trainers, port against reference on the CPU:
``make_backbone_fedavg_round`` (full parameters; the seed contract with
``agg=None``, and fedavg, fedavgm, median and krum through the delta
contract) and ``make_fedlora_round`` (LoRA adapters on a frozen
backbone; fedavg, and the DP release with and without the int8 codec,
the reference's noise and uniforms replayed), 2 rounds each, and the
reference's refusals.

Both packages start from the same weights (numpy draws into the
reference's tree, carried across by ``params_from_reference``; the
reference's adapters by ``lora_from_reference``) and the same batches.
The reference's round draws its release randomness from a round key;
its noise and uniforms (``client_noise`` / ``client_uniform`` of the
round key's per-client split) go to the port as ``RoundDraws``. The
model is qwen2-0.5b's family cut to one layer at width 64 (f32), so the
reference's vmapped rounds compile in a few seconds each
(``FAST_COMPILE``). Params, optimizer states, server states, residuals
and losses within 1e-5. Adam takes eps 1e-6 (see
``test_torch_lm_train.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.configs import AdversaryConfig as JaxAdversaryConfig
from repro.configs import AggConfig as JaxAggConfig
from repro.configs import CompressionConfig as JaxCompressionConfig
from repro.configs import PrivacyConfig as JaxPrivacyConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs import override as jax_override
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import broadcast_to_clients as jax_broadcast
from repro.core import compression as jax_cx
from repro.core import init_lora as jax_init_lora
from repro.core import make_aggregator as jax_make_aggregator
from repro.core import make_backbone_fedavg_round as jax_fedavg_round
from repro.core import make_fedlora_round as jax_fedlora_round
from repro.core import privacy as jax_dp
from repro_torch import optim
from repro_torch.configs import (
    AdversaryConfig,
    AggConfig,
    CompressionConfig,
    PrivacyConfig,
    get_arch,
    override,
    smoke_variant,
)
from repro_torch.core import (
    RoundDraws,
    broadcast_to_clients,
    lora_from_reference,
    make_aggregator,
    make_backbone_fedavg_round,
    make_fedlora_round,
)
from repro_torch.models import params_from_reference
from repro_torch.utils.pytree import tree_count_params, tree_leaves
from test_torch_backbone import _numpy_tree
from test_torch_zoo_dense import FAST_COMPILE, reference_params

TOL = 1e-5
C, STEPS, B, S, ROUNDS = 3, 2, 2, 8, 2
LR, EPS = 1e-3, 1e-6
TINY = dict(num_layers=1, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=128)
_DP = dict(clip_norm=0.05, noise_multiplier=0.8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jax_override(jax_smoke_variant(jax_get_arch("qwen2-0.5b")),
                        **TINY)
    cfg = override(smoke_variant(get_arch("qwen2-0.5b")), **TINY)
    jparams = reference_params(jcfg, 4)
    params = params_from_reference(cfg, _numpy_tree(jparams), device="cpu")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (ROUNDS, C, STEPS, B, S + 1),
                          dtype=np.int32)
    batches = [{"tokens": t[..., :-1], "labels": t[..., 1:]}
               for t in tokens]
    jlora = jax_init_lora(jparams, jax.random.PRNGKey(3), rank=4)
    return jcfg, jparams, cfg, params, batches, jlora


def _jax_draws(round_key, p, priv, comp):
    """The reference round's release draws for round key ``round_key``:
    (noise, uniform) as numpy, None where the config draws none."""
    keys = jax.random.split(round_key, C)
    noise = (np.asarray(jax_dp.client_noise(keys, (C, p), priv.sigma))
             if priv.enabled and priv.noise_multiplier > 0 else None)
    uniform = (np.asarray(jax_cx.client_uniform(keys, (C, p)))
               if comp.enabled and comp.needs_rng else None)
    return noise, uniform


def _run(lora: bool, agg_name, priv_kw=None, comp_kw=None):
    """ROUNDS rounds in both packages: per round, (reference outputs,
    port outputs), each a list of numpy leaves of (payload, optimizer
    state, losses[, server state[, residual]])."""
    jcfg, jparams, cfg, params, batches, jlora = _model()
    weights = np.array([0.5, 0.3, 0.2], np.float32)
    jpriv, priv = (JaxPrivacyConfig(**(priv_kw or {})),
                   PrivacyConfig(**(priv_kw or {})))
    jcomp, comp = (JaxCompressionConfig(**(comp_kw or {})),
                   CompressionConfig(**(comp_kw or {})))
    jopt, opt = jax_optim.adam(LR, eps=EPS), optim.adam(LR, eps=EPS)
    if lora:
        jpayload = jlora
        payload = lora_from_reference(_numpy_tree(jlora), device="cpu")
    else:
        jpayload, payload = jparams, params
    jagg = agg = None
    if agg_name is not None:
        acfg = dict(name=agg_name, num_malicious=1)
        jagg = jax_make_aggregator(JaxAggConfig(**acfg), num_clients=C)
        agg = make_aggregator(AggConfig(**acfg), num_clients=C)
    kw = dict(privacy=priv, compression=comp)
    jkw = dict(privacy=jpriv, compression=jcomp)
    if lora:
        jrnd = jax_fedlora_round(jcfg, jparams, jopt, STEPS, agg=jagg, **jkw)
        rnd = make_fedlora_round(cfg, params, opt, STEPS, agg=agg, **kw)
    else:
        jrnd = jax_fedavg_round(jcfg, jopt, STEPS, agg=jagg, **jkw)
        rnd = make_backbone_fedavg_round(cfg, opt, STEPS, agg=agg, **kw)
    jclient = jax_broadcast(jpayload, C)
    client = broadcast_to_clients(payload, C)
    jstate, state = jax.vmap(jopt.init)(jclient), opt.init(
        client, num_clients=C)
    ef = comp.enabled and comp.error_feedback
    need_key = priv.enabled or (comp.enabled and comp.needs_rng)
    p = tree_count_params(payload)
    jextra, extra = (), ()
    if agg is not None:
        jextra, extra = (jagg.init(jpayload),), (agg.init(payload),)
        if ef:
            jextra += (jnp.zeros((C, p), jnp.float32),)
            extra += (torch.zeros((C, p)),)
    compiled, out = None, []
    for r in range(ROUNDS):
        jb = {k: jnp.asarray(v) for k, v in batches[r].items()}
        b = {k: torch.from_numpy(v.copy()) for k, v in batches[r].items()}
        jargs = (jclient, jstate, jb, jnp.asarray(weights)) + jextra
        draws = None
        if need_key:
            key = jax.random.fold_in(jax.random.PRNGKey(17), r)
            jargs += (key,)
            noise, uniform = _jax_draws(key, p, jpriv, jcomp)
            draws = RoundDraws(
                *(None if a is None else torch.from_numpy(a)
                  for a in (noise, uniform)))
        if compiled is None:
            compiled = jax.jit(jrnd).lower(*jargs).compile(FAST_COMPILE)
        jres = compiled(*jargs)
        res = rnd(client, state, b, torch.from_numpy(weights), *extra,
                  **({} if agg is None else {"draws": draws}))
        jclient, jstate = jres[0], jres[1]
        client, state = res[0], res[1]
        jextra, extra = tuple(jres[3:]), tuple(res[3:])
        out.append(([np.asarray(x) for x in jax.tree_util.tree_leaves(jres)],
                    [x.numpy() for x in tree_leaves(res)]))
    return out


def _check(out):
    for want, got in out:
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert w.shape == g.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("agg_name", [None, "fedavg", "fedavgm", "median",
                                      "krum"])
def test_backbone_fedavg_round_matches_jax(agg_name):
    _check(_run(False, agg_name))


@pytest.mark.parametrize("stage", ["fedavg", "dp_noise", "dp_int8_ef"])
def test_fedlora_round_matches_jax(stage):
    """The adapters (their scale included), the clients' Adam states,
    the losses, the server state and the EF residual; the DP stages on
    the reference's replayed noise and uniforms."""
    priv = _DP if stage.startswith("dp") else None
    comp = dict(kind="int8") if stage == "dp_int8_ef" else None
    out = _run(True, "fedavg", priv, comp)
    _check(out)
    # the adapters moved: B starts at zero and is trained
    assert np.abs(out[-1][1][0]).max() > 0


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["no_agg", "prox", "label_flip"])
def test_round_refusals_match_jax(case):
    """The reference's refusals, word for word: a release stage without
    an aggregator, FedProx's proximal term, and label flipping."""
    jcfg, jparams, cfg, params, _, _ = _model()
    jopt, opt = jax_optim.adam(LR), optim.adam(LR)
    jkw, kw = {}, {}
    if case == "no_agg":
        jkw["privacy"] = JaxPrivacyConfig(**_DP)
        kw["privacy"] = PrivacyConfig(**_DP)
    else:
        a = dict(name="fedprox", prox_mu=0.1) if case == "prox" else {}
        jkw["agg"] = jax_make_aggregator(JaxAggConfig(**a), num_clients=C)
        kw["agg"] = make_aggregator(AggConfig(**a), num_clients=C)
        if case == "label_flip":
            adv = dict(kind="label_flip", num_attackers=1)
            jkw["adversary"] = JaxAdversaryConfig(**adv)
            kw["adversary"] = AdversaryConfig(**adv)
    want = _message(lambda: jax_fedavg_round(jcfg, jopt, STEPS, **jkw))
    assert _message(lambda: make_backbone_fedavg_round(
        cfg, opt, STEPS, **kw)) == want
    assert _message(lambda: make_fedlora_round(
        cfg, params, opt, STEPS, **kw)) == want
    assert _message(lambda: jax_fedlora_round(
        jcfg, jparams, jopt, STEPS, **jkw)) == want
