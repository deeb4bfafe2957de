"""The port's training path against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed, or the JAX package's own draws
passed over as numpy (JAX's keys cannot be reproduced in torch). The
JAX side runs its Pallas kernels in interpret mode, the port's kernel
wrappers their plain versions. Tolerances:

* attention gradients: atol 1e-5, rtol 1e-5 (float32, the same math in
  another summation order);
* gpo_loss and its gradients, one Adam step: 1e-5;
* three replayed FederatedGPO rounds (two for CentralizedGPO), for
  FedAvg and for the aggregation strategies and round features the port
  runs (fedavgm, median, krum, adaptive, FedProx, norm bounding, the DP
  release and the int8 and top-k codecs): round losses rtol 1e-4, eval
  AS / FI / CoV atol 1e-4, final params, server state and EF residual
  max-abs 1e-4 (Adam divides by sqrt(v) + 1e-8, which magnifies the
  float32 differences of gradients near zero), cumulative ε rtol 1e-12.
  Two codec runs take an allowance of one coordinate a round, with at
  most 12 coordinates beyond 1e-4: with the clip and the int8 codec
  together, one quantization level s (the reference's scale can sit an
  ulp off the port's, its norms summed in another order and its division
  by 127 compiled to a reciprocal multiply, which may flip a rounding
  decision by one level); with top-k, one kept entry of size τ (Adam's
  first steps leave the top 1% of |Δ| within 1e-7 of 2·lr, so a float
  difference can swap two near-tied entries across the threshold). The
  params take w_max times that a round, the residual that a round.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AggConfig as JaxAggConfig
from repro.configs import CompressionConfig as JaxCompressionConfig
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import GPOConfig as JaxGPOConfig
from repro.configs import PrivacyConfig as JaxPrivacyConfig
from repro.core import CentralizedGPO as JaxCentralizedGPO
from repro.core import FederatedGPO as JaxFederatedGPO
from repro.core import compression as jax_cx
from repro.core import fairness as jax_fairness
from repro.core import gpo as jax_gpo
from repro.core import privacy as jax_dp
from repro.data import SurveyConfig as JaxSurveyConfig
from repro.data import make_survey_data as jax_make_survey_data
from repro.data import sample_icl_batch as jax_sample_icl_batch
from repro.data import split_groups as jax_split_groups
from repro.kernels import gpo_attention as jax_gpo_attention
from repro.kernels.ref import ref_gpo_attention_grads as jax_ref_grads
from repro.optim import adam as jax_adam
from repro.optim.optimizers import clip_by_global_norm as jax_clip
from repro_torch.configs import (
    AdversaryConfig,
    AggConfig,
    AvailabilityConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
    HierarchyConfig,
    PrivacyConfig,
)
from repro_torch.core import (
    CentralizedGPO,
    FederatedGPO,
    fairness,
    gpo_apply,
    gpo_loss,
    params_from_numpy,
)
from repro_torch.core import pipeline
from repro_torch.core.fedavg import broadcast_to_clients
from repro_torch.data import ICLBatch, SurveyData
from repro_torch.kernels import gpo_attention
from repro_torch.kernels.ref import (
    ref_gpo_attention,
    ref_gpo_attention_bwd,
    ref_gpo_attention_bwd_dkdv,
    ref_gpo_attention_bwd_dq,
)
from repro_torch.optim import adam, clip_by_global_norm
from repro_torch.core import compression as cx
from repro_torch.core import privacy as dp
from repro_torch.utils.pytree import tree_count_params, tree_leaves, tree_map

ga = importlib.import_module("repro_torch.kernels.gpo_attention")

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(d_embed=16, d_model=32, num_layers=2, num_heads=2, d_ff=64)
FED = dict(local_epochs=2, num_context=4, num_target=4, eval_every=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# attention backward
# ---------------------------------------------------------------------------
BWD_SHAPES = [  # (S, num_ctx, hd): S a multiple of 16 or not, num_ctx at
    (32, 0, 32), (32, 1, 24), (32, 31, 32), (32, 32, 24),  # its edges
    (37, 0, 24), (37, 1, 32), (37, 36, 24), (37, 37, 32),
    (48, 20, 32), (45, 17, 24)]


@pytest.mark.parametrize("s,num_ctx,hd", BWD_SHAPES)
def test_attention_bwd_closed_form_matches_autograd_and_reference(
        s, num_ctx, hd):
    rng = np.random.default_rng(s * 100 + num_ctx + hd)
    q, k, v, do = (rng.standard_normal((3, s, hd)).astype(np.float32)
                   for _ in range(4))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o, lse = ref_gpo_attention(tq, tk, tv, num_ctx=num_ctx)
    auto = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    got = ref_gpo_attention_bwd(_t(q), _t(k), _t(v), o.detach(),
                                lse.detach(), _t(do), num_ctx=num_ctx)
    want = jax_ref_grads(*(jnp.asarray(a) for a in (q, k, v, do)),
                         num_ctx=num_ctx)
    for g, a, w in zip(got, auto, want):
        np.testing.assert_allclose(g.numpy(), a.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the kernel wrappers on CPU tensors: the plain versions, uncounted
    before = (ga.gpo_attention_bwd_dq.launches,
              ga.gpo_attention_bwd_dkdv.launches)
    delta = (_t(do) * o.detach()).sum(-1)
    ops = (_t(q), _t(k), _t(v), _t(do), lse.detach(), delta)
    dq = ga.gpo_attention_bwd_dq(*ops, num_ctx=num_ctx)
    dk, dv = ga.gpo_attention_bwd_dkdv(*ops, num_ctx=num_ctx)
    assert torch.equal(dq, ref_gpo_attention_bwd_dq(*ops, num_ctx=num_ctx))
    pdk, pdv = ref_gpo_attention_bwd_dkdv(*ops, num_ctx=num_ctx)
    assert torch.equal(dk, pdk) and torch.equal(dv, pdv)
    assert (ga.gpo_attention_bwd_dq.launches,
            ga.gpo_attention_bwd_dkdv.launches) == before


@pytest.mark.parametrize("s,num_ctx,hd", [
    (32, 0, 24), (37, 1, 32), (48, 47, 24), (40, 40, 32), (37, 20, 32)])
def test_gpo_attention_function_matches_jax_grad(s, num_ctx, hd):
    """Gradients through the GPOAttention Function (CPU: plain forward
    and backward) against jax.grad through the Pallas custom VJP."""
    rng = np.random.default_rng(7 * s + num_ctx)
    h = 2
    q, k, v, w = (rng.standard_normal((s, h, hd)).astype(np.float32)
                  for _ in range(4))

    def jloss(q, k, v):
        return jnp.sum(jax_gpo_attention(q, k, v, num_ctx=num_ctx)
                       * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    loss = (gpo_attention(tq, tk, tv, num_ctx=num_ctx) * _t(w)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


# ---------------------------------------------------------------------------
# the loss, client-stacked params, Adam
# ---------------------------------------------------------------------------
def _batch(rng, b=None, m=12, t=8, d=16):
    lead = () if b is None else (b,)
    return (rng.standard_normal(lead + (m, d)).astype(np.float32),
            rng.random(lead + (m,)).astype(np.float32),
            rng.standard_normal(lead + (t, d)).astype(np.float32),
            rng.random(lead + (t,)).astype(np.float32))


@pytest.mark.parametrize("learn_sigma", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_gpo_loss_and_grads_match_jax(learn_sigma, kernel):
    kw = dict(SMALL, learn_sigma=learn_sigma, use_pallas_attention=kernel)
    cfg, jcfg = GPOConfig(**kw), JaxGPOConfig(**kw)
    jp = jax_gpo.init_gpo_params(jcfg, jax.random.PRNGKey(3))
    ins = _batch(np.random.default_rng(1))
    want_l, want_g = jax.value_and_grad(jax_gpo.gpo_loss)(
        jp, jcfg, *(jnp.asarray(a) for a in ins))
    p = tree_map(lambda x: x.requires_grad_(),
                 params_from_numpy(_np_tree(jp), "cpu"))
    loss = gpo_loss(p, cfg, *(_t(a) for a in ins))
    grads = torch.autograd.grad(loss, tree_leaves(p))
    np.testing.assert_allclose(loss.item(), float(want_l), **TOL)
    for g, w in zip(grads, jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("kernel", [False, True])
def test_client_stacked_params_give_each_client_its_own_loss_and_grad(
        kernel):
    """Params with a leading client axis against a batch over the same
    clients: per-client losses and, from their sum, per-client gradients
    equal to the reference's per client."""
    kw = dict(SMALL, use_pallas_attention=kernel)
    cfg, jcfg = GPOConfig(**kw), JaxGPOConfig(**kw)
    c = 3
    jps = [jax_gpo.init_gpo_params(jcfg, jax.random.PRNGKey(i))
           for i in range(c)]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                     *map(_np_tree, jps))
    ins = _batch(np.random.default_rng(2), b=c)
    p = tree_map(lambda x: x.requires_grad_(),
                 params_from_numpy(stacked, "cpu"))
    losses = gpo_loss(p, cfg, *(_t(a) for a in ins))
    grads = torch.autograd.grad(losses.sum(), tree_leaves(p))
    assert losses.shape == (c,)
    for i in range(c):
        wl, wg = jax.value_and_grad(jax_gpo.gpo_loss)(
            jps[i], jcfg, *(jnp.asarray(a[i]) for a in ins))
        np.testing.assert_allclose(losses[i].item(), float(wl), **TOL)
        for g, w in zip(grads, jax.tree_util.tree_leaves(wg)):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), **TOL)
    # broadcast params and a batch over the clients == the unstacked
    # forward batched over the same inputs
    one = params_from_numpy(_np_tree(jps[0]), "cpu")
    mu_b, _ = gpo_apply(broadcast_to_clients(one, c), cfg,
                        *(_t(a) for a in ins[:3]))
    mu_u, _ = gpo_apply(one, cfg, *(_t(a) for a in ins[:3]))
    np.testing.assert_allclose(mu_b.detach().numpy(), mu_u.detach().numpy(),
                               **TOL)
    with pytest.raises(ValueError, match="client-stacked"):
        gpo_apply(broadcast_to_clients(one, c + 1), cfg,
                  *(_t(a) for a in ins[:3]))


def test_fedprox_step_matches_jax():
    """One local Adam step with the FedProx term (μ/2)·‖θ − anchor‖² on
    client-stacked params, against the reference's objective per client
    (jax.grad of the task loss plus the term, then its Adam); the loss
    reported is the task loss alone."""
    from repro.utils.pytree import tree_sq_norm as jax_sq_norm
    from repro.utils.pytree import tree_sub as jax_sub
    from repro_torch.core.federated import _train_step

    cfg, jcfg = GPOConfig(**SMALL), JaxGPOConfig(**SMALL)
    c, mu = 2, 0.5
    jps = [jax_gpo.init_gpo_params(jcfg, jax.random.PRNGKey(i))
           for i in range(2 * c)]
    params, anchors = jps[:c], jps[c:]  # anchors far off: a large term
    ins = _batch(np.random.default_rng(4), b=c)
    jopt = jax_adam(3e-4)
    want = []
    for i in range(c):
        def objective(p):
            task = jax_gpo.gpo_loss(p, jcfg, *(jnp.asarray(a[i])
                                               for a in ins))
            return task + 0.5 * mu * jax_sq_norm(jax_sub(p, anchors[i])), \
                task

        (_, task), g = jax.value_and_grad(objective, has_aux=True)(params[i])
        new, _ = jopt.update(g, jopt.init(params[i]), params[i])
        want.append((float(task), new))

    def stack(trees):
        return params_from_numpy(jax.tree_util.tree_map(
            lambda *xs: np.stack(xs), *map(_np_tree, trees)), "cpu")

    opt = adam(3e-4)
    p = stack(params)
    batch = ICLBatch(*(_t(a) for a in ins), tgt_q=None, num_options=5)
    new, _, loss = _train_step(cfg, opt, p, opt.init(p, num_clients=c),
                               batch, mu, stack(anchors))
    plain, _, _ = _train_step(cfg, opt, p, opt.init(p, num_clients=c),
                              batch)
    for i in range(c):
        np.testing.assert_allclose(loss[i].item(), want[i][0], **TOL)
        for a, b in zip(tree_leaves(new), jax.tree_util.tree_leaves(
                want[i][1])):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b), **TOL)
    # the term moved the step: Adam's first step is lr·sign(grad), so a
    # sign flipped by the pull toward the anchor moves a parameter
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                     tree_leaves(plain)))


@pytest.mark.parametrize("clients", [None, 4])
def test_adam_update_matches_jax(clients):
    """Two Adam steps (with gradient clipping on) on a params tree, one
    model or client-stacked with a per-client step count."""
    rng = np.random.default_rng(5)
    lead = () if clients is None else (clients,)
    shapes = {"a": (3, 4), "b": (5,)}
    p = {k: rng.standard_normal(lead + s).astype(np.float32)
         for k, s in shapes.items()}
    gs = [{k: (rng.standard_normal(lead + s) * 10.0 ** -i).astype(
        np.float32) for k, s in shapes.items()} for i in range(2)]
    jopt, opt = jax_adam(3e-4, grad_clip=2.0), adam(3e-4, grad_clip=2.0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    if clients is None:
        js, ts = jopt.init(jp), opt.init(tp)
        jupd = jopt.update
    else:
        js, ts = jax.vmap(jopt.init)(jp), opt.init(tp, num_clients=clients)
        jupd = jax.vmap(jopt.update)
        assert ts.step.shape == (clients,)
    for g in gs:
        jp, js = jupd({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = opt.update({k: _t(v) for k, v in g.items()}, ts, tp)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   **TOL)
    np.testing.assert_array_equal(ts.step.numpy(), np.asarray(js.step))


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(6)
    g = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal((7,)).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        want, wn = jax_clip({k: jnp.asarray(v) for k, v in g.items()},
                            max_norm)
        got, n = clip_by_global_norm({k: _t(v) for k, v in g.items()},
                                     max_norm)
        np.testing.assert_allclose(n.item(), float(wn), **TOL)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **TOL)


@pytest.mark.parametrize("scores", [
    [0.61, 0.72, 0.55, 0.68], [0.5, 0.5, 0.5], [0.9, 0.1]])
def test_cov_and_fairness_index_match_jax(scores):
    s = np.asarray(scores, np.float32)
    for port, ref in ((fairness.coefficient_of_variation,
                       jax_fairness.coefficient_of_variation),
                      (fairness.fairness_index, jax_fairness.fairness_index)):
        np.testing.assert_allclose(port(_t(s)).item(),
                                   float(ref(jnp.asarray(s))), **TOL)


@pytest.mark.parametrize("losses", [
    [1.0, 0.6, 0.3, 0.2, 0.19], [0.5, 0.5, 0.5], [0.2, 0.4, 0.9],
    [1.0, 0.9], []])
def test_convergence_round_matches_jax(losses):
    assert fairness.convergence_round(losses) == \
        jax_fairness.convergence_round(np.asarray(losses))


# ---------------------------------------------------------------------------
# whole rounds on the reference's draws
# ---------------------------------------------------------------------------
def _jax_setup():
    data = jax_make_survey_data(JaxSurveyConfig(num_groups=6,
                                                num_questions=30,
                                                d_embed=16))
    tr, ev = jax_split_groups(data)
    port = SurveyData(*(torch.from_numpy(np.array(a)) for a in data))
    return data, port, tr, ev


def _stack(batches) -> ICLBatch:
    return ICLBatch(*(np.stack([np.asarray(getattr(b, f)) for b in batches])
                      for f in ICLBatch._fields[:-1]),
                    num_options=batches[0].num_options)


def _fed_draws(data, fcfg, tr, ev, rounds):
    """The reference FederatedGPO's batches, rebuilt from its key chain:
    PRNGKey(seed+1) split 3 per round (_dispatch_round), the round key
    split into (subsample, train) (round_step), the train key into one
    key per client, each client key into one per local epoch
    (_make_local_train), the eval key into one per held-out group."""
    key = jax.random.PRNGKey(fcfg.seed + 1)
    m, t, epochs = fcfg.num_context, fcfg.num_target, fcfg.local_epochs
    train, evals = {}, {}
    for r in range(rounds):
        key, k_round, k_eval = jax.random.split(key, 3)
        _, k_train = jax.random.split(k_round)
        ekeys = [jax.random.split(ck, epochs)
                 for ck in jax.random.split(k_train, len(tr))]
        for e in range(epochs):
            train[r, e] = _stack([
                jax_sample_icl_batch(ekeys[c][e], data, int(g), m, t)
                for c, g in enumerate(tr)])
        evals[r] = _stack([
            jax_sample_icl_batch(k, data, int(g), m, t)
            for k, g in zip(jax.random.split(k_eval, len(ev)), ev)])
    return train, evals


def _assert_runs_agree(h, jh, params, jparams):
    np.testing.assert_allclose(h.round_loss, jh.round_loss, rtol=1e-4,
                               atol=0)
    assert h.eval_rounds == jh.eval_rounds
    for key in ("eval_mean_as", "eval_fi", "eval_cov"):
        np.testing.assert_allclose(getattr(h, key), getattr(jh, key),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.stack(h.eval_scores),
                               np.stack(jh.eval_scores), rtol=0, atol=1e-4)
    for p, jp in zip(tree_leaves(params),
                     jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-4)


def _replayed_pair(agg: dict, kernels: bool, rounds: int):
    """The reference FederatedGPO (engine="loop") and the port's, with
    the aggregation config ``agg`` and the kernel flags, the port
    replaying the reference's init and draws for ``rounds`` rounds."""
    data, port_data, tr, ev = _jax_setup()
    flags = dict(use_pallas_attention=kernels,
                 use_pallas_aggregation=kernels)
    jfed = JaxFederatedGPO(JaxGPOConfig(**SMALL),
                           JaxFedConfig(num_clients=len(tr), engine="loop",
                                        agg=JaxAggConfig(**agg), **FED,
                                        **flags), data, tr, ev)
    fcfg = FedConfig(num_clients=len(tr), agg=AggConfig(**agg), **FED,
                     **flags)
    train, evals = _fed_draws(data, fcfg, tr, ev, rounds=rounds)
    fed = FederatedGPO(GPOConfig(**SMALL), fcfg, port_data, tr, ev,
                       device="cpu", init_params=_np_tree(jfed.global_params),
                       batches=lambda r, e: train[r, e],
                       eval_batches=lambda r: evals[r])
    return fed, jfed


# a bound under every client's delta norm (about 0.08 after two Adam
# steps at 3e-4 over this model's parameters), so every row is clipped
NORM_BOUND = 0.02


@pytest.mark.parametrize("kernels,agg", [
    (False, {}), (True, {}),
    (True, dict(name="fedavgm", momentum=0.9)),
    (True, dict(name="median")),
    (True, dict(name="krum", num_malicious=1)),
    (True, dict(name="adaptive", fair_temp=1.0)),
    (True, dict(name="fedprox", prox_mu=0.01)),
    (True, dict(norm_bound=NORM_BOUND))],
    ids=["dense", "kernels", "fedavgm", "median", "krum", "adaptive",
         "fedprox", "norm_bound"])
def test_federated_rounds_match_jax_on_replayed_draws(kernels, agg,
                                                      monkeypatch):
    clipped = []
    real_clip = pipeline.norm_clip_rows

    def clip(vecs, bound):
        clipped.append(float(torch.linalg.vector_norm(vecs, dim=1).min()))
        return real_clip(vecs, bound)

    monkeypatch.setattr(pipeline, "norm_clip_rows", clip)
    fed, jfed = _replayed_pair(agg, kernels, rounds=3)
    jh = jfed.run(rounds=3)
    h = fed.run(rounds=3)
    assert len(h.round_loss) == 3 and h.eval_rounds == [0, 1, 2]
    _assert_runs_agree(h, jh, fed.global_params, jfed.global_params)
    np.testing.assert_array_equal(fed.opt_states.step.numpy(),
                                  [6] * len(fed.train_groups))
    state, jstate = fed.server_state, jfed.server_state
    assert int(state.step) == int(jstate.step) == 3
    pairs = []
    if not isinstance(state.m, torch.Tensor):  # fedavgm's momentum tree
        pairs += zip(tree_leaves(state.m),
                     jax.tree_util.tree_leaves(jstate.m))
    if isinstance(state.scores, dict):  # adaptive's ema and seen
        pairs += [(state.scores[k], jstate.scores[k])
                  for k in state.scores]
    want = {"fedavgm": len(tree_leaves(state.m)), "adaptive": 2}
    assert len(pairs) == want.get(agg.get("name"), 0)
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    if agg.get("norm_bound"):  # every round clipped every row
        assert len(clipped) == 3 and min(clipped) > NORM_BOUND
    else:
        assert not clipped


def _jax_release_draws(jfed, rounds):
    """The reference's DP noise and rounding uniforms, rebuilt from its
    key chain as in _fed_draws: the round's per-client training keys
    fold them out (privacy.client_noise, compression.client_uniform)."""
    fcfg, priv, comp = jfed.fed_cfg, jfed.fed_cfg.privacy, \
        jfed.fed_cfg.compression
    c = len(jfed.train_groups)
    shape = (c, tree_count_params(_np_tree(jfed.global_params)))
    key = jax.random.PRNGKey(fcfg.seed + 1)
    draws = {}
    for r in range(rounds):
        key, k_round, _ = jax.random.split(key, 3)
        keys = jax.random.split(jax.random.split(k_round)[1], c)
        noise = (np.asarray(jax_dp.client_noise(keys, shape, priv.sigma))
                 if priv.enabled and priv.noise_multiplier > 0 else None)
        uniform = (np.asarray(jax_cx.client_uniform(keys, shape))
                   if comp.needs_rng else None)
        draws[r] = (noise, uniform)
    return draws


# a DP clip under round 0's delta norms (0.068-0.072 at this size) and
# round 1's largest two (0.0456-0.050), over the other two
DP_CLIP = 0.045
DP = dict(clip_norm=DP_CLIP, noise_multiplier=0.8)
PRIVATE = {
    "dp_noise": dict(privacy=DP),
    "int8_ef": dict(compression=dict(kind="int8")),
    "topk_ef": dict(compression=dict(kind="topk", topk_frac=0.01)),
    "dp_int8_ef": dict(privacy=DP, compression=dict(kind="int8")),
    "dp_median": dict(privacy=DP, agg=dict(name="median")),
    "norm_bound_dp_noise": dict(privacy=DP,
                                agg=dict(norm_bound=NORM_BOUND)),
}


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("label", list(PRIVATE))
def test_private_rounds_match_jax_on_replayed_draws(label, kernels,
                                                    monkeypatch):
    """Three rounds with the DP release and the codecs, the port
    replaying the reference's init, batches, noise and uniforms: loss,
    eval, params, the EF residual and the cumulative ε."""
    taus = []
    real_thresholds = cx.topk_thresholds

    def thresholds(vecs, frac):
        taus.append(real_thresholds(vecs, frac))
        return taus[-1]

    monkeypatch.setattr(cx, "topk_thresholds", thresholds)
    spec = PRIVATE[label]
    data, port_data, tr, ev = _jax_setup()
    flags = dict(use_pallas_attention=kernels,
                 use_pallas_aggregation=kernels)
    kw = dict(agg=spec.get("agg", {}), privacy=spec.get("privacy", {}),
              compression=spec.get("compression", {}))
    jfcfg = JaxFedConfig(
        num_clients=len(tr), engine="loop", **FED, **flags,
        agg=JaxAggConfig(**kw["agg"]),
        privacy=JaxPrivacyConfig(**kw["privacy"]),
        compression=JaxCompressionConfig(**kw["compression"]))
    jfed = JaxFederatedGPO(JaxGPOConfig(**SMALL), jfcfg, data, tr, ev)
    fcfg = FedConfig(num_clients=len(tr), **FED, **flags,
                     agg=AggConfig(**kw["agg"]),
                     privacy=PrivacyConfig(**kw["privacy"]),
                     compression=CompressionConfig(**kw["compression"]))
    train, evals = _fed_draws(data, fcfg, tr, ev, rounds=3)
    draws = _jax_release_draws(jfed, rounds=3)
    fed = FederatedGPO(GPOConfig(**SMALL), fcfg, port_data, tr, ev,
                       device="cpu", init_params=_np_tree(jfed.global_params),
                       batches=lambda r, e: train[r, e],
                       eval_batches=lambda r: evals[r],
                       release_draws=lambda r: draws[r])
    jh = jfed.run(rounds=3)
    h = fed.run(rounds=3)
    assert len(h.round_loss) == 3
    np.testing.assert_allclose(h.round_loss, jh.round_loss, rtol=1e-4,
                               atol=0)
    for key in ("eval_mean_as", "eval_fi", "eval_cov"):
        np.testing.assert_allclose(getattr(h, key), getattr(jh, key),
                                   rtol=0, atol=1e-4)
    # the size of one coordinate that may flip a round (module doc)
    level = 0.0
    if fcfg.privacy.enabled and fcfg.compression.kind == "int8":
        noise_max = max(np.abs(n).max() for n, _ in draws.values())
        # |u| <= clip + |noise| + |resid|, |resid| < s
        level = 1.01 * (DP_CLIP + noise_max) / 127.0
    elif fcfg.compression.kind == "topk":
        assert len(taus) == 3
        level = max(float(t.max()) for t in taus)
    w_max = float(fed.weights.max())
    pairs = [(p, jp, 3 * w_max * level) for p, jp in zip(
        tree_leaves(fed.global_params),
        jax.tree_util.tree_leaves(jfed.global_params))]
    if fed.ef_resid is not None:
        pairs.append((fed.ef_resid, jfed.ef_resid, 3 * level))
    for p, jp, allowance in pairs:
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-4 + allowance)
        assert (np.abs(p.numpy() - np.asarray(jp)) > 1e-4).sum() <= 12
    assert (fed.ef_resid is None) == (jfed.ef_resid is None) == (
        not fcfg.compression.enabled)
    if fcfg.privacy.enabled:
        acct = dp.RdpAccountant(0.8, 1.0, fcfg.privacy.target_delta)
        np.testing.assert_allclose(h.round_eps, jh.round_eps, rtol=1e-12)
        np.testing.assert_allclose(
            h.round_eps, [acct.epsilon(r) for r in (1, 2, 3)], rtol=1e-12)
    else:
        assert h.round_eps == jh.round_eps == []


def test_adaptive_scores_after_a_round_match_jax():
    """The round passes the clients' losses to the aggregate stage, so
    adaptive's per-client loss EMA is seeded after one round, as the
    reference's is."""
    fed, jfed = _replayed_pair(dict(name="adaptive"), False, rounds=1)
    jfed.run(rounds=1)
    fed.run(rounds=1)
    scores, jscores = fed.server_state.scores, jfed.server_state.scores
    np.testing.assert_array_equal(scores["seen"].numpy(),
                                  np.ones(len(fed.train_groups)))
    for key in ("ema", "seen"):
        np.testing.assert_allclose(scores[key].numpy(),
                                   np.asarray(jscores[key]), rtol=1e-5,
                                   atol=0)
    assert float(scores["ema"].min()) > 0.0


def test_centralized_epochs_match_jax_on_replayed_draws():
    data, port_data, tr, ev = _jax_setup()
    jcfg = JaxFedConfig(num_clients=len(tr), **FED)
    jcen = JaxCentralizedGPO(JaxGPOConfig(**SMALL), jcfg, data, tr, ev)
    init = _np_tree(jcen.params)
    # the reference's chain: PRNGKey(seed+2) split 3 per epoch, the epoch
    # key into (permutation, steps), the step key into one per group
    key = jax.random.PRNGKey(jcfg.seed + 2)
    m, t = jcfg.num_context, jcfg.num_target
    steps, evals = {}, {}
    for e in range(2):
        key, k_epoch, k_eval = jax.random.split(key, 3)
        k_perm, k_steps = jax.random.split(k_epoch)
        order = jax.random.permutation(k_perm, jnp.asarray(tr, jnp.int32))
        for i, (k, g) in enumerate(zip(jax.random.split(k_steps, len(tr)),
                                       order)):
            steps[e, i] = ICLBatch(*jax_sample_icl_batch(k, data, int(g),
                                                         m, t))
        evals[e] = _stack([
            jax_sample_icl_batch(k, data, int(g), m, t)
            for k, g in zip(jax.random.split(k_eval, len(ev)), ev)])
    cen = CentralizedGPO(GPOConfig(**SMALL), FedConfig(num_clients=len(tr),
                                                       **FED),
                         port_data, tr, ev, device="cpu", init_params=init,
                         batches=lambda e, i: steps[e, i],
                         eval_batches=lambda e: evals[e])
    jh = jcen.run(epochs=2)
    h = cen.run(epochs=2)
    _assert_runs_agree(h, jh, cen.params, jcen.params)


def test_unreplayed_runs_are_seeded_and_device_independent_of_hooks():
    """Without hooks the trainer draws from generators seeded by
    FedConfig.seed: two trainers agree exactly, each run restarts the
    stream, and the loss falls."""
    _, port_data, tr, ev = _jax_setup()
    fcfg = FedConfig(num_clients=len(tr), **FED)
    runs = [FederatedGPO(GPOConfig(**SMALL), fcfg, port_data, tr, ev,
                         device="cpu").run(rounds=6) for _ in range(2)]
    assert runs[0].round_loss == runs[1].round_loss
    assert np.mean(runs[0].round_loss[3:]) < np.mean(runs[0].round_loss[:3])


@pytest.mark.parametrize("change", [
    dict(batch_groups=2), dict(reset_opt_each_round=True),
    dict(avail=AvailabilityConfig(online_prob=0.5)),
    dict(adversary=AdversaryConfig(kind="sign_flip", num_attackers=1)),
    dict(hierarchy=HierarchyConfig(num_edges=2))])
def test_unported_round_features_raise(change):
    _, port_data, tr, ev = _jax_setup()
    fcfg = FedConfig(num_clients=len(tr), **FED, **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        FederatedGPO(GPOConfig(**SMALL), fcfg, port_data, tr, ev,
                     device="cpu")


def test_train_launcher_checkpoint_is_served(tmp_path, capsys):
    """launch.train on the CPU at GPOConfig() width, then launch.serve
    restores and serves its checkpoint: the train -> serve loop."""
    from repro_torch.launch import serve, train

    train.main(["--trainer", "gpo", "--rounds", "1", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])
    serve.main(["--gpo", "--restore", "--ckpt-dir", str(tmp_path),
                "--device", "cpu", "--requests", "4"])
    out = capsys.readouterr().out
    assert "1 rounds on cpu" in out and "ckpt_00000001.npz" in out
    assert "served 4/4 requests" in out


@pytest.mark.parametrize("flags,priv,comp", [
    (["--clip-norm", "0.475", "--noise-multiplier", "0.8", "--compress",
      "int8"], dict(clip_norm=0.475, noise_multiplier=0.8),
     dict(kind="int8")),
    (["--compress", "topk", "--topk-frac", "0.05", "--no-error-feedback",
      "--dp-delta", "1e-6"], dict(target_delta=1e-6),
     dict(kind="topk", topk_frac=0.05, error_feedback=False))],
    ids=["dp_int8", "topk_no_ef"])
def test_train_launcher_dp_and_codec_flags(flags, priv, comp, capsys,
                                          monkeypatch):
    """The reference's DP and codec flags reach the FedConfig; one round
    on the CPU at GPOConfig() width, with the final ε printed where the
    release is noised."""
    from repro_torch.launch import train

    built = []

    def spy(gcfg, fcfg, *a, **k):
        built.append(fcfg)
        return FederatedGPO(gcfg, fcfg, *a, **k)

    monkeypatch.setattr(train, "FederatedGPO", spy)
    train.main(["--trainer", "gpo", "--rounds", "1", "--device", "cpu",
                *flags])
    out = capsys.readouterr().out
    assert built[0].privacy == PrivacyConfig(**priv)
    assert built[0].compression == CompressionConfig(**comp)
    assert "1 rounds on cpu" in out
    if built[0].privacy.noise_multiplier > 0:
        eps = dp.RdpAccountant(0.8, 1.0).epsilon(1)
        assert f"privacy: eps={eps:.3f} at delta=1e-05 after 1 rounds" in out
    else:
        assert "privacy:" not in out
