"""LM training, port against reference on the CPU: the cross-entropy
loss, ``lm_loss`` and one ``make_train_step`` step on the smoke variants
of qwen2-0.5b (dense), granite-moe-3b-a800m (MoE, its aux loss in the
loss) and mamba2-780m (SSM), the microbatched and rematerialised steps
against the plain one, the four optimizers and the three schedules, and
the kernels' refusal under grad.

Both packages start from the same weights (numpy draws into the
reference's tree, ``test_torch_zoo_dense.reference_params``, carried
across by ``params_from_reference``) and the same batches
(``synthetic_lm_batches`` is numpy in both). f32 throughout; the loss
within 1e-5 and the params after the step within 1e-4 (absolute), the
optimizers within 1e-6, the gradients within 1e-4 of each leaf's
largest (the zoo tests' forward tolerance; mamba2's chunked scan moves
its embedding gradient by 3e-5 of the largest). The train step's Adam takes eps 1e-6: at the default 1e-8 a
gradient entry of order eps (granite's experts have a few) maps to an
update m/(√v + eps) set by its last bits, which moves a param by up to
lr between two correct f32 gradients. The reference runs jitted, one
compile a configuration (``FAST_COMPILE``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.trainer import lm_loss as jax_lm_loss
from repro.core.trainer import make_train_step as jax_make_train_step
from repro.data.lm_data import LMDataConfig as JaxLMDataConfig
from repro.data.lm_data import synthetic_lm_batches as jax_lm_batches
from repro.models.layers import cross_entropy_loss as jax_ce
from repro import optim as jax_optim
from repro_torch import optim
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.core import lm_loss, make_train_step
from repro_torch.core.trainer import value_and_grad
from repro_torch.data import LMDataConfig, synthetic_lm_batches
from repro_torch.models import (
    hidden_states,
    init_params,
    params_from_reference,
    train_logits,
)
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_backbone import _numpy_tree
from test_torch_zoo_dense import FAST_COMPILE, reference_params

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
OPT_TOL = 1e-6
LR = 1e-3
EPS = 1e-6
GRAD_TOL = 1e-4
B, S = 4, 16
ARCHS = ("qwen2-0.5b", "granite-moe-3b-a800m", "mamba2-780m")


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
def _model(arch):
    """(reference cfg, reference params, port cfg, port params, one
    batch as numpy) for the smoke variant of ``arch``."""
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    cfg = smoke_variant(get_arch(arch))
    jparams = reference_params(jcfg, 3)
    params = params_from_reference(cfg, _numpy_tree(jparams), device="cpu")
    batch = next(jax_lm_batches(JaxLMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=5)))
    return jcfg, jparams, cfg, params, {k: np.asarray(v)
                                        for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_step(arch):
    """The reference's loss, its gradient and its params after one Adam
    step."""
    jcfg, jparams, _, _, batch = _model(arch)
    opt = jax_optim.adam(LR, eps=EPS)
    step = jax_make_train_step(jcfg, opt)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = opt.init(jparams)

    def both(p, s, b):
        loss, grads = jax.value_and_grad(
            lambda q: jax_lm_loss(q, jcfg, b))(p)
        return loss, grads, step(p, s, b)

    loss, grads, (new, _, m) = jax.jit(both).lower(
        jparams, state, jb).compile(FAST_COMPILE)(jparams, state, jb)
    leaves = jax.tree_util.tree_leaves
    return (float(loss), [np.asarray(g) for g in leaves(grads)],
            float(m["loss"]), [np.asarray(x) for x in leaves(new)])


@pytest.mark.parametrize("cap", [None, 30.0], ids=["plain", "softcap"])
def test_cross_entropy_matches_jax(cap):
    rng = np.random.default_rng(0)
    logits = (8.0 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7), dtype=np.int32)
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), cap)
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), cap)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # bf16 logits are taken in f32
    got16 = cross_entropy_loss(torch.from_numpy(logits).bfloat16(),
                               torch.from_numpy(labels), cap)
    assert got16.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_train_step_match_jax(arch):
    """lm_loss (CE + the MoE aux), its gradient, and one Adam step: the
    loss, the step's reported loss and every param after it."""
    _, _, cfg, params, batch = _model(arch)
    want_loss, want_grads, want_step_loss, want_params = \
        _reference_step(arch)
    loss, grads = value_and_grad(
        lambda p: lm_loss(p, cfg, _port_batch(batch)), params)
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    for g, w in zip(tree_leaves(grads), want_grads, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())
    opt = optim.adam(LR, eps=EPS)
    new, state, m = make_train_step(cfg, opt)(params, opt.init(params),
                                              _port_batch(batch))
    assert abs(float(m["loss"]) - want_step_loss) <= LOSS_TOL
    assert int(state.step) == 1
    got = tree_leaves(new)
    assert len(got) == len(want_params)
    for g, w in zip(got, want_params):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=PARAM_TOL)
    if cfg.is_moe:  # the aux loss is in the loss
        assert float(loss) > float(cross_entropy_loss(
            forward_logits(params, cfg, batch), _port_batch(batch)["labels"]))


def forward_logits(params, cfg, batch):
    return train_logits(params, cfg,
                        tokens=_port_batch(batch)["tokens"])[0]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b",
                                  "whisper-small"])
def test_microbatch_and_remat_match_the_plain_step(arch):
    """microbatch=2 adds two half-batch gradients and divides (the same
    mean as one batch up to f32 rounding); remat recomputes each layer
    in the backward pass (the same gradient). The hybrid's super-block
    loop and whisper's encoder and cross K/V differentiate too."""
    cfg = smoke_variant(get_arch(arch))
    gen = torch.Generator().manual_seed(1)
    params = init_params(cfg, gen, device="cpu")
    batch = next(synthetic_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=6),
        device="cpu"))
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.randn((B, cfg.enc_seq_len, cfg.d_model),
                                          generator=gen)
    opt = optim.sgd(0.5)  # the gradient itself shows in the params
    base = make_train_step(cfg, opt)(params, opt.init(params), batch)
    for kw in (dict(microbatch=2), dict(remat=True),
               dict(microbatch=2, remat=True)):
        got = make_train_step(cfg, opt, **kw)(params, opt.init(params),
                                              batch)
        assert abs(float(got[2]["loss"]) - float(base[2]["loss"])) <= 1e-5
        for g, w in zip(tree_leaves(got[0]), tree_leaves(base[0])):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5)


def _opt_tree(rng):
    """A small tree with a 1-D, a 2-D and a stacked 3-D leaf."""
    return {"b": rng.standard_normal(6).astype(np.float32),
            "layers": {"w": rng.standard_normal((2, 5, 4)).astype(
                np.float32)},
            "w": rng.standard_normal((5, 3)).astype(np.float32)}


OPTIMIZERS = {
    "adam_schedule": lambda m: m.adam(m.linear_warmup_cosine(1e-2, 2, 6),
                                      grad_clip=1.0),
    "adamw": lambda m: m.adamw(3e-2, weight_decay=0.1),
    "adafactor": lambda m: m.adafactor(m.cosine_schedule(5e-2, 4)),
    "sgd": lambda m: m.sgd(0.1, momentum=0.9, grad_clip=2.0),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_jax(name):
    """Three updates on the same grads: the params and every state
    leaf."""
    rng = np.random.default_rng(11)
    tree = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    jopt, opt = OPTIMIZERS[name](jax_optim), OPTIMIZERS[name](optim)
    jp = jax.tree.map(jnp.asarray, tree)
    p = tree_map(torch.from_numpy, tree)
    js, s = jopt.init(jp), opt.init(p)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        p, s = opt.update(tree_map(torch.from_numpy, g), s, p)
    for got, want in zip(tree_leaves(p) + tree_leaves(s),
                         jax.tree_util.tree_leaves(jp)
                         + jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=OPT_TOL, atol=OPT_TOL)
    assert type(s).__name__ == type(js).__name__


def test_adam_schedule_is_per_client_on_stacked_state():
    """On a client-stacked state (step (C,)) the schedule is taken at
    each client's own step: a client stepped twice moves as it does
    alone."""
    sched = optim.linear_warmup_cosine(1e-2, 2, 6)
    opt = optim.adam(sched)
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
    state = opt.init({"w": w}, num_clients=2)
    state = state._replace(step=torch.tensor([0, 3], dtype=torch.int32))
    new, _ = opt.update({"w": g}, state, {"w": w})
    for i, t in enumerate((0, 3)):
        one = opt.init({"w": w[i]})
        one = one._replace(step=torch.tensor(t, dtype=torch.int32))
        alone, _ = opt.update({"w": g[i]}, one, {"w": w[i]})
        torch.testing.assert_close(new["w"][i], alone["w"], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_jax(name):
    """At step 0, in the warmup, at its end, mid-way, at the total and
    past it; on a () step and on a (C,) one."""
    make = {"constant": lambda m: m.constant_schedule(3e-4),
            "cosine": lambda m: m.cosine_schedule(3e-4, 10, 0.2),
            "warmup_cosine": lambda m: m.linear_warmup_cosine(3e-4, 4, 20)}
    sched, jsched = make[name](optim), make[name](jax_optim)
    steps = np.array([0, 1, 3, 4, 10, 20, 27], np.int32)
    for t in steps:
        got = sched(torch.tensor(t, dtype=torch.int32))
        want = jsched(jnp.asarray(t, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got = sched(torch.from_numpy(steps))
    want = np.array([float(jsched(jnp.asarray(t))) for t in steps])
    assert got.shape == steps.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_kernels_refuse_grad_and_the_train_step_takes_the_plain_branch():
    """hidden_states through the kernels under grad, with params that
    require it, raises through refuse_grad; lm_loss (the plain branch)
    differentiates."""
    _, _, cfg, params, batch = _model("qwen2-0.5b")
    grad_params = tree_map(lambda x: x.detach().requires_grad_(True),
                           params)
    tokens = torch.from_numpy(batch["tokens"])
    with pytest.raises(RuntimeError, match="takes the plain branch"):
        hidden_states(grad_params, cfg, tokens=tokens, use_kernels=True)
    loss = lm_loss(grad_params, cfg, _port_batch(batch))
    loss.backward()
    assert grad_params["embed"].grad is not None


def test_ssd_decay_gradient_stays_finite_where_the_exp_overflows():
    """The plain SSD's intra-chunk decay at mamba2's chunk 128 with
    strong decays: cs_i - cs_j above the diagonal passes exp's f32
    range. The values are the reference's (0 above the diagonal) and
    the gradient is finite, where exp-then-mask gives 0 · inf."""
    from repro.models.ssm import _segsum_decay as jax_segsum_decay
    from repro_torch.models.ssm import _segsum_decay

    rng = np.random.default_rng(13)
    da = -rng.uniform(0.5, 2.0, (2, 3, 128)).astype(np.float32)
    want = np.asarray(jax_segsum_decay(jnp.asarray(da)))
    x = torch.from_numpy(da).requires_grad_(True)
    got = _segsum_decay(x)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-30)  # f32's subnormals flush apart
    # the values are exp-then-mask's, bit for bit
    cs = torch.cumsum(x.detach(), dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    below = torch.tril(torch.ones((128, 128), dtype=torch.bool))
    assert torch.equal(got.detach(),
                       torch.where(below, torch.exp(diff), 0.0))
    assert not torch.isfinite(torch.exp(diff)).all()
    (got * torch.linspace(0, 1, 128)).sum().backward()
    assert torch.isfinite(x.grad).all()
    jgrad = jax.grad(lambda a: (jax_segsum_decay(a) * jnp.linspace(
        0, 1, 128)).sum())(jnp.asarray(da))
    assert not np.isfinite(np.asarray(jgrad)).all()
