"""PluralLLM federated runtime (paper §3, §4.3): the PyTorch port of
``repro/core/federated.py``'s ``FederatedGPO`` for the paper's round.

A round, with every training client participating:

  1. the server broadcasts the global GPO params to the C clients;
  2. every client runs ``local_epochs`` Adam steps (Eq. 1), all clients
     at once: the params are client-stacked (leaves (C, ...)), each
     epoch draws one ICL batch per client, and one batched forward and
     backward serves them all (the reference's ``jax.vmap(local_train)``
     written out; one attention launch per layer covers C·H client-
     heads). The loss differentiated is the SUM of the clients' mean
     losses, so each client's gradient is its own;
     With ``AggConfig.prox_mu > 0`` each client's objective gains the
     FedProx term (μ/2)·‖θ − θ_broadcast‖²; the reported loss stays the
     task loss;
  3. clients ship deltas θ_g − θ; with ``FedConfig.privacy`` enabled
     each delta is clipped to ``clip_norm`` and noised before it leaves
     the client (DESIGN.md §9, ``core/privacy.py``; the Rényi accountant
     records the cumulative ε in ``History.round_eps``); with
     ``FedConfig.compression`` enabled the released delta is then int8-
     quantized or top-k-sparsified with an EF21 error-feedback residual
     carried per client in ``ef_resid`` (DESIGN.md §10,
     ``core/compression.py``);
  4. the aggregate stage (``core/pipeline.py``): the configured strategy
     of the registry (``core/aggregation.py``) reduces the deltas with
     w_g = |D_g| / Σ|D_g'| (Eq. 2-3) and applies its server update,
     with the clients' losses passed on (``adaptive`` scores them);
     ``AggConfig.norm_bound > 0`` clips each delta row first. With
     ``use_pallas_aggregation`` the client-axis work, the DP release and
     the codec included, is one CUDA kernel call on the raveled (C, P)
     matrix.

``engine="scan"`` and ``engine="loop"`` both run this per-round driver:
the fused multi-round driver (a captured round replayed as a CUDA graph)
is ROADMAP.md queue A item 6. Partial participation, per-round optimizer
resets, and the availability, adversary and hierarchy stages are not
ported yet; a config that asks for one raises ``NotImplementedError``
naming its ROADMAP item.

Randomness: the initial params come from a CPU ``torch.Generator``
seeded with ``FedConfig.seed``, the training batches and the eval
batches from two CPU generators restarted from ``FedConfig.seed`` at
every ``run`` call (as the reference restarts its key chain); batches
move to the trainer's device after sampling, so a seed gives the same
inputs on every device. The release draws (the σ-scaled DP noise, then
the int8 rounding uniforms, (C, P) each, drawn only where the config
uses them) come from a third generator, on the trainer's device,
restarted from ``FedConfig.seed`` at every ``run`` call too: the card's
draws differ from the CPU's, but runs on one device with and without the
kernels see the same noise. JAX's keys cannot be reproduced in torch, so
for parity with the reference ``FederatedGPO`` takes replay hooks:
``init_params`` (the reference's params as numpy arrays), ``batches``
((round, epoch) -> client-stacked ICLBatch), ``eval_batches`` (round ->
ICLBatch stacked over the held-out groups) and ``release_draws`` (round
-> (noise or None, uniform or None) as numpy arrays).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, GPOConfig
from repro_torch.core import compression as cx
from repro_torch.core import fairness
from repro_torch.core import privacy as dp
from repro_torch.core.aggregation import make_aggregator
from repro_torch.core.fedavg import broadcast_to_clients, normalize_weights
from repro_torch.core.gpo import (
    gpo_loss,
    init_gpo_params,
    params_from_numpy,
    predict_preferences,
)
from repro_torch.core.pipeline import make_pipeline
from repro_torch.data.surveys import ICLBatch, SurveyData, sample_icl_batches
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim import adam
from repro_torch.utils.pytree import (
    tree_count_params,
    tree_leaves,
    tree_map,
    tree_sq_norm,
    tree_sub,
    tree_unflatten,
)

BatchHook = Callable[[int, int], ICLBatch]
EvalHook = Callable[[int], ICLBatch]
DrawsHook = Callable[[int], tuple]
# the release generator's seed offset (any constant apart from the batch
# generators' seeds): the reference's DP noise key tag
_RELEASE_TAG = 0x5A11CE


def _train_step(gpo_cfg: GPOConfig, opt, params, opt_state, batch,
                prox_mu: float = 0.0, anchor=None):
    """One Adam step on ``batch``: for client-stacked params and a batch
    over the same clients, every client's step at once (the summed loss
    gives each client its own gradient). With ``prox_mu > 0`` the
    objective adds (μ/2)·‖θ − anchor‖², which sums over the clients as
    the loss does. Returns (params, opt_state, task loss () or (C,))."""
    p = tree_map(lambda x: x.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = gpo_loss(p, gpo_cfg, batch.ctx_x, batch.ctx_y, batch.tgt_x,
                        batch.tgt_y)
        objective = loss.sum()
        if prox_mu > 0.0:
            objective = objective + 0.5 * prox_mu * tree_sq_norm(
                tree_sub(p, anchor))
        grads = torch.autograd.grad(objective, tree_leaves(p))
    params, opt_state = opt.update(tree_unflatten(p, grads), opt_state, p)
    return params, opt_state, loss.detach()


def _make_local_train(gpo_cfg: GPOConfig, fed_cfg: FedConfig, opt):
    """Local training of every client at once: ``local_epochs`` Adam
    steps on client-stacked params; ``batches(epoch)`` gives the
    epoch's client-stacked ICL batch. With ``AggConfig.prox_mu > 0`` the
    FedProx term anchors every step to the entry params (the round's
    broadcast global). Returns (params, opt_state, per-client mean task
    loss (C,))."""
    mu = fed_cfg.agg.prox_mu

    def local_train(params, opt_state, batches: Callable[[int], ICLBatch]):
        anchor, losses = params, []
        for e in range(fed_cfg.local_epochs):
            params, opt_state, loss = _train_step(gpo_cfg, opt, params,
                                                  opt_state, batches(e), mu,
                                                  anchor)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean(dim=0)

    return local_train


def _make_eval_group(gpo_cfg: GPOConfig, num_options: int):
    """AS of the global model on the held-out groups (Eq. 4): one
    batched ``predict_preferences`` over a batch stacked on the groups
    (through the attention kernel with ``use_pallas_attention``).
    Returns (K,) scores."""

    @torch.no_grad()
    def eval_groups(params, batch: ICLBatch) -> torch.Tensor:
        pred = predict_preferences(params, gpo_cfg, batch.ctx_x,
                                   batch.ctx_y, batch.tgt_x, num_options,
                                   device=batch.ctx_x.device)
        return fairness.alignment_score(pred,
                                        batch.tgt_y.reshape(pred.shape))

    return eval_groups


@dataclass
class History:
    round_loss: list = field(default_factory=list)  # mean client loss / round
    eval_rounds: list = field(default_factory=list)
    eval_scores: list = field(default_factory=list)  # (K,) per eval round
    eval_mean_as: list = field(default_factory=list)
    eval_fi: list = field(default_factory=list)
    eval_cov: list = field(default_factory=list)
    # DP accounting (DESIGN.md §9): cumulative ε at PrivacyConfig.
    # target_delta after each round, counted across every `run` call on
    # the trainer. Empty when the privacy pipeline is disabled; inf per
    # round for clip-only runs (clipping alone carries no DP guarantee).
    round_eps: list = field(default_factory=list)

    def append_eval(self, r: int, scores: np.ndarray, log_every: int,
                    label: str = "[fed] round") -> None:
        s = torch.from_numpy(np.asarray(scores, np.float32))
        self.eval_rounds.append(r)
        self.eval_scores.append(np.asarray(scores))
        self.eval_mean_as.append(float(s.mean()))
        self.eval_fi.append(float(fairness.fairness_index(s)))
        self.eval_cov.append(float(fairness.coefficient_of_variation(s)))
        if log_every and r % log_every == 0:
            print(f"{label} {r:5d} loss={self.round_loss[r]:.4f} "
                  f"AS={self.eval_mean_as[-1]:.4f} "
                  f"FI={self.eval_fi[-1]:.4f}")


def _refuse_unported(fed_cfg: FedConfig) -> None:
    """Raise for any round feature the port does not run yet, naming its
    ROADMAP.md item, rather than running a different round."""
    todo = [
        (fed_cfg.batch_groups > 0, "batch_groups > 0 (partial "
         "participation)", "A.6"),
        (fed_cfg.reset_opt_each_round, "reset_opt_each_round", "A.6"),
        (fed_cfg.avail.enabled, "the availability stage", "A.8"),
        (fed_cfg.adversary.enabled, "the adversary stage", "A.8"),
        (fed_cfg.hierarchy.enabled, "the hierarchy stage", "A.8"),
    ]
    for on, what, item in todo:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md queue A item "
                f"{item[2:]}); the port runs the full-participation "
                "round")


def _generators(seed: int):
    """Two CPU generators, for training and for eval batches."""
    return (torch.Generator().manual_seed(2 * seed),
            torch.Generator().manual_seed(2 * seed + 1))


def _release_generator(seed: int, device: torch.device) -> torch.Generator:
    """The generator of the DP noise and the rounding uniforms, on the
    trainer's device."""
    return torch.Generator(device=device).manual_seed(_RELEASE_TAG + seed)


class FederatedGPO:
    def __init__(self, gpo_cfg: GPOConfig, fed_cfg: FedConfig,
                 data: SurveyData, train_groups, eval_groups, *,
                 device=None, init_params=None,
                 batches: Optional[BatchHook] = None,
                 eval_batches: Optional[EvalHook] = None,
                 release_draws: Optional[DrawsHook] = None):
        self.device = resolve_device(device)
        gpo_cfg = fed_cfg.resolve_gpo(gpo_cfg)  # runtime attention override
        if gpo_cfg.d_embed != data.phi.shape[-1]:
            raise ValueError(f"GPOConfig.d_embed={gpo_cfg.d_embed} but the "
                             f"survey embeds in {data.phi.shape[-1]}")
        fed_cfg.privacy.validate()
        fed_cfg.compression.validate()
        fed_cfg.avail.validate()
        fed_cfg.adversary.validate()
        fed_cfg.hierarchy.validate(len(train_groups))
        _refuse_unported(fed_cfg)
        dp.check_adaptive_privacy(fed_cfg)
        self.gpo_cfg, self.fed_cfg, self.data = gpo_cfg, fed_cfg, data
        self.train_groups = np.asarray(train_groups)
        self.eval_groups = np.asarray(eval_groups)
        num_clients = len(self.train_groups)
        self.weights = normalize_weights(
            data.sizes[torch.as_tensor(self.train_groups)]).to(self.device)
        self.opt = adam(fed_cfg.lr)
        self.agg = make_aggregator(
            fed_cfg.agg, num_clients=num_clients,
            use_pallas=fed_cfg.use_pallas_aggregation)
        self._pipe = make_pipeline(fed_cfg, agg=self.agg)
        if init_params is None:
            self.global_params = init_gpo_params(
                gpo_cfg, torch.Generator().manual_seed(fed_cfg.seed),
                device=self.device)
        else:
            self.global_params = params_from_numpy(init_params, self.device)
        self.server_state = self.agg.init(self.global_params)
        # EF21-style compression residual (DESIGN.md §10): one flat f32
        # row per client, carried across rounds next to the server state
        comp = fed_cfg.compression
        self.ef_resid = (torch.zeros(
            (num_clients, tree_count_params(self.global_params)),
            device=self.device)
            if comp.enabled and comp.error_feedback else None)
        # DP accounting: one sampled Gaussian mechanism a round, at the
        # sampling rate q = 1 of full participation
        self._accountant = dp.make_accountant(fed_cfg.privacy, 1.0)
        self._rounds_elapsed = 0
        self.opt_states = self.opt.init(
            broadcast_to_clients(self.global_params, num_clients),
            num_clients=num_clients)
        self._local_train = _make_local_train(gpo_cfg, fed_cfg, self.opt)
        self._eval = _make_eval_group(gpo_cfg, data.num_options)
        self._batches, self._eval_batches = batches, eval_batches
        self._release_draws = release_draws

    def _eval_mask(self, rounds: int) -> np.ndarray:
        """Rounds that evaluate: every ``eval_every``-th and the last."""
        mask = np.zeros(rounds, np.bool_)
        mask[:: self.fed_cfg.eval_every] = True
        mask[rounds - 1] = True
        return mask

    def _draws(self, r: int, gen: torch.Generator):
        """The round's (noise, uniform) release operands, each (C, P) or
        None: replayed from the hook, or drawn from ``gen`` (noise
        first) where the config uses them."""
        if self._release_draws is not None:
            return tuple(None if a is None else
                         torch.as_tensor(np.array(a, np.float32),
                                         device=self.device)
                         for a in self._release_draws(r))
        priv, comp = self.fed_cfg.privacy, self.fed_cfg.compression
        shape = (len(self.train_groups),
                 tree_count_params(self.global_params))
        noise = (dp.client_noise(gen, shape, priv.sigma)
                 if priv.enabled and priv.noise_multiplier > 0.0 else None)
        uniform = cx.client_uniform(gen, shape) if comp.needs_rng else None
        return noise, uniform

    def _round(self, r: int, gen: torch.Generator,
               gen_release: torch.Generator) -> float:
        """One round; returns the mean client loss."""
        fed = self.fed_cfg
        clients = broadcast_to_clients(self.global_params,
                                       len(self.train_groups))

        def batches(e: int) -> ICLBatch:
            b = (self._batches(r, e) if self._batches is not None else
                 sample_icl_batches(gen, self.data, self.train_groups,
                                    fed.num_context, fed.num_target))
            return b.to(self.device)

        trained, self.opt_states, losses = self._local_train(
            clients, self.opt_states, batches)
        deltas = tree_sub(trained, clients)
        noise, uniform = self._draws(r, gen_release)
        (self.global_params, self.server_state,
         self.ef_resid) = self._pipe.reduce_apply(
            self.server_state, self.global_params, deltas, self.weights,
            losses=losses, idx=None, resid=self.ef_resid, noise=noise,
            uniform=uniform)
        return float(losses.mean())

    def _note_privacy(self, hist: History) -> None:
        """Record the cumulative ε after a finished round (host-side;
        the accountant composes RDP linearly over rounds)."""
        self._rounds_elapsed += 1
        if self.fed_cfg.privacy.enabled:
            hist.round_eps.append(
                self._accountant.epsilon(self._rounds_elapsed)
                if self._accountant else float("inf"))

    def evaluate(self, batch: ICLBatch) -> np.ndarray:
        """Per-group AS (K,) of the global model on a batch stacked over
        the held-out groups."""
        return self._eval(self.global_params,
                          batch.to(self.device)).cpu().numpy()

    def run(self, rounds: int | None = None, log_every: int = 0,
            engine: str | None = None) -> History:
        """Run ``rounds`` rounds and return the metric ``History``.
        ``engine`` ("scan" or "loop", default ``FedConfig.engine``) is
        accepted for parity with the reference; both run the per-round
        driver."""
        rounds = rounds or self.fed_cfg.rounds
        engine = engine or self.fed_cfg.engine
        if engine not in ("scan", "loop"):
            raise ValueError(f"unknown engine {engine!r} (want "
                             "'scan'|'loop')")
        hist = History()
        if rounds <= 0:
            return hist
        fed = self.fed_cfg
        gen_train, gen_eval = _generators(fed.seed + 1)
        gen_release = _release_generator(fed.seed + 1, self.device)
        eval_mask = self._eval_mask(rounds)
        for r in range(rounds):
            hist.round_loss.append(self._round(r, gen_train, gen_release))
            self._note_privacy(hist)
            if eval_mask[r]:
                b = (self._eval_batches(r) if self._eval_batches is not None
                     else sample_icl_batches(gen_eval, self.data,
                                             self.eval_groups,
                                             fed.num_context,
                                             fed.num_target))
                hist.append_eval(r, self.evaluate(b), log_every)
        return hist
