"""PluralLLM federated runtime (paper §3, §4.3): the PyTorch port of
``repro/core/federated.py``'s ``FederatedGPO`` for the paper's round.

A round:

  0. with ``FedConfig.batch_groups`` = m < C (partial participation, a
     beyond-paper ablation) the round's cohort of m clients is drawn
     first, without replacement; else all C clients take part and
     nothing is drawn. The Eq. 2 weights renormalize over the cohort;
  1. the server broadcasts the global GPO params to the m clients;
  2. every client runs ``local_epochs`` Adam steps (Eq. 1), all clients
     at once: the params are client-stacked (leaves (m, ...)), each
     epoch draws one ICL batch per client, and one batched forward and
     backward serves them all (the reference's ``jax.vmap(local_train)``
     written out; one attention launch per layer covers m·H client-
     heads). The loss differentiated is the SUM of the clients' mean
     losses, so each client's gradient is its own. Each client's Adam
     state is gathered from the C-stacked states and scattered back, or,
     with ``reset_opt_each_round``, starts fresh every round.
     With ``AggConfig.prox_mu > 0`` each client's objective gains the
     FedProx term (μ/2)·‖θ − θ_broadcast‖²; the reported loss stays the
     task loss. Under a ``label_flip`` adversary (DESIGN.md §13) the
     round's attackers train on flipped preference targets;
  3. clients ship deltas θ_g − θ; a delta-level adversary corrupts its
     attackers' rows first (``core/adversary.py``: exactly f of the C
     clients a round); with ``FedConfig.privacy`` enabled each delta is
     clipped to ``clip_norm`` and noised before it leaves the client
     (DESIGN.md §9, ``core/privacy.py``; the Rényi accountant records
     the cumulative ε in ``History.round_eps``); with
     ``FedConfig.compression`` enabled the released delta is then int8-
     quantized or top-k-sparsified with an EF21 error-feedback residual
     carried per client in ``ef_resid`` (DESIGN.md §10,
     ``core/compression.py``; the cohort's rows are gathered and
     scattered back), and the accountant composes at q = (m/C) ·
     ``AvailabilityConfig.release_rate()``;
  4. the aggregate stage (``core/pipeline.py``): the configured strategy
     of the registry (``core/aggregation.py``) reduces the deltas with
     w_g = |D_g| / Σ|D_g'| (Eq. 2-3) and applies its server update,
     with the clients' losses passed on (``adaptive`` scores them);
     ``AggConfig.norm_bound > 0`` clips each delta row first, and
     ``HierarchyConfig.num_edges`` = E > 1 reduces per edge of m/E
     clients, then over the E edges (DESIGN.md §14). With
     ``use_pallas_aggregation`` the client-axis work, the DP release and
     the codec included, is one CUDA kernel call on the raveled (C, P)
     matrix (one for each edge under the hierarchy).

With ``FedConfig.avail`` enabled the fault round runs instead (DESIGN.md
§11, ``core/availability.py``): of the sampled clients some are offline,
some crash after training (their update and optimizer step are lost),
some straggle (their released row is buffered and lands ``delay`` rounds
later, discounted by its staleness); the server reduces the fresh rows
and the arrivals with ``RoundPipeline.masked_reduce``, a zero-survivor
round leaves params and server state unchanged, and
``History.round_survivors`` counts the rows absorbed each round. The
hierarchy does not compose with it (``ValueError``), as in the
reference.

``engine="scan"`` and ``engine="loop"`` both run this per-round driver:
the fused multi-round driver (a captured round replayed as a CUDA graph)
is ROADMAP.md queue A.2.

The second engine, ``make_sharded_round``, lays the clients out over
processes (``torch.distributed``, a client mesh of ``launch/mesh.py``):
each process trains its own C/W clients with no collective, and the
round ends in ONE all-reduce of the (P,) partial sum for the linear
family, or an all-gather of the rows for the robust one, two hops on an
edge mesh (``RoundPipeline.sharded_delta``); the server update then runs
on every process alike. Its fault round keeps the schedule on every
process and only the in-flight payloads of its own clients.
``ShardedGPO`` drives it with the draws ``FederatedGPO`` makes for the
whole population, each process keeping its own rows, so an unreplayed
run equals the stacked run with the same seed at any W. Partial
participation stays with ``FederatedGPO``, as in the reference, whose
sharded round trains every client it is handed.

Randomness: the initial params come from a CPU ``torch.Generator``
seeded with ``FedConfig.seed``, the cohorts and the training batches
(the cohort first, then the round's batches) and the eval batches from
two CPU generators restarted from ``FedConfig.seed`` at every ``run``
call (as the reference restarts its key chain); batches move to the
trainer's device after sampling, so a seed gives the same inputs and
cohorts on every device. The release draws (the σ-scaled DP noise, then
the int8 rounding uniforms, (m, P) each, drawn only where the config
uses them) come from a third generator, on the trainer's device,
restarted from ``FedConfig.seed`` at every ``run`` call too: the card's
draws differ from the CPU's, but runs on one device with and without the
kernels see the same noise. The adversary and the availability stage
each draw from generators of their own, created only when the stage is
on, so they move no other stream: the attackers' C uniforms a round on
the CPU, the ``gaussian`` attack's (C, P) normals on the device, and the
fault draws' (C, 3) uniforms and (C,) delays on the CPU, all C clients
every round. JAX's keys cannot be reproduced in torch, so for parity
with the reference ``FederatedGPO`` takes replay hooks: ``init_params``
(the reference's params as numpy arrays), ``participants`` (round -> the
cohort's client indices, in the reference's order; read only when m <
C), ``batches`` ((round, epoch) -> the ICLBatch stacked over the cohort
in that order), ``eval_batches`` (round -> ICLBatch stacked over the
held-out groups), ``release_draws`` (round -> (noise or None, uniform or
None) as numpy arrays, (m, P) each), ``attack_draws`` (round -> (the
attacker mask (C,) bool, the gaussian attack's (C, P) normals or None))
and ``fault_draws`` (round -> (online, crash, straggle, delay), (C,)
each).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, GPOConfig
from repro_torch.core import adversary as byz
from repro_torch.core import availability as av
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
from repro_torch.launch.collectives import Collectives
from repro_torch.launch.mesh import ClientMesh
from repro_torch.launch.mesh import client_axes as mesh_client_axes
from repro_torch.optim import adam
from repro_torch.utils.pytree import (
    tree_count_params,
    tree_index,
    tree_leaves,
    tree_map,
    tree_ravel_clients,
    tree_sq_norm,
    tree_sub,
    tree_unflatten,
    tree_unflatten_from_vector,
)

BatchHook = Callable[[int, int], ICLBatch]
EvalHook = Callable[[int], ICLBatch]
DrawsHook = Callable[[int], tuple]
CohortHook = Callable[[int], "np.ndarray"]
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


def _poison(batch: ICLBatch, attacked: torch.Tensor) -> ICLBatch:
    """The batch with the attacked clients' context and target
    preferences flipped (label_flip; ``attacked`` (C,) bool)."""
    def flip(y):
        y = y.float()
        a = attacked.reshape((-1,) + (1,) * (y.ndim - 1))
        return torch.where(a, byz.flip_preferences(y, batch.num_options), y)

    return batch._replace(ctx_y=flip(batch.ctx_y), tgt_y=flip(batch.tgt_y))


def _make_local_train(gpo_cfg: GPOConfig, fed_cfg: FedConfig, opt):
    """Local training of every client at once: ``local_epochs`` Adam
    steps on client-stacked params; ``batches(epoch)`` gives the
    epoch's client-stacked ICL batch. With ``AggConfig.prox_mu > 0`` the
    FedProx term anchors every step to the entry params (the round's
    broadcast global). ``attacked`` ((C,) bool, label_flip only) poisons
    those clients' preferences before every step. Returns (params,
    opt_state, per-client mean task loss (C,))."""
    mu = fed_cfg.agg.prox_mu

    def local_train(params, opt_state, batches: Callable[[int], ICLBatch],
                    attacked: Optional[torch.Tensor] = None):
        anchor, losses = params, []
        for e in range(fed_cfg.local_epochs):
            batch = batches(e)
            if attacked is not None:
                batch = _poison(batch, attacked)
            params, opt_state, loss = _train_step(gpo_cfg, opt, params,
                                                  opt_state, batch, mu,
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
    # partial participation: each round's cohort (client indices, in the
    # order their batches are stacked). Empty under full participation.
    round_participants: list = field(default_factory=list)
    # fault injection (DESIGN.md §11): the updates the server absorbed
    # each round (fresh releases and buffered arrivals). Empty when
    # AvailabilityConfig is disabled.
    round_survivors: list = field(default_factory=list)
    # the sharded round: each round's (C/W,) losses of the clients this
    # process trained (their mean over all C would take a collective the
    # round does not make). Empty for FederatedGPO.
    client_losses: list = field(default_factory=list)

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


def _generators(seed: int):
    """Two CPU generators, for training and for eval batches."""
    return (torch.Generator().manual_seed(2 * seed),
            torch.Generator().manual_seed(2 * seed + 1))


def _release_generator(seed: int, device: torch.device) -> torch.Generator:
    """The generator of the DP noise and the rounding uniforms, on the
    trainer's device."""
    return torch.Generator(device=device).manual_seed(_RELEASE_TAG + seed)


class _Streams(NamedTuple):
    """A run's generators; a stage's are None while the stage is off."""

    train: torch.Generator
    eval: torch.Generator
    release: torch.Generator
    byz: Optional[torch.Generator] = None  # attacker uniforms (CPU)
    attack_noise: Optional[torch.Generator] = None  # gaussian (device)
    fault: Optional[torch.Generator] = None  # fault draws (CPU)


class _RoundSource:
    """What a round draws and records, the same in both engines: the
    run's generators, the release draws, the attack's and the fault
    draws for the whole population (each replayed from its hook where
    one is given), and the cumulative ε. Its users set ``fed_cfg``,
    ``device``, ``train_groups``, ``global_params``, the hooks and the
    accountant."""

    def _streams(self, seed: int) -> _Streams:
        """A run's generators, restarted from ``seed`` (the stages' only
        while the stage is on)."""
        fed, dev = self.fed_cfg, self.device
        gen_train, gen_eval = _generators(seed)
        s = _Streams(gen_train, gen_eval, _release_generator(seed, dev))
        adv = fed.adversary
        if adv.enabled and self._attack_draws is None:
            tag = 2 * (byz.BYZ_TAG + seed)
            s = s._replace(byz=torch.Generator().manual_seed(tag))
            if adv.kind == "gaussian":
                s = s._replace(attack_noise=torch.Generator(
                    device=dev).manual_seed(tag + 1))
        if fed.avail.enabled and self._fault_draws is None:
            s = s._replace(fault=torch.Generator().manual_seed(
                av.FAULT_TAG + seed))
        return s

    def _draws(self, r: int, gen: torch.Generator, m: int):
        """The round's (noise, uniform) release operands, each (m, P) or
        None: replayed from the hook, or drawn from ``gen`` (noise
        first) where the config uses them."""
        if self._release_draws is not None:
            return tuple(None if a is None else
                         torch.as_tensor(np.array(a, np.float32),
                                         device=self.device)
                         for a in self._release_draws(r))
        priv, comp = self.fed_cfg.privacy, self.fed_cfg.compression
        shape = (m, tree_count_params(self.global_params))
        noise = (dp.client_noise(gen, shape, priv.sigma)
                 if priv.enabled and priv.noise_multiplier > 0.0 else None)
        uniform = cx.client_uniform(gen, shape) if comp.needs_rng else None
        return noise, uniform

    def _attack(self, r: int, s: _Streams):
        """The round's attacker mask over the population ((C,) bool on the
        host) and the gaussian attack's (C, P) normals (or None), replayed
        from the hook or drawn; None while the adversary is off."""
        if not self.fed_cfg.adversary.enabled:
            return None
        if self._attack_draws is not None:
            mask, noise = self._attack_draws(r)
            return (torch.as_tensor(np.array(mask, np.bool_)),
                    None if noise is None else torch.as_tensor(
                        np.array(noise, np.float32), device=self.device))
        c, adv = len(self.train_groups), self.fed_cfg.adversary
        mask = byz.attacker_mask(byz.attacker_draws(s.byz, c),
                                 adv.num_attackers)
        noise = None
        if adv.kind == "gaussian":
            noise = torch.randn(
                (c, tree_count_params(self.global_params)),
                generator=s.attack_noise, device=self.device)
        return mask, noise

    def _faults(self, r: int, s: _Streams) -> av.FaultDraws:
        """The round's fault draws for the population, replayed from the
        hook or drawn."""
        if self._fault_draws is not None:
            online, crash, straggle, delay = (
                torch.as_tensor(np.array(a)) for a in self._fault_draws(r))
            return av.FaultDraws(online.bool(), crash.bool(),
                                 straggle.bool(), delay.to(torch.int32))
        return av.fault_draws(s.fault, len(self.train_groups),
                              self.fed_cfg.avail)

    def _note_privacy(self, hist: History) -> None:
        """Record the cumulative ε after a finished round (host-side;
        the accountant composes RDP linearly over rounds)."""
        self._rounds_elapsed += 1
        if self.fed_cfg.privacy.enabled:
            hist.round_eps.append(
                self._accountant.epsilon(self._rounds_elapsed)
                if self._accountant else float("inf"))


class FederatedGPO(_RoundSource):
    def __init__(self, gpo_cfg: GPOConfig, fed_cfg: FedConfig,
                 data: SurveyData, train_groups, eval_groups, *,
                 device=None, init_params=None,
                 participants: Optional[CohortHook] = None,
                 batches: Optional[BatchHook] = None,
                 eval_batches: Optional[EvalHook] = None,
                 release_draws: Optional[DrawsHook] = None,
                 attack_draws: Optional[DrawsHook] = None,
                 fault_draws: Optional[DrawsHook] = None):
        self.device = resolve_device(device)
        gpo_cfg = fed_cfg.resolve_gpo(gpo_cfg)  # runtime attention override
        if gpo_cfg.d_embed != data.phi.shape[-1]:
            raise ValueError(f"GPOConfig.d_embed={gpo_cfg.d_embed} but the "
                             f"survey embeds in {data.phi.shape[-1]}")
        fed_cfg.privacy.validate()
        fed_cfg.compression.validate()
        fed_cfg.avail.validate()
        fed_cfg.adversary.validate()
        num_clients = len(train_groups)
        # partial participation (beyond-paper ablation): m clients a round
        self.num_participants = min(fed_cfg.batch_groups or num_clients,
                                    num_clients)
        # the edges partition the round's m participants (DESIGN.md §14);
        # the fault round's buffered arrivals break a static edge
        # assignment, so the two do not compose
        fed_cfg.hierarchy.validate(self.num_participants)
        if fed_cfg.hierarchy.enabled and fed_cfg.avail.enabled:
            raise ValueError(
                "hierarchy.num_edges > 1 does not compose with the §11 "
                "fault simulator: the buffered/masked reduce aggregates "
                "flat (edge assignment is static per round)")
        dp.check_adaptive_privacy(fed_cfg)
        byz.check_defense_composition(fed_cfg)
        self.gpo_cfg, self.fed_cfg, self.data = gpo_cfg, fed_cfg, data
        self.train_groups = np.asarray(train_groups)
        self.eval_groups = np.asarray(eval_groups)
        # the Eq. 2 weights of full participation
        self.weights = self._weights(self.train_groups)
        self.opt = adam(fed_cfg.lr)
        self.agg = make_aggregator(
            fed_cfg.agg, num_clients=num_clients,
            use_pallas=fed_cfg.use_pallas_aggregation)
        self._pipe = make_pipeline(fed_cfg, agg=self.agg,
                                   num_clients=num_clients)
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
        # the fault state (DESIGN.md §11): crash-rejoin gates and the
        # stragglers' in-flight buffer; None while the stage is off
        self.fault_state = (av.init_fault_state(
            num_clients, tree_count_params(self.global_params),
            device=self.device) if fed_cfg.avail.enabled else None)
        # DP accounting: one sampled Gaussian mechanism a round, at the
        # realized rate q = (m/C) · release_rate (a client releases when
        # sampled, online and not crashed; 1.0 without faults)
        self._accountant = dp.make_accountant(
            fed_cfg.privacy, (self.num_participants / num_clients)
            * fed_cfg.avail.release_rate())
        self._rounds_elapsed = 0
        self.opt_states = self.opt.init(
            broadcast_to_clients(self.global_params, num_clients),
            num_clients=num_clients)
        self._local_train = _make_local_train(gpo_cfg, fed_cfg, self.opt)
        self._eval = _make_eval_group(gpo_cfg, data.num_options)
        self._participants = participants
        self._batches, self._eval_batches = batches, eval_batches
        self._release_draws = release_draws
        self._attack_draws, self._fault_draws = attack_draws, fault_draws

    def _weights(self, groups) -> torch.Tensor:
        """w_g = |D_g| / Σ|D_g'| over ``groups`` (Eq. 2), on the device."""
        return normalize_weights(
            self.data.sizes[torch.as_tensor(groups)]).to(self.device)

    def _cohort(self, r: int, gen: torch.Generator):
        """The round's participants, (m,) int64 on the CPU in the order
        their batches and draws stack: replayed from the hook, or the
        first m of a permutation drawn from ``gen``. None under full
        participation, which draws nothing."""
        c, m = len(self.train_groups), self.num_participants
        if m == c:
            return None
        if self._participants is not None:
            return torch.as_tensor(np.array(self._participants(r)),
                                   dtype=torch.int64)
        return torch.randperm(c, generator=gen)[:m]

    def _eval_mask(self, rounds: int) -> np.ndarray:
        """Rounds that evaluate: every ``eval_every``-th and the last."""
        mask = np.zeros(rounds, np.bool_)
        mask[:: self.fed_cfg.eval_every] = True
        mask[rounds - 1] = True
        return mask

    def _participants_of(self, r: int, s: _Streams, hist: History):
        """(groups, Eq. 2 weights on the device, the cohort on the host
        and on the device, or None and None) of the round's cohort
        (``_cohort``), recorded in ``hist``."""
        cohort = self._cohort(r, s.train)
        if cohort is None:
            return self.train_groups, self.weights, None, None
        hist.round_participants.append(cohort.tolist())
        groups = self.train_groups[cohort.numpy()]
        return (groups, self._weights(groups), cohort,
                cohort.to(self.device))

    def _train(self, r: int, s: _Streams, groups, idx, attacked):
        """Local training of the round's participants from the global
        params: (client params, trained params, their Adam states,
        per-client losses). The caller scatters the states."""
        fed, m = self.fed_cfg, len(groups)
        clients = broadcast_to_clients(self.global_params, m)
        if fed.reset_opt_each_round:
            opt_in = self.opt.init(clients, num_clients=m)
        else:
            opt_in = (self.opt_states if idx is None
                      else tree_index(self.opt_states, idx))

        def batches(e: int) -> ICLBatch:
            b = (self._batches(r, e) if self._batches is not None else
                 sample_icl_batches(s.train, self.data, groups,
                                    fed.num_context, fed.num_target))
            return b.to(self.device)

        if attacked is not None:
            attacked = attacked.to(self.device)
        trained, opt_out, losses = self._local_train(clients, opt_in,
                                                     batches, attacked)
        return clients, trained, opt_out, losses

    def _round(self, r: int, s: _Streams, hist: History) -> float:
        """One round; returns the mean client loss."""
        groups, weights, cohort, idx = self._participants_of(r, s, hist)
        m, pipe = len(groups), self._pipe
        attack = self._attack(r, s)
        clients, trained, opt_out, losses = self._train(
            r, s, groups, idx,
            None if attack is None else pipe.attacked_flags(attack[0],
                                                            cohort))
        self.opt_states = opt_out if idx is None else tree_map(
            lambda full, sub: full.index_copy(0, idx, sub),
            self.opt_states, opt_out)
        deltas = tree_sub(trained, clients)
        noise, uniform = self._draws(r, s.release, m)
        resid = self.ef_resid
        if resid is not None and idx is not None:
            resid = resid[idx]
        self.global_params, self.server_state, resid = pipe.reduce_apply(
            self.server_state, self.global_params, deltas, weights,
            losses=losses, idx=idx, resid=resid, noise=noise,
            uniform=uniform,
            attack=None if attack is None else pipe.attack_draws(
                *attack, cohort))
        if resid is not None and idx is not None:
            resid = self.ef_resid.index_copy(0, idx, resid)
        self.ef_resid = resid
        return float(losses.mean())

    def _fault_round(self, r: int, s: _Streams, hist: History) -> float:
        """One round under the fault simulator (the reference's
        ``fault_round_step``); returns the mean loss of the clients whose
        local round survived."""
        fed, agg, pipe, dev = self.fed_cfg, self.agg, self._pipe, self.device
        c = len(self.train_groups)
        groups, weights, cohort, idx = self._participants_of(r, s, hist)
        sub = torch.arange(c) if cohort is None else cohort
        attack = self._attack(r, s)
        # the schedule over the population, then restricted to the
        # sampled clients (sampling cannot know who will fail)
        state = self.fault_state
        sched = av.round_schedule(self._faults(r, s), state)
        sampled = torch.zeros((c,), dtype=torch.bool)
        sampled[sub] = True
        sched = sched._replace(
            available=sched.available & sampled,
            fresh=sched.fresh & sampled, crashed=sched.crashed & sampled,
            straggle=sched.straggle & sampled)
        w_full = torch.zeros((c,))
        w_full[sub] = agg.weigh(self.server_state, weights,
                                idx).float().cpu()
        clients, trained, opt_out, losses = self._train(
            r, s, groups, idx,
            None if attack is None else pipe.attacked_flags(attack[0], sub))
        # the local work survives where the client is fresh or straggles:
        # offline clients never trained, crashed ones lost it
        keep = (sched.fresh | sched.straggle)[sub]
        keep_d = keep.to(dev)

        def merge(full, new):
            old = full if idx is None else full[idx]
            k = keep_d.reshape((-1,) + (1,) * (new.ndim - 1))
            rows = torch.where(k, new, old)
            return rows if idx is None else full.index_copy(0, idx, rows)

        self.opt_states = tree_map(merge, self.opt_states, opt_out)
        # per-row release: attack, DP, codec; the EF rows advance where
        # the client released (fresh or straggling)
        noise, uniform = self._draws(r, s.release, len(groups))
        resid = self.ef_resid
        if resid is not None and idx is not None:
            resid = resid[idx]
        rel, new_resid = pipe.release_rows(
            tree_ravel_clients(tree_sub(trained, clients)), noise, uniform,
            resid, attack=None if attack is None else pipe.attack_draws(
                *attack, sub))
        if resid is not None:
            rows = torch.where(keep_d[:, None], new_resid, resid)
            self.ef_resid = (rows if idx is None
                             else self.ef_resid.index_copy(0, idx, rows))
        rel_full = rel if idx is None else torch.zeros(
            (c, rel.shape[1]), device=dev).index_copy(0, idx, rel)
        # fresh rows at full weight and buffered arrivals discounted by
        # their staleness; a client that is both contributes the
        # weight-averaged row
        disc = av.staleness_discount(sched.staleness, fed.agg.staleness_power)
        w_fresh = torch.where(sched.fresh, w_full, 0.0)
        w_arr = torch.where(sched.arrive, state.pending_weight * disc, 0.0)
        w_c = w_fresh + w_arr
        mask_c = w_c > 0.0
        n_released = int(sched.fresh.sum()) + int(sched.arrive.sum())
        if n_released > 0:  # else params and server state stay as they are
            wf, wa, wc = (t.to(dev)[:, None] for t in (w_fresh, w_arr, w_c))
            contrib = torch.where(
                mask_c.to(dev)[:, None],
                (wf * rel_full + wa * state.pending)
                / torch.clamp(wc, min=1e-12), 0.0)
            delta = tree_unflatten_from_vector(
                pipe.masked_reduce(contrib, w_c, mask_c,
                                   trim_frac=fed.agg.trim_frac),
                self.global_params)
            kw = {}
            if agg.buffered:
                kw = dict(mass=w_c.sum().to(dev), released=float(n_released))
            if agg.needs_losses:
                # the server saw only the losses that came with a release
                kw["mask"] = sched.fresh[sub]
            self.global_params, self.server_state = agg.apply(
                self.server_state, self.global_params, delta, losses=losses,
                idx=idx, **kw)
        self.fault_state = av.advance_fault_state(
            state, sched, rel_full, w_full, fed.avail.rejoin_rounds)
        hist.round_survivors.append(n_released)
        n_train = max(float(keep.sum()), 1.0)
        return float(torch.where(keep_d, losses, 0.0).sum() / n_train)

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
        s = self._streams(fed.seed + 1)
        round_fn = self._round if self.fault_state is None \
            else self._fault_round
        eval_mask = self._eval_mask(rounds)
        for r in range(rounds):
            hist.round_loss.append(round_fn(r, s, hist))
            self._note_privacy(hist)
            if eval_mask[r]:
                b = (self._eval_batches(r) if self._eval_batches is not None
                     else sample_icl_batches(s.eval, self.data,
                                             self.eval_groups,
                                             fed.num_context,
                                             fed.num_target))
                hist.append_eval(r, self.evaluate(b), log_every)
        return hist


# ---------------------------------------------------------------------------
# Engine 2: clients laid out over processes (torch.distributed)
# ---------------------------------------------------------------------------
class ShardedOut(NamedTuple):
    """One sharded round's results on one process."""

    params: dict  # the new global params, the same on every process
    opt_states: object  # this process's clients' Adam states
    losses: torch.Tensor  # (C/W,) its clients' mean task losses
    server_state: object  # AggState, the same on every process
    resid: Optional[torch.Tensor] = None  # (C/W, P) EF residual rows
    fault: Optional[av.FaultState] = None  # pending (C/W, P), rest (C,)
    survivors: Optional[int] = None  # rows the fault round absorbed


def _shard_rows(mesh: ClientMesh, axes, num_clients: int) -> torch.Tensor:
    """This process's global client ids: shard s of the W along ``axes``
    owns [s·C/W, (s+1)·C/W)."""
    w = mesh.size(axes)
    if num_clients % w:
        raise ValueError(f"{num_clients} clients do not split over the "
                         f"{w} processes along {tuple(axes)}")
    c_local = num_clients // w
    return mesh.index(axes) * c_local + torch.arange(c_local)


def make_sharded_round(gpo_cfg: GPOConfig, fed_cfg: FedConfig,
                       mesh: ClientMesh, client_axes=("data",), opt=None,
                       agg=None, *, comm: Optional[Collectives] = None
                       ) -> Callable:
    """Returns ``round_fn(global_params, opt_states, batches, weights,
    server_state, *, noise=None, uniform=None, resid=None, attack=None,
    fault=None, fault_draws=None) -> ShardedOut`` for this process.

    ``global_params`` and ``server_state`` are replicated: every process
    holds the same and applies the same server update. ``weights`` are
    the population's (C,) Eq. 2 weights (``agg.weigh`` runs on them
    first, outside the per-process body, as ``adaptive`` needs all C).
    ``opt_states``, ``batches(epoch)`` (an ICLBatch over the process's
    clients), ``noise``, ``uniform`` and ``resid`` are this process's
    C/W rows: shard s of the W processes along ``client_axes`` owns the
    clients [s·C/W, (s+1)·C/W). ``attack`` is the population's attacker
    mask (C,) and gaussian normals (C, P) or None, as ``FederatedGPO``
    draws them. Local training makes no collective; the round ends in
    ``RoundPipeline.sharded_delta``'s (one all-reduce for the linear
    family, an all-gather of rows for the robust one; two hops with
    ``client_axes=("edge", "data")`` under ``HierarchyConfig``), plus
    an all-gather of the losses where the strategy takes them. All go
    through ``comm`` (a ``Collectives`` on ``mesh`` when None), whose
    ledger records each.

    With ``FedConfig.avail`` on, the fault round: ``fault`` is the
    ``FaultState`` with its (C,) schedule state on every process and
    only this process's in-flight rows in ``pending``, ``fault_draws``
    the round's draws for the population. The schedule and the survivor
    weights are computed on every process alike; the opt states and the
    EF rows advance only where the client's work survived; the linear
    family keeps its one all-reduce, the robust family gathers the
    blended rows; a zero-survivor round leaves params and server state
    as they are and makes no collective."""
    gpo_cfg = fed_cfg.resolve_gpo(gpo_cfg)
    fed_cfg.privacy.validate()
    fed_cfg.compression.validate()
    fed_cfg.avail.validate()
    fed_cfg.adversary.validate()
    num_clients = fed_cfg.num_clients
    fed_cfg.hierarchy.validate(num_clients)
    axes = tuple(client_axes)
    if fed_cfg.hierarchy.enabled and (
            len(axes) < 2
            or mesh.shape[axes[0]] != fed_cfg.hierarchy.num_edges):
        # the two hops need a leading "edge" axis of exactly num_edges
        # processes in front of the intra-edge axes (make_edge_mesh)
        raise ValueError(
            f"hierarchy.num_edges={fed_cfg.hierarchy.num_edges} requires "
            f"client_axes=('edge', ...) with a leading axis of that size; "
            f"got {axes} on mesh {mesh.shape}")
    if fed_cfg.hierarchy.enabled and fed_cfg.avail.enabled:
        raise ValueError(
            "hierarchy.num_edges > 1 does not compose with the §11 fault "
            "simulator: the buffered/masked reduce aggregates flat")
    byz.check_defense_composition(fed_cfg)
    gids = _shard_rows(mesh, axes, num_clients)
    c_local, dev = len(gids), mesh.device
    gids_dev = gids.to(dev)
    opt = opt or adam(fed_cfg.lr)
    if agg is None:
        agg = make_aggregator(fed_cfg.agg, num_clients=num_clients,
                              use_pallas=fed_cfg.use_pallas_aggregation)
    pipe = make_pipeline(fed_cfg, agg=agg, num_clients=num_clients)
    local_train = _make_local_train(gpo_cfg, fed_cfg, opt)
    comm = comm or Collectives(mesh)
    comp, avail = fed_cfg.compression, fed_cfg.avail
    ef = comp.enabled and comp.error_feedback

    def train(global_params, opt_states, batches, attack):
        """This process's clients' local epochs: (deltas, opt states,
        losses). No collective."""
        flags = None if attack is None else pipe.attacked_flags(attack[0],
                                                                gids)
        clients = broadcast_to_clients(global_params, c_local)
        trained, opt_out, losses = local_train(
            clients, opt_states, batches,
            None if flags is None else flags.to(dev))
        return tree_sub(trained, clients), opt_out, losses

    def all_losses(losses):
        return comm.all_gather(losses, axes) if agg.needs_losses else None

    def round_body(global_params, opt_states, batches, weights,
                   server_state, noise, uniform, resid, attack):
        deltas, opt_out, losses = train(global_params, opt_states,
                                        batches, attack)
        delta, new_resid = pipe.sharded_delta(
            deltas, weights[gids_dev], global_params, axes=axes, comm=comm,
            resid=resid, noise=noise, uniform=uniform,
            attack=None if attack is None else pipe.attack_draws(*attack,
                                                                 gids))
        new_global, server_state = agg.apply(
            server_state, global_params, delta, losses=all_losses(losses),
            idx=None)
        return ShardedOut(new_global, opt_out, losses, server_state,
                          new_resid)

    def fault_body(global_params, opt_states, batches, weights,
                   server_state, noise, uniform, resid, attack, fault,
                   draws):
        # the schedule over the population, the same on every process
        sched = av.round_schedule(draws, fault)
        w_full = weights.float().cpu()
        deltas, opt_out, losses = train(global_params, opt_states,
                                        batches, attack)
        # the local work survives where the client is fresh or straggles
        keep = (sched.fresh | sched.straggle)[gids].to(dev)
        opt_out = tree_map(lambda new, old: torch.where(
            keep.reshape((-1,) + (1,) * (new.dim() - 1)), new, old),
            opt_out, opt_states)
        rel, new_r = pipe.release_rows(
            tree_ravel_clients(deltas), noise, uniform, resid,
            attack=None if attack is None else pipe.attack_draws(*attack,
                                                                 gids),
            axes=axes, comm=comm)
        if ef:
            resid = torch.where(keep[:, None], new_r, resid)
        disc = av.staleness_discount(sched.staleness,
                                     fed_cfg.agg.staleness_power)
        w_fresh = torch.where(sched.fresh, w_full, 0.0)
        w_arr = torch.where(sched.arrive, fault.pending_weight * disc, 0.0)
        w_c = w_fresh + w_arr
        mask_c = w_c > 0.0
        n_released = int(sched.fresh.sum()) + int(sched.arrive.sum())
        if n_released > 0:  # else params and server state stay
            wf, wa, wc = (t[gids].to(dev)[:, None]
                          for t in (w_fresh, w_arr, w_c))
            contrib = torch.where(
                mask_c[gids].to(dev)[:, None],
                (wf * rel + wa * fault.pending)
                / torch.clamp(wc, min=1e-12), 0.0)
            delta = tree_unflatten_from_vector(
                pipe.masked_reduce_sharded(
                    contrib, w_c, mask_c, gids, axes, comm,
                    trim_frac=fed_cfg.agg.trim_frac), global_params)
            kw = {}
            if agg.buffered:
                kw = dict(mass=w_c.sum().to(dev), released=float(n_released))
            if agg.needs_losses:
                kw["mask"] = sched.fresh
            global_params, server_state = agg.apply(
                server_state, global_params, delta,
                losses=all_losses(losses), idx=None, **kw)
        fault = av.advance_fault_state(fault, sched, rel, w_full,
                                       avail.rejoin_rounds, rows=gids)
        return ShardedOut(global_params, opt_out, losses, server_state,
                          resid, fault, n_released)

    def round_fn(global_params, opt_states, batches, weights, server_state,
                 *, noise=None, uniform=None, resid=None, attack=None,
                 fault=None, fault_draws=None) -> ShardedOut:
        weights = agg.weigh(server_state, weights, None)
        if avail.enabled:
            return fault_body(global_params, opt_states, batches, weights,
                              server_state, noise, uniform, resid, attack,
                              fault, fault_draws)
        return round_body(global_params, opt_states, batches, weights,
                          server_state, noise, uniform, resid, attack)

    return round_fn


def _batch_rows(batch: ICLBatch, rows: slice) -> ICLBatch:
    """The rows ``rows`` of a client-stacked batch."""
    return ICLBatch(*(f[rows] for f in batch[:-1]),
                    num_options=batch.num_options)


class ShardedGPO(_RoundSource):
    """``make_sharded_round`` driven on this process's clients, round
    after round, with what ``FederatedGPO`` draws for the whole
    population (its generators, seeded from ``FedConfig.seed``, or its
    replay hooks, which take the same arguments and return the same
    population-wide values): each process keeps its own rows of the
    training batches, the release noise and uniforms, and the gaussian
    attack's normals. So at any W, an unreplayed run equals
    ``FederatedGPO``'s with the same seed, up to the order of the
    round's sums. Runs on ``mesh.device``; full participation only.

    ``global_params`` and ``server_state`` are the same on every
    process; ``opt_states``, ``ef_resid`` and ``fault_state.pending``
    hold this process's rows; ``comm.ledger`` records the collectives.
    ``run`` returns a ``History`` with ``client_losses`` (this process's
    clients' losses each round), ``round_survivors`` under faults and
    ``round_eps`` under DP; it evaluates nothing."""

    def __init__(self, gpo_cfg: GPOConfig, fed_cfg: FedConfig,
                 data: SurveyData, train_groups, mesh: ClientMesh, *,
                 client_axes=None, init_params=None,
                 batches: Optional[BatchHook] = None,
                 release_draws: Optional[DrawsHook] = None,
                 attack_draws: Optional[DrawsHook] = None,
                 fault_draws: Optional[DrawsHook] = None):
        self.device = mesh.device
        gpo_cfg = fed_cfg.resolve_gpo(gpo_cfg)
        if gpo_cfg.d_embed != data.phi.shape[-1]:
            raise ValueError(f"GPOConfig.d_embed={gpo_cfg.d_embed} but the "
                             f"survey embeds in {data.phi.shape[-1]}")
        self.train_groups = np.asarray(train_groups)
        c = len(self.train_groups)
        if c != fed_cfg.num_clients:
            raise ValueError(f"{c} training groups for "
                             f"FedConfig.num_clients={fed_cfg.num_clients}")
        if (fed_cfg.batch_groups and fed_cfg.batch_groups < c) \
                or fed_cfg.reset_opt_each_round:
            raise ValueError("partial participation and per-round "
                             "optimizer resets run on FederatedGPO: the "
                             "sharded round trains every client it holds")
        self.gpo_cfg, self.fed_cfg, self.data = gpo_cfg, fed_cfg, data
        axes = tuple(client_axes or mesh_client_axes(mesh))
        gids = _shard_rows(mesh, axes, c)
        self.rows = slice(int(gids[0]), int(gids[-1]) + 1)
        self.opt = adam(fed_cfg.lr)
        self.agg = make_aggregator(fed_cfg.agg, num_clients=c,
                                   use_pallas=fed_cfg.use_pallas_aggregation)
        self.comm = Collectives(mesh)
        self._round_fn = make_sharded_round(gpo_cfg, fed_cfg, mesh, axes,
                                            opt=self.opt, agg=self.agg,
                                            comm=self.comm)
        if init_params is None:
            self.global_params = init_gpo_params(
                gpo_cfg, torch.Generator().manual_seed(fed_cfg.seed),
                device=self.device)
        else:
            self.global_params = params_from_numpy(init_params, self.device)
        self.server_state = self.agg.init(self.global_params)
        self.weights = normalize_weights(
            data.sizes[torch.as_tensor(self.train_groups)]).to(self.device)
        p, c_local = tree_count_params(self.global_params), len(gids)
        comp = fed_cfg.compression
        self.ef_resid = (torch.zeros((c_local, p), device=self.device)
                         if comp.enabled and comp.error_feedback else None)
        self.fault_state = (av.init_fault_state(c, 0)._replace(
            pending=torch.zeros((c_local, p), device=self.device))
            if fed_cfg.avail.enabled else None)
        self.opt_states = self.opt.init(
            broadcast_to_clients(self.global_params, c_local),
            num_clients=c_local)
        self._accountant = dp.make_accountant(fed_cfg.privacy,
                                              fed_cfg.avail.release_rate())
        self._rounds_elapsed = 0
        self._batches, self._release_draws = batches, release_draws
        self._attack_draws, self._fault_draws = attack_draws, fault_draws

    def run(self, rounds: int) -> History:
        """Run ``rounds`` rounds (the generators restart from the seed at
        every call, as ``FederatedGPO.run``'s do)."""
        fed, hist, rows = self.fed_cfg, History(), self.rows
        s = self._streams(fed.seed + 1)
        for r in range(rounds):
            attack = self._attack(r, s)
            draws = self._faults(r, s) if fed.avail.enabled else None

            def batches(e: int, r=r) -> ICLBatch:
                b = (self._batches(r, e) if self._batches is not None else
                     sample_icl_batches(s.train, self.data,
                                        self.train_groups, fed.num_context,
                                        fed.num_target))
                return _batch_rows(b, rows).to(self.device)

            noise, uniform = (None if a is None else a[rows] for a in
                              self._draws(r, s.release,
                                          len(self.train_groups)))
            out = self._round_fn(
                self.global_params, self.opt_states, batches, self.weights,
                self.server_state, noise=noise, uniform=uniform,
                resid=self.ef_resid, attack=attack, fault=self.fault_state,
                fault_draws=draws)
            self.global_params, self.opt_states = out.params, out.opt_states
            self.server_state, self.ef_resid = out.server_state, out.resid
            self.fault_state = out.fault
            hist.client_losses.append(out.losses.cpu().numpy())
            if out.survivors is not None:
                hist.round_survivors.append(out.survivors)
            self._note_privacy(hist)
        return hist
