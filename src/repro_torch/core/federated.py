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

A round is two halves. The host half (``_stage``) makes every draw the
round takes on the CPU, in the order above: the cohort, the attackers,
the E epochs' ICL draws, and the replay hooks' values
(``RoundOperands``). The ICL draws are staged as question indices only
(``ICLDraw``: the cohort's groups and one (E, m, nq) index tensor, from
one ``sample_icl_indices`` call); replayed batches (the ``batches=``
hook) are staged whole. The device half (``_round_body``) takes only
tensors and the device generators: it gathers the round's batches from
the trainer's device copies of ``phi`` and ``prefs`` in one advanced
index, draws the release noise and uniforms and the gaussian attack's
normals there, trains, releases, reduces and applies, and calls nothing
that reads a tensor back to the host. The eval is staged and gathered
the same way. The two drivers run the same halves:

* ``engine="loop"``: one round at a time, the operands copied to the
  device, the loss read back every round (one host sync a round).
* ``engine="scan"`` (the default; the reference's fused driver,
  DESIGN.md §3), on a CUDA device (``_CapturedRound``, which
  ``CentralizedGPO`` shares for its epoch): the round body
  is captured once a trainer into a CUDA graph and the eval into a
  second graph on the first one's memory pool; each round copies its
  operands through pinned, double-buffered host memory into the graph's
  static operands and replays the graph, and the device generators are
  registered with the graph (``register_generator_state``) and re-seeded
  in place at every ``run``. The losses and eval scores stay on the
  device for a block of rounds (the whole run, or ``log_every`` rounds)
  and reach the host once a block. A capture or replay that fails
  raises; no round falls back to the loop. Off CUDA there are no
  graphs, and ``"scan"`` runs the per-round driver of ``"loop"``.

The fault round keeps its schedule on the host (it reads the survivors'
count and weights there every round), so under ``FedConfig.avail`` both
engines run the per-round driver (ROADMAP.md queue A.2).

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
uses them) come from a third generator, on the trainer's device, which
the trainer keeps and re-seeds in place from ``FedConfig.seed`` at every
``run`` call (a captured round draws from the generator it was captured
with): the card's draws differ from the CPU's, but runs on one device
with and without the kernels, and under either engine, see the same
noise. The adversary and the availability stage
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

import time
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
from repro_torch.data.surveys import (
    ICLBatch,
    ICLDraw,
    SurveyData,
    gather_icl_batch,
    sample_icl_batches,
    sample_icl_indices,
)
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


class _Streams(NamedTuple):
    """A run's generators; a stage's are None while the stage is off."""

    train: torch.Generator
    eval: torch.Generator
    release: torch.Generator
    byz: Optional[torch.Generator] = None  # attacker uniforms (CPU)
    attack_noise: Optional[torch.Generator] = None  # gaussian (device)
    fault: Optional[torch.Generator] = None  # fault draws (CPU)


class RoundState(NamedTuple):
    """What a round carries to the next: the global params, the C
    clients' Adam states, the server state and the EF residual (None
    without error feedback)."""

    params: dict
    opt_states: object
    server_state: object
    ef_resid: Optional[torch.Tensor]


class RoundOperands(NamedTuple):
    """A round's inputs, drawn by the host half (``FederatedGPO._stage``)
    as CPU tensors and then staged on the device. The device generators'
    draws are not here: the round body makes them."""

    # the E local epochs' batches: drawn, an ICLDraw of the cohort's (m,)
    # groups and (E, m, nq) question indices, gathered by the round body;
    # replayed (the batches= hook), E client-stacked ICLBatches, whole
    batches: object
    weights: torch.Tensor  # (m,) Eq. 2 weights over the cohort
    idx: Optional[torch.Tensor] = None  # (m,) int64 cohort; None: all C
    attack_mask: Optional[torch.Tensor] = None  # (C,) bool attackers
    attack_noise: Optional[torch.Tensor] = None  # (C, P), replayed
    noise: Optional[torch.Tensor] = None  # (m, P) DP noise, replayed
    uniform: Optional[torch.Tensor] = None  # (m, P) uniforms, replayed


def _on(tree, device):
    """``tree`` with every tensor leaf moved to ``device``."""
    return tree_unflatten(tree, [
        x.to(device) if isinstance(x, torch.Tensor) else x
        for x in tree_leaves(tree)])


class _RoundSource:
    """What a round draws and records, the same in both engines: the
    run's generators, the release draws, the attack's and the fault
    draws for the whole population (each replayed from its hook where
    one is given), and the cumulative ε. Its users set ``fed_cfg``,
    ``device``, ``train_groups``, ``global_params``, the hooks and the
    accountant."""

    def _device_generator(self, name: str, seed: int) -> torch.Generator:
        """The trainer's generator ``name`` on its device, made once and
        re-seeded in place with ``seed``: a captured round keeps drawing
        from the generator objects it was captured with."""
        gens = self.__dict__.setdefault("_device_gens", {})
        if name not in gens:
            gens[name] = torch.Generator(device=self.device)
        return gens[name].manual_seed(seed)

    def _streams(self, seed: int) -> _Streams:
        """A run's generators, restarted from ``seed`` (the stages' only
        while the stage is on). The device ones are the trainer's own
        (``_device_generator``)."""
        fed = self.fed_cfg
        gen_train, gen_eval = _generators(seed)
        s = _Streams(gen_train, gen_eval,
                     self._device_generator("release", _RELEASE_TAG + seed))
        adv = fed.adversary
        if adv.enabled and self._attack_draws is None:
            tag = 2 * (byz.BYZ_TAG + seed)
            s = s._replace(byz=torch.Generator().manual_seed(tag))
            if adv.kind == "gaussian":
                s = s._replace(attack_noise=self._device_generator(
                    "attack_noise", tag + 1))
        if fed.avail.enabled and self._fault_draws is None:
            s = s._replace(fault=torch.Generator().manual_seed(
                av.FAULT_TAG + seed))
        return s

    def _release_host(self, r: int) -> tuple:
        """The round's replayed (noise, uniform) release operands as CPU
        tensors, (m, P) each or None; (None, None) without the hook."""
        if self._release_draws is None:
            return None, None
        return tuple(None if a is None else
                     torch.as_tensor(np.array(a, np.float32))
                     for a in self._release_draws(r))

    def _release_drawn(self, gen: torch.Generator, m: int) -> tuple:
        """(noise, uniform), each (m, P) or None, drawn from ``gen`` on
        its device (noise first) where the config uses them."""
        priv, comp = self.fed_cfg.privacy, self.fed_cfg.compression
        shape = (m, tree_count_params(self.global_params))
        noise = (dp.client_noise(gen, shape, priv.sigma)
                 if priv.enabled and priv.noise_multiplier > 0.0 else None)
        uniform = cx.client_uniform(gen, shape) if comp.needs_rng else None
        return noise, uniform

    def _draws(self, r: int, gen: torch.Generator, m: int):
        """The round's (noise, uniform) release operands on the device,
        each (m, P) or None: replayed from the hook, or drawn from
        ``gen``."""
        if self._release_draws is not None:
            return tuple(None if a is None else a.to(self.device)
                         for a in self._release_host(r))
        return self._release_drawn(gen, m)

    def _attack_host(self, r: int, s: _Streams):
        """The round's attacker mask over the population ((C,) bool) and
        the hook's gaussian (C, P) normals (or None), on the host,
        replayed from the hook or drawn; None while the adversary is
        off."""
        if not self.fed_cfg.adversary.enabled:
            return None
        if self._attack_draws is not None:
            mask, noise = self._attack_draws(r)
            return (torch.as_tensor(np.array(mask, np.bool_)),
                    None if noise is None else torch.as_tensor(
                        np.array(noise, np.float32)))
        c, adv = len(self.train_groups), self.fed_cfg.adversary
        return byz.attacker_mask(byz.attacker_draws(s.byz, c),
                                 adv.num_attackers), None

    def _attack_noise_drawn(self, s: _Streams) -> Optional[torch.Tensor]:
        """The gaussian attack's (C, P) standard normals drawn on the
        device; None unless the attack is gaussian and unreplayed."""
        if s.attack_noise is None:
            return None
        return torch.randn((len(self.train_groups),
                            tree_count_params(self.global_params)),
                           generator=s.attack_noise, device=self.device)

    def _attack(self, r: int, s: _Streams):
        """The round's attacker mask ((C,) bool on the host) and the
        gaussian attack's (C, P) normals on the device (or None); None
        while the adversary is off."""
        attack = self._attack_host(r, s)
        if attack is None:
            return None
        mask, noise = attack
        return mask, (self._attack_noise_drawn(s) if noise is None
                      else noise.to(self.device))

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


class _StagedTrainer:
    """What ``FederatedGPO`` and ``CentralizedGPO`` share around their
    two halves: the eval schedule, whether the scan engine captures, and
    the ICL batches, drawn on the host as question indices (``ICLDraw``)
    from the CPU generators and gathered on the device from the
    trainer's copies of ``phi`` and ``prefs`` (``_tables``, made once by
    ``_init_tables``); replayed batches (the hooks) come whole. Its
    users set ``fed_cfg``, ``data``, ``device``, ``eval_groups``,
    ``_eval`` and ``_eval_batches``."""

    def _eval_mask(self, rounds: int) -> np.ndarray:
        """Rounds that evaluate: every ``eval_every``-th and the last."""
        mask = np.zeros(rounds, np.bool_)
        mask[:: self.fed_cfg.eval_every] = True
        mask[rounds - 1] = True
        return mask

    def _captures(self) -> bool:
        """The scan engine captures its round where CUDA graphs exist."""
        return self.device.type == "cuda"

    def _init_tables(self) -> None:
        self._tables = (self.data.phi.to(self.device),
                        self.data.prefs.to(self.device))

    def _draw(self, gen: torch.Generator, groups, epochs: int = 0
              ) -> ICLDraw:
        """An ``ICLDraw`` over ``groups`` from ``gen``: (n, nq) indices,
        or (E, n, nq) with ``epochs`` E > 0, epoch-major (the draws of E
        ``sample_icl_batches`` calls in turn), from one multinomial."""
        fed = self.fed_cfg
        g = torch.as_tensor(np.asarray(groups), dtype=torch.int64)
        q = sample_icl_indices(gen, self.data, g.repeat(max(epochs, 1)),
                               fed.num_context, fed.num_target)
        return ICLDraw(g, q.reshape(epochs, len(g), -1) if epochs else q)

    def _device_batch(self, ops) -> ICLBatch:
        """Staged batch operands as an ``ICLBatch`` on the device: an
        ``ICLDraw`` gathered from ``_tables`` in one advanced index a
        table, an ``ICLBatch`` as it is."""
        if isinstance(ops, ICLDraw):
            return gather_icl_batch(*self._tables, ops.groups, ops.q,
                                    self.fed_cfg.num_context)
        return ops

    def _eval_host(self, r: int, s: _Streams):
        """Round ``r``'s eval operands over the held-out groups on the
        host: the hook's batch, or an ``ICLDraw`` ((K, nq) indices) from
        the eval generator."""
        if self._eval_batches is not None:
            return self._eval_batches(r).to("cpu")
        return self._draw(s.eval, self.eval_groups)

    def _eval_body(self, params, ops) -> torch.Tensor:
        """The held-out groups' (K,) scores of ``params`` on staged eval
        operands (on the device): gathered, then scored."""
        return self._eval(params, self._device_batch(ops))


class FederatedGPO(_RoundSource, _StagedTrainer):
    _LABEL = "[fed] round"  # a History eval line's label

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
        # the Eq. 2 weights of full participation, on the host and the
        # device
        self._full_weights = self._host_weights(self.train_groups)
        self.weights = self._full_weights.to(self.device)
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
        self._init_tables()
        self._participants = participants
        self._batches, self._eval_batches = batches, eval_batches
        self._release_draws = release_draws
        self._attack_draws, self._fault_draws = attack_draws, fault_draws
        # the scan engine's captured round on a CUDA device, made by the
        # first run that needs it (_CapturedRound)
        self.captured_round: Optional[_CapturedRound] = None

    def _host_weights(self, groups) -> torch.Tensor:
        """w_g = |D_g| / Σ|D_g'| over ``groups`` (Eq. 2), on the host."""
        return normalize_weights(self.data.sizes[torch.as_tensor(groups)])

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

    def _host_batches(self, r: int, s: _Streams, groups):
        """The E local epochs' batches over ``groups`` on the host: the
        hook's E client-stacked batches, or one ``ICLDraw`` ((E, m, nq)
        indices) from the training generator."""
        epochs = self.fed_cfg.local_epochs
        if self._batches is not None:
            return tuple(self._batches(r, e).to("cpu")
                         for e in range(epochs))
        return self._draw(s.train, groups, epochs)

    def _stage(self, r: int, s: _Streams, hist: History) -> RoundOperands:
        """The host half of a round: every host draw it takes, from the
        generators and in the order of the per-round driver (the cohort,
        the attackers, the E epochs' ICL draws) and the hooks' values, as
        CPU tensors. Records the cohort in ``hist``."""
        cohort = self._cohort(r, s.train)
        if cohort is None:
            groups, weights = self.train_groups, self._full_weights
        else:
            hist.round_participants.append(cohort.tolist())
            groups = self.train_groups[cohort.numpy()]
            weights = self._host_weights(groups)
        mask, attack_noise = self._attack_host(r, s) or (None, None)
        batches = self._host_batches(r, s, groups)
        noise, uniform = self._release_host(r)
        return RoundOperands(batches, weights, cohort, mask, attack_noise,
                             noise, uniform)

    def _state(self) -> RoundState:
        return RoundState(self.global_params, self.opt_states,
                          self.server_state, self.ef_resid)

    def _set_state(self, state: RoundState) -> None:
        (self.global_params, self.opt_states, self.server_state,
         self.ef_resid) = state

    def _attack_ops(self, ops: RoundOperands, s: _Streams):
        """The attack stage's operands for the participants' rows: the
        mask and the gaussian normals (replayed, or drawn from ``s``'s
        device generator); None while the adversary is off."""
        if ops.attack_mask is None:
            return None
        noise = (ops.attack_noise if ops.attack_noise is not None
                 else self._attack_noise_drawn(s))
        return self._pipe.attack_draws(ops.attack_mask, noise, ops.idx)

    def _release_ops(self, ops: RoundOperands, s: _Streams) -> tuple:
        """The release's (noise, uniform) for the participants' rows:
        replayed, or drawn from ``s``'s device generator."""
        if self._release_draws is not None:
            return ops.noise, ops.uniform
        return self._release_drawn(s.release, ops.weights.shape[0])

    def _local_round(self, state: RoundState, ops: RoundOperands) -> tuple:
        """Local training of the round's participants from the global
        params, label_flip's attackers on flipped targets: (client
        params, trained params, their Adam states, per-client losses).
        A drawn round's (E, m, ...) batches are gathered here at once,
        each epoch's taken by a Python int. The caller scatters the
        states."""
        idx, m = ops.idx, ops.weights.shape[0]
        batches = ops.batches
        if isinstance(batches, ICLDraw):
            stack = self._device_batch(batches)
            batches = [_batch_rows(stack, e) for e in range(len(batches.q))]
        clients = broadcast_to_clients(state.params, m)
        if self.fed_cfg.reset_opt_each_round:
            opt_in = self.opt.init(clients, num_clients=m)
        else:
            opt_in = (state.opt_states if idx is None
                      else tree_index(state.opt_states, idx))
        flags = (None if ops.attack_mask is None
                 else self._pipe.attacked_flags(ops.attack_mask, idx))
        trained, opt_out, losses = self._local_train(
            clients, opt_in, batches.__getitem__, flags)
        return clients, trained, opt_out, losses

    def _round_body(self, state: RoundState, ops: RoundOperands,
                    s: _Streams) -> tuple:
        """The device half of a round: ``state`` and ``ops`` (tensors on
        one device) in, (the new ``RoundState``, the mean client loss as
        a () tensor) out. It draws the release operands and the gaussian
        attack's normals from ``s``'s device generators (where no hook
        replays them) and reads nothing back to the host, so it can be
        captured into a CUDA graph."""
        pipe, idx = self._pipe, ops.idx
        attack = self._attack_ops(ops, s)
        clients, trained, opt_out, losses = self._local_round(state, ops)
        opt_states = opt_out if idx is None else tree_map(
            lambda full, sub: full.index_copy(0, idx, sub),
            state.opt_states, opt_out)
        deltas = tree_sub(trained, clients)
        noise, uniform = self._release_ops(ops, s)
        resid = state.ef_resid
        if resid is not None and idx is not None:
            resid = resid[idx]
        params, server_state, resid = pipe.reduce_apply(
            state.server_state, state.params, deltas, ops.weights,
            losses=losses, idx=idx, resid=resid, noise=noise,
            uniform=uniform, attack=attack)
        if resid is not None and idx is not None:
            resid = state.ef_resid.index_copy(0, idx, resid)
        return (RoundState(params, opt_states, server_state, resid),
                losses.mean())

    def _fault_round(self, r: int, s: _Streams, hist: History) -> float:
        """One round under the fault simulator (the reference's
        ``fault_round_step``); returns the mean loss of the clients whose
        local round survived."""
        fed, agg, pipe, dev = self.fed_cfg, self.agg, self._pipe, self.device
        c = len(self.train_groups)
        host = self._stage(r, s, hist)
        ops = _on(host, dev)
        idx = ops.idx
        sub = torch.arange(c) if host.idx is None else host.idx
        attack = self._attack_ops(ops, s)
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
        w_full[sub] = agg.weigh(self.server_state, ops.weights,
                                idx).float().cpu()
        clients, trained, opt_out, losses = self._local_round(self._state(),
                                                              ops)
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
        noise, uniform = self._release_ops(ops, s)
        resid = self.ef_resid
        if resid is not None and idx is not None:
            resid = resid[idx]
        rel, new_resid = pipe.release_rows(
            tree_ravel_clients(tree_sub(trained, clients)), noise, uniform,
            resid, attack=attack)
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

    def _record(self, hist: History, loss: float) -> None:
        """A finished round's loss and cumulative ε, into ``hist``."""
        hist.round_loss.append(loss)
        self._note_privacy(hist)

    def _completed(self, n: int) -> None:
        """``n`` rounds of a block that raised did complete: the
        accountant counts them, as in the per-round driver."""
        self._rounds_elapsed += n

    def run(self, rounds: int | None = None, log_every: int = 0,
            engine: str | None = None) -> History:
        """Run ``rounds`` rounds and return the metric ``History``.
        ``engine`` ("scan" or "loop", default ``FedConfig.engine``) picks
        the driver (the module docstring); off CUDA and under
        ``FedConfig.avail`` both run the per-round driver. A run that
        raises leaves the trainer at its last completed round."""
        rounds = rounds or self.fed_cfg.rounds
        engine = engine or self.fed_cfg.engine
        if engine not in ("scan", "loop"):
            raise ValueError(f"unknown engine {engine!r} (want "
                             "'scan'|'loop')")
        hist = History()
        if rounds <= 0:
            return hist
        eval_mask = self._eval_mask(rounds)
        if (engine == "loop" or self.fault_state is not None
                or not self._captures()):
            self._run_loop(rounds, log_every, eval_mask, hist)
        else:
            self._run_blocks(rounds, log_every, eval_mask, hist)
        return hist

    def _run_loop(self, rounds: int, log_every: int, eval_mask,
                  hist: History) -> None:
        """The per-round driver: one host sync a round."""
        s = self._streams(self.fed_cfg.seed + 1)
        for r in range(rounds):
            if self.fault_state is None:
                state, loss = self._round_body(
                    self._state(), _on(self._stage(r, s, hist),
                                       self.device), s)
                self._set_state(state)
                loss = float(loss)
            else:
                loss = self._fault_round(r, s, hist)
            self._record(hist, loss)
            if eval_mask[r]:
                hist.append_eval(r, self._eval_body(
                    self.global_params,
                    _on(self._eval_host(r, s), self.device)).cpu().numpy(),
                    log_every)

    def _run_blocks(self, rounds: int, log_every: int, eval_mask,
                    hist: History) -> None:
        """The scan driver on CUDA: the captured round (made by the
        trainer's first such run) replayed in blocks
        (``_CapturedRound.run``)."""
        if self.captured_round is None:
            self.captured_round = _CapturedRound(self)
        # re-seeds the device generators in place, after the warm-up
        self.captured_round.run(self._streams(self.fed_cfg.seed + 1),
                                rounds, log_every, eval_mask, hist)


def _clone(tree):
    """``tree`` with every tensor leaf cloned."""
    return tree_unflatten(tree, [
        x.clone() if isinstance(x, torch.Tensor) else x
        for x in tree_leaves(tree)])


def _copy_into(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into ``dst``'s leaf of the same
    place, which must have its shape (None leaves must match)."""
    for d, x in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        if d is None and x is None:
            continue
        if not (isinstance(d, torch.Tensor) and isinstance(x, torch.Tensor)
                and d.shape == x.shape):
            raise ValueError("the trainer's state does not match the "
                             "captured round's: a leaf of shape "
                             f"{getattr(x, 'shape', x)} for "
                             f"{getattr(d, 'shape', d)}")
        if d is not x:
            d.copy_(x)


class _PinnedOperands:
    """Static device copies of a fixed structure of CPU tensors (the
    captured graph reads them), refilled through two pinned host buffers
    in turn. A refill writes the next host buffer (waiting only for that
    buffer's previous copy to finish) and copies it to the device with
    ``non_blocking=True`` on the current stream, so the host draws the
    next round while the card runs this one. The tensors lie in one flat
    buffer (``nbytes``), so a refill is one host-to-device copy."""

    _ALIGN = 16

    def __init__(self, like, device: torch.device):
        spans, off = [], 0
        for x in tree_leaves(like):
            if isinstance(x, torch.Tensor):
                n = x.numel() * x.element_size()
                spans.append((off, n, x.dtype, tuple(x.shape)))
                off += -(-n // self._ALIGN) * self._ALIGN
            else:
                spans.append(None)
        self._like, self._spans = like, spans
        self._cuda = device.type == "cuda"
        size = self.nbytes = max(off, self._ALIGN)
        self._host = [torch.empty(size, dtype=torch.uint8,
                                  pin_memory=self._cuda) for _ in range(2)]
        self._flat = torch.empty(size, dtype=torch.uint8, device=device)
        self._events = [None, None]
        self._turn = 0
        self.static = self._views(self._flat)
        self._host_leaves = [tree_leaves(self._views(h)) for h in self._host]
        self.put(like)

    def _views(self, flat: torch.Tensor):
        return tree_unflatten(self._like, [
            x if span is None else
            flat[span[0]:span[0] + span[1]].view(span[2]).view(span[3])
            for x, span in zip(tree_leaves(self._like), self._spans)])

    def put(self, tree) -> None:
        """Stage ``tree`` (``like``'s structure, dtypes and shapes)."""
        leaves = tree_leaves(tree)
        if len(leaves) != len(self._spans):
            raise ValueError("a round's operands differ in structure from "
                             "the captured round's")
        b, self._turn = self._turn, self._turn ^ 1
        if self._events[b] is not None:
            self._events[b].synchronize()
        for i, (dst, x, like, span) in enumerate(zip(
                self._host_leaves[b], leaves, tree_leaves(self._like),
                self._spans)):
            if span is None:
                if isinstance(x, torch.Tensor) or x != like:
                    raise ValueError(f"operand {i} is {x!r}, the captured "
                                     f"round's {like!r}")
                continue
            if not (isinstance(x, torch.Tensor) and x.dtype == span[2]
                    and tuple(x.shape) == span[3]):
                raise ValueError(
                    f"operand {i} is {getattr(x, 'dtype', x)} "
                    f"{tuple(getattr(x, 'shape', ()))}, the captured "
                    f"round's {span[2]} {span[3]}")
            dst.copy_(x)
        self._flat.copy_(self._host[b], non_blocking=True)
        if self._cuda:
            self._events[b] = torch.cuda.Event()
            self._events[b].record()


class _CapturedRound:
    """The scan engine on a CUDA device: a trainer's round body captured
    once into a CUDA graph, and its eval into a second graph on the
    first one's memory pool, each replayed once a round (an eval round).

    The trainer is ``FederatedGPO`` (a round) or ``CentralizedGPO`` (an
    epoch, its round). It gives the two halves and their bookkeeping:
    ``_stage(r, s, hist)`` and ``_eval_host(r, s)`` (the host's operands
    as CPU tensors), ``_round_body(state, ops, s)`` -> (state, loss ())
    and ``_eval_body(params, ops)`` -> (K,) scores (tensors only, no host
    read), ``_state()`` / ``_set_state(state)`` (a NamedTuple with
    ``params``), ``_streams(seed)`` (the run's generators; the device
    ones ``release`` and ``attack_noise``, None where it has none),
    ``_record(hist, loss)``, ``_completed(n)``, ``_LABEL``, ``device``,
    ``fed_cfg`` and ``eval_groups``.

    ``state`` is static: copied in from the trainer at every ``run``
    (``load``) and out as new tensors after every block and on an
    exception (``store``), so a caller that holds or replaces the
    trainer's tensors between runs is honoured and a run that raises
    leaves the trainer at its last completed round. The operands are
    static too: a round's and an eval's, refilled through
    ``_PinnedOperands``. A replay writes its loss (an eval replay its
    (K,) scores) into one static output, which is cloned on the same
    stream right after it; ``read`` brings a block's clones to the host
    in one transfer. The trainer's device generators are registered with
    the round graph, so each replay draws the next values of the streams
    that ``run`` re-seeds in place.

    The warm-up (which also builds and loads the kernels) runs on a side
    stream, on copies of the state, so the trainer does not advance; it
    draws from the trainer's device generators, which every ``run``
    re-seeds before its first replay. A kernel wrapper's ``launches``
    counts the capture's call once and no replay; the graph's replays
    are ``replays`` and ``eval_replays``. The host's seconds: ``draw_s``
    in the host half (``_stage``, ``_eval_host``), ``stage_s`` in the
    refills (waits for a pinned buffer included), ``replay_s`` in the
    replay calls; ``warmup_ms`` and ``capture_ms`` what the warm-up and
    the two captures took."""

    def __init__(self, trainer):
        dev = trainer.device
        self.trainer = trainer
        self.draw_s = self.stage_s = self.replay_s = 0.0
        self.replays = self.eval_replays = 0
        self._losses, self._scores = [], []
        self._gens = trainer._streams(trainer.fed_cfg.seed + 1)
        self._train_in = _PinnedOperands(
            trainer._stage(0, self._gens, History()), dev)
        self._eval_in = _PinnedOperands(trainer._eval_host(0, self._gens),
                                        dev)
        ops, batch = self._train_in.static, self._eval_in.static
        self.state = _clone(trainer._state())

        def warm_up():
            new, _ = trainer._round_body(_clone(self.state), ops, self._gens)
            trainer._eval_body(new.params, batch)

        def round_fn():
            new, self.loss = trainer._round_body(self.state, ops, self._gens)
            _copy_into(self.state, new)

        def eval_fn():
            self.scores = trainer._eval_body(self.state.params, batch)

        self._sync()
        t0 = time.perf_counter()
        self._warm_up(warm_up)
        self._sync()
        t1 = time.perf_counter()
        self.graph = self._capture(round_fn, gens=(self._gens.release,
                                                   self._gens.attack_noise))
        self.eval_graph = self._capture(eval_fn, pool=self.graph.pool())
        self._sync()
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3

    def _sync(self) -> None:
        torch.cuda.synchronize(self.trainer.device)

    def _warm_up(self, fn: Callable) -> None:
        """``fn()`` on a side stream, which the current stream then
        waits for."""
        dev = self.trainer.device
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)

    def _capture(self, fn: Callable, gens=(), pool=None):
        """A CUDA graph of ``fn()``'s work (its memory from ``pool`` when
        given), drawing from the generators ``gens`` (None skipped)."""
        graph = torch.cuda.CUDAGraph()
        for gen in gens:
            if gen is not None:
                graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=pool):
            fn()
        return graph

    def load(self, s: _Streams) -> None:
        if (s.release is not self._gens.release
                or s.attack_noise is not self._gens.attack_noise):
            raise RuntimeError("the run's device generators are not the "
                               "ones the round was captured with")
        _copy_into(self.state, self.trainer._state())
        self._losses, self._scores = [], []

    def store(self) -> None:
        self.trainer._set_state(_clone(self.state))

    def _replay(self, staged: _PinnedOperands, graph, operands) -> None:
        t0 = time.perf_counter()
        staged.put(operands)
        t1 = time.perf_counter()
        graph.replay()
        self.stage_s += t1 - t0
        self.replay_s += time.perf_counter() - t1

    def round(self, ops) -> None:
        self._replay(self._train_in, self.graph, ops)
        self._losses.append(self.loss.clone())
        self.replays += 1

    def eval(self, ops) -> None:
        self._replay(self._eval_in, self.eval_graph, ops)
        self._scores.append(self.scores.clone())
        self.eval_replays += 1

    def read(self) -> tuple:
        """The block's losses (a list) and eval scores ((evals, K)), in
        one transfer."""
        losses, scores = self._losses, self._scores
        self._losses, self._scores = [], []
        out = torch.cat([x.reshape(-1) for x in losses + scores]).cpu()
        n, k = len(losses), len(self.trainer.eval_groups)
        return out[:n].tolist(), out[n:].reshape(len(scores), k).numpy()

    def run(self, s: _Streams, rounds: int, log_every: int, eval_mask,
            hist: History) -> None:
        """``rounds`` rounds from the trainer's state, replayed in blocks
        of ``log_every`` rounds (the whole run without it), each read
        back once into ``hist``. ``s`` holds the run's generators, its
        device ones those the round was captured with, re-seeded."""
        t = self.trainer
        chunk = min(log_every, rounds) if log_every else rounds
        self.load(s)
        for start in range(0, rounds, chunk):
            n, done, evals = min(chunk, rounds - start), 0, []
            try:
                for r in range(start, start + n):
                    t0 = time.perf_counter()
                    ops = t._stage(r, s, hist)
                    self.draw_s += time.perf_counter() - t0
                    self.round(ops)
                    done += 1
                    if eval_mask[r]:
                        t0 = time.perf_counter()
                        ops = t._eval_host(r, s)
                        self.draw_s += time.perf_counter() - t0
                        self.eval(ops)
                        evals.append(r)
                losses, scores = self.read()
            except BaseException:
                # the trainer keeps the rounds that completed
                self.store()
                t._completed(done)
                raise
            self.store()
            for loss in losses:
                t._record(hist, loss)
            for i, r in enumerate(evals):
                hist.append_eval(r, scores[i], log_every, label=t._LABEL)


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
