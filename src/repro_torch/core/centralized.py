"""Centralized GPO baseline (paper §4.3, "Centralized Learning"), the
PyTorch port of ``repro/core/centralized.py``.

The original GPO training loop: ONE model; each epoch visits the
training groups in a random order and takes one Adam step on one ICL
batch per group, sequentially, unlike FL, which aggregates per round.
An epoch is this baseline's "round" in ``History``.

An epoch is two halves, as ``FederatedGPO``'s round is (the reference
jits it as one ``lax.scan`` over the groups, its draws inside). The host
half (``_stage_epoch``) draws the group order and the G groups' question
indices (``ICLDraw``, one ``sample_icl_indices`` call) on the CPU. The
device half (``_epoch_body``) gathers the epoch's G batches from the
trainer's device copies of ``phi`` and ``prefs`` in one advanced index,
takes the G steps in order and returns the mean loss as a () tensor,
reading nothing back to the host. ``run``'s ``engine`` picks the driver
as ``FederatedGPO.run``'s does: ``"loop"`` runs the halves an epoch at
a time and reads the loss every epoch; ``"scan"`` (``FedConfig.engine``,
the default) on a CUDA device replays the epoch and the eval from two
CUDA graphs (``core/federated.py::_CapturedRound``, shared with the
federated round), reading the losses and scores once a block; off CUDA
it is the per-epoch driver.

Randomness and replay as in ``core/federated.py``: the initial params
from ``FedConfig.seed``, the group order and batches from CPU
generators restarted from it at each ``run``; for parity the hooks
``init_params``, ``batches`` ((epoch, step) -> the step's ICLBatch, one
group, order included; the epoch's G batches are stacked and staged
whole) and ``eval_batches`` (epoch -> ICLBatch stacked over the
held-out groups) feed the reference's draws.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, GPOConfig
from repro_torch.core import federated
from repro_torch.core.federated import (
    History,
    _batch_rows,
    _generators,
    _make_eval_group,
    _on,
    _StagedTrainer,
    _Streams,
    _train_step,
)
from repro_torch.core.gpo import init_gpo_params, params_from_numpy
from repro_torch.data.surveys import ICLBatch, SurveyData
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim import adam


class EpochState(NamedTuple):
    """What an epoch carries to the next: the params and Adam state."""

    params: dict
    opt_state: object


class CentralizedGPO(_StagedTrainer):
    _LABEL = "[cen] epoch"  # a History eval line's label

    def __init__(self, gpo_cfg: GPOConfig, fed_cfg: FedConfig,
                 data: SurveyData, train_groups, eval_groups, *,
                 device=None, init_params=None,
                 batches: Optional[Callable[[int, int], ICLBatch]] = None,
                 eval_batches: Optional[Callable[[int], ICLBatch]] = None):
        self.device = resolve_device(device)
        gpo_cfg = fed_cfg.resolve_gpo(gpo_cfg)  # runtime attention override
        self.gpo_cfg, self.fed_cfg, self.data = gpo_cfg, fed_cfg, data
        self.train_groups = np.asarray(train_groups)
        self.eval_groups = np.asarray(eval_groups)
        self.opt = adam(fed_cfg.lr)
        if init_params is None:
            self.params = init_gpo_params(
                gpo_cfg, torch.Generator().manual_seed(fed_cfg.seed),
                device=self.device)
        else:
            self.params = params_from_numpy(init_params, self.device)
        self.opt_state = self.opt.init(self.params)
        self._eval = _make_eval_group(gpo_cfg, data.num_options)
        self._init_tables()
        self._batches, self._eval_batches = batches, eval_batches
        # the scan engine's captured epoch on a CUDA device, made by the
        # first run that needs it
        self.captured_round: Optional[federated._CapturedRound] = None

    def _streams(self, seed: int) -> _Streams:
        """A run's CPU generators (group order and batches, eval
        batches), restarted from ``seed``; the baseline has no device
        generator."""
        return _Streams(*_generators(seed), release=None)

    def _stage_epoch(self, e: int, gen: torch.Generator):
        """The host half of epoch ``e``: the group order from ``gen``,
        then the G groups' ``ICLDraw`` in that order ((G,) groups, (G,
        nq) indices); with the hook, its G single-group batches stacked
        in step order."""
        order = self.train_groups[torch.randperm(
            len(self.train_groups), generator=gen).numpy()]
        if self._batches is None:
            return self._draw(gen, order)
        steps = [self._batches(e, i).to("cpu") for i in range(len(order))]
        return ICLBatch(*(torch.stack(f) for f in zip(*(b[:-1]
                                                        for b in steps))),
                        num_options=steps[0].num_options)

    def _epoch_body(self, state: EpochState, ops) -> tuple:
        """The device half of an epoch (the reference's ``epoch_fn``):
        the staged operands gathered into the G steps' batches at once,
        one Adam step on each in order. Returns (the new ``EpochState``,
        the mean loss as a () tensor); reads nothing back to the host."""
        stack = self._device_batch(ops)
        params, opt_state = state
        losses = []
        for i in range(stack.ctx_x.shape[0]):
            params, opt_state, loss = _train_step(
                self.gpo_cfg, self.opt, params, opt_state,
                _batch_rows(stack, i))
            losses.append(loss)
        return EpochState(params, opt_state), torch.stack(losses).mean()

    # the halves under the names _CapturedRound calls
    def _stage(self, e: int, s: _Streams, hist: History):
        return self._stage_epoch(e, s.train)

    def _round_body(self, state: EpochState, ops, s: _Streams) -> tuple:
        return self._epoch_body(state, ops)

    def _state(self) -> EpochState:
        return EpochState(self.params, self.opt_state)

    def _set_state(self, state: EpochState) -> None:
        self.params, self.opt_state = state

    def _record(self, hist: History, loss: float) -> None:
        hist.round_loss.append(loss)

    def _completed(self, n: int) -> None:
        """Nothing is counted across epochs but the state, which the
        captured driver stores."""

    def run(self, epochs: int | None = None, log_every: int = 0,
            engine: str | None = None) -> History:
        """Run ``epochs`` epochs and return the metric ``History``.
        ``engine`` ("scan" or "loop", default ``FedConfig.engine``) picks
        the driver (the module docstring). A run that raises leaves the
        trainer at its last completed epoch."""
        fed = self.fed_cfg
        epochs = epochs or fed.rounds
        engine = engine or fed.engine
        if engine not in ("scan", "loop"):
            raise ValueError(f"unknown engine {engine!r} (want "
                             "'scan'|'loop')")
        hist = History()
        if epochs <= 0:
            return hist
        eval_mask = self._eval_mask(epochs)
        s = self._streams(fed.seed + 2)
        if engine == "scan" and self._captures():
            if self.captured_round is None:
                self.captured_round = federated._CapturedRound(self)
            self.captured_round.run(s, epochs, log_every, eval_mask, hist)
            return hist
        for e in range(epochs):
            state, loss = self._epoch_body(
                self._state(), _on(self._stage_epoch(e, s.train),
                                   self.device))
            self._set_state(state)
            self._record(hist, float(loss))
            if eval_mask[e]:
                scores = self._eval_body(
                    self.params, _on(self._eval_host(e, s), self.device))
                hist.append_eval(e, scores.cpu().numpy(), log_every,
                                 label=self._LABEL)
        return hist
