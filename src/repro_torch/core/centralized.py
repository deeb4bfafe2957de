"""Centralized GPO baseline (paper §4.3, "Centralized Learning"), the
PyTorch port of ``repro/core/centralized.py``.

The original GPO training loop: ONE model; each epoch visits the
training groups in a random order and takes one Adam step on one ICL
batch per group, sequentially, unlike FL, which aggregates per round.
An epoch is this baseline's "round" in ``History``.

Randomness and replay as in ``core/federated.py``: the initial params
from ``FedConfig.seed``, the group order and batches from CPU
generators restarted from it at each ``run``; for parity the hooks
``init_params``, ``batches`` ((epoch, step) -> the step's ICLBatch, one
group, order included) and ``eval_batches`` (epoch -> ICLBatch stacked
over the held-out groups) feed the reference's draws.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, GPOConfig
from repro_torch.core.federated import (
    History,
    _generators,
    _make_eval_group,
    _train_step,
)
from repro_torch.core.gpo import init_gpo_params, params_from_numpy
from repro_torch.data.surveys import (
    ICLBatch,
    SurveyData,
    sample_icl_batch,
    sample_icl_batches,
)
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim import adam


class CentralizedGPO:
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
        self._batches, self._eval_batches = batches, eval_batches

    def _epoch(self, e: int, gen: torch.Generator) -> float:
        """One epoch of sequential per-group steps; the mean loss."""
        fed = self.fed_cfg
        order = self.train_groups[torch.randperm(
            len(self.train_groups), generator=gen).numpy()]
        losses = []
        for i, group in enumerate(order):
            b = (self._batches(e, i) if self._batches is not None else
                 sample_icl_batch(gen, self.data, int(group),
                                  fed.num_context, fed.num_target))
            self.params, self.opt_state, loss = _train_step(
                self.gpo_cfg, self.opt, self.params, self.opt_state,
                b.to(self.device))
            losses.append(loss)
        return float(torch.stack(losses).mean())

    def run(self, epochs: int | None = None, log_every: int = 0) -> History:
        fed = self.fed_cfg
        epochs = epochs or fed.rounds
        hist = History()
        gen_train, gen_eval = _generators(fed.seed + 2)
        for e in range(epochs):
            hist.round_loss.append(self._epoch(e, gen_train))
            if e % fed.eval_every == 0 or e == epochs - 1:
                b = (self._eval_batches(e) if self._eval_batches is not None
                     else sample_icl_batches(gen_eval, self.data,
                                             self.eval_groups,
                                             fed.num_context,
                                             fed.num_target))
                scores = self._eval(self.params,
                                    b.to(self.device)).cpu().numpy()
                hist.append_eval(e, scores, log_every, label="[cen] epoch")
        return hist
