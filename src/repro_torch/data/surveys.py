"""Synthetic PewResearch-style global-opinion survey data.

Each *group* (country / demographic) answers multiple-choice opinion
questions; the label for (group, question) is the group's answer
distribution over the question's options:

* every question q has ``num_options`` options with feature embeddings
  phi(q, a), the stand-in for a frozen-LLM embedding of the text;
* every group g has a latent opinion vector w_g drawn from one of
  ``num_archetypes`` clusters plus per-group idiosyncrasy;
* the group's answer distribution is softmax_a( phi(q,a) . w_g / temp ).

The arrays are host-side data drawn from a CPU ``torch.Generator``; move
batches to the device that serves or trains on them (a seed then gives
the same batches whatever that device is). The same seed gives other
numbers than the JAX package's (threefry keys are not reproducible in
torch): parity tests feed the JAX package's arrays instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class SurveyConfig:
    num_groups: int = 17
    num_questions: int = 120
    num_options: int = 5
    d_embed: int = 64
    num_archetypes: int = 4
    idiosyncrasy: float = 0.35  # scale of per-group deviation from archetype
    temperature: float = 0.8  # sharpness of group answer distributions
    min_questions_frac: float = 0.6  # groups observe a random subset of Qs
    seed: int = 0


class SurveyData(NamedTuple):
    """Arrays describing the full synthetic survey population."""

    phi: torch.Tensor  # (Q, A, d_embed) frozen-LLM embedding of (q, a) text
    prefs: torch.Tensor  # (G, Q, A) per-group answer distributions (simplex)
    mask: torch.Tensor  # (G, Q) bool: did group g answer question q
    sizes: torch.Tensor  # (G,) |D_g| = number of answered questions
    group_w: torch.Tensor  # (G, d_embed) latent opinion vectors (debug only)

    @property
    def num_groups(self) -> int:
        return self.prefs.shape[0]

    @property
    def num_questions(self) -> int:
        return self.prefs.shape[1]

    @property
    def num_options(self) -> int:
        return self.prefs.shape[2]


def make_survey_data(cfg: SurveyConfig,
                     generator: Optional[torch.Generator] = None
                     ) -> SurveyData:
    """The population for ``cfg``, drawn from ``generator`` (default: a
    CPU generator seeded with ``cfg.seed``)."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    G, Q, A, d = (cfg.num_groups, cfg.num_questions, cfg.num_options,
                  cfg.d_embed)
    phi = torch.randn((Q, A, d), generator=g)
    phi = phi / phi.norm(dim=-1, keepdim=True)

    archetypes = torch.randn((cfg.num_archetypes, d), generator=g)
    assign = torch.randint(0, cfg.num_archetypes, (G,), generator=g)
    idio = cfg.idiosyncrasy * torch.randn((G, d), generator=g)
    group_w = archetypes[assign] + idio  # (G, d)

    logits = torch.einsum("qad,gd->gqa", phi, group_w) / cfg.temperature
    prefs = torch.softmax(logits, dim=-1)

    # groups answer a random subset of questions -> unequal |D_g| so the
    # FedAvg weights p_g = |D_g| / sum |D_g'| are non-trivial (Eq. 2).
    frac = torch.rand((G, Q), generator=g)
    keep_prob = cfg.min_questions_frac + (1.0 - cfg.min_questions_frac) * (
        torch.rand((G, 1), generator=g))
    mask = frac < keep_prob
    # guarantee a minimum so context/target sampling never starves
    min_q = max(8, int(cfg.min_questions_frac * Q) // 2)
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    forced = torch.zeros_like(mask).scatter_(1, order[:, :min_q], True)
    mask = mask | forced
    sizes = mask.sum(dim=1)
    return SurveyData(phi=phi, prefs=prefs, mask=mask, sizes=sizes,
                      group_w=group_w)


def split_groups(data: SurveyData, train_frac: float = 0.6,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """60/40 train/eval group split as in the paper (§4.2); numpy's
    generator, so it equals the JAX package's split."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(data.num_groups)
    n_train = max(1, int(round(train_frac * data.num_groups)))
    return perm[:n_train], perm[n_train:]


class ICLBatch(NamedTuple):
    """One in-context batch for the GPO predictor (flattened to points).

    A "point" is one (question, option) pair: x = phi(q, a), y = P_g(a | q).
    """

    ctx_x: torch.Tensor  # (m*A, d_embed)
    ctx_y: torch.Tensor  # (m*A,)
    tgt_x: torch.Tensor  # (t*A, d_embed)
    tgt_y: torch.Tensor  # (t*A,) ground truth
    tgt_q: torch.Tensor  # (t*A,) int64 question index of each target point
    num_options: int

    def to(self, device) -> "ICLBatch":
        """This batch on ``device``; array fields (numpy, or another
        package's arrays) become tensors first."""
        def move(f):
            t = f if isinstance(f, torch.Tensor) else torch.from_numpy(
                np.array(f))
            return t.to(device)

        return ICLBatch(*(move(f) for f in self[:-1]),
                        num_options=self.num_options)


class ICLDraw(NamedTuple):
    """The question indices of ICL batches, drawn but not yet gathered:
    ``q`` (..., num_context + num_target) int64, the context questions
    first, for the groups ``groups`` (broadcast against ``q``'s leading
    axes, so (m,) serves an (E, m, nq) draw). ``gather_icl_batch`` makes
    the ``ICLBatch``es on whatever device the two lie on."""

    groups: torch.Tensor
    q: torch.Tensor


def sample_icl_indices(generator: torch.Generator, data: SurveyData, groups,
                       num_context: int, num_target: int) -> torch.Tensor:
    """(n, num_context + num_target) int64 question indices for the n
    groups of ``groups``, distinct within a row and among the group's
    answered questions, from ONE 2-D ``torch.multinomial`` over their
    mask rows: the values, and the generator's state after, of n
    ``sample_icl_batch`` calls in that order."""
    rows = data.mask[torch.as_tensor(np.asarray(groups), dtype=torch.int64)]
    return torch.multinomial(rows.float(), num_context + num_target,
                             replacement=False, generator=generator)


def gather_icl_batch(phi: torch.Tensor, prefs: torch.Tensor,
                     groups: torch.Tensor, q: torch.Tensor,
                     num_context: int) -> ICLBatch:
    """The ICL batches of the draw (``groups``, ``q``) (``ICLDraw``):
    ``q``'s leading axes lead every field, and its first ``num_context``
    questions a row are the context. One advanced index into ``phi``
    (Q, A, d) and one into ``prefs`` (G, Q, A), on their device."""
    num_options, d = phi.shape[-2], phi.shape[-1]
    lead = q.shape[:-1]
    x = phi[q]  # (..., nq, A, d)
    y = prefs[groups[..., None], q]  # (..., nq, A)
    tgt_q = q[..., num_context:, None].expand(*lead, -1, num_options)
    return ICLBatch(
        ctx_x=x[..., :num_context, :, :].reshape(*lead, -1, d),
        ctx_y=y[..., :num_context, :].reshape(*lead, -1),
        tgt_x=x[..., num_context:, :, :].reshape(*lead, -1, d),
        tgt_y=y[..., num_context:, :].reshape(*lead, -1),
        tgt_q=tgt_q.reshape(*lead, -1),
        num_options=num_options)


def sample_icl_batch(generator: torch.Generator, data: SurveyData,
                     group: int, num_context: int,
                     num_target: int) -> ICLBatch:
    """Sample distinct context/target questions among the group's
    answered ones (paper §3.1), drawn from ``generator``."""
    weights = data.mask[group].float()
    qs = torch.multinomial(weights, num_context + num_target,
                           replacement=False, generator=generator)
    ctx_q, tgt_q = qs[:num_context], qs[num_context:]

    def gather(q_idx):
        x = data.phi[q_idx]  # (n, A, d)
        y = data.prefs[group, q_idx]  # (n, A)
        return x.reshape(-1, x.shape[-1]), y.reshape(-1)

    ctx_x, ctx_y = gather(ctx_q)
    tgt_x, tgt_y = gather(tgt_q)
    return ICLBatch(ctx_x=ctx_x, ctx_y=ctx_y, tgt_x=tgt_x, tgt_y=tgt_y,
                    tgt_q=tgt_q.repeat_interleave(data.num_options),
                    num_options=data.num_options)


def sample_icl_batches(generator: torch.Generator, data: SurveyData, groups,
                       num_context: int, num_target: int) -> ICLBatch:
    """One ICL batch per group of ``groups``, drawn from ``generator`` in
    that order and stacked on a leading axis: the client-stacked batch
    of one local epoch, or the held-out groups' batch of one eval. The
    same values, and the same generator state after, as one
    ``sample_icl_batch`` call a group."""
    g = torch.as_tensor(np.asarray(groups), dtype=torch.int64)
    return gather_icl_batch(data.phi, data.prefs, g, sample_icl_indices(
        generator, data, g, num_context, num_target), num_context)
