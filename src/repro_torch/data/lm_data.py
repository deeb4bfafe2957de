"""Token pipeline for backbone (LM-objective) training.

Synthetic corpus: a mixture of Zipf-distributed unigrams with Markov
bigram structure, so the LM loss actually decreases during the example
training runs (pure-uniform tokens would pin loss at log V). The draws
are numpy's, as in the JAX package, so a seed gives the JAX package's
batches bit for bit; they are handed out as int32 tensors on the
requested device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


@dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int = 1024
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    zipf_a: float = 1.2
    markov_strength: float = 0.7  # prob of following the bigram chain


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return (p / p.sum()).astype(np.float64)


def synthetic_lm_batches(cfg: LMDataConfig, device=None) -> Iterator[dict]:
    """Yields {'tokens': (B, S) int32, 'labels': (B, S) int32} forever,
    on ``device`` (CUDA unless the caller names another).

    labels[t] = tokens[t+1]; final label is a wrap to BOS (=0).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
    # deterministic bigram successor table: token v prefers (v*7+3) % V
    succ = (np.arange(cfg.vocab_size) * 7 + 3) % cfg.vocab_size
    while True:
        b, s = cfg.global_batch, cfg.seq_len
        iid = rng.choice(cfg.vocab_size, size=(b, s + 1), p=probs)
        follow = rng.random((b, s + 1)) < cfg.markov_strength
        seq = iid.copy()
        for t in range(1, s + 1):
            seq[:, t] = np.where(follow[:, t], succ[seq[:, t - 1]], iid[:, t])
        seq = torch.from_numpy(seq.astype(np.int32))
        yield {"tokens": seq[:, :-1].to(dev), "labels": seq[:, 1:].to(dev)}


def shard_batch(batch: dict, mesh, batch_axis: str = "data", *,
                index: int) -> dict:
    """Block ``index`` of a host batch split as the reference's
    ``NamedSharding(mesh, P(batch_axis))`` splits it: dim 0 in
    ``mesh.shape[batch_axis]`` equal blocks, in order."""
    n = mesh.shape[batch_axis]
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{k}: batch {v.shape[0]} does not split over "
                             f"{batch_axis} ({n})")
        rows = v.shape[0] // n
        out[k] = v[index * rows:(index + 1) * rows]
    return out
