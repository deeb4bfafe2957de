"""Frozen-LLM embedding frontends for the preference pipeline.

The paper embeds each concatenated (question, answer) text with Alpaca-7B
once per group before training (§4.3). Offline we provide:

* ``StubEmbedder`` — deterministic pseudo-embeddings (hash -> seeded
  generator -> unit normal): the right shape, zero model weights. JAX's
  ``fold_in`` cannot be reproduced in torch, so its vectors are the
  JAX package's in distribution (unit norm, one vector a text), not in
  value.
* ``BackboneEmbedder`` — runs any model-zoo backbone (mean-pooled final
  hidden state, under ``no_grad``: the prefill goes through the flash
  and SSD kernels on the card) so the full pipeline (backbone -> GPO ->
  FedAvg) runs with real compute.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


class StubEmbedder:
    """Deterministic stand-in for the frozen Alpaca-7B embedding function.
    The vectors are drawn on the CPU and moved to ``device`` (CUDA unless
    the caller names another), so a text gives one vector everywhere."""

    def __init__(self, d_embed: int, seed: int = 0, device=None):
        self.d_embed = d_embed
        self.seed = seed
        self.device = resolve_device(device)

    def _generator_for(self, text: str) -> torch.Generator:
        """A CPU generator seeded from the hash of the seed and the text
        (its Mersenne Twister takes a 32-bit seed)."""
        h = hashlib.sha256(f"{self.seed}\x00{text}".encode()).digest()
        return torch.Generator().manual_seed(
            int.from_bytes(h[:4], "little"))

    def embed_text(self, text: str) -> torch.Tensor:
        v = torch.randn((self.d_embed,), generator=self._generator_for(text))
        return (v / torch.linalg.vector_norm(v)).to(self.device)

    def embed_qa(self, question: str, answer: str) -> torch.Tensor:
        return self.embed_text(question + " [SEP] " + answer)

    def embed_batch(self, texts: list[str]) -> torch.Tensor:
        return torch.stack([self.embed_text(t) for t in texts])


class BackboneEmbedder:
    """Embed token sequences with a frozen model-zoo backbone.

    ``apply_fn(params, tokens) -> (B, S, d_model)`` is the backbone's hidden
    state function (``models.hidden_states``' first output); embeddings
    are masked mean-pools in f32, projected to d_embed by a (d_model,
    d_embed) N(0, 1/d_model) matrix drawn from ``seed`` on the CPU (or
    ``proj`` where given, e.g. the JAX package's as numpy), unit-normed.
    """

    def __init__(self, apply_fn: Callable, params, d_model: int,
                 d_embed: int, seed: int = 0, proj: Optional[np.ndarray]
                 = None, device=None):
        self.apply_fn = apply_fn
        self.params = params
        self.device = resolve_device(device)
        if d_model == d_embed:
            self.proj = None
        elif proj is not None:
            self.proj = torch.as_tensor(np.asarray(proj, np.float32),
                                        device=self.device)
        else:
            g = torch.Generator().manual_seed(seed)
            self.proj = (torch.randn((d_model, d_embed), generator=g)
                         / np.sqrt(d_model)).to(self.device)

    @torch.no_grad()
    def embed_tokens(self, tokens: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = torch.ones(tokens.shape[:2], dtype=torch.float32,
                              device=tokens.device)
        hidden = self.apply_fn(self.params, tokens).float()  # (B, S, d)
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
        pooled = (hidden * mask[..., None]).sum(dim=1) / denom
        if self.proj is not None:
            pooled = pooled @ self.proj
        return pooled / (torch.linalg.vector_norm(pooled, dim=-1,
                                                  keepdim=True) + 1e-6)
