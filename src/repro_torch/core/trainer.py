"""Backbone serving steps (the reference's ``core/trainer.py``, its
serving half):

* ``make_prefill_step`` — the full-sequence forward that materialises
  the decode cache, returning the last position's logits;
* ``make_serve_step`` — ONE token against the cache;
* ``greedy_decode`` — the greedy generation loop of ``launch/serve.py``.

The prefill runs the flash-attention and SSD kernels unless
``use_kernels=False``; decode is plain PyTorch, as in the reference. A
ring cache (``models.transformer.ring_cache_from_full`` of the prefill's
cache) decodes through the same serve step.
LM training (``lm_loss``, ``make_train_step``, the backbone FedAvg and
FedLoRA rounds) is ROADMAP queue A.8.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward


def make_prefill_step(cfg: ModelConfig, max_seq: int, *,
                      use_kernels: bool = True) -> Callable:
    """(params, batch) -> (last_logits (B, V) f32, cache); ``batch``
    holds the prompt's ``tokens`` (B, S) or its ``embeds`` (B, S, d),
    and an encoder-decoder's ``enc_embeds`` (B, enc_seq_len, d). The
    last logits are a copy, so the (B, S, V) logits are freed before
    decoding (gemma3-27b's are 8.6 GB at batch 4 × 2048)."""

    def prefill_step(params, batch):
        logits, cache, _ = forward(params, cfg, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"),
                                   enc_embeds=batch.get("enc_embeds"),
                                   prefill_len=max_seq,
                                   use_kernels=use_kernels)
        return logits[:, -1].clone(), cache

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, cache, tokens (B, 1), cache_pos) -> (logits (B, V),
    cache): ONE new token against the KV cache or the SSM state."""

    def serve_step(params, cache, tokens, cache_pos: int):
        logits, cache, _ = forward(params, cfg, tokens=tokens, cache=cache,
                                   cache_pos=cache_pos)
        return logits[:, 0], cache

    return serve_step


@torch.no_grad()
def greedy_decode(cfg: ModelConfig, params, cache, first_token,
                  start_pos: int, num_steps: int):
    """Greedy generation from ``first_token`` (B, 1) at ``start_pos``:
    returns (tokens (B, num_steps), cache)."""
    serve = make_serve_step(cfg)
    tok, toks = first_token, []
    for i in range(num_steps):
        logits, cache = serve(params, cache, tok, start_pos + i)
        tok = torch.argmax(logits, dim=-1)[:, None]
        toks.append(tok[:, 0])
    if not toks:
        return first_token.new_zeros((first_token.shape[0], 0)), cache
    return torch.stack(toks, dim=1), cache
