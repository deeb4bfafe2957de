"""Backbone training and serving steps, and the federated backbone
trainers (the reference's ``core/trainer.py``):

* ``lm_loss`` / ``make_train_step`` — LM loss (+ MoE aux), grad,
  optimizer update, optional microbatch gradient accumulation and
  activation remat;
* ``make_prefill_step`` — the full-sequence forward that materialises
  the decode cache, returning the last position's logits;
* ``make_serve_step`` — ONE token against the cache;
* ``greedy_decode`` — the greedy generation loop of ``launch/serve.py``;
* ``make_backbone_fedavg_round`` / ``make_fedlora_round`` — the paper's
  technique applied to backbone training: clients run local steps, then
  the round's stages (attack, DP, codec) and the server aggregation run
  on the flat (C, P) client deltas (``core/pipeline.py``).

Training differentiates the plain branch (``models.train_logits``): the
flash and SSD kernels have no backward, as the reference has none and
differentiates its plain path. The prefill runs those kernels unless
``use_kernels=False``; decode is plain PyTorch, as in the reference. A
ring cache (``models.transformer.ring_cache_from_full`` of the prefill's
cache) decodes through the same serve step. The rounds' aggregation
runs the hand-written reduce kernels where the aggregator and the
pipeline are built with ``use_pallas``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import (
    AdversaryConfig,
    CompressionConfig,
    ModelConfig,
    PrivacyConfig,
)
from repro_torch.core import adversary as byz
from repro_torch.core import compression as cx
from repro_torch.core import privacy as dp
from repro_torch.core.aggregation import ServerAggregator
from repro_torch.core.fedavg import broadcast_to_clients, fedavg_stacked
from repro_torch.core.lora import apply_lora
from repro_torch.core.pipeline import AttackDraws, RoundPipeline
from repro_torch.models import forward, train_logits
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.optim import Optimizer
from repro_torch.utils.pytree import (
    tree_count_params,
    tree_index,
    tree_leaves,
    tree_map,
    tree_sub,
    tree_unflatten,
)

PyTree = Any


def lm_loss(params, cfg: ModelConfig, batch: dict, *,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens`` or
    ``embeds``, an encoder-decoder's ``enc_embeds``, and ``labels``)
    plus the MoE aux loss; the final softcap is inside the logits."""
    logits, aux = train_logits(params, cfg, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               enc_embeds=batch.get("enc_embeds"),
                               remat=remat)
    return cross_entropy_loss(logits, batch["labels"]) + aux


def value_and_grad(loss_fn: Callable, params: PyTree, *args):
    """(loss, grads like ``params``) of ``loss_fn(params, *args)``: the
    reference's ``jax.value_and_grad``. A leaf the loss does not reach
    gets a zero gradient."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, opt: Optimizer, *,
                    microbatch: int = 1, remat: bool = False) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, {"loss"}).
    ``microbatch`` > 1 splits the batch's leading axis into that many
    slices and adds their losses and gradients in turn (in the params'
    dtype, as the reference's scan carry), then divides; ``remat``
    recomputes each layer in the backward pass."""

    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch, remat=remat)

    def train_step(params, opt_state, batch):
        if microbatch <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            mb = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                               + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(torch.zeros_like, params)
            for j in range(microbatch):
                loss_j, grads_j = value_and_grad(
                    loss_fn, params, {k: v[j] for k, v in mb.items()})
                loss = loss + loss_j
                grads = tree_map(torch.add, grads, grads_j)
            loss = loss / microbatch
            grads = tree_map(lambda g: g / microbatch, grads)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step


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


# ---------------------------------------------------------------------------
# Federated backbone training (the paper's technique as a trainer feature)
# ---------------------------------------------------------------------------
class RoundDraws(NamedTuple):
    """A round's presampled randomness for its C clients, each None where
    the configuration draws none: the σ-scaled DP noise and the int8
    rounding uniforms, (C, P) f32 each; the attacker mask (C,) bool and
    the gaussian attack's (C, P) standard normals."""

    noise: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None
    attack_mask: Optional[torch.Tensor] = None
    attack_noise: Optional[torch.Tensor] = None


def _scan_local(step: Callable, payload, opt_state, batches: dict):
    """The reference's ``lax.scan`` of local steps over ``batches``'
    leading axis: (payload, opt_state, the steps' mean loss)."""
    losses = []
    for t in range(next(iter(batches.values())).shape[0]):
        payload, opt_state, loss = step(payload, opt_state,
                                        {k: v[t] for k, v in
                                         batches.items()})
        losses.append(loss)
    return payload, opt_state, torch.stack(losses).mean()


def _stack_into(buf, i: int, tree, c: int):
    """Row ``i`` of the client-stacked ``buf`` (made on the first call,
    buf None) set to ``tree``; returns ``buf``."""
    if buf is None:
        buf = tree_map(lambda x: x.new_empty((c,) + tuple(x.shape)), tree)
    for dst, src in zip(tree_leaves(buf), tree_leaves(tree), strict=True):
        dst[i].copy_(src)
    return buf


def _clients(local_train: Callable, payload, opt_states, batches: dict,
             keep: str):
    """Each client's local training in turn (the reference vmaps it):
    ``payload`` and ``opt_states`` are client-stacked, ``batches``
    (C, local_steps, ...) each. Returns (the clients' trained payloads,
    or with ``keep="deltas"`` their deltas from ``payload``, stacked;
    the new optimizer states, stacked; the (C,) mean losses). One
    client's trained tree is alive at a time."""
    c = next(iter(batches.values())).shape[0]
    out = states = None
    losses = []
    for i in range(c):
        start = tree_index(payload, i)
        trained, state, loss = local_train(
            start, tree_index(opt_states, i),
            {k: v[i] for k, v in batches.items()})
        if keep == "deltas":
            trained = tree_sub(trained, start)
        out = _stack_into(out, i, trained, c)
        states = _stack_into(states, i, state, c)
        losses.append(loss)
        del trained, state
    return out, states, torch.stack(losses)


def _draw(pipe: RoundPipeline, gen: torch.Generator,
          host_gen: torch.Generator, c: int, p: int) -> RoundDraws:
    """A round's draws where the configuration uses them: the release's
    noise, then its uniforms, (C, P) each on ``gen``'s device (as
    ``FederatedGPO`` draws them); the attacker mask from ``host_gen``'s
    C uniforms on the CPU, the gaussian attack's normals on the
    device."""
    priv, comp, adv = pipe.privacy, pipe.compression, pipe.adversary
    noise = (dp.client_noise(gen, (c, p), priv.sigma)
             if priv.enabled and priv.noise_multiplier > 0.0 else None)
    uniform = (cx.client_uniform(gen, (c, p))
               if comp.enabled and comp.needs_rng else None)
    mask = attack_noise = None
    if adv.enabled:
        mask = byz.attacker_mask(byz.attacker_draws(host_gen, c),
                                 adv.num_attackers)
        if adv.kind == "gaussian":
            attack_noise = torch.randn((c, p), generator=gen,
                                       device=gen.device)
    return RoundDraws(noise, uniform, mask, attack_noise)


def _aggregated_round(local_train: Callable,
                      agg: Optional[ServerAggregator],
                      privacy: Optional[PrivacyConfig] = None,
                      use_pallas_aggregation: bool = False,
                      compression: Optional[CompressionConfig] = None,
                      adversary: Optional[AdversaryConfig] = None,
                      seed: int = 0) -> Callable:
    """Shared round tail for the backbone/LoRA federated trainers.

    ``agg=None`` keeps the seed contract: (client_payload, opt_states,
    batches, weights) -> (payload, opt_states, losses) with Eq. 3
    averaging of the clients' payloads. With a ``ServerAggregator`` the
    delta contract of DESIGN.md §7 applies — the round takes and returns
    the server state: (payload, opt_states, batches, weights,
    server_state) -> (payload, opt_states, losses, server_state). An
    enabled ``privacy`` (DESIGN.md §9), ``compression`` (§10) or
    ``adversary`` (§13; the delta-level kinds) config needs ``agg``.
    With error feedback the round takes and returns a trailing ``resid``
    (C, P). The stages' randomness comes in as ``draws=`` (a
    ``RoundDraws``) or is drawn from the round's own generators, made at
    the first call that needs them from ``seed`` (a device generator for
    the (C, P) draws, a CPU one for the attacker uniforms) and kept
    across rounds; the reference's trailing ``round_key`` has no torch
    counterpart. ``use_pallas_aggregation`` routes the pipeline's fused
    DP and codec reduces through the CUDA kernels (the aggregator's own
    reduces follow its ``use_pallas``). Payloads, optimizer states and
    batches are client-stacked; the clients train in turn.
    """
    if privacy is not None:
        privacy.validate()
    if compression is not None:
        compression.validate()
    if adversary is not None:
        adversary.validate()
    private = privacy is not None and privacy.enabled
    compressed = compression is not None and compression.enabled
    adv_on = adversary is not None and adversary.enabled
    if (private or compressed or adv_on) and agg is None:
        raise ValueError("the DP delta pipeline, the compression stage,"
                         " and the Byzantine attack stage ride the delta"
                         " contract: pass a ServerAggregator (agg=) with"
                         " privacy, compression, or adversary")
    if adv_on and adversary.data_level:
        # preference label flipping rewrites survey ICL batches inside
        # the GPO trainer's local training; the backbone/LoRA local step
        # is a plain LM loss over opaque token batches
        raise ValueError(
            "adversary.kind='label_flip' is only wired into the GPO "
            "engine's local data pipeline (federated._make_local_train); "
            "the backbone/LoRA trainers support the delta-level kinds "
            "(sign_flip/scaled/gaussian/alie)")
    if agg is None:
        def round_fn(client_payload, opt_states, batches, weights):
            new_payload, opt_states, losses = _clients(
                local_train, client_payload, opt_states, batches, "params")
            global_payload = fedavg_stacked(new_payload, weights)
            del new_payload
            return (broadcast_to_clients(global_payload, weights.shape[0]),
                    opt_states, losses)

        return round_fn

    if agg.cfg.prox_mu > 0.0:
        # the proximal term lives in the local objective, which for the
        # backbone/LoRA trainers is the plain LM loss
        raise ValueError(
            "prox_mu > 0 is only wired into the GPO engine's local "
            "objective (federated._make_local_train); the backbone/LoRA "
            "trainers do not apply a proximal term")

    pipe = RoundPipeline(
        agg=agg, adversary=adversary or AdversaryConfig(),
        privacy=privacy or PrivacyConfig(),
        compression=compression or CompressionConfig(),
        use_pallas=use_pallas_aggregation)
    ef = compressed and compression.error_feedback
    need_draws = (private and privacy.noise_multiplier > 0.0) or (
        compressed and compression.needs_rng) or adv_on
    gens: dict = {}

    def round_fn(client_payload, opt_states, batches, weights,
                 server_state, resid=None, *, draws: Optional[RoundDraws]
                 = None):
        if ef != (resid is not None):
            raise TypeError(f"round expects resid (C, P) exactly when error "
                            f"feedback is on (error_feedback={ef})")
        c = weights.shape[0]
        deltas, opt_states, losses = _clients(
            local_train, client_payload, opt_states, batches, "deltas")
        if draws is None and need_draws:
            dev = weights.device
            if "dev" not in gens:
                gens["dev"] = torch.Generator(device=dev).manual_seed(seed)
                gens["host"] = torch.Generator().manual_seed(seed)
            draws = _draw(pipe, gens["dev"], gens["host"], c,
                          tree_count_params(deltas) // c)
        draws = draws or RoundDraws()
        attack = (None if draws.attack_mask is None else
                  AttackDraws(draws.attack_mask.to(weights.device),
                              draws.attack_noise))
        # pipeline tail (DESIGN.md §13): [attack ->] privacy -> codec ->
        # aggregate on the flat client deltas; full participation
        global_payload, server_state, new_resid = pipe.reduce_apply(
            server_state, tree_index(client_payload, 0), deltas, weights,
            losses=losses, idx=None, resid=resid, noise=draws.noise,
            uniform=draws.uniform, attack=attack)
        del deltas
        out = (broadcast_to_clients(global_payload, c), opt_states, losses,
               server_state)
        return out + (new_resid,) if ef else out

    return round_fn


def make_backbone_fedavg_round(cfg: ModelConfig, opt: Optimizer,
                               local_steps: int,
                               agg: Optional[ServerAggregator] = None,
                               privacy: Optional[PrivacyConfig] = None,
                               use_pallas_aggregation: bool = False,
                               compression: Optional[CompressionConfig]
                               = None,
                               adversary: Optional[AdversaryConfig] = None,
                               seed: int = 0) -> Callable:
    """Full-parameter federated round over backbones (feasible <= few-B
    params).

    (client_params (C, ...), opt_states, batches (C, local_steps, ...),
     weights (C,)) -> (new client params, opt_states, mean loss per
    client). One round = local_steps LM steps per client + aggregation +
    redistribution (Eq. 3 FedAvg by default; any registry strategy via
    ``agg``, which adds a server_state argument and result — see
    ``_aggregated_round``)."""
    step = make_train_step(cfg, opt)

    def local_step(params, opt_state, batch):
        params, opt_state, m = step(params, opt_state, batch)
        return params, opt_state, m["loss"]

    def local_train(params, opt_state, batches):
        return _scan_local(local_step, params, opt_state, batches)

    return _aggregated_round(local_train, agg, privacy,
                             use_pallas_aggregation, compression,
                             adversary, seed)


def make_fedlora_round(cfg: ModelConfig, frozen_params, opt: Optimizer,
                       local_steps: int,
                       agg: Optional[ServerAggregator] = None,
                       privacy: Optional[PrivacyConfig] = None,
                       use_pallas_aggregation: bool = False,
                       compression: Optional[CompressionConfig] = None,
                       adversary: Optional[AdversaryConfig] = None,
                       seed: int = 0) -> Callable:
    """Federated LoRA adapters with a frozen (shared) backbone — the
    production recipe for grok-1-class archs (DESIGN.md §3). The adapter
    tree (its ``scale`` included, as in the reference) is a plain tree,
    so every registry aggregation strategy applies to it unchanged
    (``agg``; see ``_aggregated_round``)."""

    def loss_fn(lora, batch):
        return lm_loss(apply_lora(frozen_params, lora), cfg, batch)

    def local_step(lora, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, lora, batch)
        lora, opt_state = opt.update(grads, opt_state, lora)
        return lora, opt_state, loss

    def local_train(lora, opt_state, batches):
        return _scan_local(local_step, lora, opt_state, batches)

    return _aggregated_round(local_train, agg, privacy,
                             use_pallas_aggregation, compression,
                             adversary, seed)
