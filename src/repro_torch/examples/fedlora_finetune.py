"""Federated fine-tuning of a ~100M-parameter backbone — the end-to-end
training program, the counterpart of ``examples/fedlora_finetune.py``.
Four clients hold disjoint synthetic corpora; each round runs local LM
steps and aggregates either full parameters or LoRA adapters (the
paper's technique applied to backbone training) under any registry
aggregation strategy (DESIGN.md §7). ``--clip-norm`` /
``--noise-multiplier`` turn on the DP client-delta pipeline
(DESIGN.md §9): the payload is clipped and noised before aggregation
and the Rényi accountant's ε is printed alongside the losses.
``--compress`` / ``--topk-frac`` add the delta codec (DESIGN.md §10):
int8 stochastic quantization or top-k sparsification with an EF21
error-feedback residual, applied AFTER the DP release — the printed
upload estimate shows the communication saving on the LoRA payload.
On the card the aggregation runs the hand-written CUDA reduce kernels;
``--device cpu`` runs their plain versions.

  PYTHONPATH=src python -m repro_torch.examples.fedlora_finetune \
      --rounds 150 --local-steps 2 --mode lora --agg fedavgm
  PYTHONPATH=src python -m repro_torch.examples.fedlora_finetune \
      --rounds 50 --mode lora --clip-norm 0.5 --noise-multiplier 0.6
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import (
    AggConfig,
    CompressionConfig,
    PrivacyConfig,
    get_arch,
    override,
)
from repro_torch.core import (
    AGGREGATORS,
    broadcast_to_clients,
    init_lora,
    lora_param_count,
    make_aggregator,
    make_backbone_fedavg_round,
    make_fedlora_round,
    normalize_weights,
)
from repro_torch.core.compression import topk_count
from repro_torch.core.privacy import make_accountant
from repro_torch.data import LMDataConfig, synthetic_lm_batches
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.train import stack_client_batches
from repro_torch.models import init_params
from repro_torch.optim import adam
from repro_torch.utils.pytree import tree_count_params


def hundred_m_config():
    """A ~100M-parameter member of the qwen2 family (same block type)."""
    return override(
        get_arch("qwen2-0.5b"), name="qwen2-100m", num_layers=16,
        d_model=640, num_heads=10, num_kv_heads=2, head_dim=64,
        d_ff=2560, vocab_size=32000, param_dtype="float32",
        activation_dtype="float32")  # ~114M params


def count_params(cfg) -> int:
    """The backbone's parameter count, from its shapes alone."""
    return tree_count_params(init_params(cfg, None, device="meta"))


def main(argv=None, cfg=None) -> dict:
    """Runs the example; ``cfg`` replaces ``hundred_m_config()`` (a
    smaller member for a quick run). Returns the per-round mean losses,
    the payload size and the wall time a round."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mode", choices=["full", "lora"], default="lora")
    # fedprox is excluded: its proximal term lives in the GPO engine's
    # local objective, which these backbone trainers don't have
    ap.add_argument("--agg", default="fedavg",
                    choices=[n for n in AGGREGATORS.names()
                             if n != "fedprox"],
                    help="server-aggregation strategy (DESIGN.md §7)")
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="per-client L2 clip on the flat delta (0 = off)")
    ap.add_argument("--noise-multiplier", type=float, default=0.0,
                    help="Gaussian noise std = z * clip-norm per client")
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"],
                    help="client->server delta codec")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="fraction of coordinates kept (--compress topk)")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the EF21 error-feedback residual")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = cfg or hundred_m_config()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    n_params = count_params(cfg)
    print(f"backbone: {cfg.name} with {n_params / 1e6:.1f}M params")

    opt = adam(3e-4)
    c = args.clients
    # heterogeneous client corpora: different seeds + sizes -> Eq. 2 weights
    sizes = torch.tensor([100.0, 80.0, 60.0, 40.0][:c])
    weights = normalize_weights(sizes).to(device)
    iters = [synthetic_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=10 + i), device=device)
        for i in range(c)]

    pallas = device.type == "cuda"
    agg = make_aggregator(AggConfig(name=args.agg), num_clients=c,
                          use_pallas=pallas)
    priv = PrivacyConfig(clip_norm=args.clip_norm,
                         noise_multiplier=args.noise_multiplier)
    priv.validate()
    if priv.enabled:
        print(f"DP pipeline on: clip={priv.clip_norm} "
              f"z={priv.noise_multiplier} (DESIGN.md §9)")
    comp = CompressionConfig(kind=args.compress, topk_frac=args.topk_frac,
                             error_feedback=not args.no_error_feedback)
    comp.validate()
    kw = dict(agg=agg, privacy=priv, compression=comp,
              use_pallas_aggregation=pallas, seed=23)
    if args.mode == "full":
        payload = params
        rnd = make_backbone_fedavg_round(cfg, opt, args.local_steps, **kw)
    else:
        payload = init_lora(params, gen, rank=8)
        print(f"LoRA payload: {lora_param_count(payload) / 1e6:.2f}M "
              f"params ({100 * lora_param_count(payload) / n_params:.2f}% "
              "of the backbone) — the federated communication volume")
        rnd = make_fedlora_round(cfg, params, opt, args.local_steps, **kw)
    pdim = tree_count_params(payload)
    if comp.enabled:
        dense = 4 * pdim
        wire = (pdim + 4 if comp.kind == "int8"
                else 8 * topk_count(pdim, comp.topk_frac))
        print(f"compression on: {comp.kind} "
              f"(EF={'on' if comp.error_feedback else 'off'}) — per-client "
              f"upload {wire / 1e6:.2f} MB vs {dense / 1e6:.2f} MB dense "
              f"f32 ({dense / wire:.1f}x; DESIGN.md §10)")

    client_state = broadcast_to_clients(payload, c)
    opt_states = opt.init(client_state, num_clients=c)
    server_state = agg.init(payload)
    accountant = make_accountant(priv, 1.0)  # full participation
    ef = comp.enabled and comp.error_feedback
    extra = ((torch.zeros((c, pdim), device=device),) if ef else ())
    t0 = time.time()
    total_steps, mean_losses = 0, []
    for r in range(args.rounds):
        per_client = [stack_client_batches(iters[i], 1, args.local_steps)
                      for i in range(c)]
        batches = {k: torch.cat([b[k] for b in per_client])
                   for k in per_client[0]}
        out = rnd(client_state, opt_states, batches, weights, server_state,
                  *extra)
        client_state, opt_states, losses, server_state = out[:4]
        extra = tuple(out[4:])
        total_steps += c * args.local_steps
        mean_losses.append(float(losses.mean()))
        if r % max(1, args.rounds // 15) == 0:
            eps = (f" eps={accountant.epsilon(r + 1):.3f}"
                   if accountant else "")
            print(f"round {r:4d} ({total_steps:5d} client steps) "
                  f"losses={[round(x, 4) for x in losses.tolist()]}{eps}")
    dt = time.time() - t0
    print(f"\n{args.rounds} rounds = {total_steps} client steps "
          f"in {dt:.0f}s; final mean loss {mean_losses[-1]:.4f}")
    return {"losses": mean_losses, "payload_params": pdim,
            "backbone_params": n_params,
            "round_s": dt / max(args.rounds, 1)}


if __name__ == "__main__":
    main()
