"""Training launcher, on the GPU unless ``--device cpu``. Four trainers:

  standard  — plain LM training of the selected architecture;
  fedavg    — the paper's technique on the backbone: C clients run local
              LM steps on their own data; rounds end with the server's
              aggregation of the full parameters;
  fedlora   — frozen backbone, federated LoRA adapters (the large-arch
              recipe);
  gpo       — the paper's own experiment (the default).

  PYTHONPATH=src python -m repro_torch.launch.train --trainer gpo \
      --rounds 50 --agg fedavg --ckpt-dir checkpoints/gpo_serve
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --smoke --trainer fedavg --rounds 3 --local-steps 2 --agg fedavgm \
      --device cpu

``gpo`` trains the GPO preference predictor federated (``core.FederatedGPO``) on
synthetic survey data at ``GPOConfig()`` width with the paper's
``FedConfig`` (10 training clients, 6 local Adam epochs at 3e-4, 16+16
questions), and with ``--ckpt-dir`` saves the final global params as an
``.npz`` checkpoint in the JAX package's format, which
``python -m repro_torch.launch.serve --gpo --restore`` serves.
``--agg`` picks the server-aggregation strategy from the registry
(DESIGN.md §7, §13), with the reference's flags for its
hyperparameters; ``--norm-bound`` clips each client's delta on the
server. ``--attack`` simulates ``--attackers`` Byzantine clients a
round (DESIGN.md §13; ``--attack-scale`` for ``scaled``), and
``--attackers`` is also the defenses' assumed f. ``--clip-norm`` and
``--noise-multiplier`` turn on the DP release (DESIGN.md §9; the final
ε is printed), ``--compress int8`` or
``topk`` the delta codec with error feedback (DESIGN.md §10). The
attention (forward and backward) and the aggregation's client-axis work,
the DP clip and the codec included, always go through the hand-written
CUDA kernels on the card; ``--device cpu`` runs their plain PyTorch
versions on the CPU (the rehearsal; the default is the card).

The backbone trainers take ``--arch`` (``--smoke`` for the reduced
variant, f32 and CPU-sized), ``--steps`` (standard), ``--rounds``,
``--local-steps``, ``--clients``, ``--batch``, ``--seq`` and ``--lr``
(local Adam); batches come from ``synthetic_lm_batches``. fedavg and
fedlora take ``--agg`` and the stage flags as the GPO trainer does; the
LM step differentiates the plain branch (the flash and SSD kernels have
no backward), and the round's aggregation runs the CUDA reduce kernels
on the card. ``--ckpt-dir`` saves the trained params (standard) or the
client-stacked payload in the JAX package's format.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import (
    AdversaryConfig,
    AggConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
    PrivacyConfig,
)
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.core import (
    AGGREGATORS,
    FederatedGPO,
    broadcast_to_clients,
    init_lora,
    make_aggregator,
    make_backbone_fedavg_round,
    make_fedlora_round,
    make_train_step,
    normalize_weights,
)
from repro_torch.core.privacy import make_accountant
from repro_torch.data import (
    LMDataConfig,
    SurveyConfig,
    make_survey_data,
    split_groups,
    synthetic_lm_batches,
)
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import init_params
from repro_torch.optim import adam
from repro_torch.utils.pytree import tree_count_params


def gpo_fed_config(**fields) -> FedConfig:
    """The GPO trainer's ``FedConfig`` with the attention (forward and
    backward) and the aggregation through the kernels: on the card the
    hand-written CUDA kernels, on CPU tensors their plain versions. The
    JAX package's launchers leave these flags off; the values agree
    within the port's stated tolerances either way."""
    return FedConfig(use_pallas_attention=True, use_pallas_aggregation=True,
                     **fields)


def stack_client_batches(it, clients: int, steps: int) -> dict:
    """``clients`` × ``steps`` batches from ``it``, stacked (C, steps,
    B, S)."""
    batches = [[next(it) for _ in range(steps)] for _ in range(clients)]
    return {k: torch.stack([torch.stack([b[k] for b in bs])
                            for bs in batches]) for k in batches[0][0]}


def _backbone(args, device, agg_cfg, priv, comp, adv) -> None:
    """The standard, fedavg and fedlora trainers."""
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    opt = adam(args.lr)
    it = synthetic_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed), device=device)
    t0 = time.time()
    if args.trainer == "standard":
        step = make_train_step(cfg, opt)
        opt_state = opt.init(params)
        for i in range(args.steps):
            params, opt_state, m = step(params, opt_state, next(it))
            if i % max(1, args.steps // 10) == 0:
                print(f"step {i:4d} loss={float(m['loss']):.4f}")
        print(f"done: {args.steps} steps on {device} in "
              f"{time.time() - t0:.1f}s final loss={float(m['loss']):.4f}")
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, args.steps, params)
        return
    c = args.clients
    weights = normalize_weights(torch.ones(c)).to(device)
    pallas = device.type == "cuda"
    agg = make_aggregator(agg_cfg, num_clients=c, use_pallas=pallas)
    kw = dict(agg=agg, privacy=priv, compression=comp, adversary=adv,
              use_pallas_aggregation=pallas, seed=args.seed + 17)
    if args.trainer == "fedavg":
        payload = params
        rnd = make_backbone_fedavg_round(cfg, opt, args.local_steps, **kw)
    else:
        payload = init_lora(params, gen, rank=8)
        rnd = make_fedlora_round(cfg, params, opt, args.local_steps, **kw)
    client = broadcast_to_clients(payload, c)
    opt_states = opt.init(client, num_clients=c)
    server_state = agg.init(payload)
    accountant = make_accountant(priv, 1.0)  # full participation
    ef = comp.enabled and comp.error_feedback
    extra = ((torch.zeros((c, tree_count_params(payload)), device=device),)
             if ef else ())
    for r in range(args.rounds):
        out = rnd(client, opt_states, stack_client_batches(
            it, c, args.local_steps), weights, server_state, *extra)
        client, opt_states, losses, server_state = out[:4]
        extra = tuple(out[4:])
        eps = (f" eps={accountant.epsilon(r + 1):.3f}"
               if accountant else "")
        print(f"round {r:3d} client losses="
              f"{[round(x, 4) for x in losses.tolist()]}{eps}")
    print(f"done: {args.rounds} {args.trainer} rounds on {device} "
          f"({args.agg}) in {time.time() - t0:.1f}s")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.rounds, client)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trainer", default="gpo",
                    choices=["standard", "fedavg", "fedlora", "gpo"])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the final global params here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    # server-aggregation strategy (DESIGN.md §7) and the defenses (§13)
    ap.add_argument("--agg", default="fedavg", choices=AGGREGATORS.names())
    ap.add_argument("--server-lr", type=float, default=1.0)
    ap.add_argument("--server-momentum", type=float, default=0.9,
                    help="fedavgm server momentum")
    ap.add_argument("--prox-mu", type=float, default=0.0,
                    help="FedProx client proximal coefficient")
    ap.add_argument("--trim-frac", type=float, default=0.1,
                    help="trimmed_mean per-side trim fraction")
    ap.add_argument("--fair-temp", type=float, default=1.0,
                    help="adaptive fairness-weight temperature")
    # Byzantine attack simulation (DESIGN.md §13). --attack none
    # (default) disables the stage; pick a defense with --agg
    # krum/multi_krum/geomedian/median and/or --norm-bound.
    ap.add_argument("--attack", default="none",
                    choices=["none", "sign_flip", "scaled", "gaussian",
                             "alie", "label_flip"],
                    help="per-round Byzantine client attack")
    ap.add_argument("--attackers", type=int, default=0,
                    help="number of Byzantine clients per round (also "
                         "the defenses' assumed f)")
    ap.add_argument("--attack-scale", type=float, default=10.0,
                    help="model-replacement factor for --attack scaled")
    ap.add_argument("--norm-bound", type=float, default=0.0,
                    help="server-side per-client L2 norm bound on "
                         "received deltas (0 = off)")
    ap.add_argument("--multi-krum-m", type=int, default=3,
                    help="rows averaged by --agg multi_krum")
    # DP client-delta pipeline (DESIGN.md §9). --clip-norm 0 (default)
    # disables it.
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="per-client L2 clip on the flat delta (0 = off)")
    ap.add_argument("--noise-multiplier", type=float, default=0.0,
                    help="Gaussian noise std = z * clip-norm per client")
    ap.add_argument("--dp-delta", type=float, default=1e-5,
                    help="target delta for the Renyi accountant's eps")
    # client->server delta compression (DESIGN.md §10). --compress none
    # (default) disables it.
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"],
                    help="delta codec: int8 stochastic quantization or "
                         "top-k magnitude sparsification")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="fraction of coordinates kept per client "
                         "(--compress topk)")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the EF21 error-feedback residual")
    args = ap.parse_args(argv)

    priv = PrivacyConfig(clip_norm=args.clip_norm,
                         noise_multiplier=args.noise_multiplier,
                         target_delta=args.dp_delta)
    priv.validate()
    comp = CompressionConfig(kind=args.compress, topk_frac=args.topk_frac,
                             error_feedback=not args.no_error_feedback)
    comp.validate()
    adv = AdversaryConfig(kind=args.attack, num_attackers=args.attackers,
                          scale=args.attack_scale)
    adv.validate()
    device = resolve_device(args.device)
    agg = AggConfig(name=args.agg, server_lr=args.server_lr,
                    momentum=args.server_momentum, prox_mu=args.prox_mu,
                    trim_frac=args.trim_frac, fair_temp=args.fair_temp,
                    num_malicious=args.attackers,
                    multi_krum_m=args.multi_krum_m,
                    norm_bound=args.norm_bound)
    if args.trainer != "gpo":
        _backbone(args, device, agg, priv, comp, adv)
        return
    data = make_survey_data(SurveyConfig(seed=args.seed))
    tr, ev = split_groups(data, seed=args.seed)
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    fcfg = gpo_fed_config(num_clients=len(tr), rounds=args.rounds,
                          eval_every=args.eval_every, seed=args.seed,
                          agg=agg, privacy=priv, compression=comp,
                          adversary=adv)
    fed = FederatedGPO(gcfg, fcfg, data, tr, ev, device=device)
    t0 = time.time()
    hist = fed.run(rounds=args.rounds, log_every=args.eval_every)
    print(f"{args.rounds} rounds on {device} ({args.agg}) in "
          f"{time.time() - t0:.1f}s: "
          f"final loss={hist.round_loss[-1]:.4f} "
          f"AS={hist.eval_mean_as[-1]:.4f} FI={hist.eval_fi[-1]:.4f}")
    if hist.round_eps:
        print(f"privacy: eps={hist.round_eps[-1]:.3f} at "
              f"delta={priv.target_delta:g} after {args.rounds} "
              f"rounds (clip={priv.clip_norm}, "
              f"z={priv.noise_multiplier})")
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.rounds, fed.global_params)
        print(f"saved the global params to {path}")


if __name__ == "__main__":
    main()
