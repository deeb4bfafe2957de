"""Training launcher: the paper's federated GPO experiment on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.train --trainer gpo \
      --rounds 50 --agg fedavg --ckpt-dir checkpoints/gpo_serve

Trains the GPO preference predictor federated (``core.FederatedGPO``) on
synthetic survey data at ``GPOConfig()`` width with the paper's
``FedConfig`` (10 training clients, 6 local Adam epochs at 3e-4, 16+16
questions), and with ``--ckpt-dir`` saves the final global params as an
``.npz`` checkpoint in the JAX package's format, which
``python -m repro_torch.launch.serve --gpo --restore`` serves.
``--agg`` picks the server-aggregation strategy from the registry
(DESIGN.md §7, §13), with the reference's flags for its
hyperparameters; ``--norm-bound`` clips each client's delta on the
server. ``--clip-norm`` and ``--noise-multiplier`` turn on the DP
release (DESIGN.md §9; the final ε is printed), ``--compress int8`` or
``topk`` the delta codec with error feedback (DESIGN.md §10). The
attention (forward and backward) and the aggregation's client-axis work,
the DP clip and the codec included, always go through the hand-written
CUDA kernels on the card; ``--device cpu`` runs their plain PyTorch
versions on the CPU (the rehearsal; the default is the card).
The backbone trainers of the reference (standard, fedavg, fedlora) come
with the backbone-zoo slice.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import (
    AggConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
    PrivacyConfig,
)
from repro_torch.core import AGGREGATORS, FederatedGPO
from repro_torch.data import SurveyConfig, make_survey_data, split_groups
from repro_torch.kernels.backend import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trainer", default="gpo", choices=["gpo"],
                    help="the federated GPO experiment (the only trainer "
                         "ported so far)")
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
    ap.add_argument("--attackers", type=int, default=0,
                    help="the defenses' assumed number f of Byzantine "
                         "clients (krum, multi_krum); the attack "
                         "simulation is not ported yet")
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
    device = resolve_device(args.device)
    data = make_survey_data(SurveyConfig(seed=args.seed))
    tr, ev = split_groups(data, seed=args.seed)
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    agg = AggConfig(name=args.agg, server_lr=args.server_lr,
                    momentum=args.server_momentum, prox_mu=args.prox_mu,
                    trim_frac=args.trim_frac, fair_temp=args.fair_temp,
                    num_malicious=args.attackers,
                    multi_krum_m=args.multi_krum_m,
                    norm_bound=args.norm_bound)
    fcfg = FedConfig(num_clients=len(tr), rounds=args.rounds,
                     eval_every=args.eval_every, seed=args.seed, agg=agg,
                     privacy=priv, compression=comp,
                     use_pallas_attention=True,
                     use_pallas_aggregation=True)
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
