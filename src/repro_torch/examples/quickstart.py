"""Quickstart on the port: train the PluralLLM federated preference
predictor on a synthetic global-opinion survey and query it for an
unseen group. The counterpart of ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import FedConfig, GPOConfig
from repro_torch.core import FederatedGPO, predict_preferences
from repro_torch.core.fairness import alignment_score
from repro_torch.data import (
    SurveyConfig,
    make_survey_data,
    sample_icl_batch,
    split_groups,
)
from repro_torch.kernels.backend import resolve_device


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. A synthetic PewResearch-style survey population: 17 groups, 120
    #    multiple-choice questions, frozen-LLM embeddings (stub frontend).
    data = make_survey_data(SurveyConfig(seed=0))
    train_groups, eval_groups = split_groups(data, train_frac=0.6)
    print(f"groups: {len(train_groups)} train clients / "
          f"{len(eval_groups)} held-out")

    # 2. Federated training: each group is a FedAvg client (paper §3),
    #    through the attention and FedAvg kernels. The round's other
    #    options carry over from the JAX package's FedConfig: a server
    #    rule (agg=AggConfig(name="krum", num_malicious=3), ...), DP
    #    (privacy=PrivacyConfig(clip_norm=0.5, noise_multiplier=0.8);
    #    hist.round_eps tracks ε), the int8 or top-k delta codec
    #    (compression=CompressionConfig(kind="int8")) and partial
    #    participation (batch_groups=3), Byzantine attackers
    #    (adversary=AdversaryConfig(kind="sign_flip", num_attackers=3)),
    #    client faults (avail=AvailabilityConfig(online_prob=0.8,
    #    straggler_prob=0.3, max_staleness=4)) and the edge hierarchy
    #    (hierarchy=HierarchyConfig(num_edges=2)).
    gpo_cfg = GPOConfig(d_embed=data.phi.shape[-1])
    fed_cfg = FedConfig(num_clients=len(train_groups), rounds=args.rounds,
                        local_epochs=6, lr=3e-4, eval_every=25,
                        use_pallas_attention=True,
                        use_pallas_aggregation=True)
    fed = FederatedGPO(gpo_cfg, fed_cfg, data, train_groups, eval_groups,
                       device=device)
    fed.run(rounds=args.rounds, log_every=25)

    # 3. Serve: predict an UNSEEN group's answer distribution from a few
    #    in-context examples (the paper's reward-model use case), through
    #    the attention kernel. Under real query load use the multi-tenant
    #    engine (core.PreferenceServer; examples/serve_preferences.py).
    group = int(eval_groups[0])
    batch = sample_icl_batch(torch.Generator().manual_seed(42), data, group,
                             num_context=12, num_target=4)
    pred = predict_preferences(fed.global_params, fed.gpo_cfg, batch.ctx_x,
                               batch.ctx_y, batch.tgt_x, data.num_options,
                               device=device).cpu()
    truth = batch.tgt_y.reshape(-1, data.num_options)
    score = float(alignment_score(pred, truth))
    print(f"\nunseen group {group}: AS={score:.4f}")
    for i in range(2):
        print(f"  q{i} pred : {np.round(pred[i].double().numpy(), 3)}")
        print(f"  q{i} truth: {np.round(truth[i].double().numpy(), 3)}")
    return score


if __name__ == "__main__":
    main()
