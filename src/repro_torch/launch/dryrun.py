"""Dry run: every (architecture x input shape) counted on the production
mesh's shape WITHOUT allocating anything (params, optimizer states,
batches and caches are meta-device tensors), and the sharded GPO round's
collective schedule (the reference's ``launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k [--multi-pod] [--out results.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gpo-fed \\
      --agg krum --clients 4 [--device cpu]

``lower_pair`` records, per pair:

* the per-device bytes of the params, the optimizer state (Adam or
  Adafactor by ``specs.train_settings``), the batch and the cache, from
  the sharding rules (``launch/sharding.py``) and ``per_device_shape``;
* the step's FLOPs and bytes, counted op by op on meta
  (``launch/hlo_cost.py::analyze_step``, under ``activation_sharding``
  of the mesh, so the MoE blocks and the attention layout are the
  reference's), divided by the chip count;
* ``model_flops`` and the roofline with the H100's constants
  (``launch/roofline.py``): the counted bytes give the memory term's
  upper bound, the per-device params, optimizer state, batch and cache
  (each moved at least once) its lower bound, and the bottleneck is
  named only where the two bounds agree (else ``undetermined``).

What has no counterpart, reported as None with the reason, never
estimated:

* XLA's ``memory_analysis`` temporaries: an eager step has no compiled
  buffer plan;
* the backbone step's collective schedule: a meta step in one process
  issues no collectives, so the roofline has no collective term.

The train step's microbatches run the same ops on the same shapes, so
its count is one microbatch's loss and gradient (and its accumulation)
times the microbatch count, plus the set-up and the optimizer update
once: the same totals as counting the whole step, exactly (a test holds
the two equal), in a fraction of the time. The decode step is counted at
the cache's last position (the port's decode takes the position as a
Python int; its cost does not depend on it).

``lower_gpo_round`` runs one round of the sharded GPO round
(``core/federated.py::ShardedGPO``) on ``clients`` processes, one client
each, and reports its collectives from ``launch/collectives.py``'s
ledger: the linear strategies' one parameter-sized all-reduce, the
robust strategies' all-gather of the client rows. It runs on the card
unless ``device`` says otherwise (every process on that one device, the
gloo backend).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback

import torch

from repro_torch.checkpoint.checkpoint import _leaves
from repro_torch.configs import INPUT_SHAPES, InputShape, get_arch, override
from repro_torch.core.trainer import (
    lm_loss,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    value_and_grad,
)
from repro_torch.launch import roofline as rl
from repro_torch.launch.hlo_cost import CostTotals, analyze_step
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.sharding import (
    adafactor_state_shardings,
    adam_state_shardings,
    batch_shardings,
    cache_shardings,
    params_shardings,
    per_device_shape,
)
from repro_torch.launch.specs import (
    batch_specs,
    cache_specs,
    count_params,
    params_specs,
    serving_config,
    train_settings,
)
from repro_torch.models.partitioning import activation_sharding
from repro_torch.optim import adafactor, adam
from repro_torch.utils.pytree import tree_map

TEMP_WHY_NONE = ("no counterpart: XLA's memory_analysis temporaries come "
                 "from a compiled buffer plan, and an eager step has none")


def per_device_bytes(tree, shardings, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, meta ones included)
    under ``shardings`` (the same tree of ``NamedSharding``)."""
    spec_of = dict(_leaves(shardings))
    return sum(math.prod(per_device_shape(tuple(t.shape),
                                          spec_of[path].spec, mesh))
               * t.element_size() for path, t in _leaves(tree))


def _add(a: CostTotals, b: CostTotals, times: int = 1) -> CostTotals:
    by_op = dict(a.flops_by_op)
    for k, v in b.flops_by_op.items():
        by_op[k] = by_op.get(k, 0) + times * v
    return CostTotals(flops=a.flops + times * b.flops,
                      bytes=a.bytes + times * b.bytes,
                      ops=a.ops + times * b.ops, flops_by_op=by_op)


def train_step_cost(cfg, opt, params, opt_state, batch, *,
                    microbatch: int, remat: bool) -> CostTotals:
    """``make_train_step(cfg, opt, microbatch=, remat=)``'s count on
    ``batch``, with its microbatch loop folded: the set-up, one
    microbatch's loss, gradient and accumulation times ``microbatch``,
    and the mean and the optimizer update."""
    if microbatch <= 1:
        return analyze_step(make_train_step(cfg, opt, remat=remat),
                            params, opt_state, batch)
    micro = {k: v[: v.shape[0] // microbatch] for k, v in batch.items()}
    dev = next(iter(batch.values())).device

    def head():
        torch.zeros((), dtype=torch.float32, device=dev)
        return tree_map(torch.zeros_like, params)

    grads = head()
    loss = torch.zeros((), dtype=torch.float32, device=dev)

    def body():
        loss_j, grads_j = value_and_grad(
            lambda p, b: lm_loss(p, cfg, b, remat=remat), params, micro)
        loss + loss_j
        return tree_map(torch.add, grads, grads_j)

    def tail():
        loss / microbatch
        mean = tree_map(lambda g: g / microbatch, grads)
        opt.update(mean, opt_state, params)

    return _add(_add(analyze_step(head), analyze_step(body), microbatch),
                analyze_step(tail))


def lower_pair(arch: str, shape_name, *, multi_pod: bool = False,
               fsdp_override: bool | None = None,
               cfg_overrides: dict | None = None,
               verbose: bool = True, mesh=None) -> dict:
    """One (arch, shape) pair counted on meta. ``shape_name`` is a name of
    ``INPUT_SHAPES`` or an ``InputShape``; ``mesh`` a ``MeshShape`` in
    place of ``make_production_mesh(multi_pod=...)``'s. The train step
    splits its batch into ``gcd(train_settings' microbatch, batch)``
    microbatches: ``train_settings``' count at every ``INPUT_SHAPES``
    batch, which it divides, and fewer at a batch it does not divide."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    num_chips = math.prod(mesh.shape.values())
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    cfg = override(get_arch(arch), param_dtype="bfloat16",
                   activation_dtype="bfloat16")
    cfg = serving_config(cfg, shape)
    if cfg_overrides:
        cfg = override(cfg, **cfg_overrides)
    settings = train_settings(cfg)
    settings = dataclasses.replace(settings, microbatch=math.gcd(
        settings.microbatch, shape.global_batch))
    fsdp = settings.fsdp if fsdp_override is None else fsdp_override
    baxes = data_axes(mesh)

    p_shapes = params_specs(cfg)
    p_shard = params_shardings(p_shapes, cfg, mesh, fsdp=fsdp)
    mem = {"params_bytes": per_device_bytes(p_shapes, p_shard, mesh),
           "optimizer_bytes": 0, "batch_bytes": 0, "cache_bytes": 0}

    t0 = time.time()
    with activation_sharding(mesh):
        if shape.kind == "train":
            opt = (adafactor(1e-3) if settings.optimizer == "adafactor"
                   else adam(1e-3))
            opt_shapes = opt.init(p_shapes)
            if settings.optimizer == "adafactor":
                o_shard = adafactor_state_shardings(p_shard, p_shapes, mesh)
            else:
                o_shard = adam_state_shardings(p_shard, mesh)
            b_shapes = batch_specs(cfg, shape, with_labels=True)
            mem["optimizer_bytes"] = per_device_bytes(opt_shapes, o_shard,
                                                      mesh)
            mem["batch_bytes"] = per_device_bytes(
                b_shapes, batch_shardings(b_shapes, mesh, baxes), mesh)
            totals = train_step_cost(cfg, opt, p_shapes, opt_shapes,
                                     b_shapes,
                                     microbatch=settings.microbatch,
                                     remat=settings.remat)
        elif shape.kind == "prefill":
            b_shapes = batch_specs(cfg, shape, with_labels=False)
            c_shapes = cache_specs(cfg, shape)
            mem["batch_bytes"] = per_device_bytes(
                b_shapes, batch_shardings(b_shapes, mesh, baxes), mesh)
            mem["cache_bytes"] = per_device_bytes(
                c_shapes, cache_shardings(c_shapes, cfg, mesh, baxes), mesh)
            step = make_prefill_step(cfg, shape.seq_len, use_kernels=False)
            totals = analyze_step(step, p_shapes, b_shapes)
        else:  # decode
            c_shapes = cache_specs(cfg, shape)
            tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                              device="meta")
            mem["cache_bytes"] = per_device_bytes(
                c_shapes, cache_shardings(c_shapes, cfg, mesh, baxes), mesh)
            mem["batch_bytes"] = per_device_bytes(
                {"tokens": tok},
                batch_shardings({"tokens": tok}, mesh, baxes), mesh)
            totals = analyze_step(make_serve_step(cfg), p_shapes, c_shapes,
                                  tok, shape.seq_len - 1)
    t_count = time.time() - t0
    mem["argument_size_in_bytes"] = sum(mem.values())
    lower_bytes = mem["argument_size_in_bytes"]
    mem["temp_size_in_bytes"] = None
    mem["temp_why_none"] = TEMP_WHY_NONE

    mflops = rl.model_flops(cfg, shape, num_chips)
    roof = rl.analyze(totals, num_chips, model_flops_per_chip=mflops,
                      lower_bytes_per_chip=lower_bytes)
    result = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(str(v) for v in mesh.shape.values()),
        "multi_pod": multi_pod,
        "num_chips": num_chips,
        "params": count_params(cfg),
        "fsdp": fsdp,
        "kind": shape.kind,
        "optimizer": settings.optimizer if shape.kind == "train" else None,
        "microbatch": settings.microbatch if shape.kind == "train" else None,
        "count_s": round(t_count, 1),
        "counted": {"flops": totals.flops, "bytes": totals.bytes,
                    "ops": totals.ops, "flops_by_op": totals.flops_by_op},
        "memory": mem,
        "roofline": roof.as_dict(),
        "collectives": None,
        "collectives_why_none": rl.COLLECTIVE_WHY_NONE,
    }
    if verbose:
        print(f"== {arch} x {shape.name} mesh={result['mesh']} ==")
        print("per-device bytes:", {k: v for k, v in mem.items()
                                    if k.endswith("bytes")})
        print("counted: flops/chip=%.3e bytes/chip=%.3e (%d ops)" % (
            roof.flops_per_chip, roof.bytes_per_chip, totals.ops))
        print("roofline: compute=%.2fms memory=%.2f-%.2fms -> %s | "
              "useful=%.2f" % (roof.compute_s * 1e3,
                               roof.memory_lower_s * 1e3,
                               roof.memory_s * 1e3, roof.bottleneck,
                               roof.useful_ratio))
    return result


def _gpo_round_rank(rank, device, agg_name, clients, edges, kw):
    """One process of ``lower_gpo_round``: one round of ``ShardedGPO``
    on its client; returns its collective ledger."""
    from repro_torch.configs import (AdversaryConfig, AggConfig,
                                     AvailabilityConfig, CompressionConfig,
                                     FedConfig, GPOConfig, HierarchyConfig,
                                     PrivacyConfig)
    from repro_torch.core import ShardedGPO
    from repro_torch.data import SurveyConfig, make_survey_data
    from repro_torch.launch.mesh import make_edge_mesh, make_host_mesh
    from repro_torch.utils.pytree import tree_sq_norm

    torch.set_num_threads(1)
    if edges > 1:
        mesh = make_edge_mesh(edges, clients // edges, device=device)
        caxes = ("edge", "data")
    else:
        mesh = make_host_mesh(clients, device=device)
        caxes = ("data",)
    data = make_survey_data(SurveyConfig(num_groups=clients,
                                         num_questions=30, d_embed=16,
                                         seed=0))
    gcfg = GPOConfig(d_embed=16, d_model=32, num_layers=1, num_heads=2,
                     d_ff=32)
    avail = (AvailabilityConfig(online_prob=0.8, crash_prob=0.05,
                                straggler_prob=0.1, max_staleness=4)
             if kw["faults"] else AvailabilityConfig())
    fcfg = FedConfig(
        num_clients=clients, local_epochs=2, num_context=6, num_target=6,
        agg=AggConfig(name=agg_name, num_malicious=kw["attackers"],
                      norm_bound=kw["norm_bound"]),
        use_pallas_aggregation=kw["use_pallas"],
        use_pallas_attention=kw["use_pallas_attention"],
        privacy=PrivacyConfig(clip_norm=kw["clip_norm"],
                              noise_multiplier=kw["noise_multiplier"]),
        compression=CompressionConfig(kind=kw["compress"],
                                      topk_frac=kw["topk_frac"]),
        avail=avail,
        adversary=AdversaryConfig(kind=kw["attack"],
                                  num_attackers=kw["attackers"]),
        hierarchy=HierarchyConfig(num_edges=edges))
    run = ShardedGPO(gcfg, fcfg, data, list(range(clients)), mesh,
                     client_axes=caxes)
    hist = run.run(1)
    return {"linear": run.agg.linear, "ledger": list(run.comm.ledger),
            "client_losses": [float(x) for x in hist.client_losses[0]],
            "params_sq_norm": float(tree_sq_norm(run.global_params)),
            "launches": {k: fn.launches for k, fn in _launch_counts().items()}}


def _launch_counts() -> dict:
    """The round's kernel wrappers, whose ``launches`` count this
    process's launches on CUDA tensors."""
    import importlib

    from repro_torch.kernels import agg_reduce as ar

    # the module: the package's gpo_attention is the ops function
    ga = importlib.import_module("repro_torch.kernels.gpo_attention")

    return {"gpo_attention_fwd": ga.gpo_attention_fwd,
            "gpo_attention_bwd_dq": ga.gpo_attention_bwd_dq,
            "gpo_attention_bwd_dkdv": ga.gpo_attention_bwd_dkdv,
            **{k: getattr(ar, f"{k}_flat") for k in (
                "fedavg_reduce", "momentum_reduce", "trimmed_reduce",
                "pairwise_dists", "clip_reduce", "quant_clip_reduce",
                "topk_reduce")}}


def lower_gpo_round(agg_name: str, *, clients: int = 8,
                    edges: int = 1,
                    use_pallas: bool = False,
                    use_pallas_attention: bool = False,
                    clip_norm: float = 0.0,
                    noise_multiplier: float = 0.0,
                    compress: str = "none",
                    topk_frac: float = 0.01,
                    faults: bool = False,
                    attack: str = "none",
                    attackers: int = 0,
                    norm_bound: float = 0.0,
                    verbose: bool = True,
                    device=None) -> dict:
    """One round of the sharded GPO round for one aggregation strategy on
    ``clients`` processes (an (edges, clients/edges) ("edge", "data")
    mesh when ``edges`` > 1), at the reference's dry-run widths, and its
    collective schedule (DESIGN.md §7): the linear strategies make ONE
    parameter-sized all-reduce of the weighted delta, the robust ones an
    all-gather of the client rows (two hops on the edge mesh, int8 rows
    under ``compress="int8"``). ``device``: every process's device (the
    card unless named)."""
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import spawn

    dev = resolve_device(device)
    kw = dict(use_pallas=use_pallas,
              use_pallas_attention=use_pallas_attention,
              clip_norm=clip_norm, noise_multiplier=noise_multiplier,
              compress=compress, topk_frac=topk_frac, faults=faults,
              attack=attack, attackers=attackers, norm_bound=norm_bound)
    t0 = time.time()
    ranks = spawn(clients, _gpo_round_rank, agg_name, clients, edges, kw,
                  backend="gloo", device=dev)
    ledger = ranks[0]["ledger"]
    coll = rl.collectives_from_ledger(ledger)
    result = {
        "agg": agg_name,
        "clients": clients,
        "edges": edges,
        "device": str(dev),
        "use_pallas_aggregation": use_pallas,
        "use_pallas_attention": use_pallas_attention,
        "private": clip_norm > 0,
        "clip_norm": clip_norm,
        "noise_multiplier": noise_multiplier,
        "compress": compress,
        "topk_frac": topk_frac if compress == "topk" else None,
        "faults": faults,
        "attack": attack,
        "attackers": attackers,
        "norm_bound": norm_bound,
        "linear": ranks[0]["linear"],
        "run_s": round(time.time() - t0, 1),
        # each process's clients' losses and rank 0's global params'
        # squared norm after the round, and the kernel launches of every
        # process (0 on the CPU, where the wrappers run the plain versions)
        "client_losses": [x for r in ranks for x in r["client_losses"]],
        "params_sq_norm": ranks[0]["params_sq_norm"],
        "kernel_launches": {k: sum(r["launches"][k] for r in ranks)
                            for k in ranks[0]["launches"]},
        "collective_bytes_by_kind": dict(coll.bytes_by_kind),
        "collective_count_by_kind": dict(coll.count_by_kind),
        "collective_count": coll.total_count,
        # per call: (kind, bytes, multiplier), the hops apart
        "collective_ops": [[rl.LEDGER_KINDS[c.op], float(c.nbytes), 1.0]
                           for c in ledger],
        "collective_axes": [list(call.axes) for call in ledger],
        "memory": None,
        "memory_why_none": TEMP_WHY_NONE,
    }
    if verbose:
        print(f"== gpo-fed round x agg={agg_name} mesh={clients}"
              + (f" edges={edges}" if edges > 1 else "")
              + (f" compress={compress}" if compress != "none" else "")
              + (" faults" if faults else "")
              + (f" attack={attack}({attackers})" if attack != "none"
                 else "")
              + (f" norm_bound={norm_bound}" if norm_bound else "")
              + " ==")
        print("collectives:", result["collective_bytes_by_kind"])
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--gpo-fed", action="store_true",
                    help="run the sharded federated GPO round instead of "
                         "a backbone (arch/shape ignored)")
    ap.add_argument("--agg", default="fedavg",
                    help="aggregation strategy for --gpo-fed")
    ap.add_argument("--clients", type=int, default=8,
                    help="client processes for --gpo-fed")
    ap.add_argument("--edges", type=int, default=1,
                    help="edge shards for the two-level client→edge→server "
                         "round (must divide --clients; 1 = flat)")
    ap.add_argument("--pallas-attn", action="store_true",
                    help="route --gpo-fed local training through the "
                         "attention kernels")
    ap.add_argument("--private", action="store_true",
                    help="run the --gpo-fed round with the DP client-delta "
                         "pipeline (DESIGN.md §9)")
    ap.add_argument("--clip-norm", type=float, default=1.0,
                    help="per-client L2 clip for --private")
    ap.add_argument("--noise-multiplier", type=float, default=1.0,
                    help="Gaussian noise multiplier for --private")
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"],
                    help="run the --gpo-fed round with the delta codec "
                         "(DESIGN.md §10)")
    ap.add_argument("--topk-frac", type=float, default=0.01,
                    help="fraction of coordinates kept for "
                         "--compress topk")
    ap.add_argument("--faults", action="store_true",
                    help="run the --gpo-fed round with the fault-injection "
                         "layer (DESIGN.md §11)")
    ap.add_argument("--attack", default="none",
                    choices=["none", "sign_flip", "scaled", "gaussian",
                             "alie", "label_flip"],
                    help="run the --gpo-fed round with the Byzantine "
                         "attack stage (DESIGN.md §13)")
    ap.add_argument("--attackers", type=int, default=2,
                    help="Byzantine clients per round for --attack")
    ap.add_argument("--norm-bound", type=float, default=0.0,
                    help="server-side L2 norm bound on received rows "
                         "(0 = off)")
    ap.add_argument("--device", default=None,
                    help="--gpo-fed: the processes' torch device (default: "
                         "cuda); a backbone pair is counted on meta")
    ap.add_argument("--out", default=None, help="append result as json line")
    args = ap.parse_args(argv)
    if not args.gpo_fed and not (args.arch and args.shape):
        ap.error("--arch and --shape are required unless --gpo-fed")
    what = (f"gpo-fed x {args.agg} clients={args.clients}"
            + (" private" if args.private else "")
            + (f" compress={args.compress}" if args.compress != "none"
               else "")
            + (" faults" if args.faults else "")
            + (f" attack={args.attack}" if args.attack != "none"
               else "") if args.gpo_fed
            else f"{args.arch} x {args.shape} multi_pod={args.multi_pod}")
    try:
        if args.gpo_fed:
            # the spawned processes import this function from the package
            from repro_torch.launch import dryrun
            result = dryrun.lower_gpo_round(
                args.agg, clients=args.clients, edges=args.edges,
                use_pallas_attention=args.pallas_attn,
                clip_norm=args.clip_norm if args.private else 0.0,
                noise_multiplier=(args.noise_multiplier if args.private
                                  else 0.0),
                compress=args.compress, topk_frac=args.topk_frac,
                faults=args.faults,
                attack=args.attack,
                attackers=args.attackers if args.attack != "none" else 0,
                norm_bound=args.norm_bound, device=args.device)
        else:
            result = lower_pair(args.arch, args.shape,
                                multi_pod=args.multi_pod)
        status = "ok"
    except Exception:
        traceback.print_exc()
        result = {"arch": args.arch, "shape": args.shape,
                  "gpo_fed": args.gpo_fed,
                  "multi_pod": args.multi_pod, "error": traceback.format_exc()}
        status = "error"
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    print(f"DRYRUN {status}: {what}")
    if status == "error":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
