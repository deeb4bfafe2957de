#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU:
the GPO predictor's and the LM backbones'.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (into the git-ignored ``build/``), then runs these phases on
the card, raising on any mismatch:

1. Kernel checks: each kernel against its plain PyTorch version on the
   same inputs on the card, at the serving and training paths' shapes:
   the int8 matmul (with rows 0-15 bit-equal at M = 16, 320 and 1280),
   the attention forward and backward (dq, dk/dv; head
   widths 32 and 24; up to S 645 and at num_ctx 0 and S, bit-equal from
   one call to the next and for one bh computed alone as in the batch of
   40, the mean error against float64 within ``FWD_F64_RATIO`` (o) and
   ``BWD_F64_RATIO`` (dq, dk, dv) of the plain version's, which a
   planted control rebuilt from the sources with chained tensor-core
   sums must exceed),
   the ``GPOAttention`` Function's gradients, and
   the aggregation kernels: the FedAvg reduce, the FedAvgM momentum
   reduce, the rank-trimmed reduce (ties included), the Krum pairwise
   distances (exactly symmetric, and their mean error against float64
   within ``PAIRWISE_F64_RATIO`` of the f32 expansion form's, which a
   planted control rebuilt with one TF32 pass must exceed), the DP clip
   reduce (with and without noise, the design that ran printed: on chip
   at the quickstart's shape, two launches at
   ``QUANT_THREE_PASS_SHAPE``), the fused int8 quant-clip reduce
   (every operand combination of the reference's tests, the design that
   ran printed: on chip at the quickstart's shape, three passes at
   ``QUANT_THREE_PASS_SHAPE``) and the top-k reduce (zero and tied
   rows); and the LM
   backbones' flash-attention forward (the reference's sweeps of S,
   GQA, windows and softcap, non-causal at ragged S, qwen2's 14/2
   heads; head_dim 128 too, up to qwen3-32b's 64/8 heads at S 1024;
   the served archs' heads, windows and softcaps: gemma2-27b's 32/16
   with softcap 50, local and global, gemma3-27b's window 1024 at S
   1100, granite-moe's 24/8, grok-1's 48/8, whisper-small's 12/12
   non-causal over its 1500 frames (padded to 1536, the padded keys
   masked) and causal at its 416-token prompt, llava-next-34b's 56/8 at
   hd 128, zamba2-1.2b's 32/32; bf16 against the f32 plain
   version) and SSD chunked scan (the
   reference's sweep, mamba2's p 64, n 128 at chunk 128, 64 and 20 and
   at batch 1, zamba2's n 64 (its 64 heads in the batch check below),
   p and n that are not multiples of 8; with the final
   state; bf16 also by each row of y against the f32 plain version, at
   SSD_BF16_ROW_TOL, two planted faults that must fail: one chunk's B
   zeroed, the state one chunk short; and each sequence of a batch-4
   call bit-equal to the same sequence alone, which the kernel runs at
   another p_width), in f32 and bf16; each also bit-equal from one call
   to the next.
2. Serving: ``PreferenceServer`` at ``ServeConfig()`` defaults over a
   64-request trace, with f32 and with int8 weights, at ``GPOConfig()``
   width with random weights from a seed; cache hit == miss bit for bit,
   served rows against the monolithic ``predict_preferences`` and against
   the port's CPU path, p50/p99 latency and QPS; then both engines once
   more under ``torch.profiler``: device kernel time against wall time.
3. The quickstart's serve step: ``predict_preferences`` with the
   attention kernel for every held-out group, against the dense branch.
4. Training: ``FederatedGPO`` at ``GPOConfig()`` width with the
   quickstart's ``FedConfig`` (10 clients, 6 local Adam epochs at 3e-4,
   16+16 questions) through the attention and FedAvg kernels: 3 rounds
   with the launch counts asserted, against the same trainer on the CPU
   and against the card's dense path; 20 more rounds, over which the
   loss must fall; a checkpoint saved, restored into a
   ``PreferenceServer`` and served; one round under ``torch.profiler``.
   Then every strategy of the aggregation registry that the reference's
   sweeps run (``benchmarks/bench_round.py``'s ``AGG_SWEEP``, krum and
   multi_krum as in ``BENCH_byz.json``, geomedian, fedbuff, and FedAvg
   with a norm bound that clips in round 0): 3 rounds each through the
   kernels with the launch counts asserted, against the same run with
   the aggregation's plain versions on the card, and median and krum
   against their CPU runs. Then the round's DP and codec stages: the
   clip alone, clip and noise, int8 with error feedback, both together,
   top-k with error feedback and DP under the median, 3 rounds each
   through the kernels with the launch counts asserted, against the
   plain-aggregation card run (the same device generator draws the
   noise and the uniforms), two of them against a CPU run that replays
   draws made once on the CPU, and the cumulative ε against the port's
   accountant; one round each of dp_noise and dp_int8_ef (which must run
   the on-chip clip and quant kernels once and no two-launch or
   three-pass one) and topk_ef under the profiler; then one round each of
   dp_noise and int8_ef with every survey group a client (17), which
   must run the clip's two launches and the quant's three passes,
   against the plain-aggregation card run and the CPU run of the same
   draws.
   4d. LM serving: ``serve_lm``'s path (``make_prefill_step``, then
   ``greedy_decode``) for all ten archs at full width in bf16,
   random weights from the seed, batch 4, prompt 2048, 32 tokens:
   qwen2-0.5b, mamba2-780m, granite-moe-3b-a800m, zamba2-1.2b (38
   Mamba2 layers and 6 shared-block calls) and whisper-small (12
   encoder layers over 1500 frames drawn from the generator, 12 decoder
   layers, prompt 416 so the cache is its 448-token context) at full
   depth, qwen3-32b, gemma2-27b, gemma3-27b and llava-next-34b (its
   prefill from embeddings drawn from the generator, decode from
   tokens) at 8 layers, grok-1-314b at 2 (``LM_ARCHS``; each cut
   printed): the launch counts (``_lm_launches``: flash or ssd once a
   layer a prefill, zamba2's flash once a shared block, whisper's once
   an encoder layer too; 0 in decode and 0 for every other kernel),
   the last logits and greedy tokens against the same run through the
   plain branch on the card, prefill and decode times, one profiled
   prefill; the MoE archs' pairs dropped at capacity factor 1.25 and
   the (token, layer) routing choices that differ between the kernel
   and the plain run; the gemmas' ring cache (``ring_cache_from_full``
   of the prefill's cache) decoding the greedy tokens against the full
   cache, with both caches' bytes; then an f32 run at the same depth,
   kernel against plain branch (the gemmas' ring again, at 1e-4), and
   an f32 run at full width and a few layers (``LM_F32_CPU``) against
   the same run on the CPU.
   4e. The paper's experiment: one seed of
   ``repro_torch.benchmarks.paper_experiment``'s pair at the reference's
   widths and ``FedConfig`` (17 groups, 10 clients, d_model 96, head_dim
   24, 6 local epochs at 3e-4, 12+12 questions) through the kernels, 30
   federated rounds and 30 centralized epochs under ``engine="loop"``:
   the launch counts of every round and epoch, the first 3 of each
   against the same pair on the CPU, the falling loss, ``summarize``,
   the wall per round and epoch; the pair again under the default
   engine, both halves replayed from CUDA graphs, each History bit for
   bit the loop's, its walls a round and an epoch printed beside the
   loop's; then 3 rounds of 3 clients a round (``batch_groups``), once
   with ``reset_opt_each_round``: the cohorts equal to the CPU's and
   the run within the training tolerance of the CPU's.
   4f. The round's adversary, availability and hierarchy stages at the
   quickstart's ``FedConfig``: five attacks (f = 3: sign_flip × krum,
   scaled λ 30 × multi_krum, alie × median, gaussian × FedAvg with the
   norm bound, label_flip × FedAvg), four fault configurations (online
   0.8, stragglers 0.7 up to 4 rounds late: FedAvg, FedBuff, median with
   crashes 0.2, int8 with error feedback) and two edges (median, FedAvg),
   3 rounds each through the kernels with the launch counts asserted
   (Krum's distances, the trimmed reduce and the FedAvg reduce), against
   the plain-aggregation card run; sign_flip × krum, faulted FedAvg and
   the median hierarchy also against a CPU run replaying attacker masks
   and fault draws made once on the CPU; a straggler buffered and landed
   in one round; a zero-survivor round that leaves params and server
   state bit for bit, under both engines (the graph replayed on the
   second run); one attacked and one faulted round profiled.
   4g. The sharded round (``make_sharded_round`` through ``ShardedGPO``)
   on processes that ``repro_torch.launch.mesh.spawn`` starts, each
   loading the kernels this process built, at the quickstart's
   ``FedConfig``, 3 rounds a configuration, each held to the stacked
   card run from the same seed: (a) one NCCL process, 10 clients,
   FedAvg and median, bit for bit; (b) two processes of 5 clients (NCCL
   on two cards; on one, gloo over CUDA tensors, staged through the
   host, since NCCL refuses two processes on one device): FedAvg with
   and without the kernels, fedavgm, adaptive, fedbuff, median, krum,
   dp_noise, int8_ef, topk_ef, dp_int8_ef, alie × median, sign_flip ×
   krum, gaussian with the norm bound, label_flip, faulted FedAvg and
   faulted median, within ``TRAIN_TOL`` (codec runs with their level
   allowance, ``_private_within``); (c) four processes on
   ``make_edge_mesh(2, 2)``, 8 clients: FedAvg, median and int8 under
   the median at two edges. Every process's params digest equal each
   round; each process's launches asserted (``_shard_launches``); its
   wall per round, collective time (synchronized) and ledger bytes
   printed beside the stacked run's wall.
   4h. ``engine="scan"`` on the card (``core/federated.py::
   _CapturedRound``: the round body and the eval replayed from two CUDA
   graphs) against the eager card run (``engine="loop"``) from one
   seed, at the quickstart's ``FedConfig`` with eval every round: FedAvg
   (also 3 of 10 clients a round with optimizer resets), every other
   strategy of the registry, every DP and codec configuration of phase
   4b, every attack of phase 4f, the four fault configurations of
   phase 4f and FedAvg under faults at 3 of 10 clients a round with
   resets (the schedule on the card, the survivor count read with the
   block), median and FedAvg at 2 edges, and FedAvg, median,
   dp_int8_ef, the gaussian attack and faulted FedAvg with the kernels
   off, 3 rounds, 3 more and 3 profiled under each engine, bit for bit,
   ``round_survivors`` included (``CAPTURED_BOUND`` names none); the
   graphs replayed once a
   round and once an eval round; the wrappers called once by the
   warm-up and once by the capture, never by a replay; the replayed
   kernels in the profile, counted by name (``KERNEL_NAMES``), equal
   to the loop's launches; one staged round of each under
   ``torch.cuda.set_sync_debug_mode("error")``; FedAvg 20 more rounds in
   blocks of 5 (the same graphs); the paper experiment's configuration
   for 30 rounds, 30 more and 10 profiled. The round's ICL draws are
   staged as question indices and gathered in the graph. Then the
   centralized epoch (``core/centralized.py``, the same capture machine)
   in the same way: the quickstart's configuration 3 epochs, 3 more and
   3 profiled, the paper experiment's 30, 30 and 10, each through the
   kernels and dense, bit for bit its eager card epochs, one staged
   epoch under the sync debug mode; the host's draws a round and an
   epoch timed by part before and after index staging (the per-group
   multinomials, gathers and stack against one multinomial), the bytes
   staged a round and an eval in both layouts; and the 2-D
   ``torch.multinomial`` against the per-row calls on this machine's
   torch. Phases 4, 4b, 4c, 4e, 4f and 4g's stacked runs pass
   ``engine="loop"``, so their launch counts count what they counted
   before.
   4i. LM training (``core/trainer.py``) at full width, bf16, run right
   after phase 1 while the card's memory is whole: (a) 10
   Adam steps of ``make_train_step`` on qwen2-0.5b (24 layers, batch 4,
   seq 256; the loss must fall; step ms and peak memory) and (a') 3 on
   mamba2-780m; (b) the full-parameter ``make_backbone_fedavg_round``
   on qwen2-0.5b (4 clients, 2 local steps, batch 2, seq 128, 3 rounds)
   through the FedAvg kernel at P = 494,032,768, the kernel held to its
   plain version on the round's own (C, P) operand, the losses and
   params to the same rounds with every kernel swapped for its plain
   version on the card (``_plain_versions``), round ms and peak memory; (c) ``make_fedlora_round`` (rank 8, P = 4,399,105, the
   same rounds) under fedavg, fedavgm, median, krum (f = 1), dp_noise,
   dp_int8_ef and topk_ef, each through its kernel and against the same
   run with its plain version on the card, the draws from the same
   device generator; (d) one
   FedAvg and one FedLoRA round in f32 at 2 layers against the CPU; (e)
   ``examples/fedlora_finetune.py``'s ~114.9M-param config, 5 rounds
   in each mode; (f) ``BackboneEmbedder`` on (a)'s trained backbone
   through flash against the plain branch. Launches asserted for each
   run: no flash and no SSD in any train step (LM training takes the
   plain branch, as the kernels have no backward), the aggregation
   kernel once a round, flash once a layer in the embedder.
   4j. ``python -m repro_torch.launch.serve --gpo`` in-process, as a
   user runs it: its default 60 FedAvg rounds at ``GPOConfig()`` width
   through the attention kernels (forward, dq, dk/dv) and the FedAvg
   reduce, the checkpoint saved, the default trace served int8 (the int8
   matmul; the engine's prefix and decode attention is plain); then
   ``--restore`` serves it f32 on the card (no kernel launched) and on
   the CPU, the rows within ``SERVE_CPU_TOL``; the five kernels' wrapper
   launches nonzero; the training (``engine="scan"``: a warm-up round,
   then the captured round replayed) and int8 serving once more under
   the profiler, the five kernels counted by name, nonzero, the FedAvg
   reduce once a round and once in the warm-up; the launcher's p50/p99
   and QPS.
   4k. The dry-run tooling: the sweep of all ten archs x four shapes on
   meta (``launch/sweep.py``, one process an arch, no card visible to
   them; every record ok, and its seconds); phase 4i's qwen2-0.5b step
   counted by ``launch/hlo_cost.py::analyze_step`` on meta and by
   ``FlopCounterMode`` on the card, equal exactly; ``lower_pair`` on a
   (1, 1) mesh at 4i's shape, its params + optimizer + batch bytes no
   larger than 4i's measured peak; mfu (``launch/roofline.py``'s
   ``model_flops``, 6·N·D a train step and 2·N·D a prefill, over the
   measured time x the bf16 dense peak) of 4i's step and 4d's prefills.
   4l. Kernel coverage: the attention forward, dq and dk/dv at head
   widths ``COVER_HDS`` (12 and 100 padded to a built width) at the
   training shape and the experiment's, and the trimmed reduce (trim 0,
   1, the median; ties, NaN in entries and in a whole column, an
   infinity) and the pairwise distances at ``COVER_CS`` clients past
   the C <= 32 designs, each against its plain version, each call a
   launch of its kernel, two calls bit for bit, and the pairwise
   distances at ``COVER_F64_CS`` clients against float64 as phase 1
   holds the C <= 32 design (a one-pass control must fail); then the
   users that need those shapes, through the kernels against their CPU
   runs:
   ``benchmarks/bench_round.py``'s round (head_dim 8), krum and the
   median over 40 clients (67 groups at the 60/40 split), the dry run
   ``--gpo-fed --pallas-attn --clients 8`` (head_dim 16; its processes'
   launches and losses). Each widened source's build seconds and its
   kernels' registers and spills by width.
   4m. The kernels' last shape limits: flash at head widths
   ``LIMIT_FLASH_HDS`` (1 and 8 padded to 16, 100 to 128) in f32 and
   bf16, causal with
   GQA, a window with a softcap and non-causal at a ragged kv_len, and
   phase 1's two planted bf16 faults at hd 256; the SSD scan at chunk
   256, p 128 and n 256, each alone, in f32 and bf16 with the state;
   the C <= 32 trimmed kernel's NaN columns (a NaN or an infinity
   trimmed away makes the column NaN, as in the reference) at
   ``LIMIT_NAN_CS``; clip and quant at ``LIMIT_ROW_C`` clients (their
   scales in device memory); trimmed and pairwise at ``LIMIT_WIDE_CS``
   clients; each against its plain version at phase 1's tolerances,
   twice bit for bit, one launch a call. Then the users that need those
   shapes, kernels against the plain branch on the card: a 2-layer
   gemma2-27b at Gemma 2 9B's attention widths (16/8 heads of 256) and a
   2-layer mamba2-780m at chunk 256, one prefill each in bf16 and f32;
   the DP release (``private_delta_flat``) on ``LIMIT_ROW_C`` client
   rows; the registry's median and krum on ``LIMIT_WIDE_CS[0]`` rows.
5. Timing: each kernel, its plain version and one PyTorch library call
   at the main paths' shapes (CUDA events, median of repeats; replayed
   from a CUDA graph for the device time, and launched eagerly),
   beside the card's least time for the same work; the attention
   forward also at other num_ctx and for one bh alone; the attention
   backward (delta, dq, dk/dv through ``GPOAttention``) also beside
   SDPA's backward alone, each replayed from a retained graph, and dq
   and dk/dv at other num_ctx and for one bh alone; flash also at
   qwen3-32b's widths (B 1, H 64, KV 8, S 2048, hd 128), at the
   gemmas' local layers (B 4, H 32, KV 16, S 2048, hd 128: window 4096
   with softcap 50, no library call; window 1024 beside SDPA with the
   same boolean mask), at whisper-small's encoder (B 4, H = KV 12, hd
   64, S 1500 padded to 1536, non-causal, beside non-causal SDPA) and
   decoder (S 416 padded to 512), llava-next-34b's (B 4, H 56, KV 8, hd
   128, S 2048) and zamba2-1.2b's shared block (B 4, H = KV 32, hd 64,
   S 2048); SSD also at zamba2's trunk (h 64, p 64, n 64); int8 also at
   (1280, 256) x (256, 256); SSD also at batch 1, in f32, and beside
   the chunked plain branch (``ssd_chunked``), after its bf16 check and
   planted faults at the prefill shape; the DP clip reduce also in its
   other design (two launches) and, on chip, by phase from a build that
   stamps each block's clock (tile load, barrier wait, reduce); the
   attention kernels and the FedAvg reduce also at phase 4e's shapes;
   the FedAvg reduce also at phase 4i's (4, 494,032,768) and (4,
   4,399,105), the momentum reduce at the latter; phase 4m's shapes
   (``LIMIT_TIME_FLASH``, SSD at chunk 256, clip and quant at
   ``LIMIT_TIME_ROW_C`` clients, trimmed and pairwise at
   ``LIMIT_TIME_WIDE_C``).

Launch counters are set to 0 right before each main-path phase and read
right after it. The last seventeen lines of standard output are the
``engine`` JSON line (steps, launches, latency summaries, profiles), the
``train`` JSON line (launches, agreement, losses, profile), the
``strategies`` JSON line (per strategy: launches, agreement, wall per
round), the ``private`` JSON line (the same per DP and codec
configuration, with ε), the ``lm`` JSON line (per architecture:
launches, times, agreement, profile), the ``experiment`` JSON line
(launches, walls, agreement, ``summarize``, the partial-participation
runs), the ``stages`` JSON line (per phase 4f configuration: launches,
agreement, wall per round, survivors per round), the ``sharded`` JSON
line (per phase 4g part: backend, devices; per configuration each
process's launches, walls and collective ms, the ledger's calls and
bytes, agreement), the ``captured`` JSON line (per phase 4h
configuration, the centralized ones too: the loop's launches, the
replayed kernels in the profile, walls under both engines, the host's
draw, stage and replay ms, warm-up and capture ms, staged bytes,
deviation; the draws by part; the multinomial check), the ``lm_train``
JSON line (phase 4i: losses, step and round ms, peak memory, launches,
agreement), the ``serve_train`` JSON line (phase 4j: round ms,
launches, the latency summaries, the CPU rows' distance), the
``tooling`` JSON line (phase 4k: the sweep's records and seconds, the
two FLOP counts, the dry run's bytes, mfu), the ``coverage`` and
``limits`` JSON lines (phases 4l and 4m: each shape's errors, repeats
and launches, the users' runs), the ``kernels`` JSON line
(4g's, 4h's, 4i's and 4j's launches in each row's ``launches_by_path``,
4i's shapes under ``lm_train_shapes``), the
card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout of the repository, the script exits non-zero and prints no
result. Full float32 for the GPO paths: TF32 is off for matmuls and
cuDNN; the LM phase serves the configs' bf16 (and one f32 run).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.benchmarks.paper_experiment import (  # noqa: E402
    FED_SETTINGS,
    make_pair,
    result_from_histories,
    summarize,
)
from repro_torch.checkpoint import (  # noqa: E402
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import (  # noqa: E402
    ALL_ARCHS,
    AdversaryConfig,
    AggConfig,
    AvailabilityConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
    HierarchyConfig,
    InputShape,
    MAMBA,
    ModelConfig,
    PrivacyConfig,
    ServeConfig,
    get_arch,
    override,
)
from repro_torch.core import adversary as byz  # noqa: E402
from repro_torch.core import availability as av  # noqa: E402
from repro_torch.core import compression as cx  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core import privacy as dp  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CentralizedGPO,
    FederatedGPO,
    PreferenceServer,
    gpo_apply,
    greedy_decode,
    init_gpo_params,
    latency_summary,
    make_prefill_step,
    make_request_trace,
    make_serve_step,
    predict_preferences,
    quantize_gpo_params,
)
from repro_torch.core import History, ShardedGPO, federated  # noqa: E402
from repro_torch.core import (  # noqa: E402
    broadcast_to_clients,
    init_lora,
    make_aggregator,
    make_backbone_fedavg_round,
    make_fedlora_round,
    make_train_step,
)
from repro_torch.core.fairness import alignment_score  # noqa: E402
from repro_torch.core.gpo import map_params  # noqa: E402
from repro_torch.data import (  # noqa: E402
    ICLDraw,
    SurveyConfig,
    gather_icl_batch,
    make_survey_data,
    sample_icl_batch,
    sample_icl_indices,
    split_groups,
)
from repro_torch.data import (  # noqa: E402
    BackboneEmbedder,
    LMDataConfig,
    synthetic_lm_batches,
)
from repro_torch.examples import fedlora_finetune  # noqa: E402
from repro_torch.kernels import backend, quantize_linear  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels.agg_reduce import (  # noqa: E402
    _CLIP_ARGTYPES,
    _PAIRWISE_ARGTYPES,
    _TILES_ARGTYPES,
    pairwise_design_for,
    pairwise_split,
    ROW_CHUNK,
    clip_reduce_flat,
    fedavg_reduce_flat,
    momentum_reduce_flat,
    pairwise_dists_flat,
    QUANT_SPLIT,
    quant_clip_reduce_flat,
    quant_split,
    topk_reduce_flat,
    trimmed_design_for,
    trimmed_reduce_flat,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bhsd,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    head_width_for as flash_width_for,
)
from repro_torch.kernels.gpo_attention import (  # noqa: E402
    _DKDV_ARGTYPES,
    _DQ_ARGTYPES,
    _FWD_ARGTYPES,
    GPOAttention,
    gpo_attention_bwd_dkdv,
    gpo_attention_bwd_dq,
    gpo_attention_fwd,
    head_width_for,
)
from repro_torch.kernels.ops import (  # noqa: E402
    flash_attention,
    ssd_scan_with_state,
)
from repro_torch.kernels.quant_matmul import int8_matmul_flat  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    ref_clip_reduce,
    ref_fedavg_flat,
    ref_momentum_reduce_flat,
    ref_pairwise_sq_dists,
    ref_quant_clip_reduce,
    ref_topk_mask_reduce,
    ref_trimmed_flat,
    ref_gpo_attention,
    ref_gpo_attention_bwd,
    ref_gpo_attention_bwd_dkdv,
    ref_gpo_attention_bwd_dq,
    ref_int8_matmul,
    ref_attention,
    ref_ssd,
)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    p_width_for,
    ssd_scan_bhsp,
)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.hlo_cost import analyze_step  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    MeshShape,
    make_edge_mesh,
    make_host_mesh,
    spawn,
)
from repro_torch.models import attention as lm_attention  # noqa: E402
from repro_torch.launch.train import stack_client_batches  # noqa: E402
from repro_torch.models import hidden_states, init_params, moe  # noqa: E402
from repro_torch.optim import adam as lm_adam  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    ring_cache_from_full,
    uses_ring_cache,
)
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.utils.pytree import (  # noqa: E402
    tree_count_params,
    tree_index,
    tree_leaves,
    tree_map,
)

# weights, survey data, trace and kernel inputs. With seed 0 the random
# predictor's mu stays well above the 1e-4 clip on the served groups, so
# clip-and-normalized rows are well conditioned and the row tolerances
# below test the kernels, not the clip.
SEED = 0
# NVIDIA data sheet rows: (f32 CUDA-core FLOP/s, memory bytes/s), dense
_PEAKS = {"SXM": (67e12, 3.35e12), "PCIe": (51e12, 2.0e12),
          "NVL": (60e12, 3.9e12)}
# and the bf16 dense tensor-core rate of the same rows (the LM kernels'
# operations are bf16 products)
_BF16_PEAKS = {"SXM": 989e12, "PCIe": 756e12, "NVL": 835e12}
# and the TF32 dense tensor-core rate (the attention backward's products,
# three TF32 passes each)
_TF32_PEAKS = {"SXM": 494.7e12, "PCIe": 378e12, "NVL": 417.5e12}
INT8_SHAPES = [(66, 128), (128, 128), (128, 256), (256, 128), (128, 1),
               (4098, 128)]  # (K, N): in_proj, wq..wo, w1, w2, head, paper
INT8_M_ROWS = (16, 320, 1280)  # M of which rows 0-15 must not depend on
# (BH, S, ctx): training's 10 clients x 4 heads, predict's 7 held-out
# groups x 4 heads, then the backward's shapes (BWD_SHAPES): ragged S and
# num_ctx at both ends, and a long ragged S that streams many stages; and
# num_ctx 13, under one stage, where two of the forward's warps see no key
ATTN_SHAPES = [(10 * 4, 160, 80), (7 * 4, 160, 80), (4, 80, 60),
               (4, 85, 37), (4, 64, 0), (4, 64, 64), (4, 645, 321),
               (4, 37, 13)]
# the backward's: 10 clients x 4 heads at the quickstart's 16+16
# questions of 5 options, then ragged S and num_ctx at both ends, and a
# longer ragged S that streams many stages through both kernels
BWD_SHAPES = [(10 * 4, 160, 80), (4, 80, 60), (4, 85, 37), (4, 64, 0),
              (4, 64, 64), (4, 645, 321)]
BWD_ALONE = 7  # the bh slice that must come out alone as in the batch
# the forward's o: its mean |error| against the forward in float64 at
# most this many times the plain f32 version's, at the training shape
# and at the longest band of ATTN_SHAPES (10 stages of keys), at both
# head widths. The same planted control (the forward rebuilt with
# _CHAINED_EDITS) must exceed it at every one of these shapes: the
# kernel reads 0.54-0.80x there and the control 1.34-2.30x (PERF.md,
# section 6), so the limit sits between the two. The forward's o and
# lse feed every backward and every client's training, which phase 4
# holds to the CPU within 1e-4
FWD_F64_RATIO = 1.1
FWD_F64_SHAPES = ((10 * 4, 160, 80), (4, 645, 321))
# the backward kernels' mean |error| against the backward in float64, at
# the training shape, at most this many times the plain f32 version's: a
# design that chained every product through one tensor-core accumulator
# (which rounds toward zero) drifted far enough to fail phase 4's krum
# agreement with the CPU; phase 1 rebuilds that design from the source as
# a planted control (_CHAINED_EDITS) and requires it to fail this limit
BWD_F64_RATIO = 1.5
# the control's edits of gpo_tiles.cuh, the tile schedule that the
# forward and backward sources share: each k-step's big.big and each
# product of a stage go into the running accumulator itself
_CHAINED_EDITS = (
    ("""    mma_tf32(lo, as, bb[0], bb[1]);
    mma_tf32(lo, ab, bs[0], bs[1]);
    float hi[4] = {};
    mma_tf32(hi, ab, bb[0], bb[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += hi[e];
""", """    mma_3xtf32(d, ab, as, bb, bs);
"""),
    ("""    float t[4] = {};
    mma_3xtf32(t, ab, as, bb, bs);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += t[e];
""", """    mma_3xtf32(acc[nt], ab, as, bb, bs);
"""))
# Krum's pairwise distances at the quickstart's (C, P), and in phase 4l
# at COVER_F64_CS clients (the tiled design): the kernel's mean |error|
# against the distances in float64 at most this many times the f32
# expansion form's in plain PyTorch (TF32 off). A planted control, the
# source rebuilt with one TF32 pass (big.big alone in both designs,
# _ONE_PASS_EDITS), must exceed it; the per-value 3xTF32 split
# (_SPLIT_3X_EDITS), whose k-step sums of a row's squares the tensor
# cores round toward zero, is read beside it at the quickstart's shape
PAIRWISE_F64_RATIO = 1.5
PAIRWISE_F64_SHAPE = (10, 534016)
_ONE_PASS_EDITS = (
    ("""        mma_tf32(l, as, big[n][kk][0], big[n][kk][1]);
        mma_tf32(l, as, half[n][kk][0], half[n][kk][1]);
""", ""),
    ("""        mma_tf32(lo, as, bJ[n][kk][0], bJ[n][kk][1]);
        mma_tf32(lo, ab, sJ[n][kk][0], sJ[n][kk][1]);
        mma_tf32(lo, as, sJ[n][kk][0], sJ[n][kk][1]);
""", ""))
_SPLIT_3X_EDITS = (
    ("""      const float b = __fmul_rn(rintf(__fmul_rn(v[k][e], inv)), step);
      const float sm = __fsub_rn(v[k][e], b);
""", """      uint32_t bb, ss;
      split_tf32(v[k][e], bb, ss);
      const float b = __uint_as_float(bb), sm = __uint_as_float(ss);
"""),
    ("""          mma_tf32(hi, ab, big[n][kk][0], big[n][kk][1]);
        }
        mma_tf32(l, as, big[n][kk][0], big[n][kk][1]);
        mma_tf32(l, as, half[n][kk][0], half[n][kk][1]);
""", """          float t3[4] = {};
          mma_3xtf32(t3, ab, as, big[n][kk], small[n][kk]);
#pragma unroll
          for (int e = 0; e < 4; ++e) hi[e] = __fadd_rn(hi[e], t3[e]);
        }
"""))
# a reading, not a control: the on-chip clip kernel with thread 0 of each
# block stamping %globaltimer at its start, after its tile and partial
# norms, after the grid barrier and at its end, into a device array the
# added clip_stamps_read entry copies out (phase 5, beside row 7)
_STAMP_EDITS = (
    ("using namespace client_rows;\n", """using namespace client_rows;

__device__ unsigned long long g_clip_stamps[4 * kOcSplit];

__device__ __forceinline__ void clip_stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_clip_stamps[k * kOcSplit + blockIdx.x] = t;
  }
}
"""),
    ("  const Blk blk(oc_buf, C, P, width);\n",
     "  const Blk blk(oc_buf, C, P, width);\n  clip_stamp(0);\n"),
    ("  grid_barrier();\n", """  __syncthreads();
  clip_stamp(1);
  grid_barrier();
  clip_stamp(2);
"""),
    ("    st<V>(out + blk.col0 + k * V, acc);\n  }\n}\n",
     """    st<V>(out + blk.col0 + k * V, acc);
  }
  __syncthreads();
  clip_stamp(3);
}
"""),
    ('extern "C" int clip_reduce_launch(',
     """extern "C" int clip_stamps_read(unsigned long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_clip_stamps, sizeof(g_clip_stamps)));
}

extern "C" int clip_reduce_launch("""))
# phase 4l, the kernels' coverage of the reference's shapes: head widths
# that are not built (12, 100: padded), built ones past 32, at the
# training shape and at the experiment's (S 120, num_ctx 60); client
# counts past the C <= 32 designs, at the quickstart's P
COVER_HDS = (8, 12, 16, 40, 64, 100, 128, 256)
COVER_ATTN = ((40, 160, 80), (40, 120, 60))
COVER_CS = (33, 64, 200, 1024)
COVER_P = 534016
# the tiled pairwise design against float64 (PAIRWISE_F64_RATIO), and the
# products a k-step and tile that it computes on the tensor cores at the
# TF32 rate (big.big and three small), which phase 5 prices
COVER_F64_CS = (64, 1024)
GRAM_TILE_PRODUCTS = 4
# phase 5's rows of the same: widths and client counts
COVER_ROW_HDS = (8, 64, 128, 256)
COVER_ROW_CS = (64, 1024)
# the sources whose kernels phase 4l widened: their ptxas reports
COVER_SOURCES = ("gpo_attention_fwd", "gpo_attention_bwd", "trimmed_reduce",
                 "pairwise_dists")
# phase 4m, the kernels' last shape limits: flash at head widths past the
# first built 64 and 128 (Phi-2's 80, Phi-3-mini's 96, Gemma's 256; 1 and
# 8 padded to 16, whose kernel takes p in three bf16 parts; 100 padded to
# 128), both dtypes, (B, S, H, KV, keyword arguments): causal with GQA, a
# window with a softcap, non-causal at a ragged kv_len
LIMIT_FLASH_HDS = (1, 8, 16, 32, 80, 96, 100, 256)
LIMIT_FLASH_CASES = ((2, 257, 4, 2, {"causal": True}),
                     (1, 128, 4, 4, {"causal": True, "window": 7,
                                     "softcap": 20.0}),
                     (2, 100, 4, 4, {"causal": False, "kv_len": 77}))
# the SSD scan past each tile alone, (b, s, h, p, n, chunk): chunk 256 at
# mamba2's p 64 and n 128, p 128, n 256
LIMIT_SSD = ((2, 512, 4, 64, 128, 256), (2, 256, 4, 128, 128, 128),
             (2, 256, 4, 64, 256, 128))
# the trimmed register design's NaN columns (C <= 32); the clip and quant
# reduces past the 4096 clients whose scales live in shared memory (P
# past the on-chip designs, and one P they hold); the trimmed and
# pairwise reduces past 1024 clients
LIMIT_NAN_CS = (5, 17, 32)
LIMIT_ROW_C, LIMIT_ROW_PS = 5000, (8192, 512)
LIMIT_WIDE_CS, LIMIT_WIDE_P = (2048, 4096), 8192
# the users: a 2-layer gemma2-27b at Gemma 2 9B's attention widths (16
# heads, 8 KV heads of 256) and a 2-layer mamba2-780m at chunk 256 (the
# published Mamba2 and Zamba2 default), one prefill each in bf16 and f32
# at (LIMIT_LM_BATCH, LIMIT_LM_PROMPT), kernel against plain branch; the
# DP release on LIMIT_ROW_C client rows; median and krum on
# LIMIT_WIDE_CS[0] rows
LIMIT_LM = {"gemma2-27b": dict(num_layers=2, num_heads=16, num_kv_heads=8,
                               head_dim=256),
            "mamba2-780m": dict(num_layers=2, ssm_chunk=256)}
LIMIT_LM_BATCH, LIMIT_LM_PROMPT = 2, 1024
# phase 5's rows of phase 4m's shapes: flash at Gemma 2 9B's widths and
# Phi-3-mini's (B, H, KV, S, hd), bf16, causal; SSD at mamba2's widths at
# chunk 256 beside chunk 128; clip and quant at LIMIT_TIME_ROW_C, trimmed
# and pairwise at LIMIT_TIME_WIDE_C
LIMIT_TIME_FLASH = {"12i": (4, 16, 8, 2048, 256), "12j": (4, 32, 32, 2048, 96)}
LIMIT_TIME_ROW_C, LIMIT_TIME_WIDE_C = 8192, 4096
HEAD_DIM = 32
HEAD_DIMS = (32, 24)  # GPOConfig() and benchmarks/paper_experiment.py
# (C, P): the quickstart's 10 clients x 534,016 GPOConfig() params, then
# ragged P through the kernel's scalar path
FEDAVG_SHAPES = [(10, 534016), (3, 2049), (1, 7)]
# the other aggregation kernels: the quickstart's shape, ragged P, and
# the kernels' cap of 32 clients (bench_round.py's aggregation section)
AGG_SHAPES = [(10, 534016), (3, 2049), (1, 7), (32, 5001)]
# the clip and quant reduces also above their on-chip capacity (48
# clients' x or u is 103 MB), where the two-launch and three-pass designs
# run
QUANT_THREE_PASS_SHAPE = (48, 534016)
# the registry's strategies on the training path: AGG_SWEEP of
# benchmarks/bench_round.py:217-228 (its hyperparameters), krum and
# multi_krum with f = 3 and m = 3 as in BENCH_byz.json, geomedian,
# fedbuff, and FedAvg with a server-side norm bound. Round 0's client
# delta norms at this config lie in 0.457-0.483 (the port's CPU run), so
# 0.475 clips about half of the rows there.
NORM_BOUND = 0.475
STRATEGIES = {
    "fedavg": {},
    "fedavgm": {"momentum": 0.9, "server_lr": 1.0},
    "fedadam": {"beta1": 0.9, "beta2": 0.99, "tau": 1e-2,
                "server_lr": 1e-2},
    "fedyogi": {"beta1": 0.9, "beta2": 0.99, "tau": 1e-2,
                "server_lr": 1e-2},
    "fedprox": {"prox_mu": 0.01},
    "trimmed_mean": {"trim_frac": 0.1},
    "median": {},
    "adaptive": {"fair_temp": 1.0, "fair_decay": 0.9},
    "krum": {"num_malicious": 3},
    "multi_krum": {"num_malicious": 3, "multi_krum_m": 3},
    "geomedian": {},
    "fedbuff": {},
    "fedavg+norm_bound": {"name": "fedavg", "norm_bound": NORM_BOUND},
}
# the aggregation kernel each strategy launches once a round (none:
# geomedian, which has no kernel in the reference either)
STRATEGY_KERNEL = {"fedavgm": "momentum_reduce",
                   "trimmed_mean": "trimmed_reduce",
                   "median": "trimmed_reduce", "krum": "pairwise_dists",
                   "multi_krum": "pairwise_dists", "geomedian": None}
CPU_STRATEGIES = ("median", "krum")
# the round's DP and codec stages (DESIGN.md §9, §10): the clip at the
# norm bound above (about half of round 0's rows clipped), the noise
# multiplier of examples/quickstart.py:30, the reference's int8 and
# top-k defaults (stochastic rounding, EF21 error feedback, 1% kept)
TOPK_FRAC = 0.01
_DP = {"clip_norm": NORM_BOUND, "noise_multiplier": 0.8}
PRIVATE = {
    "dp_clip": {"privacy": {"clip_norm": NORM_BOUND}},
    "dp_noise": {"privacy": _DP},
    "int8_ef": {"compression": {"kind": "int8"}},
    "dp_int8_ef": {"privacy": _DP, "compression": {"kind": "int8"}},
    "topk_ef": {"compression": {"kind": "topk", "topk_frac": TOPK_FRAC}},
    "dp_median": {"privacy": _DP, "agg": {"name": "median"}},
}
# the kernel each configuration launches once a round (dp_median:
# privatize in plain torch, then the median's trimmed kernel)
PRIVATE_KERNEL = {"dp_clip": "clip_reduce", "dp_noise": "clip_reduce",
                  "int8_ef": "quant_clip_reduce",
                  "dp_int8_ef": "quant_clip_reduce",
                  "topk_ef": "topk_reduce", "dp_median": "trimmed_reduce"}
CPU_PRIVATE = ("dp_noise", "int8_ef")
# one more round of these under the profiler: the DP clip's on-chip
# kernel, the heaviest transport kernel, and the top-k selection outside
# its kernel
PROFILED_PRIVATE = ("dp_noise", "dp_int8_ef", "topk_ef")
# and one replayed round of these with every survey group a client (17 at
# SurveyConfig()), past the on-chip designs' 13 clients at the
# quickstart's P: the clip's two launches and the quant's three passes,
# against the CPU run of the same draws
WIDE_PRIVATE = {"dp_noise": "two_launch", "int8_ef": "three_pass"}
# coordinates of params and EF residual that may lie beyond 1e-4 of the
# other run after 3 rounds (flipped int8 levels, swapped top-k near-ties;
# train_private): 0.02% of the 5.3 M, a bound against a systematic error
MAX_FLIPPED = 1000
# phase 4f, the round's adversary, availability and hierarchy stages
# (DESIGN.md §11, §13, §14) at the quickstart's FedConfig: the attacks of
# BENCH_byz.json (f = 3 of the 10 clients, λ 30; benchmarks/
# bench_round.py:918-928) against its defenses, the gaussian attack at
# AdversaryConfig's default σ under phase 4's norm bound; the faults of
# BENCH_async.json at dropout 0.2 (bench_round.py:845-849: online 0.8,
# crash 0.05, stragglers 0.7 delayed up to 4 rounds, rejoin after 1;
# fedbuff at its buffer_k 2),
# median with crash_prob 0.2; two edges
STAGE_ROUNDS = 3
_BYZ = {"num_attackers": 3}
_FAULTS = {"online_prob": 0.8, "crash_prob": 0.05, "straggler_prob": 0.7,
           "max_staleness": 4, "rejoin_rounds": 1}
STAGE_RUNS = {
    "sign_flip-krum": {"adversary": {"kind": "sign_flip", **_BYZ},
                       "agg": {"name": "krum", "num_malicious": 3}},
    "scaled-multi_krum": {"adversary": {"kind": "scaled", "scale": 30.0,
                                        **_BYZ},
                          "agg": {"name": "multi_krum", "num_malicious": 3,
                                  "multi_krum_m": 3}},
    "alie-median": {"adversary": {"kind": "alie", **_BYZ},
                    "agg": {"name": "median"}},
    "gaussian-fedavg-norm_bound": {"adversary": {"kind": "gaussian", **_BYZ},
                                   "agg": {"norm_bound": NORM_BOUND}},
    "label_flip-fedavg": {"adversary": {"kind": "label_flip", **_BYZ}},
    "faults-fedavg": {"avail": _FAULTS},
    "faults-fedbuff": {"avail": _FAULTS,
                       "agg": {"name": "fedbuff", "buffer_k": 2}},
    "faults-median": {"avail": {**_FAULTS, "crash_prob": 0.2},
                      "agg": {"name": "median"}},
    "faults-int8_ef": {"avail": _FAULTS, "compression": {"kind": "int8"}},
    "hier-median": {"hierarchy": {"num_edges": 2},
                    "agg": {"name": "median"}},
    "hier-fedavg": {"hierarchy": {"num_edges": 2}},
}
# (the aggregation kernel a run launches, launches a round): Krum's
# distances once; the trimmed reduce once, or once an edge (the server's
# 2-candidate median trims k = 0, the weighted mean, which never reaches
# the kernel, in the reference too); the FedAvg reduce once, or once an
# edge; under faults once every round, a round that absorbed no row too
# (the masked reduce runs and its result is discarded, as in the
# reference's traced round); median's masked reduce under faults is
# plain torch (the reference has no kernel for it)
STAGE_KERNEL = {"sign_flip-krum": ("pairwise_dists", 1),
                "scaled-multi_krum": ("pairwise_dists", 1),
                "alie-median": ("trimmed_reduce", 1),
                "gaussian-fedavg-norm_bound": ("fedavg_reduce", 1),
                "label_flip-fedavg": ("fedavg_reduce", 1),
                "faults-fedavg": ("fedavg_reduce", 1),
                "faults-fedbuff": ("fedavg_reduce", 1),
                "faults-median": (None, 0),
                "faults-int8_ef": ("fedavg_reduce", 1),
                "hier-median": ("trimmed_reduce", 2),
                "hier-fedavg": ("fedavg_reduce", 2)}
# one of each family against the CPU, the schedules and the noise
# replayed through the hooks; one attacked and one faulted round profiled
STAGE_CPU = ("sign_flip-krum", "faults-fedavg", "hier-median")
STAGE_PROFILED = ("sign_flip-krum", "faults-fedavg")
# phase 4g, the sharded round (core/federated.py::make_sharded_round,
# driven by ShardedGPO) at the quickstart's FedConfig, SHARD_ROUNDS
# rounds a configuration, each process's counters, walls and collective
# ledger returned to the parent and held to the stacked card run from
# the same seed (the same generators draw the same values for the whole
# population; each process keeps its rows): (a) one NCCL process, C 10,
# bit for bit; (b) two processes of 5 clients (NCCL on two cards, gloo
# over CUDA tensors on one), every configuration of SHARD_RUNS: the
# strategies, the DP and codec stages and phase 4f's attacks and faults;
# (c) make_edge_mesh(2, 2), C 8
SHARD_ROUNDS = 3
SHARD_RUNS = {
    "fedavg": {},
    "fedavg-plain": {"plain": True},
    "fedavgm": {"agg": {"name": "fedavgm", **STRATEGIES["fedavgm"]}},
    "adaptive": {"agg": {"name": "adaptive", **STRATEGIES["adaptive"]}},
    "fedbuff": {"agg": {"name": "fedbuff"}},
    "median": {"agg": {"name": "median"}},
    "krum": {"agg": {"name": "krum", **STRATEGIES["krum"]}},
    "dp_noise": PRIVATE["dp_noise"],
    "int8_ef": PRIVATE["int8_ef"],
    "topk_ef": PRIVATE["topk_ef"],
    "dp_int8_ef": PRIVATE["dp_int8_ef"],
    **{k: STAGE_RUNS[k] for k in (
        "alie-median", "sign_flip-krum", "gaussian-fedavg-norm_bound",
        "label_flip-fedavg", "faults-fedavg", "faults-median")},
}
SHARD_ONE = ("fedavg", "median")
SHARD_EDGE = {
    "hier-fedavg": STAGE_RUNS["hier-fedavg"],
    "hier-median": STAGE_RUNS["hier-median"],
    "hier-int8-median": {**STAGE_RUNS["hier-median"],
                         "compression": {"kind": "int8"}},
}
SHARD_EDGE_CLIENTS = 8
# the aggregation kernel each process launches once a round (under
# faults once a round that absorbed a row): the linear family's on its
# own rows before the all-reduce (fedavgm too: the fused momentum step
# is the stacked round's), the robust family's on the gathered (C, P)
# matrix, the two hops' on the edge's rows (the server's 2-candidate
# median trims k = 0: no kernel); none for the dense run and for faulted
# median's masked reduce (plain torch, as in the reference)
SHARD_KERNEL = {"fedavg": "fedavg_reduce", "fedavg-plain": None,
                "fedavgm": "fedavg_reduce", "adaptive": "fedavg_reduce",
                "fedbuff": "fedavg_reduce", "median": "trimmed_reduce",
                "krum": "pairwise_dists", "dp_noise": "clip_reduce",
                "int8_ef": "quant_clip_reduce", "topk_ef": "topk_reduce",
                "dp_int8_ef": "quant_clip_reduce",
                "alie-median": "trimmed_reduce",
                "sign_flip-krum": "pairwise_dists",
                "gaussian-fedavg-norm_bound": "fedavg_reduce",
                "label_flip-fedavg": "fedavg_reduce",
                "faults-fedavg": "fedavg_reduce", "faults-median": None,
                "hier-fedavg": "fedavg_reduce",
                "hier-median": "trimmed_reduce",
                "hier-int8-median": "trimmed_reduce"}
# phase 4e, the paper's experiment (benchmarks/paper_experiment.py): one
# seed of the pair, EXP_ROUNDS federated rounds and as many centralized
# epochs, its first EXP_CPU_ROUNDS against the CPU run; then SUB_ROUNDS
# at batch_groups=SUB_GROUPS (with and without reset_opt_each_round)
# against the CPU run
EXP_ROUNDS, EXP_CPU_ROUNDS = 30, 3
SUB_GROUPS, SUB_ROUNDS = 3, 3
# phase 4h, the captured round (engine="scan" on the card: the round body
# replayed from a CUDA graph, core/federated.py::_CapturedRound) at the
# quickstart's FedConfig with eval every round: each configuration
# CAPTURED_ROUNDS rounds under both engines from one seed, then as many
# more under each, the captured run held to the eager card run
# (engine="loop"), then CAPTURED_ROUNDS more captured under the profiler;
# FedAvg also CAPTURED_MORE more rounds with log_every 5 (blocks longer
# than the first run's, replayed from the same graphs); and the paper
# experiment's configuration for CAPTURED_PAPER_ROUNDS rounds. Every
# strategy of the registry, every DP and codec configuration of phase 4b
# and every attack of phase 4f run through the kernels; "dense" runs
# with use_pallas_attention and use_pallas_aggregation off
CAPTURED = {
    "fedavg": {},
    "fedavg-sub3-reset": {"batch_groups": 3, "reset_opt_each_round": True},
    **{name: {"agg": {"name": name, **STRATEGIES[name]}} for name in (
        "fedprox", "fedavgm", "fedadam", "fedyogi", "trimmed_mean",
        "median", "adaptive", "fedbuff", "krum", "multi_krum",
        "geomedian")},
    **{name: PRIVATE[name] for name in (
        "dp_clip", "dp_noise", "int8_ef", "dp_int8_ef", "topk_ef",
        "dp_median")},
    **{name: STAGE_RUNS[name] for name in (
        "sign_flip-krum", "scaled-multi_krum", "alie-median",
        "gaussian-fedavg-norm_bound", "label_flip-fedavg", "faults-fedavg",
        "faults-fedbuff", "faults-median", "faults-int8_ef")},
    "faults-fedavg-sub3-reset": {"avail": _FAULTS, "batch_groups": 3,
                                 "reset_opt_each_round": True},
    "median-2-edges": STAGE_RUNS["hier-median"],
    "fedavg-2-edges": STAGE_RUNS["hier-fedavg"],
    "dense-fedavg": {"dense": True},
    "dense-median": {"dense": True, "agg": {"name": "median"}},
    "dense-dp_int8_ef": {"dense": True, **PRIVATE["dp_int8_ef"]},
    "dense-gaussian-fedavg-norm_bound": {
        "dense": True, **STAGE_RUNS["gaussian-fedavg-norm_bound"]},
    "dense-faults-fedavg": {"dense": True, **STAGE_RUNS["faults-fedavg"]},
}
CAPTURED_ROUNDS, CAPTURED_MORE, CAPTURED_PAPER_ROUNDS = 3, 20, 30
# the centralized epoch captured (core/centralized.py, through the same
# _CapturedRound): the quickstart's configuration (GPOConfig() width, a
# step for each of the 10 training groups an epoch, eval every epoch)
# for CAPTURED_ROUNDS epochs and as many more, and the paper
# experiment's (phase 4e's trainer, eval every 10) for
# CAPTURED_PAPER_ROUNDS and as many more, each through the kernels and
# dense, bit for bit as the federated configurations
CAPTURED_CEN = ("quickstart", "quickstart-dense", "paper", "paper-dense")
# the host half's ICL draws timed by part, before (one sample_icl_batch
# a group: the multinomial, the gathers, the stack) and after (one
# sample_icl_indices over every row, the gathers moved into the graph),
# median of DRAW_REPS rounds or epochs
DRAW_REPS = 20
# the graph replays the eager round's kernels on the same operands, so
# the captured run must equal the eager card run bit for bit; a
# configuration named here may differ by at most its bound (≤ 1e-6), for
# the cause PERF.md gives. None is named.
CAPTURED_BOUND: dict = {}
# the device kernels of one wrapper call, by name in a profile (at the
# quickstart's 10 clients the clip and quant reduces run on chip, one
# kernel a call; Krum's distances end in one finish kernel a call)
KERNEL_NAMES = {
    "gpo_attention_fwd": ("gpo_attention_fwd_kernel",),
    "gpo_attention_bwd_dq": ("gpo_attention_bwd_dq_kernel",),
    "gpo_attention_bwd_dkdv": ("gpo_attention_bwd_dkdv_kernel",),
    "fedavg_reduce": ("fedavg_reduce_",),
    "momentum_reduce": ("momentum_reduce_",),
    "trimmed_reduce": ("trimmed_reduce_kernel",),
    "pairwise_dists": ("gram_finish_kernel",),
    "clip_reduce": ("clip_on_chip_kernel", "clip_reduce_kernel"),
    "quant_clip_reduce": ("quant_on_chip_kernel", "quant_reduce_kernel"),
    "topk_reduce": ("topk_reduce_kernel",),
    "int8_matmul": ("int8_matmul_kernel",),
    "flash_attention": ("flash_attention_fwd",),
    "ssd_scan": ("ssd_scan",),
}
# FederatedGPO against its CPU run and its dense run after 3 rounds
TRAIN_ROUNDS, MORE_ROUNDS = 3, 20
TRAIN_TOL = {"round_loss_rtol": 1e-4, "eval_atol": 1e-4,
             "params_max_abs": 1e-4}


# the LM backbones' kernels against their plain versions: the tolerances
# of tests/test_kernels.py. Every flash case, bf16 too, is held to the
# plain version in f32 on the same inputs: the kernel keeps its scores in
# f32 as the TPU kernel does, where the bf16 plain version rounds them
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 flash, besides FLASH_TOL: the largest error of an output row (its
# 2-norm over the row's 2-norm). The kernel's own rounding (p and o to
# bf16) read at most FLASH_BF16_ROW_FLOOR over the phase 1 sweeps and
# phase 5's shapes on an H100, and up to 3.53e-3 on the LM prefills' own
# tensors (PERF.md §6); the limit is twice the floor. The controls (a key
# tile dropped, a window one key wider) must exceed it: they read 0.5-2
# there, and 0.029-0.79 on the prefills' tensors
FLASH_BF16_ROW_FLOOR = 3.45e-3
FLASH_BF16_ROW_TOL = 2 * FLASH_BF16_ROW_FLOOR
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# bf16 SSD, besides SSD_TOL: the largest error of a row of y (|y −
# plain|₂ over |plain|₂ for each (b, s, h), plain = ref_ssd on the f32
# upcast of the same inputs). The kernel's rounding (y to bf16 once; the
# products keep ~16 bits of each f32 operand) read at most
# SSD_BF16_ROW_FLOOR over the phase 1 cases and the timed prefill shapes
# on an H100 (PERF.md §6, the SSD rows); the limit is twice that. The
# planted faults (one interior chunk's B zeroed; the state of a run one
# chunk short, against SSD_TOL's f32 state check) must fail: they read
# 6-59 and 1.2-3.2 there
SSD_BF16_ROW_FLOOR = 3.146e-3
SSD_BF16_ROW_TOL = 2 * SSD_BF16_ROW_FLOOR
# LM serving: arch -> (its prefill's kernels, the layers served (None:
# all of the config's), a change to the plain branch that rounds its sums
# otherwise without changing what it computes, or None); the launches a
# prefill are ``_lm_launches``': one a layer, zamba2's SSD one a trunk
# layer and flash one a shared block, whisper's flash one an encoder and
# one a decoder layer. Depth is cut only to fit the card and the
# clock. The change is a config change (mamba2's chunk 64 reorders the
# SSD's sums) or F32_SCORES: the plain attention with its scores kept in
# f32, the flash kernel's own rounding. granite-moe's router flips 11.6%
# of its (token, layer) choices on a bf16 ulp (PERF.md §6), each moving
# a token by O(1), so its floor is that rounding's effect. The floor
# follows the kernel's rounding, so the bf16 kernel is held on its own as
# well: on the main path's q, k and v of a few layers of every attention
# arch (``_flash_on_path``), to the plain version in f32. zamba2 takes
# mamba2's change: its trunk is mamba2's SSD, and its plain branch at
# chunk 64 lands 4.1e-2 from itself on an H100 (PERF.md §6)
F32_SCORES = "the attention's scores in f32"
FLASH, SSD = ("flash_attention",), ("ssd_scan",)
LM_ARCHS = {
    "qwen2-0.5b": (FLASH, None, None),
    "mamba2-780m": (SSD, None, {"ssm_chunk": 64}),
    "qwen3-32b": (FLASH, 8, None),
    "gemma2-27b": (FLASH, 8, None),
    "gemma3-27b": (FLASH, 8, None),
    "granite-moe-3b-a800m": (FLASH, None, F32_SCORES),
    "grok-1-314b": (FLASH, 2, None),
    "zamba2-1.2b": (SSD + FLASH, None, {"ssm_chunk": 64}),
    "whisper-small": (FLASH, None, None),
    "llava-next-34b": (FLASH, 8, None),
}
LM_DEPTH_WHY = {
    "qwen3-32b": "11 GB of bf16 weights",
    "gemma2-27b": "four local:global periods",
    "gemma3-27b": "one 5:1 period and a two-layer tail, so the ring's "
                  "tail path runs",
    "grok-1-314b": "23 GB of bf16 weights (9.7 GB of experts a layer)",
    "llava-next-34b": "10.8 GB of bf16 weights; all 60 layers' 68.8 GB "
                      "do not fit beside the f32 logits and the plain "
                      "branch's scores",
}
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
# whisper's decoder context is 448 tokens (n_text_ctx in the Whisper
# release, arXiv 2212.04356): a prompt of 416 and 32 generated fill it.
# Its encoder reads enc_seq_len (1500) frames drawn N(0, 1) from the
# generator, as the reference's serve_lm draws them; llava's prefill
# reads (B, prompt, d_model) embeddings drawn so, then decodes tokens
LM_PROMPTS = {"whisper-small": 416}
# the kernel run's last logits against the plain branch's on the card,
# max-abs over the largest |logit|: bf16 activations round every layer's
# output, and the flash kernel keeps scores in f32 where the plain
# branch rounds them to bf16. Where the plain branch run once more with
# its sums rounded otherwise (mamba2 at chunk 64, granite-moe with f32
# scores) lands further from itself than that, rounding alone sets the
# floor: the bound is then 1.5 times that floor, and the f32 run
# (LM_F32_TOL) is what holds the kernel to the plain branch.
LM_BF16_TOL = 2e-2
LM_FLOOR_FACTOR = 1.5
# f32 at full width and the served depth, prompt 2048: the kernel
# prefill against the plain branch's on the card; and f32 at full
# width, few layers, against the CPU: (layers, batch, prompt), 4 tokens
LM_F32_CPU = {"qwen2-0.5b": (4, 4, 512), "mamba2-780m": (4, 4, 512),
              "grok-1-314b": (1, 1, 64), "zamba2-1.2b": (7, 1, 64)}
LM_F32_CPU_DEFAULT = (2, 1, 64)
# zamba2 at 7 layers: one super-block of 6 and the shared block, then a
# tail layer (2 layers at shared_attn_every 6 would have no shared
# block); whisper's encoder is cut to the decoder's layers there too
LM_F32_GEN = 4
LM_F32_TOL = 1e-4
# the gemmas' ring decode against the full-cache decode on the card, the
# same tokens fed to both: the reference's bound in f32
# (tests/test_ring_cache.py); in bf16 the ring's slot order sums the
# window's keys in another order than the full cache's
LM_RING_TOL = {"float32": 1e-4, "bfloat16": LM_BF16_TOL}
# phase 4i, LM training (core/trainer.py): the standard step on
# qwen2-0.5b at full width and depth (batch 4, seq 256, 10 Adam steps at
# 3e-4) and on mamba2-780m (3 steps); the full-parameter backbone FedAvg
# round and the FedLoRA rounds (rank 8) at 4 clients, 2 local steps,
# batch 2, seq 128, 3 rounds; f32 rounds at 2 layers against the CPU;
# the example's ~114.9M-param config for 5 rounds in both modes; the
# embedder on the trained backbone
LM_TRAIN_ARCH = "qwen2-0.5b"
LM_TRAIN_STD = {"batch": 4, "seq": 256, "steps": 10, "lr": 3e-4}
LM_TRAIN_SSM = ("mamba2-780m", 3)
LM_FED = {"clients": 4, "local_steps": 2, "batch": 2, "seq": 128,
          "rounds": 3, "lr": 3e-4}
LM_LORA_RANK = 8
LM_LORA_RUNS = {
    "fedavg": {},
    "fedavgm": {"agg": {"name": "fedavgm", **STRATEGIES["fedavgm"]}},
    "median": {"agg": {"name": "median"}},
    "krum": {"agg": {"name": "krum", "num_malicious": 1}},
    "dp_noise": {"privacy": _DP},
    "dp_int8_ef": {"privacy": _DP, "compression": {"kind": "int8"}},
    "topk_ef": {"compression": {"kind": "topk", "topk_frac": TOPK_FRAC}},
}
LM_LORA_KERNEL = {"fedavg": "fedavg_reduce", "fedavgm": "momentum_reduce",
                  "median": "trimmed_reduce", "krum": "pairwise_dists",
                  "dp_noise": "clip_reduce",
                  "dp_int8_ef": "quant_clip_reduce",
                  "topk_ef": "topk_reduce"}
# the kernel run against the same run with the kernels' plain versions
# on the card, bf16: the per-client mean losses (about 12 at these
# random weights) and the final payload, each leaf relative to its
# largest entry. The two runs differ by the reduces' order of additions,
# rounded to bf16 in the payload, and where that moves a rounding level
# (int8) or a top-k near-tie
LM_TRAIN_LOSS_TOL = 2e-2
LM_LORA_PAYLOAD_TOL = 1e-2
LM_MAX_BEYOND = 880  # 0.02% of the LoRA payload's 4,399,105 entries
# f32 at full width and 2 layers: one round of each trainer on the card
# against the CPU, 1 local step at seq 64
LM_F32_CPU_TRAIN = {"layers": 2, "clients": 4, "local_steps": 1,
                    "batch": 2, "seq": 64, "lr": 3e-4}
LM_F32_CPU_TOL = 1e-4
LM_EXAMPLE_ROUNDS = 5
LM_EMBED_DIM = 64
# phase 4j: `python -m repro_torch.launch.serve --gpo` in-process, its
# defaults (60 FedAvg rounds at GPOConfig() width, the default 32-request
# trace), serving int8 and then f32 from the checkpoint it saved
SERVE_TRAIN_ROUNDS = 60  # the launcher's default --rounds
SERVE_TRAIN_KERNELS = ("int8_matmul", "gpo_attention_fwd",
                       "gpo_attention_bwd_dq", "gpo_attention_bwd_dkdv",
                       "fedavg_reduce")
SERVE_CPU_TOL = 1e-4  # the card's f32 rows against the CPU's, max abs
# phase 4k: the dry-run sweep's processes (one an arch, no card visible)
SWEEP_TIMEOUT = 600


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _card_row(name: str) -> str:
    """The data sheet row of the card ``name``: SXM unless it says
    PCIe or NVL."""
    return next((k for k in _PEAKS if k != "SXM" and k in name), "SXM")


def _peaks(name: str):
    return _PEAKS[_card_row(name)]


# the device time one timed repetition of ``_time_ms`` aims at
TIME_REP_MS = 20.0


class _Ms(float):
    """A time in ms from ``_time_ms`` or ``_once_ms``, which keeps the
    calls each timed repetition made (``iters``); ``_iters_of`` reads
    them back from a row."""

    def __new__(cls, ms: float, iters: int):
        out = super().__new__(cls, ms)
        out.iters = iters
        return out


def _iters_of(row, path: str = "") -> dict:
    """{path of a time in ``row``: the calls a timed repetition made},
    over the row's nested dicts and lists, for the row's JSON: the count
    ``_time_ms`` chose (or 1 for a single timed call)."""
    out = {}
    items = (row.items() if isinstance(row, dict) else
             enumerate(row) if isinstance(row, list) else ())
    for k, v in items:
        key = f"{path}.{k}" if path else str(k)
        if isinstance(v, _Ms):
            out[key] = v.iters
        elif isinstance(v, (dict, list)):
            out.update(_iters_of(v, key))
    return out


def _bound_ms(nbytes: float, flops: float, peaks):
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def _time_ms(fn, iters: int | None = None, reps: int = 7,
             graph: bool = True, stream=None) -> tuple:
    """(device, eager) milliseconds per call of ``fn``, each the median
    over ``reps`` of CUDA-event times over ``iters`` calls, after a
    warm-up. Device: the calls captured once in a CUDA graph and
    replayed, so the host's launch cost is out of the reading and the
    card's own time for the work remains (inputs stay in the 50 MB L2,
    as the serving path's weights do); None with ``graph=False``. Eager:
    the same calls launched one by one from Python, host overhead
    included. ``iters`` by default: as many calls as take about
    ``TIME_REP_MS`` by the warm-up's last call, from 3 to 50 (a call of
    microseconds is repeated 50 times, one of milliseconds fewer: about
    17·iters calls in all). ``stream``: the warm-up and capture stream
    (default a new one)."""
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
    if iters is None:
        once = (time.perf_counter() - t0) * 1e3
        iters = max(3, min(50, int(TIME_REP_MS / max(once, 1e-6))))
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured, stream=stream):
            for _ in range(iters):
                fn()

    def median_ms(run):
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / iters)
        return float(np.median(times))

    def eager():
        for _ in range(iters):
            fn()

    return ((_Ms(median_ms(captured.replay), iters) if graph else None),
            _Ms(median_ms(eager), iters))


def _once_ms(fn) -> tuple:
    """(None, eager ms) of one call of ``fn`` after one warm call: for
    plain versions that take seconds a call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return None, _Ms(a.elapsed_time(b), 1)


def _timed(kernel_fn, plain_fn, library_fn) -> dict:
    """Device and eager times of a kernel, its plain version and the
    library call that computes the same function (None: no such call)."""
    (ms, eager), (plain, plain_eager) = (_time_ms(f)
                                         for f in (kernel_fn, plain_fn))
    lib, lib_eager = (None, None) if library_fn is None else _time_ms(
        library_fn)
    return {"ms": ms, "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
            "eager_ms": {"kernel": eager, "plain": plain_eager,
                         "library": lib_eager}}


def _bwd_alone(forward, leaf, do) -> tuple:
    """(device, eager) ms of the backward alone of ``forward(*leaf)``,
    replayed from one retained graph. A backward op runs on its forward's
    stream, so the forward runs on the capture stream."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out_ = forward(*leaf)
    return _time_ms(lambda: torch.autograd.grad(out_, leaf, do,
                                                retain_graph=True),
                    stream=stream)


def _profile(fn, trace: str = "engine_trace.json", match=()) -> dict:
    """Wall time of ``fn()`` under ``torch.profiler``, and the device
    time of every kernel it ran, read from the exported trace (kept as
    ``trace`` in the git-ignored ``build/``). ``busy_share`` is kernel
    time over wall time; the profiler's own host overhead is in the wall
    time. ``matched`` sums the launches and time of the kernels whose
    name holds each string of ``match`` (any case)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = ROOT / "build" / trace
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    by_name: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            n, ms = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, ms + e["dur"] * 1e-3)
    kernel_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    matched = {m: [sum(v[i] for k, v in by_name.items()
                       if m.lower() in k.lower()) for i in (0, 1)]
               for m in match}
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "kernels": sum(n for n, _ in by_name.values()),
            "busy_share": kernel_ms / wall_ms,
            "top": [{"name": k[:60], "launches": n, "ms": ms}
                    for k, (n, ms) in top],
            "matched": {m: {"launches": n, "ms": ms}
                        for m, (n, ms) in matched.items()}}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _int8_inputs(m, k, n, g, dev):
    x = torch.randn((m, k), generator=g).to(dev)
    ql = quantize_linear(torch.randn((k, n), generator=g) / k ** 0.5)
    return x, ql.q.to(dev), ql.scale.to(dev)


def _attn_inputs(bh, s, g, dev, hd=HEAD_DIM, n=3):
    return tuple(torch.randn((bh, s, hd), generator=g).to(dev)
                 for _ in range(n))


def _close(got, plain, tol: float) -> tuple:
    """(max abs error, all within tol*(1+|plain|) and finite)."""
    err = (got - plain).abs()
    ok = bool((err <= tol * (1 + plain.abs())).all()
              and torch.isfinite(got).all())
    return err.max().item(), ok


def _quant_close(got, plain, level: float) -> tuple:
    """(max abs error, coordinates beyond 2e-5·(1 + |plain|), within
    2e-5 plus one quantization ``level`` with at most a thousandth of the
    coordinates beyond and finite): ``got`` and ``plain`` the quant
    reduce's (out, new residual or None). A scale an ulp off (norms
    summed in another order) may flip a rounding decision by a level."""
    pairs = [(a, b) for a, b in zip(got, plain) if a is not None]
    errs = [(a - b).abs() for a, b in pairs]
    err = max(e.max().item() for e in errs)
    flips = sum(int((e > 2e-5 + 2e-5 * b.abs()).sum())
                for e, (_, b) in zip(errs, pairs))
    ok = err <= 2e-5 + level and flips <= 1e-3 * sum(
        b.numel() for _, b in pairs) and all(
        bool(torch.isfinite(a).all()) for a, _ in pairs)
    return err, flips, ok


def _row_rel(got, plain) -> float:
    """max over output rows (the last axis) of |got - plain| / |plain|,
    2-norms."""
    d = torch.linalg.vector_norm(got.float() - plain, dim=-1)
    n = torch.linalg.vector_norm(plain, dim=-1)
    return (d / n.clamp_min(1e-30)).max().item()


def _flash_close(got, plain) -> tuple:
    """(max abs error, largest row error, within FLASH_TOL and, for bf16,
    FLASH_BF16_ROW_TOL): ``got`` of the kernel, ``plain`` the plain
    version in f32 on the same inputs."""
    err, ok = _close(got.float(), plain, FLASH_TOL[got.dtype])
    row = _row_rel(got, plain)
    if got.dtype == torch.bfloat16:
        ok = ok and row <= FLASH_BF16_ROW_TOL
    return err, row, ok


def _flash_control(fault: str, got, plain) -> float:
    """A planted fault: the kernel run on other arguments than the plain
    version's must fail ``_flash_close``, or the check cannot see such a
    fault. Returns the fault's row error."""
    _, row, ok = _flash_close(got, plain)
    print(f"    control ({fault}): row error {row:.3e} against the limit "
          f"{FLASH_BF16_ROW_TOL:g}")
    if ok:
        raise AssertionError(f"the bf16 flash check passes {fault}")
    return row


def _ssd_inputs(g, dev, dtype, b, s, h, p, n):
    """x, dt, A_log, B, C, D for the SSD scan: x, B, C in ``dtype``."""
    x = (torch.randn((b, s, h, p), generator=g) * 0.5).to(dev, dtype)
    dt = F.softplus(torch.randn((b, s, h), generator=g)).to(dev)
    a_log = (torch.randn((h,), generator=g) * 0.5).to(dev)
    bm, cm = ((torch.randn((b, s, n), generator=g) * 0.5).to(dev, dtype)
              for _ in range(2))
    d = torch.randn((h,), generator=g).to(dev)
    return x, dt, a_log, bm, cm, d


def _f32(*ts):
    return tuple(t.float() for t in ts)


def _ssd_controls(args, chunk: int) -> tuple:
    """Planted faults the bf16 SSD checks must catch, at one shape (s at
    least three chunks): the kernel given B with chunk 1 zeroed, against
    the plain version (f32) with B intact, must read above
    SSD_BF16_ROW_TOL; the kernel's final state from a run one chunk
    short, against the plain version's full-length state, must fail the
    1e-4 (1 + |plain|) state check. Returns (row error, state error)."""
    x, dt, a_log, bm, cm, d = args
    s = x.shape[1]
    py, pstate = ref_ssd(*_f32(x, dt, a_log, bm, cm, d))
    bz = bm.clone()
    bz[:, chunk:2 * chunk] = 0
    row = _row_rel(ssd_scan_bhsp(x, dt, a_log, bz, cm, d, chunk=chunk)[0],
                   py)
    xs, dts, bs, cs = (t[:, :s - chunk].contiguous()
                       for t in (x, dt, bm, cm))
    state = ssd_scan_bhsp(xs, dts, a_log, bs, cs, d, chunk=chunk,
                          return_state=True)[1]
    torch.cuda.synchronize()
    est, state_ok = _close(state, pstate, SSD_TOL[torch.float32])
    print(f"    ssd_scan bf16 controls {list(x.shape)} chunk={chunk}: chunk 1's "
          f"B zeroed: row error {row:.3e} (limit {SSD_BF16_ROW_TOL:g}); the "
          f"state one chunk short: max_abs_err {est:.3e} (tol "
          f"{SSD_TOL[torch.float32]:g}*(1+|plain|))")
    if row <= SSD_BF16_ROW_TOL:
        raise AssertionError("the bf16 SSD row check passes a zeroed chunk")
    if state_ok:
        raise AssertionError("the SSD state check passes a short run")
    return row, est


def _attention_bwd(ops, nc) -> tuple:
    """(dq, dk, dv) from the two backward kernels on ``ops`` = (q, k, v,
    do, lse, delta)."""
    return (gpo_attention_bwd_dq(*ops, num_ctx=nc),
            *gpo_attention_bwd_dkdv(*ops, num_ctx=nc))


# planted controls and readings, each built from a copy of the sources
# under build/<name> with text edits applied: name -> (the sources it
# builds, {edited file: edits}); the other headers come from csrc on the
# include path, which a quoted include searches after the copy's folder
_CONTROLS = {
    "chained": (("gpo_attention_fwd", "gpo_attention_bwd"),
                {"gpo_tiles.cuh": _CHAINED_EDITS}),
    "pairwise_one_pass": (("pairwise_dists",),
                          {"pairwise_dists.cu": _ONE_PASS_EDITS}),
    "pairwise_3xtf32": (("pairwise_dists",),
                        {"pairwise_dists.cu": _SPLIT_3X_EDITS}),
    "clip_stamps": (("clip_reduce",), {"clip_reduce.cu": _STAMP_EDITS}),
}
_BUILDS = {}  # control -> {source: (library, nvcc process)}
_CONTROL_LIBS = {}  # (control, source) -> the loaded library


def _start_control_builds() -> None:
    """Start nvcc on every control of ``_CONTROLS``, beside the kernels'
    build."""
    for ctl, (sources, edits) in _CONTROLS.items():
        out = backend.BUILD_DIR / ctl
        out.mkdir(parents=True, exist_ok=True)
        for fname, pairs in edits.items():
            text = (backend.CSRC / fname).read_text()
            for old, new in pairs:
                if text.count(old) != 1:
                    raise AssertionError(f"the {ctl} control's edit no "
                                         f"longer matches {fname}")
                text = text.replace(old, new)
            (out / fname).write_text(text)
        builds = {}
        for name in sources:
            cu = out / f"{name}.cu"
            if cu.name not in edits:
                shutil.copy(backend.CSRC / cu.name, cu)
            so = cu.with_suffix(".so")
            builds[name] = (so, subprocess.Popen(
                [backend._nvcc(), *backend.NVCC_FLAGS, "-I",
                 str(backend.CSRC), "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        _BUILDS[ctl] = builds


def _wait_control_builds() -> None:
    """Wait for every control build no phase loaded (a card that runs
    the clip's two launches skips the stamped build), so that no nvcc
    outlives the script."""
    for builds in _BUILDS.values():
        for _, proc in builds.values():
            if proc.returncode is None:
                proc.communicate(timeout=600)


def _control_fn(ctl: str, name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of control ``ctl``'s build of ``name``,
    bound as the wrappers bind theirs."""
    key = (ctl, name)
    if key not in _CONTROL_LIBS:
        if ctl not in _BUILDS:
            _start_control_builds()
        so, proc = _BUILDS[ctl][name]
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {ctl} control "
                               f"{name}:\n{out}")
        _CONTROL_LIBS[key] = ctypes.CDLL(str(so))
    fn = getattr(_CONTROL_LIBS[key], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _clip_entry(fn, x, n, w, clip: float, design: str) -> torch.Tensor:
    """One call of a clip_reduce C entry (the build's or a control's) in
    ``design``, as the wrapper makes it; uncounted (no wrapper)."""
    c, p = x.shape
    width, nb = quant_split(p) if design == "on_chip" else (
        0, -(-p // ROW_CHUNK))
    part = torch.empty((nb * c,), dtype=torch.float32, device=x.device)
    out = torch.empty((p,), dtype=torch.float32, device=x.device)
    backend.check(fn(x.data_ptr(), None if n is None else n.data_ptr(),
                     w.data_ptr(), part.data_ptr(), out.data_ptr(),
                     float(clip), c, p, nb, width,
                     backend.stream_ptr(x.device)), f"clip_reduce {design}")
    return out


def _clip_phases(sets, w, clip: float, noise: bool) -> dict:
    """The on-chip clip kernel's phases from the stamped build
    (``_STAMP_EDITS``), µs: each block's tile load (start to its partial
    norms written), barrier wait and reduce (the scales, the noise and
    the weighted sum), the median over the blocks, then over 20 calls on
    the rotated sets after 3 more; and the span, first start to last
    end."""
    fn = _control_fn("clip_stamps", "clip_reduce", "clip_reduce_launch",
                     _CLIP_ARGTYPES)
    read = _control_fn("clip_stamps", "clip_reduce", "clip_stamps_read",
                       [ctypes.c_void_p])
    rows = []
    for i in range(23):
        x, n = sets[i % len(sets)][:2]
        _clip_entry(fn, x, n if noise else None, w, clip, "on_chip")
        torch.cuda.synchronize()
        host = np.zeros(4 * QUANT_SPLIT, dtype=np.uint64)
        backend.check(read(host.ctypes.data), "clip_stamps_read")
        if i < 3:
            continue
        t = host.reshape(4, QUANT_SPLIT)[:, :quant_split(x.shape[1])[1]]
        t = t.astype(np.int64)
        rows.append([np.median(t[k + 1] - t[k]) for k in range(3)]
                    + [t[3].max() - t[0].min()])
    m = np.median(np.array(rows), axis=0) / 1e3
    return dict(zip(("tile_us", "barrier_us", "reduce_us", "span_us"),
                    map(float, m)))


def _chained_fwd(q, k, v, nc) -> tuple:
    """(o, lse) from the chained control, as ``gpo_attention_fwd``;
    uncounted (no wrapper)."""
    bh, s, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=q.dtype, device=q.device)
    backend.check(_control_fn(
        "chained", "gpo_attention_fwd", "gpo_attention_fwd_launch",
        _FWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, s, nc, hd, hd, backend.stream_ptr(q.device)),
        "chained forward")
    return o, lse


def _chained_bwd(ops, nc) -> tuple:
    """(dq, dk, dv) from the chained control on ``ops``, as
    ``_attention_bwd``; uncounted (no wrapper)."""
    q = ops[0]
    bh, s, hd = q.shape
    outs = [torch.empty_like(q) for _ in range(3)]
    ptrs = [t.data_ptr() for t in ops]
    stream = backend.stream_ptr(q.device)
    backend.check(_control_fn(
        "chained", "gpo_attention_bwd", "gpo_attention_bwd_dq_launch",
        _DQ_ARGTYPES)(
        *ptrs, outs[0].data_ptr(), bh, s, nc, hd, hd, stream), "chained dq")
    backend.check(_control_fn(
        "chained", "gpo_attention_bwd", "gpo_attention_bwd_dkdv_launch",
        _DKDV_ARGTYPES)(
        *ptrs, outs[1].data_ptr(), outs[2].data_ptr(), bh, s, nc, hd, hd,
        stream), "chained dk/dv")
    return tuple(outs)


def _gpo_fwd_f64(q, k, v, nc) -> tuple:
    """(o, lse) of the forward in float64 throughout: ref_gpo_attention
    rounds its scores and softmax to f32 whatever the input type."""
    q, k, v = (t.double() for t in (q, k, v))
    s, hd = q.shape[-2:]
    pos = torch.arange(s, device=q.device)
    allowed = (pos[None, :] < nc) | (pos[None, :] == pos[:, None])
    scores = torch.where(allowed, q @ k.transpose(-1, -2) / hd ** 0.5,
                         -torch.inf)
    return torch.softmax(scores, -1) @ v, torch.logsumexp(scores, -1)


def _check_attention_fwd(g, dev, worst) -> None:
    """The forward against the plain version at every attention shape
    and head width, o and lse within 1e-5, each bit-equal from one call
    to the next, and bh slice ``BWD_ALONE`` computed alone bit-equal to
    the same slice of the batch; then o's mean error against the forward
    in float64 at ``FWD_F64_SHAPES``, beside the plain version's and the
    chained control's, which must exceed the limit at each of them."""
    for hd in HEAD_DIMS:
        for bh, s, nc in ATTN_SHAPES:
            q, k, v = _attn_inputs(bh, s, g, dev, hd)
            got = gpo_attention_fwd(q, k, v, num_ctx=nc)
            again = gpo_attention_fwd(q, k, v, num_ctx=nc)
            alone = None
            if bh > BWD_ALONE:
                one = slice(BWD_ALONE, BWD_ALONE + 1)
                alone = gpo_attention_fwd(q[one].contiguous(),
                                          k[one].contiguous(),
                                          v[one].contiguous(), num_ctx=nc)
            po, plse = ref_gpo_attention(q, k, v, num_ctx=nc)
            torch.cuda.synchronize()
            o, lse = got
            eo = (o - po).abs().max().item()
            el = (lse - plse).abs().max().item()
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            sliced = alone is None or all(
                torch.equal(a, b[one]) for a, b in zip(alone, got))
            print(f"  gpo_attention_fwd BH={bh:3d} S={s:4d} num_ctx={nc:3d} "
                  f"hd={hd}  o max_abs_err={eo:.3e}  lse max_abs_err="
                  f"{el:.3e}  tol=1e-05; repeat bit-equal {repeat}"
                  + ("" if alone is None else
                     f"; bh {BWD_ALONE} alone bit-equal {sliced}"))
            if not (eo <= 1e-5 and el <= 1e-5 and torch.isfinite(o).all()
                    and torch.isfinite(lse).all()):
                raise AssertionError(f"gpo_attention_fwd mismatch at "
                                     f"{(bh, s, nc, hd)}")
            if not (repeat and sliced):
                raise AssertionError(f"gpo_attention_fwd not bit-equal "
                                     f"between calls at {(bh, s, nc, hd)}")
            worst["gpo_attention_fwd"] = max(worst["gpo_attention_fwd"], eo,
                                             el)

    for hd in HEAD_DIMS:
        for bh, s, nc in FWD_F64_SHAPES:
            q, k, v = _attn_inputs(bh, s, g, dev, hd)
            exact = _gpo_fwd_f64(q, k, v, nc)
            runs = (gpo_attention_fwd(q, k, v, num_ctx=nc),
                    ref_gpo_attention(q, k, v, num_ctx=nc),
                    _chained_fwd(q, k, v, nc))
            torch.cuda.synchronize()
            # [o, lse] mean |err| of the kernel, the plain version, the
            # control
            means = [[(a.double() - b).abs().mean().item()
                      for a, b in zip(run, exact)] for run in runs]
            ratios = {name: [m / pm for m, pm in zip(ms, means[1])]
                      for name, ms in (("kernel", means[0]),
                                       ("chained", means[2]))}
            worst["gpo_attention_fwd_f64"][f"hd {hd} {bh}x{s}x{nc}"] = {
                "kernel": means[0], "plain": means[1], "chained": means[2],
                "ratios": ratios}
            print(f"  gpo_attention_fwd against float64 BH={bh} S={s} "
                  f"num_ctx={nc} hd={hd}: mean |err| o, lse kernel "
                  f"{[f'{m:.3e}' for m in means[0]]}, plain f32 "
                  f"{[f'{m:.3e}' for m in means[1]]}, chained control "
                  f"{[f'{m:.3e}' for m in means[2]]}; ratios to the "
                  f"plain's kernel {[f'{r:.2f}' for r in ratios['kernel']]}"
                  f", control {[f'{r:.2f}' for r in ratios['chained']]} "
                  f"(limit on o {FWD_F64_RATIO}; the control must exceed "
                  f"it)")
            if ratios["kernel"][0] > FWD_F64_RATIO:
                raise AssertionError(f"gpo_attention_fwd drifts from "
                                     f"float64 at {(bh, s, nc, hd)}: "
                                     f"{means}")
            if ratios["chained"][0] <= FWD_F64_RATIO:
                raise AssertionError(f"the float64 check passes the "
                                     f"chained forward at "
                                     f"{(bh, s, nc, hd)}: {means}")


def _check_attention_bwd(g, dev, worst) -> None:
    """dq and dk/dv against the closed-form plain backward, at every
    backward shape and head width, each bit-equal from one call to the
    next, and bh slice ``BWD_ALONE`` computed alone bit-equal to the same
    slice of the batch; the kernels' mean error against the backward in
    float64 at the training shape, beside the plain version's, and the
    chained control's, which must exceed the limit; then the
    GPOAttention Function's gradients against autograd through the plain
    forward."""
    for hd in HEAD_DIMS:
        for bh, s, nc in BWD_SHAPES:
            q, k, v, do = _attn_inputs(bh, s, g, dev, hd, n=4)
            o, lse = ref_gpo_attention(q, k, v, num_ctx=nc)
            plain = ref_gpo_attention_bwd(q, k, v, o, lse, do, num_ctx=nc)
            ops = (q, k, v, do, lse, (do * o).sum(-1))
            got = _attention_bwd(ops, nc)
            again = _attention_bwd(ops, nc)
            alone = None
            if bh > BWD_ALONE:
                one = slice(BWD_ALONE, BWD_ALONE + 1)
                alone = _attention_bwd([t[one].contiguous() for t in ops],
                                       nc)
            torch.cuda.synchronize()
            errs = [_close(a, want, 1e-5) for a, want in zip(got, plain)]
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            sliced = alone is None or all(
                torch.equal(a, b[one]) for a, b in zip(alone, got))
            print(f"  gpo_attention_bwd BH={bh:3d} S={s:4d} num_ctx={nc:3d} "
                  f"hd={hd}  max_abs_err dq={errs[0][0]:.3e} dk="
                  f"{errs[1][0]:.3e} dv={errs[2][0]:.3e}  "
                  f"tol=1e-5*(1+|plain|); repeat bit-equal {repeat}"
                  + ("" if alone is None else
                     f"; bh {BWD_ALONE} alone bit-equal {sliced}"))
            if not all(ok for _, ok in errs):
                raise AssertionError(f"gpo_attention_bwd mismatch at "
                                     f"{(bh, s, nc, hd)}")
            if not (repeat and sliced):
                raise AssertionError(f"gpo_attention_bwd not bit-equal "
                                     f"between calls at {(bh, s, nc, hd)}")
            worst["gpo_attention_bwd_dq"] = max(
                worst["gpo_attention_bwd_dq"], errs[0][0])
            worst["gpo_attention_bwd_dkdv"] = max(
                worst["gpo_attention_bwd_dkdv"], errs[1][0], errs[2][0])

    bh, s, nc = BWD_SHAPES[0]
    for hd in HEAD_DIMS:
        q, k, v, do = _attn_inputs(bh, s, g, dev, hd, n=4)
        o, lse = ref_gpo_attention(q, k, v, num_ctx=nc)
        wide = [t.double() for t in (q, k, v, do)]
        o64, lse64 = ref_gpo_attention(*wide[:3], num_ctx=nc)
        exact = ref_gpo_attention_bwd(*wide[:3], o64, lse64, wide[3],
                                      num_ctx=nc)
        ops = (q, k, v, do, lse, (do * o).sum(-1))
        means = [[(a.double() - b).abs().mean().item()
                  for a, b in zip(got, exact)]
                 for got in (_attention_bwd(ops, nc),
                             ref_gpo_attention_bwd(q, k, v, o, lse, do,
                                                   num_ctx=nc),
                             _chained_bwd(ops, nc))]
        torch.cuda.synchronize()
        ratios = {name: [m / pm for m, pm in zip(ms, means[1])]
                  for name, ms in (("kernels", means[0]),
                                   ("chained", means[2]))}
        worst["gpo_attention_bwd_f64"][hd] = {
            "kernels": means[0], "plain": means[1], "chained": means[2],
            "ratios": ratios}
        print(f"  gpo_attention_bwd against float64 BH={bh} S={s} "
              f"num_ctx={nc} hd={hd}: mean |err| dq, dk, dv kernels "
              f"{[f'{m:.3e}' for m in means[0]]}, plain f32 "
              f"{[f'{m:.3e}' for m in means[1]]}, chained control "
              f"{[f'{m:.3e}' for m in means[2]]}; ratios to the plain's "
              f"kernels {[f'{r:.2f}' for r in ratios['kernels']]}, "
              f"control {[f'{r:.2f}' for r in ratios['chained']]} (limit "
              f"{BWD_F64_RATIO})")
        if max(ratios["kernels"]) > BWD_F64_RATIO:
            raise AssertionError(f"gpo_attention_bwd drifts from float64 "
                                 f"at hd={hd}: {means}")
        if max(ratios["chained"]) <= BWD_F64_RATIO:
            raise AssertionError(f"the float64 check passes the chained "
                                 f"control at hd={hd}: {means}")

    q, k, v, do = _attn_inputs(bh, s, g, dev, n=4)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(GPOAttention.apply(*ins, nc), ins, do)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref_gpo_attention(*ins, num_ctx=nc)[0], ins,
                               do)
    torch.cuda.synchronize()
    errs = [_close(a, b, 1e-5) for a, b in zip(got, want)]
    print(f"  GPOAttention Function grads BH={bh} S={s} num_ctx={nc}: "
          f"max_abs_err {max(e for e, _ in errs):.3e} against autograd "
          f"through the plain forward (tol 1e-5*(1+|plain|))")
    if not all(ok for _, ok in errs):
        raise AssertionError("GPOAttention gradients off autograd")


def _check_fedavg(g, dev, worst) -> None:
    """fedavg_reduce against the plain weighted sum, and two calls on
    the same input bit-equal (a fixed client order, no atomics)."""
    for c, p in FEDAVG_SHAPES:
        x = torch.randn((c, p), generator=g).to(dev)
        w = torch.rand((c,), generator=g) + 0.1
        w = (w / w.sum()).to(dev)
        out = fedavg_reduce_flat(x, w)
        again = fedavg_reduce_flat(x, w)
        plain = ref_fedavg_flat(x, w)
        torch.cuda.synchronize()
        err, ok = _close(out, plain, 1e-6)
        same = torch.equal(out, again)
        print(f"  fedavg_reduce C={c:2d} P={p:7d}  max_abs_err={err:.3e}  "
              f"tol=1e-6*(1+|plain|)  repeat bit-equal: {same}")
        if not (ok and same):
            raise AssertionError(f"fedavg_reduce mismatch at {(c, p)}")
        worst["fedavg_reduce"] = max(worst["fedavg_reduce"], err)


def _agg_inputs(c, p, g, dev, ties=False):
    x = torch.randn((c, p), generator=g)
    if ties:  # few distinct values: many ties across the clients
        x = torch.round(2 * x) / 2
    w = torch.rand((c,), generator=g) + 0.1
    return x.to(dev), (w / w.sum()).to(dev)


def _check_agg_kernels(g, dev, worst) -> None:
    """momentum_reduce, trimmed_reduce and pairwise_dists against their
    plain versions, and two calls on the same input bit-equal (clients
    and column blocks summed in a fixed order, no atomics)."""
    for c, p in AGG_SHAPES:
        x, w = _agg_inputs(c, p, g, dev)
        m = torch.randn((p,), generator=g).to(dev)
        for beta in (0.0, 0.9):
            d, nm = momentum_reduce_flat(x, w, m, beta=beta)
            d2, nm2 = momentum_reduce_flat(x, w, m, beta=beta)
            pd, pnm = ref_momentum_reduce_flat(x, w, m, beta=beta)
            torch.cuda.synchronize()
            (ed, okd), (en, okn) = _close(d, pd, 1e-6), _close(nm, pnm, 1e-6)
            same = torch.equal(d, d2) and torch.equal(nm, nm2)
            print(f"  momentum_reduce C={c:2d} P={p:7d} beta={beta}  "
                  f"max_abs_err delta={ed:.3e} moment={en:.3e}  "
                  f"tol=1e-6*(1+|plain|)  repeat bit-equal: {same}")
            if not (okd and okn and same):
                raise AssertionError(f"momentum_reduce mismatch at {(c, p)}")
            worst["momentum_reduce"] = max(worst["momentum_reduce"], ed, en)

        trims = sorted({min(int(0.1 * c), (c - 1) // 2), (c - 1) // 2})
        for ties in (False, True):
            x, w = _agg_inputs(c, p, g, dev, ties=ties)
            for trim in trims:
                out = trimmed_reduce_flat(x, w, trim=trim)
                again = trimmed_reduce_flat(x, w, trim=trim)
                plain = ref_trimmed_flat(x, w, trim=trim)
                torch.cuda.synchronize()
                err, ok = _close(out, plain, 1e-6)
                same = torch.equal(out, again)
                print(f"  trimmed_reduce C={c:2d} P={p:7d} trim={trim:2d} "
                      f"ties={ties!s:5}  max_abs_err={err:.3e}  "
                      f"tol=1e-6*(1+|plain|)  repeat bit-equal: {same}")
                if not (ok and same):
                    raise AssertionError(f"trimmed_reduce mismatch at "
                                         f"{(c, p, trim, ties)}")
                worst["trimmed_reduce"] = max(worst["trimmed_reduce"], err)

        x, _ = _agg_inputs(c, p, g, dev)
        out = pairwise_dists_flat(x)
        again = pairwise_dists_flat(x)
        plain = ref_pairwise_sq_dists(x)
        torch.cuda.synchronize()
        # the expansion form cancels: atol 1e-5 * max_i |x_i|^2
        atol = 1e-5 * (x * x).sum(dim=1).max().item()
        err = (out - plain).abs().max().item()
        same = torch.equal(out, again)
        exact_diag = bool((torch.diagonal(out) == 0).all())
        symmetric = torch.equal(out, out.T)
        print(f"  pairwise_dists C={c:2d} P={p:7d}  max_abs_err={err:.3e}  "
              f"tol={atol:.3e} (1e-5*max|x_i|^2)  zero diagonal: "
              f"{exact_diag}  symmetric: {symmetric}  repeat bit-equal: "
              f"{same}")
        if not (err <= atol and same and exact_diag and symmetric
                and torch.isfinite(out).all()):
            raise AssertionError(f"pairwise_dists mismatch at {(c, p)}")
        worst["pairwise_dists"] = max(worst["pairwise_dists"], err)


def _pairwise_control(ctl: str, x) -> torch.Tensor:
    """The pairwise distances from control ``ctl``'s build of the kernel
    (``_CONTROLS``), through the C entry of ``pairwise_design_for(C)``
    with the wrapper's split; uncounted (no wrapper)."""
    c, p = x.shape
    chunk, nb = pairwise_split(c, p)
    part = torch.empty((nb, c, c), dtype=torch.float64, device=x.device)
    out = torch.empty((c, c), dtype=torch.float32, device=x.device)
    fn, extra = ((_control_fn(ctl, "pairwise_dists", "pairwise_dists_launch",
                              _PAIRWISE_ARGTYPES), ())
                 if pairwise_design_for(c) == "one_tile" else
                 (_control_fn(ctl, "pairwise_dists", "pairwise_tiles_launch",
                              _TILES_ARGTYPES), (chunk,)))
    backend.check(fn(x.data_ptr(), part.data_ptr(), out.data_ptr(), c, p, nb,
                     *extra, backend.stream_ptr(x.device)), ctl)
    return out


def _pairwise_f64(x, controls) -> dict:
    """The mean |error| off the diagonal against the distances in float64:
    the f32 expansion form's in plain PyTorch, and the kernel's and each
    control's (``_pairwise_control``) as multiples of it."""
    c = x.shape[0]
    xd = x.double()
    sq = (xd * xd).sum(dim=1)
    want = (sq[:, None] + sq[None, :] - 2.0 * (xd @ xd.T)).clamp_min(0.0)
    del xd
    sq32 = (x * x).sum(dim=1)
    plain = sq32[:, None] + sq32[None, :] - 2.0 * (x @ x.T)
    off = ~torch.eye(c, dtype=torch.bool, device=x.device)

    def mean_err(d):
        return (d.double() - want).abs()[off].mean().item()

    base = mean_err(plain)
    ratios = {"kernel": mean_err(pairwise_dists_flat(x)) / base}
    for ctl in controls:
        ratios[ctl] = mean_err(_pairwise_control(ctl, x)) / base
    return {"plain_mean_abs_err": base, **ratios}


def _pairwise_f64_verdict(rec: dict, where: str) -> None:
    """The kernel within ``PAIRWISE_F64_RATIO``, the one-pass control
    above it."""
    if rec["kernel"] > PAIRWISE_F64_RATIO:
        raise AssertionError(f"pairwise_dists {where}: the mean error "
                             "against float64 is above the limit")
    if rec["pairwise_one_pass"] <= PAIRWISE_F64_RATIO:
        raise AssertionError(f"the float64 check at {where} passes the "
                             "one-pass pairwise control: it does not guard "
                             "the split")


def _check_pairwise_f64(g, dev, worst) -> None:
    """The pairwise kernel's mean |error| off the diagonal against the
    distances in float64, at most ``PAIRWISE_F64_RATIO`` times the f32
    expansion form's in plain PyTorch; the one-pass control must exceed
    that limit, and the per-value 3xTF32 split is read beside it."""
    c, p = PAIRWISE_F64_SHAPE
    x, _ = _agg_inputs(c, p, g, dev)
    rec = _pairwise_f64(x, ("pairwise_one_pass", "pairwise_3xtf32"))
    torch.cuda.synchronize()
    worst["pairwise_dists_f64"] = rec
    print(f"  pairwise_dists C={c:2d} P={p:7d}  mean |err| vs float64: f32 "
          f"expansion form {rec['plain_mean_abs_err']:.3e}; the kernel "
          f"{rec['kernel']:.3f}x that (limit {PAIRWISE_F64_RATIO}), one-pass "
          f"control {rec['pairwise_one_pass']:.3f}x, per-value 3xTF32 split "
          f"{rec['pairwise_3xtf32']:.3f}x")
    _pairwise_f64_verdict(rec, f"C {c}")


def _transport_inputs(c, p, g, dev):
    """Deltas with every other row 10x larger (half the rows above the
    median clip), normalised weights, noise, a residual and uniforms on
    ``dev``, and the median row norm as the clip."""
    x = torch.randn((c, p), generator=g)
    x[::2] *= 10.0
    w = torch.rand((c,), generator=g) + 0.1
    noise = 0.3 * torch.randn((c, p), generator=g)
    resid = 0.5 * torch.randn((c, p), generator=g)
    uniform = torch.rand((c, p), generator=g)
    clip = float(torch.linalg.vector_norm(x, dim=1).median())
    return [t.to(dev) for t in (x, w / w.sum(), noise, resid, uniform)], clip


def _check_transport_kernels(g, dev, worst) -> None:
    """clip_reduce, quant_clip_reduce and topk_reduce against their
    plain versions, and two calls on the same input bit-equal (norm and
    absmax partials finished in a fixed order, no atomics); the clip and
    quant reduces also at ``QUANT_THREE_PASS_SHAPE``, and their designs
    asserted there and at the quickstart's shape."""
    for c, p in AGG_SHAPES + [QUANT_THREE_PASS_SHAPE]:
        (x, w, noise, resid, uniform), clip = _transport_inputs(c, p, g,
                                                                dev)
        for n in (None, noise):
            out = clip_reduce_flat(x, w, clip=clip, noise=n)
            again = clip_reduce_flat(x, w, clip=clip, noise=n)
            plain = ref_clip_reduce(x, w, clip=clip, noise=n)
            torch.cuda.synchronize()
            err, ok = _close(out, plain, 1e-5)
            same = torch.equal(out, again)
            design = clip_reduce_flat.design
            print(f"  clip_reduce C={c:2d} P={p:7d} noise={n is not None!s:5}"
                  f" {design:10s}  max_abs_err={err:.3e}  tol=1e-5*(1+|plain|)"
                  f"  repeat bit-equal: {same}")
            if not (ok and same):
                raise AssertionError(f"clip_reduce mismatch at {(c, p)}")
            want = {AGG_SHAPES[0]: "on_chip",
                    QUANT_THREE_PASS_SHAPE: "two_launch"}.get((c, p), design)
            if design != want:
                raise AssertionError(f"clip_reduce ran {design} at {(c, p)}, "
                                     f"want {want}")
            worst["clip_reduce"] = max(worst["clip_reduce"], err)

        # one quantization level bounds |u| / 127: a scale an ulp off
        # (norms summed in another order) may flip one rounding decision
        level = (x.abs().max() + noise.abs().max()
                 + resid.abs().max()).item() / 127.0
        variants = {  # tests/test_compression.py:229-234, then two more
            "plain": {}, "clip": {"clip": clip},
            "clip_noise_ef": {"clip": clip, "noise": noise, "resid": resid},
            "ef_stochastic": {"uniform": uniform, "resid": resid},
            "stochastic": {"uniform": uniform},
            "every_operand": {"clip": clip, "noise": noise, "resid": resid,
                              "uniform": uniform}}
        for name, kw in variants.items():
            out, er = quant_clip_reduce_flat(x, w, **kw)
            out2, er2 = quant_clip_reduce_flat(x, w, **kw)
            pout, per = ref_quant_clip_reduce(x, w, **kw)
            torch.cuda.synchronize()
            err, flips, ok = _quant_close((out, er), (pout, per), level)
            same = torch.equal(out, out2) and (er is None
                                               or torch.equal(er, er2))
            resid_exact = er is None or torch.equal(er, per)
            design = quant_clip_reduce_flat.design
            print(f"  quant_clip_reduce C={c:2d} P={p:7d} {name:13s} "
                  f"{design:10s}  max_abs_err={err:.3e}  tol=2e-5+level="
                  f"{2e-5 + level:.3e}  coords beyond 2e-5: {flips}  "
                  f"residual bit-equal: {resid_exact}  repeat bit-equal: "
                  f"{same}")
            if not (ok and same):
                raise AssertionError(f"quant_clip_reduce mismatch at "
                                     f"{(c, p, name)}")
            want = {AGG_SHAPES[0]: "on_chip",
                    QUANT_THREE_PASS_SHAPE: "three_pass"}.get((c, p), design)
            if design != want:
                raise AssertionError(f"quant_clip_reduce ran {design} at "
                                     f"{(c, p)}, want {want}")
            worst["quant_clip_reduce"] = max(worst["quant_clip_reduce"],
                                             err)

        if (c, p) not in AGG_SHAPES:
            continue
        xt = x.clone()
        xt[0] = 0.0  # a zero row: threshold 0, every zero kept
        if c > 2:  # a row of few distinct magnitudes: ties at the k-th
            xt[1] = torch.round(2 * xt[1]) / 2
        tau = cx.topk_thresholds(xt, TOPK_FRAC)
        for with_residual in (False, True):
            out, er = topk_reduce_flat(xt, w, tau,
                                       with_residual=with_residual)
            out2, er2 = topk_reduce_flat(xt, w, tau,
                                         with_residual=with_residual)
            pout, per = ref_topk_mask_reduce(xt, w, tau,
                                             with_residual=with_residual)
            torch.cuda.synchronize()
            err, ok = _close(out, pout, 1e-6)
            exact = er is None or torch.equal(er, per)
            same = torch.equal(out, out2) and (er is None
                                               or torch.equal(er, er2))
            print(f"  topk_reduce C={c:2d} P={p:7d} residual="
                  f"{with_residual!s:5}  max_abs_err={err:.3e}  "
                  f"tol=1e-6*(1+|plain|)  residual bit-equal: {exact}  "
                  f"repeat bit-equal: {same}")
            if not (ok and exact and same):
                raise AssertionError(f"topk_reduce mismatch at {(c, p)}")
            worst["topk_reduce"] = max(worst["topk_reduce"], err)


def _check_backbone_kernels(g, dev, worst) -> None:
    """The LM backbones' kernels against their plain versions: the flash
    forward over the reference's sweeps (S 64/100/257, (H, KV) 4/4, 4/2,
    8/1; windows 1/7/64 with and without softcap 20), non-causal at
    ragged S and qwen2's g = 7, then at head_dim 128, and at the served
    archs' heads (whisper's encoder non-causal at S 1500, llava's g 7
    at hd 128, zamba2's g 1 at H 32), each against the plain version in
    f32, with two planted faults the bf16 check must catch; the SSD scan
    over the reference's sweep and at mamba2's chunk 128, p 64, n 128
    and zamba2's n 64, with its final state. f32 and bf16, each call
    twice and bit-equal."""
    def flash_case(dtype, b, s, h, kv, bq=32, hd=64, **kw):
        q, k, v = (torch.randn((b, s, n, hd), generator=g).to(dev, dtype)
                   for n in (h, kv, kv))
        got = flash_attention(q, k, v, bq=bq, **kw)
        again = flash_attention(q, k, v, bq=bq, **kw)
        tr = (0, 2, 1, 3)
        plain = ref_attention(*(t.float().permute(tr) for t in (q, k, v)),
                              **kw).permute(tr)
        torch.cuda.synchronize()
        err, row, ok = _flash_close(got, plain)
        same = torch.equal(got, again)
        print(f"  flash_attention {str(dtype)[6:]:8} B={b} S={s:4d} H={h:2d} "
              f"KV={kv} hd={hd} {kw}  max_abs_err={err:.3e}  tol="
              f"{FLASH_TOL[dtype]:g}*(1+|plain|)  row error {row:.3e}  "
              f"repeat bit-equal: {same}")
        if not (ok and same):
            raise AssertionError(f"flash_attention mismatch at "
                                 f"{(dtype, b, s, h, kv, hd, kw)}")
        worst["flash_attention"] = max(worst["flash_attention"], err)
        if dtype == torch.bfloat16:
            worst["flash_bf16_row"] = max(worst["flash_bf16_row"], row)

    def flash_controls(b, s, h, kv, hd, window, cap):
        """The bf16 check against two planted faults at one shape: causal
        with a window, run with the window one key wider; non-causal, run
        with the last 64-key tile masked off (kv_len = S - 64)."""
        q = torch.randn((b, h, s, hd), generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn((b, kv, s, hd), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        f32 = [t.float() for t in (q, k, v)]
        print(f"  flash_attention bf16 controls B={b} S={s} H={h} KV={kv} "
              f"hd={hd}")
        worst["flash_bf16_control"] = min(
            _flash_control(f"window {window + 1} for {window}",
                           flash_attention_bhsd(q, k, v, window=window + 1,
                                                softcap=cap),
                           ref_attention(*f32, window=window, softcap=cap)),
            _flash_control("the last key tile dropped, non-causal",
                           flash_attention_bhsd(q, k, v, causal=False,
                                                kv_len=s - 64),
                           ref_attention(*f32, causal=False)),
            worst["flash_bf16_control"])

    def ssd_case(dtype, b, s, h, p, n, chunk):
        x, dt, a_log, bm, cm, d = _ssd_inputs(g, dev, dtype, b, s, h, p, n)
        y, state = ssd_scan_with_state(x, dt, a_log, bm, cm, d, chunk=chunk)
        y2, state2 = ssd_scan_with_state(x, dt, a_log, bm, cm, d,
                                         chunk=chunk)
        # the plain version upcasts its inputs, so its y before the cast
        # back to x's type is its y on the f32 upcast
        fy, pstate = ref_ssd(*_f32(x, dt, a_log, bm, cm, d))
        py = fy.to(dtype)
        torch.cuda.synchronize()
        tol = SSD_TOL[dtype]
        ey, oky = _close(y.float(), py.float(), tol)
        es, oks = _close(state, pstate, SSD_TOL[torch.float32])
        same = torch.equal(y, y2) and torch.equal(state, state2)
        row = ""
        if dtype == torch.bfloat16:
            err = _row_rel(y, fy)
            oky = oky and err <= SSD_BF16_ROW_TOL
            worst["ssd_bf16_row"] = max(worst["ssd_bf16_row"], err)
            row = f"  row error {err:.3e} (limit {SSD_BF16_ROW_TOL:g})"
        print(f"  ssd_scan {str(dtype)[6:]:8} b={b} s={s:3d} h={h} p={p:2d} "
              f"n={n:3d} chunk={chunk:3d}  y max_abs_err={ey:.3e} "
              f"(tol={tol:g}*(1+|plain|)){row}  state max_abs_err={es:.3e} "
              f"(tol={SSD_TOL[torch.float32]:g}*(1+|plain|))  repeat "
              f"bit-equal: {same}")
        if not (oky and oks and same):
            raise AssertionError(f"ssd_scan mismatch at "
                                 f"{(dtype, b, s, h, p, n, chunk)}")
        worst["ssd_scan"] = max(worst["ssd_scan"], ey, es)

    def ssd_batch_rows(b, s, h, p, n, chunk):
        """bf16: each sequence of a batch-b call gives the bits of the
        same sequence alone, though the wrapper picks another p_width
        (the columns of p a block takes) for the two grids; the widths
        must differ, or the check shows nothing."""
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        widths = (p_width_for(b, h, p, sms), p_width_for(1, h, p, sms))
        x, dt, a_log, bm, cm, d = _ssd_inputs(g, dev, torch.bfloat16, b, s,
                                              h, p, n)
        y, state = ssd_scan_bhsp(x, dt, a_log, bm, cm, d, chunk=chunk,
                                 return_state=True)
        same = [all(torch.equal(u, v) for u, v in zip(
            (y[i], state[i]), (t[0] for t in ssd_scan_bhsp(
                *(t[i:i + 1] for t in (x, dt)), a_log,
                *(t[i:i + 1] for t in (bm, cm)), d, chunk=chunk,
                return_state=True)))) for i in range(b)]
        torch.cuda.synchronize()
        print(f"  ssd_scan bf16 h={h} s={s} p={p} n={n} chunk={chunk}: each "
              f"sequence of batch {b} (p_width {widths[0]}) bit-equal to it "
              f"alone (p_width {widths[1]}): {same}")
        if widths[0] == widths[1]:
            raise AssertionError(f"ssd_scan: batch {b} and 1 take the same "
                                 f"p_width {widths[0]}")
        if not all(same):
            raise AssertionError("ssd_scan: a sequence's result depends on "
                                 "its batch")

    for dtype in (torch.float32, torch.bfloat16):
        for s in (64, 100, 257):
            for h, kv in ((4, 4), (4, 2), (8, 1)):
                flash_case(dtype, 2, s, h, kv, causal=True)
        for window in (1, 7, 64):
            for cap in (None, 20.0):
                flash_case(dtype, 1, 128, 4, 2, causal=True, window=window,
                           softcap=cap)
        flash_case(dtype, 2, 100, 4, 2, causal=False)
        flash_case(dtype, 2, 257, 4, 2, bq=128, causal=False, window=64)
        flash_case(dtype, 2, 300, 14, 2, bq=128, causal=True)  # qwen2's g
        # head_dim 128: the sweeps' GQA, a window with a softcap, ragged
        # non-causal S, and qwen3-32b's 64/8 heads (gemma2's softcap 50)
        wide = dict(hd=128)
        for s in (100, 257):
            for h, kv in ((4, 2), (8, 1)):
                flash_case(dtype, 2, s, h, kv, causal=True, **wide)
        flash_case(dtype, 1, 128, 4, 2, causal=True, window=7, softcap=20.0,
                   **wide)
        flash_case(dtype, 2, 100, 4, 2, causal=False, **wide)
        flash_case(dtype, 1, 1024, 64, 8, bq=128, causal=True, **wide)
        flash_case(dtype, 1, 1024, 64, 8, bq=128, causal=True, window=256,
                   softcap=50.0, **wide)
        # the served archs' heads, windows and softcaps (phase 4d):
        # gemma2-27b's 32/16 with softcap 50, local (window 4096) and
        # global; gemma3-27b's, local (window 1024, S past it) and global;
        # granite-moe's 24/8 at hd 64; grok-1's 48/8 (qwen3-32b's 64/8
        # above)
        flash_case(dtype, 2, 300, 32, 16, bq=128, causal=True, window=4096,
                   softcap=50.0, **wide)
        flash_case(dtype, 2, 300, 32, 16, bq=128, causal=True, softcap=50.0,
                   **wide)
        flash_case(dtype, 1, 1100, 32, 16, bq=128, causal=True, window=1024,
                   **wide)
        flash_case(dtype, 2, 300, 32, 16, bq=128, causal=True, **wide)
        flash_case(dtype, 2, 300, 24, 8, bq=128, causal=True)
        flash_case(dtype, 2, 300, 48, 8, bq=128, causal=True, **wide)
        # whisper's encoder (12/12 heads of 64, non-causal over its 1500
        # frames, padded to 1536 and the padded keys masked) and decoder
        # (causal at its 416-token prompt, padded to 512); llava's 56/8
        # (g 7) at hd 128; zamba2's shared block, 32/32 (g 1)
        flash_case(dtype, 1, 1500, 12, 12, bq=128, causal=False)
        flash_case(dtype, 2, 416, 12, 12, bq=128, causal=True)
        flash_case(dtype, 1, 300, 56, 8, bq=128, causal=True, **wide)
        flash_case(dtype, 2, 300, 32, 32, bq=128, causal=True)
        for s, chunk in ((64, 16), (75, 16), (128, 32)):
            ssd_case(dtype, 2, s, 3, 16, 8, chunk)
        ssd_case(dtype, 2, 300, 4, 64, 128, 128)  # mamba2's widths
        ssd_case(dtype, 2, 300, 4, 64, 64, 128)  # zamba2's n 64
    flash_controls(1, 256, 4, 2, 64, 7, 20.0)
    flash_controls(1, 1024, 64, 8, 128, 256, 50.0)
    # mamba2's widths at chunk 64, at a chunk that is not a multiple of
    # 16 and at batch 1; then p and n that are not multiples of 8 (plain
    # loads in place of cp.async)
    for dtype in (torch.float32, torch.bfloat16):
        ssd_case(dtype, 2, 300, 4, 64, 128, 64)
        ssd_case(dtype, 2, 100, 4, 64, 128, 20)
        ssd_case(dtype, 1, 512, 8, 64, 128, 128)
        ssd_case(dtype, 2, 64, 3, 10, 12, 16)
    worst["ssd_bf16_control"], worst["ssd_state_control"] = _ssd_controls(
        _ssd_inputs(g, dev, torch.bfloat16, 2, 384, 4, 64, 128), 128)
    ssd_batch_rows(4, 384, 48, 64, 128, 128)  # mamba2's heads
    ssd_batch_rows(4, 384, 64, 64, 64, 128)  # zamba2's heads, n 64


def check_kernels(dev) -> dict:
    """Phase 1: every kernel against its plain version on the card."""
    g = _gen(SEED)
    worst = {"int8_matmul": 0.0, "gpo_attention_fwd": 0.0,
             "gpo_attention_fwd_f64": {},
             "gpo_attention_bwd_dq": 0.0, "gpo_attention_bwd_dkdv": 0.0,
             "gpo_attention_bwd_f64": {}, "fedavg_reduce": 0.0,
             "momentum_reduce": 0.0, "trimmed_reduce": 0.0,
             "pairwise_dists": 0.0, "pairwise_dists_f64": {},
             "clip_reduce": 0.0, "quant_clip_reduce": 0.0,
             "topk_reduce": 0.0, "flash_attention": 0.0, "ssd_scan": 0.0,
             "flash_bf16_row": 0.0, "flash_bf16_control": float("inf"),
             "ssd_bf16_row": 0.0}
    for k, n in INT8_SHAPES:
        tol = 1e-4 if k > 256 else 1e-5
        for m in (1, 37, 1280):
            x, q, s = _int8_inputs(m, k, n, g, dev)
            out = int8_matmul_flat(x, q, s)
            plain = ref_int8_matmul(x, q, s)
            torch.cuda.synchronize()
            err = (out - plain).abs()
            ok = bool((err <= tol * (1 + plain.abs())).all())
            one = int8_matmul_flat(x[-1:].contiguous(), q, s)
            rows_independent = torch.equal(one[0], out[-1])
            print(f"  int8_matmul M={m:5d} K={k:5d} N={n:4d}  max_abs_err="
                  f"{err.max().item():.3e}  tol={tol:g}*(1+|plain|)  "
                  f"last row alone bit-equal: {rows_independent}")
            if not ok or not rows_independent:
                raise AssertionError(f"int8_matmul mismatch at {(m, k, n)}")
            worst["int8_matmul"] = max(worst["int8_matmul"],
                                       err.max().item())
        # a row's result does not depend on M: rows 0-15 of the same x at
        # the serving step's M = 16, 320 and 1280
        x, q, s = _int8_inputs(INT8_M_ROWS[-1], k, n, g, dev)
        heads = [int8_matmul_flat(x[:m].contiguous(), q, s)[:16]
                 for m in INT8_M_ROWS]
        torch.cuda.synchronize()
        same = all(torch.equal(heads[0], h) for h in heads[1:])
        print(f"  int8_matmul K={k:5d} N={n:4d}  rows 0-15 at M="
              f"{'/'.join(map(str, INT8_M_ROWS))} bit-equal: {same}")
        if not same:
            raise AssertionError(f"int8_matmul rows depend on M at {(k, n)}")
    _check_attention_fwd(g, dev, worst)
    _check_attention_bwd(g, dev, worst)
    _check_fedavg(g, dev, worst)
    _check_agg_kernels(g, dev, worst)
    _check_pairwise_f64(g, dev, worst)
    _check_transport_kernels(g, dev, worst)
    _check_backbone_kernels(g, dev, worst)
    return worst


def _rows(results) -> dict:
    return {c.rid: c.pred for c in results}


def _max_diff(a: dict, b: dict) -> float:
    if a.keys() != b.keys():
        raise AssertionError("completed request sets differ")
    return max(float(np.abs(a[r] - b[r]).max()) for r in a)


def serve(dev, data, groups, gcfg, params) -> dict:
    """Phase 2: the serving engine, f32 and int8."""
    trace = make_request_trace(data, groups, num_requests=64,
                               hit_ratio=0.5, seed=SEED)
    servers = {w: PreferenceServer(params, gcfg,
                                   ServeConfig(int8_weights=w),
                                   num_options=data.num_options, device=dev)
               for w in (False, True)}
    for srv in servers.values():  # first launches load the kernels
        srv.run_trace(trace[:8], clear_cache=True)
    torch.cuda.synchronize()

    # the main path: the int8 engine over the whole trace, cold cache
    int8_matmul_flat.launches = 0
    gpo_attention_fwd.launches = 0
    t0 = time.perf_counter()
    cold8 = servers[True].run_trace(trace, clear_cache=True)
    wall8 = time.perf_counter() - t0
    launches = int8_matmul_flat.launches
    steps = len(servers[True].batches)
    if len(cold8) != len(trace):
        raise AssertionError(f"served {len(cold8)} of {len(trace)} requests")
    if launches == 0 or gpo_attention_fwd.launches != 0:
        raise AssertionError("the int8 engine did not run on the int8 "
                             "kernel alone")
    record = {"launches": launches, "steps": steps,
              "prefill_requests": servers[True].stats.prefills,
              "max_decode_rows": max(b.batch_pad * b.tgt_bucket
                                     for b in servers[True].batches),
              # the rows of a full batch of prefills at the largest ctx
              # bucket the trace used
              "max_prefill_rows": ServeConfig().max_batch * max(
                  b.ctx_bucket for b in servers[True].batches)}
    print(f"  int8 engine: {launches} int8_matmul launches over {steps} "
          f"steps ({servers[True].stats})")

    t0 = time.perf_counter()
    cold32 = servers[False].run_trace(trace, clear_cache=True)
    wall32 = time.perf_counter() - t0
    summaries = {"int8 cold": latency_summary(cold8, wall8),
                 "f32 cold": latency_summary(cold32, wall32)}
    for w, cold in ((True, cold8), (False, cold32)):
        name = "int8" if w else "f32"
        t0 = time.perf_counter()
        warm = servers[w].run_trace(trace, clear_cache=False)
        summaries[f"{name} warm"] = latency_summary(
            warm, time.perf_counter() - t0)
        if not all(c.cache_hit for c in warm):
            raise AssertionError(f"{name}: warm trace missed the cache")
        if _max_diff(_rows(cold), _rows(warm)) != 0.0:
            raise AssertionError(f"{name}: cache hit != miss")
    for name, s in summaries.items():
        print(f"  {name:9s}: p50={s['p50_ms']:.3f}ms p99={s['p99_ms']:.3f}"
              f"ms qps={s['qps']:.1f} hit_rate={s['hit_rate']:.2f} "
              f"completed={s['completed']}")
    print("  cache hit == miss: bit-equal (f32 and int8)")

    rows8, rows32 = _rows(cold8), _rows(cold32)
    d = _max_diff(rows8, rows32)
    sums = max(abs(float(p.sum(-1).max()) - 1) for p in rows8.values())
    sums = max(sums, max(abs(float(p.sum(-1).min()) - 1)
                         for p in rows8.values()))
    print(f"  int8 vs f32 rows: max_abs={d:.3e} (tol 0.05); rows sum to 1 "
          f"within {sums:.1e}")
    if not (d <= 0.05 and sums <= 1e-5):
        raise AssertionError("int8 rows off the f32 rows or the simplex")

    # served rows against the monolithic forward, on the card and on
    # the CPU, and alone against batched (batch-composition)
    qparams = quantize_gpo_params(params)
    cpu_params = map_params(lambda a: a.cpu(), params)
    cpu = {False: cpu_params, True: quantize_gpo_params(cpu_params)}
    mono = {False: params, True: qparams}
    alone_srv = {w: PreferenceServer(params, gcfg,
                                     ServeConfig(int8_weights=w),
                                     num_options=data.num_options,
                                     device=dev) for w in (False, True)}
    worst = {"monolithic": 0.0, "cpu": 0.0, "alone": 0.0}
    for w, rows in ((False, rows32), (True, rows8)):
        for r in trace[:8]:
            ins = [torch.from_numpy(a) for a in (r.ctx_x, r.ctx_y, r.tgt_x)]
            ref = predict_preferences(mono[w], gcfg, *ins, data.num_options,
                                      device=dev).cpu().numpy()
            ref_cpu = predict_preferences(cpu[w], gcfg, *ins,
                                          data.num_options,
                                          device="cpu").numpy()
            alone_srv[w].submit(r)
            alone = alone_srv[w].step()[0].pred
            for key, other in (("monolithic", ref), ("cpu", ref_cpu),
                               ("alone", alone)):
                worst[key] = max(worst[key],
                                 float(np.abs(rows[r.rid] - other).max()))
    print(f"  served rows vs monolithic predict_preferences on the card: "
          f"max_abs={worst['monolithic']:.3e} (tol 1e-05)")
    print(f"  served rows vs the port's CPU path: max_abs="
          f"{worst['cpu']:.3e} (tol 1e-05)")
    print(f"  batch-composition independence (served alone vs in the "
          f"batch): max_abs={worst['alone']:.3e} (tol 1e-05; not bit-"
          f"exact where cuBLAS picks per-shape algorithms)")
    if max(worst.values()) > 1e-5:
        raise AssertionError(f"served rows off their references: {worst}")

    # where an engine step's time goes: device kernel time against wall
    # time, over the same cold trace under the profiler
    for w in (True, False):
        name = "int8" if w else "f32"
        prof = _profile(lambda: servers[w].run_trace(trace, clear_cache=True))
        prof["steps"] = len(servers[w].batches)
        record[f"profile_{name}"] = prof
        print(f"  {name} engine under the profiler: wall "
              f"{prof['wall_ms']:.3f}ms over {prof['steps']} steps, "
              f"{prof['kernels']} kernels, device busy "
              f"{prof['kernel_ms']:.3f}ms ({100 * prof['busy_share']:.2f}%)")
        for t in prof["top"]:
            print(f"    {t['ms']:.4f}ms  {t['launches']:5d}x  {t['name']}")
    record.update(summaries=summaries, wall_int8_s=wall8,
                  wall_f32_s=wall32)
    return record


def predict(dev, data, groups, gcfg, params) -> dict:
    """Phase 3: the quickstart's serve step through the attention
    kernel, per held-out group and batched over all of them."""
    kcfg = replace(gcfg, use_pallas_attention=True)
    g = _gen(SEED + 1)
    quick = [sample_icl_batch(g, data, int(gr), 12, 4) for gr in groups]
    evals = [sample_icl_batch(g, data, int(gr), 16, 16) for gr in groups]
    stacked = [torch.stack([getattr(b, f) for b in evals]).to(dev)
               for f in ("ctx_x", "ctx_y", "tgt_x")]

    gpo_attention_fwd.launches = 0
    int8_matmul_flat.launches = 0
    preds = [predict_preferences(params, kcfg, b.ctx_x, b.ctx_y, b.tgt_x,
                                 data.num_options, device=dev)
             for b in quick]
    batched = predict_preferences(params, kcfg, *stacked, data.num_options,
                                  device=dev)
    torch.cuda.synchronize()
    launches = gpo_attention_fwd.launches
    calls = len(quick) + 1
    if launches == 0 or int8_matmul_flat.launches != 0:
        raise AssertionError("predict_preferences did not run on the "
                             "attention kernel")

    err, scores = 0.0, []
    for b, p in zip(quick, preds):
        dense = predict_preferences(params, gcfg, b.ctx_x, b.ctx_y, b.tgt_x,
                                    data.num_options, device=dev)
        err = max(err, (p - dense).abs().max().item())
        truth = b.tgt_y.reshape(-1, data.num_options).to(dev)
        scores.append(alignment_score(p, truth).item())
    dense = predict_preferences(params, gcfg, *stacked, data.num_options,
                                device=dev)
    err = max(err, (batched - dense).abs().max().item())
    print(f"  {launches} gpo_attention_fwd launches over {calls} "
          f"predict_preferences calls ({len(quick)} groups of 12+4 "
          f"questions, then all {len(evals)} groups batched at 16+16)")
    print(f"  kernel branch vs dense branch: max_abs={err:.3e} (tol 1e-05)"
          f"; alignment score per group (random weights): "
          f"{np.round(scores, 4).tolist()}")
    if not err <= 1e-5:
        raise AssertionError("attention kernel rows off the dense rows")

    mu32, _ = gpo_apply(params, gcfg, *stacked)
    mu8, _ = gpo_apply(quantize_gpo_params(params), gcfg, *stacked)
    mu_err = (mu8 - mu32).abs().max().item()
    print(f"  int8 vs f32 predicted preference mu: max_abs={mu_err:.3e} "
          f"(tol 0.05; |mu| max {mu32.abs().max().item():.3f})")
    if not mu_err <= 0.05:
        raise AssertionError("int8 mu off the f32 mu")
    return {"launches": launches, "calls": calls}


_COUNTED = {"gpo_attention_fwd": gpo_attention_fwd,
            "gpo_attention_bwd_dq": gpo_attention_bwd_dq,
            "gpo_attention_bwd_dkdv": gpo_attention_bwd_dkdv,
            "fedavg_reduce": fedavg_reduce_flat,
            "momentum_reduce": momentum_reduce_flat,
            "trimmed_reduce": trimmed_reduce_flat,
            "pairwise_dists": pairwise_dists_flat,
            "clip_reduce": clip_reduce_flat,
            "quant_clip_reduce": quant_clip_reduce_flat,
            "topk_reduce": topk_reduce_flat,
            "int8_matmul": int8_matmul_flat,
            "flash_attention": flash_attention_bhsd,
            "ssd_scan": ssd_scan_bhsp}


def _counts() -> dict:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def _zero_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0


def _attention_launches(gcfg, fcfg, rounds) -> dict:
    """The attention kernels' launches in ``rounds`` training rounds:
    one forward and backward per layer and local epoch, and one forward
    per layer for the round's eval."""
    steps = gcfg.num_layers * fcfg.local_epochs * rounds
    return {"gpo_attention_fwd": steps + gcfg.num_layers * rounds,
            "gpo_attention_bwd_dq": steps, "gpo_attention_bwd_dkdv": steps}


def _agreement(hist, params, other, other_params) -> dict:
    """How far two 3-round runs are apart: round losses (relative; 0
    where they are equal, as in a faulted round where no client kept its
    work and both report 0), eval AS / FI / CoV (absolute), final global
    params (max abs)."""
    a, b = np.asarray(hist.round_loss), np.asarray(other.round_loss)
    with np.errstate(divide="ignore", invalid="ignore"):
        loss = np.where(a == b, 0.0, np.abs(a - b) / np.abs(b))
    ev = max(float(np.abs(np.asarray(getattr(hist, k))
                          - getattr(other, k)).max())
             for k in ("eval_mean_as", "eval_fi", "eval_cov"))
    par = max((a.cpu() - b.cpu()).abs().max().item()
              for a, b in zip(tree_leaves(params), tree_leaves(other_params)))
    return {"round_loss_rel": float(loss.max()), "eval_abs": ev,
            "params_max_abs": par}


def _strategy_cfg(base: FedConfig, label: str) -> FedConfig:
    kw = dict(STRATEGIES[label])
    return replace(base, agg=AggConfig(name=kw.pop("name", label), **kw))


def _within(a: dict) -> bool:
    return (a["round_loss_rel"] <= TRAIN_TOL["round_loss_rtol"]
            and a["eval_abs"] <= TRAIN_TOL["eval_atol"]
            and a["params_max_abs"] <= TRAIN_TOL["params_max_abs"])


def train(dev, data, tr, ev) -> dict:
    """Phase 4: federated training at full width through the kernels,
    then its checkpoint served."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    # examples/quickstart.py:55-57, with eval every round
    dense = FedConfig(num_clients=len(tr), local_epochs=6, lr=3e-4,
                      eval_every=1)
    kern = replace(dense, use_pallas_attention=True,
                   use_pallas_aggregation=True)
    fed = FederatedGPO(gcfg, kern, data, tr, ev, device=dev)

    # the main path: 3 rounds through the kernels, eval every round
    _zero_counts()
    t0 = time.perf_counter()
    hist = fed.run(rounds=TRAIN_ROUNDS, engine="loop")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    layers, epochs = gcfg.num_layers, kern.local_epochs
    want = {**dict.fromkeys(_COUNTED, 0),
            **_attention_launches(gcfg, kern, TRAIN_ROUNDS),
            "fedavg_reduce": TRAIN_ROUNDS}
    print(f"  {TRAIN_ROUNDS} rounds of {len(tr)} clients x {epochs} local "
          f"epochs in {wall:.3f}s; launches {launches}")
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    print(f"  round_loss {hist.round_loss}  eval AS {hist.eval_mean_as}")

    # the same trainer on the CPU (plain versions) and on the card's
    # dense path: same init and batches, drawn from the same seeds
    cpu = FederatedGPO(gcfg, kern, data, tr, ev, device="cpu")
    cpu_hist = cpu.run(rounds=TRAIN_ROUNDS, engine="loop")
    den = FederatedGPO(gcfg, dense, data, tr, ev, device=dev)
    den_hist = den.run(rounds=TRAIN_ROUNDS, engine="loop")
    agree = {"cpu": _agreement(hist, fed.global_params, cpu_hist,
                               cpu.global_params),
             "dense": _agreement(hist, fed.global_params, den_hist,
                                 den.global_params)}
    for name, a in agree.items():
        print(f"  vs the {name} run: round_loss rel {a['round_loss_rel']:.3e}"
              f" (tol {TRAIN_TOL['round_loss_rtol']:g}); eval AS/FI/CoV abs "
              f"{a['eval_abs']:.3e} (tol {TRAIN_TOL['eval_atol']:g}); params "
              f"max_abs {a['params_max_abs']:.3e} (tol "
              f"{TRAIN_TOL['params_max_abs']:g})")
        if not _within(a):
            raise AssertionError(f"the kernel run is off the {name} run")

    # training goes on: the loss falls
    t0 = time.perf_counter()
    more = fed.run(rounds=MORE_ROUNDS, log_every=5, engine="loop")
    more_wall = time.perf_counter() - t0
    first, last = float(np.mean(hist.round_loss)), float(
        np.mean(more.round_loss[-5:]))
    print(f"  {MORE_ROUNDS} more rounds in {more_wall:.3f}s: mean loss of "
          f"the first {TRAIN_ROUNDS} rounds {first:.5f}, of the last 5 "
          f"{last:.5f}")
    if not last < first:
        raise AssertionError("the round loss did not fall")

    # train -> checkpoint -> serve
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    path = save_checkpoint(str(ckpt_dir), TRAIN_ROUNDS + MORE_ROUNDS,
                           fed.global_params)
    like = init_gpo_params(gcfg, _gen(SEED + 7), device=dev)
    restored = restore_checkpoint(latest_checkpoint(str(ckpt_dir)), like)
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored), tree_leaves(fed.global_params))):
        raise AssertionError("the restored checkpoint differs")
    srv = PreferenceServer(restored, gcfg, ServeConfig(),
                           num_options=data.num_options, device=dev)
    trace = make_request_trace(data, list(ev), num_requests=8,
                               hit_ratio=0.5, seed=SEED + 3)
    done = srv.run_trace(trace, clear_cache=True)
    prefs = data.prefs.numpy()
    err, served_as = 0.0, []
    for c in sorted(done, key=lambda c: c.rid):
        r = trace[c.rid]
        ins = [torch.from_numpy(a) for a in (r.ctx_x, r.ctx_y, r.tgt_x)]
        mono = predict_preferences(restored, gcfg, *ins, data.num_options,
                                   device=dev).cpu().numpy()
        err = max(err, float(np.abs(c.pred - mono).max()))
        truth = torch.from_numpy(prefs[r.meta["group"], r.meta["tgt_q"]])
        served_as.append(alignment_score(torch.from_numpy(c.pred),
                                         truth).item())
    print(f"  checkpoint {Path(path).name} restored bit-equal and served: "
          f"{len(done)}/{len(trace)} requests, rows vs monolithic "
          f"predict_preferences max_abs={err:.3e} (tol 1e-05), AS per "
          f"request {np.round(served_as, 4).tolist()}")
    if len(done) != len(trace) or not err <= 1e-5:
        raise AssertionError("the trained checkpoint was not served right")

    # where a round's time goes (its eval included)
    prof = _profile(lambda: fed.run(rounds=1, engine="loop"),
                    "train_trace.json")
    print(f"  one round under the profiler: wall {prof['wall_ms']:.3f}ms, "
          f"{prof['kernels']} kernels, device busy {prof['kernel_ms']:.3f}ms "
          f"({100 * prof['busy_share']:.2f}%)")
    for t in prof["top"]:
        print(f"    {t['ms']:.4f}ms  {t['launches']:5d}x  {t['name']}")
    return {"config": {"clients": len(tr), "local_epochs": epochs,
                       "lr": kern.lr, "num_context": kern.num_context,
                       "num_target": kern.num_target,
                       "d_model": gcfg.d_model, "layers": layers,
                       "heads": gcfg.num_heads, "d_ff": gcfg.d_ff},
            "rounds": TRAIN_ROUNDS, "launches": launches,
            "wall_ms_per_round": wall / TRAIN_ROUNDS * 1e3,
            "round_loss": hist.round_loss, "eval_mean_as": hist.eval_mean_as,
            "eval_fi": hist.eval_fi, "agreement": agree,
            "tolerance": TRAIN_TOL, "more_rounds": MORE_ROUNDS,
            "more_wall_ms_per_round": more_wall / MORE_ROUNDS * 1e3,
            "loss_first_mean": first, "loss_last5_mean": last,
            "more_eval_mean_as_last": more.eval_mean_as[-1],
            "served": len(done), "served_as_mean": float(np.mean(served_as)),
            "profile_round": prof}


def train_strategies(dev, data, tr, ev) -> dict:
    """Phase 4, continued: every strategy of ``STRATEGIES`` for 3 rounds
    through the kernels (launch counts asserted), against the same run
    with the aggregation's plain versions on the card; median and krum
    also against their CPU runs."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    base = FedConfig(num_clients=len(tr), local_epochs=6, lr=3e-4,
                     eval_every=1, use_pallas_attention=True,
                     use_pallas_aggregation=True)
    out, real_clip = {}, pipeline.norm_clip_rows
    for label in STRATEGIES:
        kern = _strategy_cfg(base, label)
        plain = replace(kern, use_pallas_aggregation=False)
        row_norms = []
        if kern.agg.norm_bound > 0:  # read the received rows' norms
            def spy(vecs, bound):
                row_norms.append(torch.linalg.vector_norm(vecs, dim=1).cpu())
                return real_clip(vecs, bound)

            pipeline.norm_clip_rows = spy
        try:
            fed = FederatedGPO(gcfg, kern, data, tr, ev, device=dev)
            _zero_counts()
            t0 = time.perf_counter()
            hist = fed.run(rounds=TRAIN_ROUNDS, engine="loop")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
            t0 = time.perf_counter()
            den = FederatedGPO(gcfg, plain, data, tr, ev, device=dev)
            den_hist = den.run(rounds=TRAIN_ROUNDS, engine="loop")
            torch.cuda.synchronize()
            den_wall = time.perf_counter() - t0
        finally:
            pipeline.norm_clip_rows = real_clip
        agg_kernel = STRATEGY_KERNEL.get(label, "fedavg_reduce")
        want = {**dict.fromkeys(_COUNTED, 0),
                **_attention_launches(gcfg, kern, TRAIN_ROUNDS)}
        if agg_kernel:
            want[agg_kernel] = TRAIN_ROUNDS
        agree = {"plain": _agreement(hist, fed.global_params, den_hist,
                                     den.global_params)}
        rec = {"agg": {"name": kern.agg.name, **STRATEGIES[label]},
               "kernel": agg_kernel,
               "launches": {k: v for k, v in launches.items() if v},
               "wall_ms_per_round": wall / TRAIN_ROUNDS * 1e3,
               "plain_wall_ms_per_round": den_wall / TRAIN_ROUNDS * 1e3,
               "round_loss": hist.round_loss,
               "eval_mean_as": hist.eval_mean_as}
        if row_norms:  # the kernel run's rounds, then the plain run's
            clipped = [int((n > NORM_BOUND).sum())
                       for n in row_norms[:TRAIN_ROUNDS]]
            rec.update(norm_bound=NORM_BOUND, rows_clipped=clipped,
                       round0_row_norms=row_norms[0].tolist())
            print(f"  norm_bound {NORM_BOUND}: rows clipped per round "
                  f"{clipped} of {len(tr)} (round 0 norms "
                  f"{np.round(row_norms[0].numpy(), 4).tolist()})")
            if clipped[0] < 1:
                raise AssertionError("the norm bound clipped no row in "
                                     "round 0")
        if label in CPU_STRATEGIES:
            cpu = FederatedGPO(gcfg, kern, data, tr, ev, device="cpu")
            cpu_hist = cpu.run(rounds=TRAIN_ROUNDS, engine="loop")
            agree["cpu"] = _agreement(hist, fed.global_params, cpu_hist,
                                      cpu.global_params)
        rec["agreement"] = agree
        out[label] = rec
        print(f"  {label:17s} {wall / TRAIN_ROUNDS * 1e3:8.2f} ms/round "
              f"(plain aggregation {den_wall / TRAIN_ROUNDS * 1e3:8.2f}); "
              f"{agg_kernel or 'no aggregation kernel'} "
              f"x{launches.get(agg_kernel, 0) if agg_kernel else 0}; "
              + "; ".join(f"vs {k}: loss rel {a['round_loss_rel']:.2e} "
                          f"eval {a['eval_abs']:.2e} params "
                          f"{a['params_max_abs']:.2e}"
                          for k, a in agree.items())
              + f"; loss {np.round(hist.round_loss, 5).tolist()}")
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, want "
                                 f"{want}")
        for k, a in agree.items():
            if not _within(a):
                raise AssertionError(f"{label}: the kernel run is off the "
                                     f"{k} run (tolerance {TRAIN_TOL})")
    return out


def _private_cfg(base: FedConfig, label: str) -> FedConfig:
    spec = PRIVATE[label]
    return replace(base, agg=AggConfig(**spec.get("agg", {})),
                   privacy=PrivacyConfig(**spec.get("privacy", {})),
                   compression=CompressionConfig(
                       **spec.get("compression", {})))


def _cpu_draws(fcfg: FedConfig, shape: tuple, rounds: int) -> dict:
    """The release draws of ``rounds`` rounds (noise, then uniforms,
    where the config uses them), made once on the CPU from a seed, as
    numpy, for a card run and a CPU run to replay."""
    g = _gen(SEED + 11)
    priv, comp = fcfg.privacy, fcfg.compression
    return {r: (dp.client_noise(g, shape, priv.sigma).numpy()
                if priv.enabled and priv.noise_multiplier > 0 else None,
                cx.client_uniform(g, shape).numpy()
                if comp.needs_rng else None)
            for r in range(rounds)}


def _spy_levels(levels: list):
    """Record the codec's level size each round of a plain run: the
    largest int8 scale, or the largest top-k threshold. Returns the
    originals to put back."""
    real = cx.quantize_int8, cx.topk_thresholds

    def quantize(vecs, *, uniform=None):
        q, scales = real[0](vecs, uniform=uniform)
        levels.append(float(scales.max()))
        return q, scales

    def thresholds(vecs, frac):
        tau = real[1](vecs, frac)
        levels.append(float(tau.max()))
        return tau

    cx.quantize_int8, cx.topk_thresholds = quantize, thresholds
    return real


def _private_agreement(hist, fed, other, other_fed, allowance) -> dict:
    """``_agreement``, the EF residuals' max abs difference, and how
    many coordinates of params and residual lie beyond 1e-4."""
    a = _agreement(hist, fed.global_params, other, other_fed.global_params)
    diffs = [(x.cpu() - y.cpu()).abs() for x, y in zip(
        tree_leaves(fed.global_params), tree_leaves(other_fed.global_params))]
    if fed.ef_resid is not None:
        r = (fed.ef_resid.cpu() - other_fed.ef_resid.cpu()).abs()
        a["ef_resid_max_abs"] = r.max().item()
        diffs.append(r)
    a["coords_beyond_1e-4"] = int(sum((d > 1e-4).sum() for d in diffs))
    a.update(allowance)
    return a


def _private_within(a: dict) -> bool:
    """TRAIN_TOL, the params and the residual widened by the level
    allowance, and at most MAX_FLIPPED coordinates beyond 1e-4."""
    return (a["round_loss_rel"] <= TRAIN_TOL["round_loss_rtol"]
            and a["coords_beyond_1e-4"] <= MAX_FLIPPED
            and a["eval_abs"] <= TRAIN_TOL["eval_atol"]
            and a["params_max_abs"] <= TRAIN_TOL["params_max_abs"]
            + a["params_allowance"]
            and a.get("ef_resid_max_abs", 0.0)
            <= TRAIN_TOL["params_max_abs"] + a["resid_allowance"])


def train_private(dev, data, tr, ev) -> dict:
    """Phase 4, continued: the round's DP and codec stages, each
    configuration of ``PRIVATE`` for 3 rounds through the kernels (launch
    counts asserted), against the same run with the aggregation's plain
    versions on the card (the same device generator draws the noise and
    the uniforms); dp_noise and int8_ef also as a card run and a CPU run
    that replay draws made once on the CPU; the cumulative ε against the
    port's accountant.

    A codec run may flip one coordinate a round between two paths: an
    int8 scale an ulp off (norms summed in another order) flips a
    rounding decision by one level s, and near-tied magnitudes (Adam's
    first steps leave many |Δ| within an ulp of each other) may trade
    places across a top-k threshold τ. The params' bound therefore grows
    by Σ_rounds w_max·level, the residual's by Σ_rounds level, level the
    largest s or τ of the plain run's round; the coordinates beyond 1e-4
    are counted and reported."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    base = FedConfig(num_clients=len(tr), local_epochs=6, lr=3e-4,
                     eval_every=1, use_pallas_attention=True,
                     use_pallas_aggregation=True)
    out = {}
    for label in PRIVATE:
        kern = _private_cfg(base, label)
        plain = replace(kern, use_pallas_aggregation=False)
        fed = FederatedGPO(gcfg, kern, data, tr, ev, device=dev)
        _zero_counts()
        t0 = time.perf_counter()
        hist = fed.run(rounds=TRAIN_ROUNDS, engine="loop")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        levels: list = []
        real = _spy_levels(levels)
        try:
            t0 = time.perf_counter()
            den = FederatedGPO(gcfg, plain, data, tr, ev, device=dev)
            den_hist = den.run(rounds=TRAIN_ROUNDS, engine="loop")
            torch.cuda.synchronize()
            den_wall = time.perf_counter() - t0
        finally:
            cx.quantize_int8, cx.topk_thresholds = real
        w_max = float(fed.weights.max())
        allowance = {"levels": levels,
                     "params_allowance": w_max * sum(levels),
                     "resid_allowance": sum(levels)}
        kernel = PRIVATE_KERNEL[label]
        want = {**dict.fromkeys(_COUNTED, 0),
                **_attention_launches(gcfg, kern, TRAIN_ROUNDS),
                kernel: TRAIN_ROUNDS}
        agree = {"plain": _private_agreement(hist, fed, den_hist, den,
                                             allowance)}
        acct = dp.make_accountant(kern.privacy, 1.0)
        eps_want = [] if not kern.privacy.enabled else [
            acct.epsilon(r) if acct else float("inf")
            for r in range(1, TRAIN_ROUNDS + 1)]
        if label in CPU_PRIVATE:
            draws = _cpu_draws(
                kern, (len(tr), tree_count_params(fed.global_params)),
                TRAIN_ROUNDS)
            runs = []
            for d in (dev, "cpu"):
                f = FederatedGPO(gcfg, kern, data, tr, ev, device=d,
                                 release_draws=lambda r: draws[r])
                runs.append((f.run(rounds=TRAIN_ROUNDS, engine="loop"), f))
            agree["cpu"] = _private_agreement(*runs[0], *runs[1],
                                              allowance)
        if label in PROFILED_PRIVATE:
            prof = _profile(lambda: fed.run(rounds=1, engine="loop"),
                            f"private_{label}_trace.json",
                            match=("clip_on_chip", "clip_reduce_kernel",
                                   "quant_on_chip", "row_sumsq",
                                   "row_absmax", "quant_reduce",
                                   "topk_reduce_kernel", "gatherTopK",
                                   "kth", "sort"))
            print(f"  {label}: one round under the profiler: wall "
                  f"{prof['wall_ms']:.3f}ms, {prof['kernels']} kernels, "
                  f"device busy {prof['kernel_ms']:.3f}ms "
                  f"({100 * prof['busy_share']:.2f}%); by name: "
                  + ", ".join(f"{m} {v['ms']:.4f}ms x{v['launches']}"
                              for m, v in prof["matched"].items()))
            for t in prof["top"]:
                print(f"    {t['ms']:.4f}ms  {t['launches']:5d}x  "
                      f"{t['name']}")
            seen = {m: v["launches"] for m, v in prof["matched"].items()}
            if label == "dp_noise" and (
                    seen["clip_on_chip"] != 1 or seen["row_sumsq"]
                    or seen["clip_reduce_kernel"]):
                raise AssertionError(f"dp_noise's profiled round ran "
                                     f"{seen}: want the on-chip clip kernel "
                                     f"once and no two-launch one")
            if label == "dp_int8_ef" and (
                    seen["quant_on_chip"] != 1 or seen["row_sumsq"]
                    or seen["row_absmax"] or seen["quant_reduce"]):
                raise AssertionError(f"dp_int8_ef's profiled round ran "
                                     f"{seen}: want the on-chip quant "
                                     f"kernel once and no three-pass one")
        rec = {"config": PRIVATE[label], "kernel": kernel,
               "launches": {k: v for k, v in launches.items() if v},
               "wall_ms_per_round": wall / TRAIN_ROUNDS * 1e3,
               "plain_wall_ms_per_round": den_wall / TRAIN_ROUNDS * 1e3,
               "round_loss": hist.round_loss,
               "eval_mean_as": hist.eval_mean_as,
               "round_eps": hist.round_eps, "agreement": agree}
        if label in PROFILED_PRIVATE:
            rec["profile_round"] = prof
        out[label] = rec
        print(f"  {label:10s} {wall / TRAIN_ROUNDS * 1e3:8.2f} ms/round "
              f"(plain aggregation {den_wall / TRAIN_ROUNDS * 1e3:8.2f}); "
              f"{kernel} x{launches[kernel]}; "
              + "; ".join(f"vs {k}: loss rel {a['round_loss_rel']:.2e} "
                          f"eval {a['eval_abs']:.2e} params "
                          f"{a['params_max_abs']:.2e} (allowance "
                          f"{a['params_allowance']:.2e}) resid "
                          f"{a.get('ef_resid_max_abs', 0.0):.2e} coords>1e-4 "
                          f"{a['coords_beyond_1e-4']}"
                          for k, a in agree.items())
              + f"; loss {np.round(hist.round_loss, 5).tolist()}; eps "
              f"{np.round(hist.round_eps, 4).tolist()}")
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, want "
                                 f"{want}")
        for k, a in agree.items():
            if not _private_within(a):
                raise AssertionError(f"{label}: the kernel run is off the "
                                     f"{k} run (tolerance {TRAIN_TOL} plus "
                                     f"the level allowance)")
        if hist.round_eps != eps_want or den_hist.round_eps != eps_want:
            raise AssertionError(f"{label}: round_eps {hist.round_eps}, "
                                 f"want {eps_want}")
        if (fed.ef_resid is None) != (not kern.compression.enabled
                                      or not kern.compression.error_feedback):
            raise AssertionError(f"{label}: EF residual carried wrongly")
    return out


def train_private_wide(dev, data, tr, ev) -> dict:
    """Phase 4c, continued: one round of each ``WIDE_PRIVATE``
    configuration with every survey group a client (the 10 training
    groups, then the 7 held-out ones; eval still on the held-out), past
    the on-chip designs' capacity: through the kernels (launch counts and
    the design asserted), against the same round with the aggregation's
    plain versions on the card and against the port's CPU run, all three
    replaying draws made once on the CPU, held as ``train_private``
    holds its rounds (the level allowance from the plain run)."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    groups = np.concatenate([np.asarray(tr), np.asarray(ev)])
    base = FedConfig(num_clients=len(groups), local_epochs=6, lr=3e-4,
                     eval_every=1, use_pallas_attention=True,
                     use_pallas_aggregation=True)
    out = {}
    for label, design_want in WIDE_PRIVATE.items():
        kern = _private_cfg(base, label)
        kernel = PRIVATE_KERNEL[label]
        shape = (len(groups), tree_count_params(
            init_gpo_params(gcfg, _gen(0), device="cpu")))
        draws = _cpu_draws(kern, shape, 1)

        def run(cfg, d):
            fed = FederatedGPO(gcfg, cfg, data, groups, ev, device=d,
                               release_draws=lambda r: draws[r])
            return fed.run(rounds=1, engine="loop"), fed

        _zero_counts()
        card = run(kern, dev)
        torch.cuda.synchronize()
        launches = _counts()
        design = _COUNTED[kernel].design
        levels: list = []
        real = _spy_levels(levels)
        try:
            plain = run(replace(kern, use_pallas_aggregation=False), dev)
        finally:
            cx.quantize_int8, cx.topk_thresholds = real
        cpu = run(kern, "cpu")
        w_max = float(card[1].weights.max())
        allowance = {"levels": levels, "params_allowance": w_max * sum(levels),
                     "resid_allowance": sum(levels)}
        agree = {k: _private_agreement(*card, *other, allowance)
                 for k, other in (("plain", plain), ("cpu", cpu))}
        want = {**dict.fromkeys(_COUNTED, 0),
                **_attention_launches(gcfg, kern, 1), kernel: 1}
        out[label] = {"clients": len(groups), "kernel": kernel,
                      "design": design,
                      "launches": {k: v for k, v in launches.items() if v},
                      "round_loss": card[0].round_loss, "agreement": agree}
        print(f"  {label:10s} {len(groups)} clients, one replayed round: "
              f"{kernel} x{launches[kernel]} ({design}); "
              + "; ".join(f"vs {k}: loss rel {a['round_loss_rel']:.2e} "
                          f"eval {a['eval_abs']:.2e} params "
                          f"{a['params_max_abs']:.2e} (allowance "
                          f"{a['params_allowance']:.2e}) resid "
                          f"{a.get('ef_resid_max_abs', 0.0):.2e} coords>1e-4 "
                          f"{a['coords_beyond_1e-4']}"
                          for k, a in agree.items()))
        if launches != want:
            raise AssertionError(f"{label} at {len(groups)} clients: "
                                 f"launches {launches}, want {want}")
        if design != design_want:
            raise AssertionError(f"{label} at {len(groups)} clients ran "
                                 f"{kernel}'s {design} design, want "
                                 f"{design_want}")
        for k, a in agree.items():
            if not _private_within(a):
                raise AssertionError(f"{label} at {len(groups)} clients: the "
                                     f"kernel run is off the {k} run "
                                     f"(tolerance {TRAIN_TOL} plus the level "
                                     f"allowance)")
    return out


def _stage_cfg(base: FedConfig, label: str) -> FedConfig:
    spec = STAGE_RUNS[label]
    return replace(
        base, agg=AggConfig(**spec.get("agg", {})),
        adversary=AdversaryConfig(**spec.get("adversary", {})),
        avail=AvailabilityConfig(**spec.get("avail", {})),
        hierarchy=HierarchyConfig(**spec.get("hierarchy", {})),
        compression=CompressionConfig(**spec.get("compression", {})))


def _stage_launches(label: str) -> dict:
    """The aggregation kernel launches of a phase 4f run: one a round
    (one an edge under the hierarchy); under faults one FedAvg reduce a
    round, a round that absorbed no row too (the masked body), none for
    median's masked reduce (plain torch, as in the reference), none for
    the codec (the fault round releases per row in plain torch)."""
    kernel, per_round = STAGE_KERNEL[label]
    if kernel is None:
        return {}
    return {kernel: per_round * STAGE_ROUNDS}


def _stage_draws(fcfg: FedConfig, c: int, p: int, rounds: int) -> tuple:
    """Attacker masks and gaussian noise, and fault draws, made once on
    the CPU from a seed, as numpy, for a card run and a CPU run to replay
    (``attack_draws=``, ``fault_draws=``). None for a stage that is
    off."""
    g = _gen(SEED + 13)
    adv, attack, faults = fcfg.adversary, None, None
    if adv.enabled:
        attack = {r: (byz.attacker_mask(byz.attacker_draws(g, c),
                                        adv.num_attackers).numpy(),
                      torch.randn((c, p), generator=g).numpy()
                      if adv.kind == "gaussian" else None)
                  for r in range(rounds)}
    if fcfg.avail.enabled:
        faults = {r: tuple(a.numpy() for a in av.fault_draws(
            g, c, fcfg.avail)) for r in range(rounds)}
    return attack, faults


def _spy_schedules(seen: list):
    """Record each fault round's (stragglers buffered, arrivals landed).
    Returns the original to put back."""
    real = av.round_schedule

    def spy(draws, state):
        sched = real(draws, state)
        seen.append((int(sched.straggle.sum()), int(sched.arrive.sum())))
        return sched

    av.round_schedule = spy
    return real


def _zero_survivor_check(dev, data, tr, ev, base) -> dict:
    """A faulted fedavgm run whose first round releases every client and
    whose second has every client offline, under each engine: the second
    leaves params and server state (momentum, step) bit for bit, and its
    survivors are [0]. The fault round is one masked body, so the second
    round still launches its one FedAvg reduce, whose result the
    zero-survivor gate discards (the reference's traced round computes
    it too): counted by the wrapper under "loop", by name in a profile
    under "scan" (the graph, captured in the first run, replays)."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    c = len(tr)
    kern = replace(base, agg=AggConfig(name="fedavgm"),
                   avail=AvailabilityConfig(online_prob=0.5))
    phase = {"offline": False}

    def draws(r):
        online = not phase["offline"]
        return [online] * c, [False] * c, [False] * c, [1] * c

    out = {}
    for engine in ("loop", "scan"):
        phase["offline"] = False
        fed = FederatedGPO(gcfg, kern, data, tr, ev, device=dev,
                           fault_draws=draws)
        first = fed.run(rounds=1, engine=engine)
        before = [t.clone() for t in tree_leaves(fed.global_params)
                  + tree_leaves(fed.server_state)]
        phase["offline"] = True
        _zero_counts()
        if engine == "loop":
            second = fed.run(rounds=1, engine=engine)
            torch.cuda.synchronize()
            reduces = _counts()["fedavg_reduce"]
        else:
            held = []
            prof = _profile(lambda: held.append(fed.run(rounds=1,
                                                        engine=engine)),
                            "zero_survivor_trace.json",
                            match=KERNEL_NAMES["fedavg_reduce"])
            second = held[0]
            if _counts()["fedavg_reduce"] != 0 \
                    or fed.captured_round.replays != 2:
                raise AssertionError("the zero-survivor round did not "
                                     "replay the first run's graph")
            reduces = sum(prof["matched"][n]["launches"]
                          for n in KERNEL_NAMES["fedavg_reduce"])
        after = tree_leaves(fed.global_params) + tree_leaves(
            fed.server_state)
        same = len(before) == len(after) and all(
            torch.equal(a, b) for a, b in zip(before, after))
        rec = {"survivors": [first.round_survivors, second.round_survivors],
               "bit_equal": same, "fedavg_reduce": reduces,
               "server_step": int(fed.server_state.step)}
        print(f"  zero-survivor round ({engine}): survivors "
              f"{rec['survivors']}, params and server state bit-equal "
              f"{same}, fedavg_reduce x{reduces} (the masked body's one, "
              f"discarded), server step {rec['server_step']}")
        if not (same and first.round_survivors == [c]
                and second.round_survivors == [0]
                and reduces == 1 and rec["server_step"] == 1):
            raise AssertionError(f"the zero-survivor round ({engine}) was "
                                 f"not a no-op: {rec}")
        out[engine] = rec
    return out


def train_stages(dev, data, tr, ev) -> dict:
    """Phase 4f: the round's adversary, availability and hierarchy stages,
    each configuration of ``STAGE_RUNS`` for 3 rounds through the kernels
    (launch counts asserted), against the same run with the aggregation's
    plain versions on the card (the same generators draw the schedules
    and the noise); ``STAGE_CPU`` also as a card run and a CPU run that
    replay attacker masks, fault draws and noise made once on the CPU
    (the hooks); a zero-survivor round; one attacked and one faulted
    round under the profiler. Held as ``train_private`` holds its runs:
    ``_private_within``, with a level allowance only for the codec."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    base = FedConfig(num_clients=len(tr), local_epochs=6, lr=3e-4,
                     eval_every=1, use_pallas_attention=True,
                     use_pallas_aggregation=True)
    c = len(tr)
    p = tree_count_params(init_gpo_params(gcfg, _gen(0), device="cpu"))
    out, schedules = {}, {}
    for label in STAGE_RUNS:
        kern = _stage_cfg(base, label)
        plain = replace(kern, use_pallas_aggregation=False)
        seen: list = []
        real = _spy_schedules(seen)
        try:
            fed = FederatedGPO(gcfg, kern, data, tr, ev, device=dev)
            _zero_counts()
            t0 = time.perf_counter()
            hist = fed.run(rounds=STAGE_ROUNDS, engine="loop")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
        finally:
            av.round_schedule = real
        levels: list = []
        real_levels = _spy_levels(levels)
        try:
            t0 = time.perf_counter()
            den = FederatedGPO(gcfg, plain, data, tr, ev, device=dev)
            den_hist = den.run(rounds=STAGE_ROUNDS, engine="loop")
            torch.cuda.synchronize()
            den_wall = time.perf_counter() - t0
        finally:
            cx.quantize_int8, cx.topk_thresholds = real_levels
        w_max = float(fed.weights.max())
        allowance = {"levels": levels, "params_allowance": w_max * sum(levels),
                     "resid_allowance": sum(levels)}
        agree = {"plain": _private_agreement(hist, fed, den_hist, den,
                                             allowance)}
        if label in STAGE_CPU:
            attack, faults = _stage_draws(kern, c, p, STAGE_ROUNDS)
            runs = []
            for d in (dev, "cpu"):
                f = FederatedGPO(
                    gcfg, kern, data, tr, ev, device=d,
                    attack_draws=None if attack is None
                    else attack.__getitem__,
                    fault_draws=None if faults is None
                    else faults.__getitem__)
                runs.append((f.run(rounds=STAGE_ROUNDS, engine="loop"), f))
            agree["cpu"] = _private_agreement(*runs[0], *runs[1], allowance)
            if runs[0][0].round_survivors != runs[1][0].round_survivors:
                raise AssertionError(f"{label}: survivors differ from the "
                                     f"CPU run's")
        want = {**dict.fromkeys(_COUNTED, 0),
                **_attention_launches(gcfg, kern, STAGE_ROUNDS),
                **_stage_launches(label)}
        rec = {"config": STAGE_RUNS[label],
               "kernel": STAGE_KERNEL[label][0],
               "launches": {k: v for k, v in launches.items() if v},
               "wall_ms_per_round": wall / STAGE_ROUNDS * 1e3,
               "plain_wall_ms_per_round": den_wall / STAGE_ROUNDS * 1e3,
               "round_loss": hist.round_loss,
               "eval_mean_as": hist.eval_mean_as,
               "survivors": hist.round_survivors, "agreement": agree}
        if seen:
            rec["stragglers_arrivals"] = seen
            schedules[label] = seen
        out[label] = rec
        kernel = STAGE_KERNEL[label][0]
        print(f"  {label:26s} {wall / STAGE_ROUNDS * 1e3:8.2f} ms/round "
              f"(plain aggregation {den_wall / STAGE_ROUNDS * 1e3:8.2f}); "
              f"{kernel or 'no aggregation kernel'} "
              f"x{launches.get(kernel, 0) if kernel else 0}; survivors "
              f"{hist.round_survivors}; "
              + (f"(stragglers, arrivals) {seen}; " if seen else "")
              + "; ".join(f"vs {k}: loss rel {a['round_loss_rel']:.2e} "
                          f"eval {a['eval_abs']:.2e} params "
                          f"{a['params_max_abs']:.2e} (allowance "
                          f"{a['params_allowance']:.2e}) coords>1e-4 "
                          f"{a['coords_beyond_1e-4']}"
                          for k, a in agree.items())
              + f"; loss {np.round(hist.round_loss, 5).tolist()}")
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, want "
                                 f"{want}")
        if hist.round_survivors != den_hist.round_survivors:
            raise AssertionError(f"{label}: survivors differ from the plain "
                                 f"run's")
        for k, a in agree.items():
            if not _private_within(a):
                raise AssertionError(f"{label}: the kernel run is off the "
                                     f"{k} run (tolerance {TRAIN_TOL} plus "
                                     f"the level allowance)")
        if not all(np.isfinite(hist.round_loss)):
            raise AssertionError(f"{label}: a round loss is not finite")
    if not any(s > 0 and a > 0 for seen in schedules.values()
               for s, a in seen):
        raise AssertionError(f"no fault round both buffered and landed a "
                             f"straggler: {schedules}")
    out["zero_survivor"] = _zero_survivor_check(dev, data, tr, ev, base)
    # where an attacked and a faulted round's time goes
    for label in STAGE_PROFILED:
        fed = FederatedGPO(gcfg, _stage_cfg(base, label), data, tr, ev,
                           device=dev)
        fed.run(rounds=1, engine="loop")
        prof = _profile(lambda: fed.run(rounds=1, engine="loop"),
                        f"stages_{label}_trace.json",
                        match=("gram_", "fedavg_reduce", "sort"))
        out[label]["profile_round"] = prof
        print(f"  {label}: one round under the profiler: wall "
              f"{prof['wall_ms']:.3f}ms, {prof['kernels']} kernels, device "
              f"busy {prof['kernel_ms']:.3f}ms "
              f"({100 * prof['busy_share']:.2f}%); by name: "
              + ", ".join(f"{m} {v['ms']:.4f}ms x{v['launches']}"
                          for m, v in prof["matched"].items()))
    return out


def _shard_cfg(label: str, c: int) -> FedConfig:
    spec = {**SHARD_RUNS, **SHARD_EDGE}[label]
    base = FedConfig(num_clients=c, local_epochs=6, lr=3e-4,
                     eval_every=SHARD_ROUNDS,
                     use_pallas_attention=not spec.get("plain"),
                     use_pallas_aggregation=not spec.get("plain"))
    return replace(
        base, agg=AggConfig(**spec.get("agg", {})),
        privacy=PrivacyConfig(**spec.get("privacy", {})),
        compression=CompressionConfig(**spec.get("compression", {})),
        adversary=AdversaryConfig(**spec.get("adversary", {})),
        avail=AvailabilityConfig(**spec.get("avail", {})),
        hierarchy=HierarchyConfig(**spec.get("hierarchy", {})))


def _shard_launches(label: str, gcfg, fcfg, survivors: list) -> dict:
    """One process's launches in a phase 4g run: the attention kernels
    once a layer and local epoch (no eval), at BH (C/W)·heads, and
    ``SHARD_KERNEL``'s once a round (under faults once a round that
    absorbed a row)."""
    steps = (gcfg.num_layers * fcfg.local_epochs * SHARD_ROUNDS
             if fcfg.use_pallas_attention else 0)
    want = {**dict.fromkeys(_COUNTED, 0), "gpo_attention_fwd": steps,
            "gpo_attention_bwd_dq": steps, "gpo_attention_bwd_dkdv": steps}
    kernel = SHARD_KERNEL[label]
    if kernel:
        want[kernel] = (sum(1 for n in survivors if n > 0)
                        if fcfg.avail.enabled else SHARD_ROUNDS)
    return want


def _digest(params) -> str:
    return hashlib.sha256(torch.cat([t.reshape(-1) for t in tree_leaves(
        params)]).cpu().numpy().tobytes()).hexdigest()[:16]


def _shard_rank(rank, device, data, tr, labels, edges):
    """One process of a phase 4g group: each configuration of ``labels``
    for SHARD_ROUNDS rounds through the kernels on this process's
    clients. Returns per configuration its launches, its walls (the run
    per round; each round's ``round_fn`` call, synchronized), each
    round's params digest, its collective ledger and its final state on
    the CPU."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    world = torch.distributed.get_world_size()
    # the host's cores shared out: each process's own intra-op pool the
    # size of the machine would oversubscribe them world times
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = (make_edge_mesh(edges, world // edges, device=device)
            if edges > 1 else make_host_mesh(device=device))
    # one round of the first configuration, not recorded: the process's
    # first kernel loads, cuBLAS handles and first collective (NCCL's
    # communicator) would otherwise land in the first run's walls
    ShardedGPO(gcfg, _shard_cfg(labels[0], len(tr)), data, tr, mesh).run(1)
    out = {}
    for label in labels:
        fcfg = _shard_cfg(label, len(tr))
        run = ShardedGPO(gcfg, fcfg, data, tr, mesh)
        real, walls, digests = run._round_fn, [], []

        def timed(*a, real=real, walls=walls, digests=digests, **k):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            res = real(*a, **k)
            torch.cuda.synchronize(device)
            walls.append((time.perf_counter() - t0) * 1e3)
            digests.append(_digest(res.params))
            return res

        run._round_fn = timed
        _zero_counts()
        t0 = time.perf_counter()
        hist = run.run(SHARD_ROUNDS)
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) / SHARD_ROUNDS * 1e3
        launches = _counts()
        fault = run.fault_state
        out[label] = {
            "device": str(device), "backend": mesh.backend,
            "rows": [run.rows.start, run.rows.stop],
            "launches": launches, "wall_ms_per_round": wall,
            "round_fn_ms": walls, "digests": digests,
            "ledger": [tuple(c) for c in run.comm.ledger],
            "survivors": hist.round_survivors, "eps": hist.round_eps,
            "losses": [x.tolist() for x in hist.client_losses],
            "params": [t.cpu() for t in tree_leaves(run.global_params)],
            "server": [t.cpu() for t in tree_leaves(run.server_state)],
            "resid": None if run.ef_resid is None else run.ef_resid.cpu(),
            "pending": None if fault is None else fault.pending.cpu()}
    return out


def _shard_stacked(dev, data, tr, ev, labels) -> dict:
    """The stacked card runs phase 4g holds its processes to: each
    configuration from the same seed, its final state on the CPU, its
    History and, under a codec, its level a round (``_spy_levels`` on
    the same run with the aggregation's plain versions, as phase 4f)."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    out = {}
    for label in labels:
        fcfg = _shard_cfg(label, len(tr))
        fed = FederatedGPO(gcfg, fcfg, data, tr, ev, device=dev)
        t0 = time.perf_counter()
        hist = fed.run(rounds=SHARD_ROUNDS, engine="loop")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / SHARD_ROUNDS * 1e3
        levels: list = []
        if fcfg.compression.enabled:
            real = _spy_levels(levels)
            try:
                FederatedGPO(gcfg, replace(fcfg, use_pallas_aggregation=False),
                             data, tr, ev, device=dev).run(SHARD_ROUNDS,
                                                     engine="loop")
            finally:
                cx.quantize_int8, cx.topk_thresholds = real
        torch.cuda.synchronize()
        fault = fed.fault_state
        out[label] = {
            "hist": hist, "levels": levels, "wall_ms_per_round": wall,
            "w_max": float(fed.weights.max()),
            "params": [t.cpu() for t in tree_leaves(fed.global_params)],
            "server": [t.cpu() for t in tree_leaves(fed.server_state)],
            "resid": None if fed.ef_resid is None else fed.ef_resid.cpu(),
            "pending": None if fault is None else fault.pending.cpu()}
    return out


def _shard_check(part: str, label: str, ranks: list, want: dict,
                 gcfg, c: int, bit: bool, dev) -> dict:
    """A phase 4g run against its stacked card run: every process's
    digest equal each round, its launches as ``_shard_launches``
    predicts, survivors and ε equal, and the state bit for bit
    (``bit``) or within TRAIN_TOL's 1e-4 (``_private_within``, with the
    codec's level allowance a round: the int8 scale or top-k threshold
    of the stacked run; with int8 at two edges also the cross-edge
    candidates' own rounding). Returns the record it prints."""
    first, fcfg = ranks[0][label], _shard_cfg(label, c)
    if any(r[label]["digests"] != first["digests"] for r in ranks):
        raise AssertionError(f"4g {part} {label}: the processes' params "
                             f"differ: {[r[label]['digests'] for r in ranks]}")
    hist = want["hist"]
    predicted = _shard_launches(label, gcfg, fcfg, hist.round_survivors)
    for r in ranks:
        if r[label]["launches"] != predicted:
            raise AssertionError(f"4g {part} {label}: launches "
                                 f"{r[label]['launches']}, want {predicted}")
    if first["survivors"] != hist.round_survivors or \
            first["eps"] != hist.round_eps:
        raise AssertionError(f"4g {part} {label}: survivors or eps differ "
                             f"from the stacked run's")
    got = {"params": first["params"], "server": first["server"]}
    for key in ("resid", "pending"):
        if want[key] is not None:
            got[key] = torch.cat([r[label][key] for r in ranks])
    diffs = {k: [(a - b).abs() for a, b in zip(
        got[k] if isinstance(got[k], list) else [got[k]],
        want[k] if isinstance(want[k], list) else [want[k]])]
        for k in got}
    rec = {k: max(d.max().item() for d in v) for k, v in diffs.items()}
    # each round's mean over the C clients, taken as the stacked round
    # takes it (a (C,) float32 mean on the card)
    losses = np.asarray([float(torch.tensor(sum(
        (r[label]["losses"][i] for r in ranks), []), device=dev).mean())
        for i in range(SHARD_ROUNDS)])
    rec["round_loss_rel"] = (0.0 if fcfg.avail.enabled else float(np.max(
        np.abs(losses - hist.round_loss) / np.abs(hist.round_loss))))
    if bit:
        if any(v != 0.0 for k, v in rec.items()):
            raise AssertionError(f"4g {part} {label}: not bit-equal to the "
                                 f"stacked run: {rec}")
        return rec
    level = sum(want["levels"])
    a = {"round_loss_rel": rec["round_loss_rel"], "eval_abs": 0.0,
         "params_max_abs": max(rec["params"], rec["server"]),
         "coords_beyond_1e-4": int(sum((d > 1e-4).sum().item()
                                       for v in diffs.values() for d in v)),
         # int8 at two edges: the cross-edge candidates' own rounding
         # (half a level a round at most) and the later rounds' training
         # from the params it moved (PR 24's first card run: 3.88e-5
         # against one level a round, 4.04e-5)
         "params_allowance": (2 * level if label == "hier-int8-median"
                              else want["w_max"] * level),
         "resid_allowance": level}
    if "resid" in rec:
        a["ef_resid_max_abs"] = rec["resid"]
    if "pending" in rec:
        a["ef_resid_max_abs"] = max(a.get("ef_resid_max_abs", 0.0),
                                    rec["pending"])
    if label == "hier-int8-median":  # later rounds train apart (4g doc)
        a["round_loss_rel"] = 0.0
    rec.update(a)
    if not _private_within(a):
        raise AssertionError(f"4g {part} {label}: off the stacked card run "
                             f"(tolerance {TRAIN_TOL} plus the level "
                             f"allowance): {rec}")
    return rec


def _shard_part(part: str, world: int, backend: str, device, data, tr,
                labels, edges: int, stacked: dict, bit: bool, dev) -> dict:
    """One spawned group of phase 4g: every configuration of ``labels``
    on ``world`` processes; prints and returns each one's record."""
    t0 = time.perf_counter()
    ranks = spawn(world, _shard_rank, data, tr, labels, edges,
                  backend=backend, device=device, timeout=300, deadline=600)
    span = time.perf_counter() - t0
    out = {"world": world, "backend": backend,
           "devices": [r[labels[0]]["device"] for r in ranks],
           "spawn_s": span, "runs": {}}
    print(f"  ({part}) {world} process(es), backend {backend}, devices "
          f"{out['devices']}, {span:.1f}s for the group")
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    for label in labels:
        agree = _shard_check(part, label, ranks, stacked[label], gcfg,
                             len(tr), bit, dev)
        per_rank = [r[label] for r in ranks]
        rec = {
            "launches": [{k: v for k, v in r["launches"].items() if v}
                         for r in per_rank],
            "wall_ms_per_round": [r["wall_ms_per_round"] for r in per_rank],
            "stacked_wall_ms_per_round": stacked[label]["wall_ms_per_round"],
            "round_fn_ms": [r["round_fn_ms"] for r in per_rank],
            "collective_ms": [sum(c[3] for c in r["ledger"])
                              for r in per_rank],
            "collectives": [[c[0], list(c[1]), c[2], c[4]]
                            for c in per_rank[0]["ledger"]],
            "collective_bytes": sum(c[2] for c in per_rank[0]["ledger"]),
            "staged": any(c[4] for c in per_rank[0]["ledger"]),
            "survivors": per_rank[0]["survivors"], "agreement": agree}
        out["runs"][label] = rec
        kernel = SHARD_KERNEL[label]
        print(f"  ({part}) {label:26s} wall/round "
              + " ".join(f"{w:8.2f}" for w in rec["wall_ms_per_round"])
              + f" ms (stacked {rec['stacked_wall_ms_per_round']:8.2f}); "
              "collectives "
              + " ".join(f"{m:7.2f}" for m in rec["collective_ms"])
              + f" ms, {rec['collective_bytes']} B a process in "
              f"{len(rec['collectives'])} calls"
              + (" (staged through the host)" if rec["staged"] else "")
              + f"; {kernel or 'no aggregation kernel'} "
              f"x{[r['launches'].get(kernel, 0) if kernel else 0 for r in per_rank]}"
              f", attention fwd x"
              f"{[r['launches']['gpo_attention_fwd'] for r in per_rank]}; "
              + ("bit-equal" if bit else
                 f"params {agree['params_max_abs']:.2e} (allowance "
                 f"{agree['params_allowance']:.2e}) loss rel "
                 f"{agree['round_loss_rel']:.2e}"))
    return out


def train_sharded(dev, data, tr, ev) -> dict:
    """Phase 4g: the sharded round on processes (see SHARD_ROUNDS):
    (a) one NCCL process, bit for bit; (b) two processes, every
    configuration of SHARD_RUNS; (c) four processes on
    ``make_edge_mesh(2, 2)``. The parent built the kernels already; the
    processes load them from build/."""
    cards = torch.cuda.device_count()
    torch.cuda.empty_cache()
    stacked = _shard_stacked(dev, data, tr, ev, list(SHARD_RUNS))
    tr8 = tr[:SHARD_EDGE_CLIENTS]
    stacked_edge = _shard_stacked(dev, data, tr8, ev, list(SHARD_EDGE))
    out = {"a": _shard_part("a", 1, "nccl", "cuda:0", data, tr,
                            list(SHARD_ONE), 1, stacked, True, dev)}
    # NCCL refuses two processes on one device: gloo over CUDA tensors
    # (staged through the host) where there is one card
    two = ("nccl", ["cuda:0", "cuda:1"]) if cards >= 2 else ("gloo",
                                                             "cuda:0")
    out["b"] = _shard_part("b", 2, *two, data, tr, list(SHARD_RUNS), 1,
                           stacked, False, dev)
    four = ("nccl", [f"cuda:{i}" for i in range(4)]) if cards >= 4 \
        else ("gloo", "cuda:0")
    out["c"] = _shard_part("c", 4, *four, data, tr8, list(SHARD_EDGE), 2,
                           stacked_edge, False, dev)
    return out


def _evals(rounds: int, every: int) -> int:
    """Evaluations in ``rounds``: every ``every``-th round and the last."""
    return len(set(range(0, rounds, every)) | {rounds - 1})


def _first_rounds_agree(hist, cpu) -> dict:
    """The kernel run's first rounds (epochs) against a shorter CPU run
    of the same trainer: their round losses (relative) and the round-0
    eval (AS / FI / CoV and each group's score, absolute)."""
    n = len(cpu.round_loss)
    loss = np.abs(np.asarray(hist.round_loss[:n]) - cpu.round_loss) / \
        np.abs(cpu.round_loss)
    ev = max([abs(getattr(hist, k)[0] - getattr(cpu, k)[0])
              for k in ("eval_mean_as", "eval_fi", "eval_cov")]
             + [float(np.abs(np.asarray(hist.eval_scores[0])
                             - cpu.eval_scores[0]).max())])
    return {"rounds": n, "round_loss_rel": float(loss.max()),
            "eval0_abs": float(ev)}


def experiment(dev) -> dict:
    """Phase 4e: the paper's experiment through the port's
    ``benchmarks/paper_experiment.py`` at the reference's widths and
    FedConfig (17 groups, 10 clients, d_model 96, head_dim 24, 6 local
    epochs), through the kernels: the launch counts of every federated
    round and centralized epoch, the first rounds against the CPU, the
    falling loss, ``summarize``, the wall per round and epoch; then
    partial participation, once with per-round optimizer resets, against
    the CPU with the same cohorts."""
    fed, cen = make_pair(EXP_ROUNDS, SEED, device=dev)
    gcfg, fcfg = fed.gpo_cfg, fed.fed_cfg
    layers, epochs, clients = (gcfg.num_layers, fcfg.local_epochs,
                               len(fed.train_groups))
    evals = _evals(EXP_ROUNDS, fcfg.eval_every)
    zero = dict.fromkeys(_COUNTED, 0)

    def want(steps_per_round: int, reduces: int) -> dict:
        steps = layers * steps_per_round * EXP_ROUNDS
        return {**zero, "gpo_attention_fwd": steps + layers * evals,
                "gpo_attention_bwd_dq": steps,
                "gpo_attention_bwd_dkdv": steps, "fedavg_reduce": reduces}

    runs = {}
    for label, trainer, kw, expected in (
            ("fed", fed, {"rounds": EXP_ROUNDS, "engine": "loop"},
             want(epochs, EXP_ROUNDS)),
            ("cen", cen, {"epochs": EXP_ROUNDS, "engine": "loop"},
             want(clients, 0))):
        _zero_counts()
        t0 = time.perf_counter()
        hist = trainer.run(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        if launches != expected:
            raise AssertionError(f"{label} launches {launches}, want "
                                 f"{expected}")
        losses = np.asarray(hist.round_loss)
        first, last = float(losses[:3].mean()), float(losses[-5:].mean())
        ok = (np.isfinite(losses).all() and last < first
              and all(0.0 < a <= 1.0 for a in hist.eval_mean_as)
              and all(0.0 < f <= 1.0 for f in hist.eval_fi))
        unit = "round" if label == "fed" else "epoch"
        print(f"  {label}: {EXP_ROUNDS} {unit}s in {wall:.3f}s "
              f"({wall / EXP_ROUNDS * 1e3:.1f} ms per {unit}); launches "
              f"{({k: v for k, v in launches.items() if v})} ({evals} "
              f"evals); mean loss of the first 3 {first:.5f}, of the last "
              f"5 {last:.5f}; final AS {hist.eval_mean_as[-1]:.4f} FI "
              f"{hist.eval_fi[-1]:.4f}")
        if not ok:
            raise AssertionError(f"{label}: the loss did not fall, or a "
                                 "value is off its range")
        runs[label] = {"hist": hist, "wall_ms_per_" + unit:
                       wall / EXP_ROUNDS * 1e3, "launches": launches,
                       "loss_first3_mean": first, "loss_last5_mean": last}
    # where a round's and an epoch's time goes (a one-round run evaluates)
    for label, fn in (("fed", lambda: fed.run(rounds=1, engine="loop")),
                      ("cen", lambda: cen.run(epochs=1, engine="loop"))):
        prof = _profile(fn, f"experiment_{label}_trace.json")
        runs[label]["profile"] = prof
        print(f"  one {label} {'round' if label == 'fed' else 'epoch'} "
              f"under the profiler: wall {prof['wall_ms']:.3f}ms, "
              f"{prof['kernels']} kernels, device busy "
              f"{prof['kernel_ms']:.3f}ms ({100 * prof['busy_share']:.2f}%)")
    result = result_from_histories(runs["fed"]["hist"], runs["cen"]["hist"])
    summary = summarize([result])
    print(f"  summarize (1 seed, {EXP_ROUNDS} rounds): "
          + ", ".join(f"{k} {v:.4f}" for k, v in summary.items()))
    captured = _experiment_captured(dev, runs)

    # the first rounds and epochs against the same pair on the CPU (the
    # batches come from CPU generators on both devices)
    cpu_f, cpu_c = make_pair(EXP_CPU_ROUNDS, SEED, device="cpu")
    agree = {"fed": _first_rounds_agree(runs["fed"]["hist"],
                                        cpu_f.run(rounds=EXP_CPU_ROUNDS,
                                                  engine="loop")),
             "cen": _first_rounds_agree(runs["cen"]["hist"],
                                        cpu_c.run(epochs=EXP_CPU_ROUNDS,
                                                  engine="loop"))}
    for label, a in agree.items():
        print(f"  {label} vs the CPU over the first {a['rounds']}: "
              f"round_loss rel {a['round_loss_rel']:.3e} (tol "
              f"{TRAIN_TOL['round_loss_rtol']:g}); round-0 eval abs "
              f"{a['eval0_abs']:.3e} (tol {TRAIN_TOL['eval_atol']:g})")
        if not (a["round_loss_rel"] <= TRAIN_TOL["round_loss_rtol"]
                and a["eval0_abs"] <= TRAIN_TOL["eval_atol"]):
            raise AssertionError(f"the {label} kernel run is off the CPU")

    # partial participation: SUB_GROUPS of the 10 clients a round, the
    # cohort drawn from the CPU training generator on both devices
    sub = {}
    for reset in (False, True):
        settings = {**FED_SETTINGS, "eval_every": 1,
                    "batch_groups": SUB_GROUPS,
                    "reset_opt_each_round": reset}
        made = {d: make_pair(SUB_ROUNDS, SEED, device=d,
                             settings=settings)[0] for d in ("cpu", dev)}
        cpu_hist = made["cpu"].run(rounds=SUB_ROUNDS, engine="loop")
        _zero_counts()
        hist = made[dev].run(rounds=SUB_ROUNDS, engine="loop")
        launches = _counts()
        steps = layers * epochs * SUB_ROUNDS
        expected = {**zero, "gpo_attention_fwd": steps + layers * SUB_ROUNDS,
                    "gpo_attention_bwd_dq": steps,
                    "gpo_attention_bwd_dkdv": steps,
                    "fedavg_reduce": SUB_ROUNDS}
        a = _agreement(hist, made[dev].global_params, cpu_hist,
                       made["cpu"].global_params)
        label = "reset_opt" if reset else "subsampled"
        print(f"  {label} ({SUB_GROUPS} of {clients} a round): cohorts "
              f"{hist.round_participants} (CPU {cpu_hist.round_participants})"
              f"; launches {({k: v for k, v in launches.items() if v})}; vs "
              f"the CPU: round_loss rel {a['round_loss_rel']:.3e}, eval abs "
              f"{a['eval_abs']:.3e}, params max_abs "
              f"{a['params_max_abs']:.3e}")
        if launches != expected:
            raise AssertionError(f"{label} launches {launches}, want "
                                 f"{expected}")
        if (hist.round_participants != cpu_hist.round_participants
                or [len(set(c)) for c in hist.round_participants]
                != [SUB_GROUPS] * SUB_ROUNDS):
            raise AssertionError(f"{label}: the cohorts differ from the "
                                 "CPU's, or are not of SUB_GROUPS clients")
        if not _within(a):
            raise AssertionError(f"the {label} kernel run is off the CPU")
        sub[label] = {"participants": hist.round_participants,
                      "launches": launches, "agreement": a}

    return {"config": {"clients": clients, "eval_groups":
                       len(fed.eval_groups), "d_model": gcfg.d_model,
                       "layers": layers, "heads": gcfg.num_heads,
                       "head_dim": gcfg.d_model // gcfg.num_heads,
                       "d_ff": gcfg.d_ff, "d_embed": gcfg.d_embed,
                       "params": tree_count_params(fed.global_params),
                       **FED_SETTINGS},
            "rounds": EXP_ROUNDS, "evals": evals,
            **{label: {k: v for k, v in r.items() if k != "hist"}
               for label, r in runs.items()},
            "summary": summary, "cpu_agreement": agree,
            "captured": captured, "tolerance": TRAIN_TOL, "partial": sub}


def _history_values(hist) -> list:
    """A History's losses, eval rounds and scores, compared exactly."""
    return [list(hist.round_loss), list(hist.eval_rounds),
            [np.asarray(x).tolist() for x in hist.eval_scores],
            list(hist.eval_mean_as), list(hist.eval_fi)]


def _experiment_captured(dev, runs: dict) -> dict:
    """The pair from the same seed under the default engine ("scan"):
    both halves replayed from CUDA graphs, each History bit for bit the
    loop run's in ``runs``; the walls a round and an epoch (warm-up and
    capture included, and without them) beside the loop's."""
    fed, cen = make_pair(EXP_ROUNDS, SEED, device=dev)
    out = {}
    for label, trainer, unit in (("fed", fed, "round"),
                                 ("cen", cen, "epoch")):
        t0 = time.perf_counter()
        hist = trainer.run(EXP_ROUNDS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        graph = trainer.captured_round
        if graph is None or graph.replays != EXP_ROUNDS:
            raise AssertionError(f"the captured {label} run did not replay "
                                 f"its graph once a {unit}")
        if _history_values(hist) != _history_values(runs[label]["hist"]):
            raise AssertionError(f"the captured {label} run's History "
                                 "differs from the loop's")
        setup = graph.warmup_ms + graph.capture_ms
        loop = runs[label]["wall_ms_per_" + unit]
        out[label] = {"wall_ms_per_" + unit: wall / EXP_ROUNDS,
                      "after_capture_ms_per_" + unit:
                      (wall - setup) / EXP_ROUNDS,
                      "loop_ms_per_" + unit: loop,
                      "warmup_ms": graph.warmup_ms,
                      "capture_ms": graph.capture_ms,
                      "bit_equal_to_loop": True}
        print(f"  captured {label}: {wall / EXP_ROUNDS:.2f} ms per {unit} "
              f"({(wall - setup) / EXP_ROUNDS:.2f} past its warm-up "
              f"{graph.warmup_ms:.1f} and capture {graph.capture_ms:.1f} "
              f"ms), loop {loop:.2f}; History bit for bit the loop's")
    return out


def _captured_cfg(base: FedConfig, label: str) -> FedConfig:
    spec = CAPTURED[label]
    kernels = not spec.get("dense", False)
    return replace(
        base, use_pallas_attention=kernels, use_pallas_aggregation=kernels,
        batch_groups=spec.get("batch_groups", 0),
        reset_opt_each_round=spec.get("reset_opt_each_round", False),
        agg=AggConfig(**spec.get("agg", {})),
        privacy=PrivacyConfig(**spec.get("privacy", {})),
        compression=CompressionConfig(**spec.get("compression", {})),
        adversary=AdversaryConfig(**spec.get("adversary", {})),
        avail=AvailabilityConfig(**spec.get("avail", {})),
        hierarchy=HierarchyConfig(**spec.get("hierarchy", {})))


def _run_values(trainer, hist) -> tuple:
    """A run's History and the trainer's state (``FederatedGPO``'s or
    ``CentralizedGPO``'s, the fault state included) as flat float64
    arrays (compared exactly), and its eval rounds, cohorts and
    survivors."""
    vals = [np.asarray(hist.round_loss, np.float64),
            np.asarray(hist.eval_scores, np.float64).reshape(-1),
            np.asarray(hist.eval_mean_as + hist.eval_fi + hist.eval_cov
                       + hist.round_eps, np.float64)]
    for x in tree_leaves(trainer._state()):
        if x is not None:
            vals.append(x.detach().double().cpu().reshape(-1).numpy())
    return vals, (hist.eval_rounds, hist.round_participants,
                  hist.round_survivors)


def _captured_deviation(label: str, a, b) -> float:
    """The largest difference between two runs' values (``_run_values``):
    0.0 when they are equal bit for bit. Raises where the eval rounds or
    cohorts differ, or where the difference passes the configuration's
    bound in ``CAPTURED_BOUND`` (no bound: they must be equal)."""
    (va, ka), (vb, kb) = a, b
    if ka != kb or len(va) != len(vb) or any(
            x.shape != y.shape for x, y in zip(va, vb)):
        raise AssertionError(f"{label}: the captured run's eval rounds, "
                             "cohorts, survivors or shapes differ from "
                             "the loop's")
    bits = all(np.array_equal(x, y) for x, y in zip(va, vb))
    dev = 0.0 if bits else max(float(np.abs(x - y).max(initial=0.0))
                               for x, y in zip(va, vb))
    bound = CAPTURED_BOUND.get(label, (0.0,))[0]
    if not bits and not dev <= bound:
        raise AssertionError(f"{label}: the captured run is {dev:.3e} off "
                             f"the eager card run (bound {bound:g})")
    return dev


def _sync_free_round(make, dev) -> None:
    """One staged round (an epoch for ``CentralizedGPO``; the fault
    body under faults) and one eval, the device halves run eagerly on a
    fresh trainer under ``torch.cuda.set_sync_debug_mode("error")``: a
    call that synchronizes the host with the card raises, the gathers of
    the staged question indices included. The operands are staged on
    the card first."""
    trainer = make()
    s = trainer._streams(trainer.fed_cfg.seed + 1)
    ops = federated._on(trainer._stage(0, s, History()), dev)
    batch = federated._on(trainer._eval_host(0, s), dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss, *_ = trainer._round_body(trainer._state(), ops, s)
        trainer._eval_body(state.params, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.isfinite(loss).item():
        raise AssertionError("the sync-free round's loss is not finite")


def _captured_pair(label: str, make, rounds: int, prof_rounds: int) -> tuple:
    """Phase 4h for one configuration: two trainers from ``make()``, one
    an engine. ``rounds`` under each (the loop's launch counts; the
    captured run's warm-up and capture, whose wrapper calls are one
    round and one eval each), ``rounds`` more (the walls), each captured
    run held to the loop's (``_captured_deviation``); then
    ``prof_rounds`` captured under the profiler, whose kernels, counted
    by name (``KERNEL_NAMES``), must be the loop's (its counts a round
    and an eval) with no wrapper call, and as many under the loop, the
    two held to each other once more. Returns (record, the loop trainer,
    the captured one, each after the same rounds)."""
    loop, cap = make(), make()
    zero = dict.fromkeys(_COUNTED, 0)
    _zero_counts()
    t0 = time.perf_counter()
    hist_l = loop.run(rounds, engine="loop")
    torch.cuda.synchronize()
    first_loop = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    _zero_counts()
    t0 = time.perf_counter()
    hist_c = cap.run(rounds, engine="scan")
    torch.cuda.synchronize()
    first_cap = (time.perf_counter() - t0) * 1e3
    counted = _counts()
    graph = cap.captured_round
    # an eval launches the forward once a layer (through the kernel);
    # the rest is the rounds'
    n_eval = len(hist_l.eval_rounds)
    per_eval = {**zero, "gpo_attention_fwd": (
        loop.gpo_cfg.num_layers if loop.fed_cfg.use_pallas_attention
        else 0)}
    per_round = {k: (v - n_eval * per_eval[k]) / rounds
                 for k, v in launches.items()}
    want = {k: round(2 * (per_round[k] + per_eval[k])) for k in zero}
    if counted != want:
        raise AssertionError(f"{label}: the captured run's wrapper calls "
                             f"{counted}, want {want} (warm-up and capture)")
    if graph is None or (graph.replays, graph.eval_replays) != (
            rounds, len(hist_c.eval_rounds)):
        raise AssertionError(f"{label}: the graphs did not replay once a "
                             "round and once an eval round")
    dev_first = _captured_deviation(label, _run_values(cap, hist_c),
                                    _run_values(loop, hist_l))
    # the next rounds: the same graphs replay, the state copied in
    t0 = time.perf_counter()
    hist_l = loop.run(rounds, engine="loop")
    torch.cuda.synchronize()
    wall_loop = (time.perf_counter() - t0) * 1e3 / rounds
    host0 = (graph.draw_s, graph.stage_s, graph.replay_s)
    t0 = time.perf_counter()
    hist_c = cap.run(rounds, engine="scan")
    torch.cuda.synchronize()
    wall_cap = (time.perf_counter() - t0) * 1e3 / rounds
    if cap.captured_round is not graph:
        raise AssertionError(f"{label}: a block that fits was captured "
                             "again")
    draw, stage, replay = ((now - was) * 1e3 / rounds for now, was in zip(
        (graph.draw_s, graph.stage_s, graph.replay_s), host0))
    dev_more = _captured_deviation(label, _run_values(cap, hist_c),
                                   _run_values(loop, hist_l))
    # the replayed kernels, read from the profiler's trace by name
    _zero_counts()
    names = [n for ns in KERNEL_NAMES.values() for n in ns]
    held = []
    prof = _profile(lambda: held.append(cap.run(prof_rounds,
                                                engine="scan")),
                    f"captured_{label}_trace.json", match=names)
    if _counts() != zero:
        raise AssertionError(f"{label}: a replayed run called a wrapper")
    dev_prof = _captured_deviation(
        label, _run_values(cap, held[0]),
        _run_values(loop, loop.run(prof_rounds, engine="loop")))
    replayed = {k: sum(prof["matched"][n]["launches"] for n in ns)
                for k, ns in KERNEL_NAMES.items()}
    n_prof = _evals(prof_rounds, cap.fed_cfg.eval_every)
    expect = {k: round(prof_rounds * per_round[k] + n_prof * per_eval[k])
              for k in zero}
    if replayed != expect:
        raise AssertionError(f"{label}: the captured rounds' trace holds "
                             f"{replayed} of the kernels; the loop's "
                             f"counts give {expect}")
    rec = {"launches_loop": {k: v for k, v in launches.items() if v},
           "replayed_in_profile": {k: v for k, v in replayed.items() if v},
           "profile_rounds": prof_rounds,
           "wrapper_calls_warmup_and_capture": {
               k: v for k, v in counted.items() if v},
           "first_run_ms": {"loop": first_loop, "captured": first_cap},
           "warmup_ms": graph.warmup_ms, "capture_ms": graph.capture_ms,
           "staged_bytes": _staged_bytes(cap),
           "wall_ms_per_round": {"loop": wall_loop, "captured": wall_cap},
           "host_ms_per_round": {"draw": draw, "stage": stage,
                                 "replay_call": replay},
           "deviation": {"first": dev_first, "more": dev_more,
                         "profiled": dev_prof},
           "bit_equal": dev_first == dev_more == dev_prof == 0.0,
           "kernels_per_round": prof["kernels"] / prof_rounds,
           "profile": prof}
    print(f"  {label:18s} loop {wall_loop:8.2f} ms/round, captured "
          f"{wall_cap:7.2f} (host: draw {draw:.2f}, stage {stage:.2f}, "
          f"replay call {replay:.2f}); "
          f"first {rounds}: loop {first_loop:.1f} ms, captured "
          f"{first_cap:.1f} (warm-up {graph.warmup_ms:.1f}, capture "
          f"{graph.capture_ms:.1f}); "
          + ("bit-equal" if rec["bit_equal"] else
             f"off by {max(dev_first, dev_more, dev_prof):.3e}")
          + f"; profiled {prof['kernels'] / prof_rounds:.0f} kernels a "
          f"round, busy {100 * prof['busy_share']:.2f}%, replayed in "
          f"{prof_rounds} rounds {rec['replayed_in_profile']}")
    return rec, loop, cap


def check_multinomial() -> dict:
    """On this machine's torch: one 2-D ``torch.multinomial`` without
    replacement over n mask rows equals the n per-row calls stacked, and
    leaves the generator where they leave it (what ``sample_icl_indices``
    rests on), at ``SurveyConfig()``'s 120 questions and the paper's 24
    a draw, over 10 rows and over 60."""
    data = make_survey_data(SurveyConfig(), _gen(SEED))
    out = {}
    for n in (10, 60):
        rows = data.mask[torch.arange(n) % data.num_groups].float()
        g_rows, g_one = _gen(n), _gen(n)
        per_row = torch.stack([torch.multinomial(
            r, 24, replacement=False, generator=g_rows) for r in rows])
        batched = torch.multinomial(rows, 24, replacement=False,
                                    generator=g_one)
        out[str(n)] = (torch.equal(per_row, batched)
                       and torch.equal(g_rows.get_state(), g_one.get_state()))
    print(f"  the 2-D multinomial against the per-row calls (torch "
          f"{torch.__version__}): " + ", ".join(
              f"{n} rows {'equal' if ok else 'DIFFERENT'}"
              for n, ok in out.items()))
    if not all(out.values()):
        raise AssertionError("the 2-D multinomial differs from the per-row "
                             "calls on this machine's torch")
    return out


def _staged_bytes(trainer) -> dict:
    """The bytes a refill copies to the card a round (an epoch for
    ``CentralizedGPO``) and an eval: as staged (question indices), and
    as the whole gathered batches the host staged before (E client-
    stacked batches a round, G a-group batches an epoch), each laid out
    as ``_PinnedOperands`` lays it (16-byte aligned)."""
    s = trainer._streams(trainer.fed_cfg.seed + 1)
    ops, ev = trainer._stage(0, s, History()), trainer._eval_host(0, s)

    def whole(x):
        if isinstance(x, federated.RoundOperands):
            return x._replace(batches=whole(x.batches))
        if not isinstance(x, ICLDraw):
            return x
        b = gather_icl_batch(trainer.data.phi, trainer.data.prefs, x.groups,
                             x.q, trainer.fed_cfg.num_context)
        return b if x.q.dim() == 2 else tuple(
            federated._batch_rows(b, e) for e in range(len(x.q)))

    def nbytes(tree) -> int:
        return federated._PinnedOperands(tree, torch.device("cpu")).nbytes

    return {"round": nbytes(ops), "eval": nbytes(ev),
            "round_whole": nbytes(whole(ops)), "eval_whole": nbytes(whole(ev))}


def _draw_parts(trainer, reps: int = DRAW_REPS) -> dict:
    """The host half's ICL draws of one round (epoch), by part, in ms on
    the host's clock (median of ``reps``). Before: one
    ``sample_icl_batch`` a group, as the host drew them until index
    staging (its multinomial, its four gathers, and for a round the
    stack of each epoch's batches), written out here with a clock
    around each part. After: one ``sample_icl_indices`` over every row
    (the gathers run on the card, inside the graph), and the whole host
    half (``_stage``: the cohort, the draw, the hooks) as it runs now."""
    fed, data = trainer.fed_cfg, trainer.data
    nc, nt, d = fed.num_context, fed.num_target, data.phi.shape[-1]
    rounds = isinstance(trainer, FederatedGPO)
    groups = (trainer.train_groups[:trainer.num_participants] if rounds
              else trainer.train_groups)
    epochs = fed.local_epochs if rounds else 1
    gen, s = _gen(SEED), trainer._streams(fed.seed + 1)
    times = {k: [] for k in ("multinomial", "gather", "stack", "indices",
                             "stage")}
    for _ in range(reps):
        mult = gath = stk = 0.0
        for _e in range(epochs):
            rows = []
            for g in (int(x) for x in groups):
                t0 = time.perf_counter()
                qs = torch.multinomial(data.mask[g].float(), nc + nt,
                                       replacement=False, generator=gen)
                t1 = time.perf_counter()
                ctx_q, tgt_q = qs[:nc], qs[nc:]
                rows.append((data.phi[ctx_q].reshape(-1, d),
                             data.prefs[g, ctx_q].reshape(-1),
                             data.phi[tgt_q].reshape(-1, d),
                             data.prefs[g, tgt_q].reshape(-1),
                             tgt_q.repeat_interleave(data.num_options)))
                t2 = time.perf_counter()
                mult, gath = mult + t1 - t0, gath + t2 - t1
            if rounds:
                t0 = time.perf_counter()
                [torch.stack(f) for f in zip(*rows)]
                stk += time.perf_counter() - t0
        t0 = time.perf_counter()
        sample_icl_indices(gen, data, np.tile(groups, epochs), nc, nt)
        t1 = time.perf_counter()
        trainer._stage(0, s, History())
        t2 = time.perf_counter()
        for k, v in (("multinomial", mult), ("gather", gath), ("stack", stk),
                     ("indices", t1 - t0), ("stage", t2 - t1)):
            times[k].append(v * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    before = med["multinomial"] + med["gather"] + med["stack"]
    return {"rows": len(groups) * epochs,
            "before_ms": {"multinomial": med["multinomial"],
                          "gather": med["gather"], "stack": med["stack"],
                          "total": before},
            "after_ms": {"indices": med["indices"], "stage": med["stage"]}}


def _cen_maker(label: str, dev, data, tr, ev, base: FedConfig):
    """``make()`` for phase 4h's centralized configuration ``label``
    (``CAPTURED_CEN``): the quickstart's (``base``, GPOConfig() width) or
    the paper experiment's trainer, through the kernels or dense."""
    kernels = not label.endswith("-dense")
    if label.startswith("quickstart"):
        gcfg, fcfg = GPOConfig(d_embed=data.phi.shape[-1]), base
        args = (data, tr, ev)
    else:
        cen = make_pair(CAPTURED_PAPER_ROUNDS, SEED, device="cpu")[1]
        gcfg, fcfg = cen.gpo_cfg, cen.fed_cfg
        args = (cen.data, cen.train_groups, cen.eval_groups)
    fcfg = replace(fcfg, use_pallas_attention=kernels,
                   use_pallas_aggregation=kernels)

    def make():
        return CentralizedGPO(gcfg, fcfg, *args, device=dev)

    return make


def train_captured(dev, data, tr, ev) -> dict:
    """Phase 4h: ``engine="scan"`` on the card, the round replayed from
    a CUDA graph, against the eager card run (``engine="loop"``) from
    the same seed, for every configuration of ``CAPTURED``; FedAvg's
    longer blocks; the paper experiment's configuration; the centralized
    epoch replayed from a CUDA graph in the configurations of
    ``CAPTURED_CEN``; one staged round or epoch of each under the sync
    debug mode; the host's draws by part before and after index staging;
    and the 2-D multinomial against the per-row calls."""
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    base = FedConfig(num_clients=len(tr), local_epochs=6, lr=3e-4,
                     eval_every=1, use_pallas_attention=True,
                     use_pallas_aggregation=True)
    multinomial = check_multinomial()
    out = {}
    for label in CAPTURED:
        cfg = _captured_cfg(base, label)

        def make(cfg=cfg):
            return FederatedGPO(gcfg, cfg, data, tr, ev, device=dev)

        _sync_free_round(make, dev)
        rec, loop, cap = _captured_pair(label, make, CAPTURED_ROUNDS,
                                        CAPTURED_ROUNDS)
        if label == "fedavg":  # blocks longer than the first run's
            first = cap.captured_round
            replays = first.replays
            t0 = time.perf_counter()
            more_l = loop.run(rounds=CAPTURED_MORE, log_every=5,
                              engine="loop")
            t1 = time.perf_counter()
            more_c = cap.run(rounds=CAPTURED_MORE, log_every=5)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if cap.captured_round is not first \
                    or first.replays - replays != CAPTURED_MORE:
                raise AssertionError("fedavg: the 5-round blocks did not "
                                     "replay the first capture once a "
                                     "round")
            last = float(np.mean(more_c.round_loss[-5:]))
            if not last < float(np.mean(more_c.round_loss[:5])):
                raise AssertionError("fedavg: the captured loss did not "
                                     "fall")
            rec["more"] = {
                "rounds": CAPTURED_MORE, "log_every": 5,
                "wall_ms_per_round": {
                    "loop": (t1 - t0) * 1e3 / CAPTURED_MORE,
                    "captured": (t2 - t1) * 1e3 / CAPTURED_MORE},
                "deviation": _captured_deviation(
                    label, _run_values(cap, more_c),
                    _run_values(loop, more_l)),
                "loss_last5_mean": last}
            walls = rec["more"]["wall_ms_per_round"]
            print(f"  fedavg, {CAPTURED_MORE} more rounds in blocks of 5: "
                  f"loop {walls['loop']:.2f} ms/round, captured "
                  f"{walls['captured']:.2f} (the same graphs); deviation "
                  f"{rec['more']['deviation']:.3e}")
        out[label] = rec

    # the paper experiment's configuration (phase 4e's trainer and its
    # FedConfig: eval every 10 rounds), 10 rounds profiled
    def make_paper():
        return make_pair(CAPTURED_PAPER_ROUNDS, SEED, device=dev)[0]

    _sync_free_round(make_paper, dev)
    out["paper"], _, _ = _captured_pair(
        "paper", make_paper, CAPTURED_PAPER_ROUNDS,
        min(10, CAPTURED_PAPER_ROUNDS))

    # the centralized epoch (an epoch is the baseline's round)
    for label in CAPTURED_CEN:
        make = _cen_maker(label, dev, data, tr, ev, base)
        _sync_free_round(make, dev)
        n = (CAPTURED_ROUNDS if label.startswith("quickstart")
             else CAPTURED_PAPER_ROUNDS)
        out["cen-" + label], _, _ = _captured_pair("cen-" + label, make, n,
                                                   min(10, n))

    # the host's ICL draws a round (epoch) by part, before and after
    parts = {}
    for label, make in (
            ("fedavg", lambda: FederatedGPO(gcfg, base, data, tr, ev,
                                            device=dev)),
            ("paper", make_paper),
            ("cen-quickstart", _cen_maker("quickstart", dev, data, tr, ev,
                                          base)),
            ("cen-paper", _cen_maker("paper", dev, data, tr, ev, base))):
        parts[label] = p = _draw_parts(make())
        b, a = p["before_ms"], p["after_ms"]
        staged = out[label]["staged_bytes"]
        print(f"  draws a {'epoch' if label.startswith('cen') else 'round'}"
              f" of {label} ({p['rows']} rows): before {b['total']:.3f} ms "
              f"(multinomial {b['multinomial']:.3f}, gather "
              f"{b['gather']:.3f}, stack {b['stack']:.3f}); after: one "
              f"multinomial {a['indices']:.3f}, the host half {a['stage']:.3f}"
              f"; staged {staged['round']} bytes (whole batches "
              f"{staged['round_whole']}), an eval {staged['eval']} "
              f"({staged['eval_whole']})")
    return {"rounds": CAPTURED_ROUNDS, "more_rounds": CAPTURED_MORE,
            "paper_rounds": CAPTURED_PAPER_ROUNDS, "bounds": CAPTURED_BOUND,
            "centralized": list(CAPTURED_CEN), "multinomial": multinomial,
            "draw_parts": parts, "runs": out}


def _lm_cfg(arch: str, **kw) -> ModelConfig:
    layers = LM_ARCHS[arch][1]
    if layers is not None:
        kw.setdefault("num_layers", layers)
    return override(get_arch(arch), **kw) if kw else get_arch(arch)


def _lm_launches(cfg: ModelConfig) -> dict:
    """Each kernel's launches in one prefill of ``cfg``: the SSD scan
    once a Mamba2 layer; flash once an attention layer, once a shared
    block (zamba2: num_layers // shared_attn_every) and once an encoder
    layer (whisper, non-causal)."""
    if cfg.shared_attn_every:
        return {"ssd_scan": cfg.num_layers,
                "flash_attention": cfg.num_layers // cfg.shared_attn_every}
    if all(k == MAMBA for k in cfg.layer_kinds()):
        return {"ssd_scan": cfg.num_layers}
    return {"flash_attention": cfg.num_layers + (
        cfg.enc_layers if cfg.is_encoder_decoder else 0)}


def _lm_batch(cfg: ModelConfig, gen, batch: int, prompt: int) -> dict:
    """``make_prefill_step``'s batch, drawn from ``gen`` on its device:
    the prompt's tokens, or (llava) its embeddings (batch, prompt,
    d_model) N(0, 1); an encoder-decoder's frames (batch, enc_seq_len,
    d_model) N(0, 1) beside its tokens. f32: the model casts them."""
    dev = gen.device
    if cfg.input_kind == "embeddings":
        return {"embeds": torch.randn((batch, prompt, cfg.d_model),
                                      generator=gen, device=dev)}
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                   generator=gen, device=dev)}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = torch.randn(
            (batch, cfg.enc_seq_len, cfg.d_model), generator=gen, device=dev)
    return out


def _prompt_len(batch: dict) -> int:
    return (batch["embeds"] if "embeds" in batch else batch["tokens"]
            ).shape[1]


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


class _Routing:
    """Records each MoE layer's top-k choices and kept pairs while on
    (``models/moe.py``'s ``top_k`` and ``_dispatch_block`` wrapped)."""

    def __init__(self):
        self.idx, self.keep = [], []

    def __enter__(self):
        self._saved = moe.top_k, moe._dispatch_block

        def top_k(probs, k):
            vals, idx = self._saved[0](probs, k)
            self.idx.append(idx)
            return vals, idx

        def dispatch(*args):
            out = self._saved[1](*args)
            self.keep.append(out[2])
            return out

        moe.top_k, moe._dispatch_block = top_k, dispatch
        return self

    def __exit__(self, *exc):
        moe.top_k, moe._dispatch_block = self._saved

    def dropped(self) -> tuple:
        """(dropped pairs, pairs) over the recorded layers."""
        return (sum(int((~k).sum()) for k in self.keep),
                sum(k.numel() for k in self.keep))


def _flipped(a: _Routing, b: _Routing, last: int) -> dict:
    """(token, layer) choices that differ between two runs' records, in
    all and at the ``last`` position of each sequence."""
    flips = [(x.sort(-1).values != y.sort(-1).values).any(-1)
             for x, y in zip(a.idx, b.idx)]
    return {"flipped": sum(int(f.sum()) for f in flips),
            "flipped_last": sum(int(f.reshape(LM_BATCH, -1)[:, last].sum())
                                for f in flips),
            "choices": sum(f.numel() for f in flips)}


class _FlashSpy:
    """Keeps the inputs and output of the model-layout flash wrapper
    (``kernels/ops.py``'s ``flash_attention``, wrapped while on) at the
    first call of each (causal, window, softcap) and at the last call: a
    call index -> (q, k, v, its keywords, the output)."""

    def __enter__(self):
        self._real = kernel_ops.flash_attention
        self.kept, self._seen, self._last = {}, set(), None
        self._n = 0

        def spy(q, k, v, **kw):
            out = self._real(q, k, v, **kw)
            call = (q, k, v, kw, out)
            key = (kw.get("causal", True), kw.get("window", 0),
                   kw.get("softcap"))
            if key not in self._seen:
                self._seen.add(key)
                self.kept[self._n] = call
            self._last = (self._n, call)
            self._n += 1
            return out

        kernel_ops.flash_attention = spy
        return self

    def __exit__(self, *exc):
        kernel_ops.flash_attention = self._real
        if self._last is not None:
            self.kept.setdefault(*self._last)


def _flash_padded(q, k, v, kv_len: int, **kw) -> torch.Tensor:
    """``flash_attention_bhsd`` on q (B, H, S, hd), k, v padded along S
    to the 128-row query block, as ``ops.flash_attention`` pads them,
    with the keys at or past ``kv_len`` masked; the result cut back to
    S rows."""
    s = q.shape[2]
    pad = (-s) % 128

    def padded(t):
        return F.pad(t, (0, 0, 0, pad)).contiguous()

    return flash_attention_bhsd(padded(q), padded(k), padded(v),
                                kv_len=kv_len, **kw)[:, :, :s]


def _flash_on_path(arch: str, spy: _FlashSpy) -> dict:
    """The bf16 flash kernel on the main path's own tensors (batch 4, the
    arch's prompt or whisper's 1500 frames, the arch's heads): each kept
    call's output held to the plain version in f32 on its inputs under
    FLASH_TOL and FLASH_BF16_ROW_TOL, and a planted fault (the last key
    tile dropped) shown to fail that check. Its launches come after the
    main path's counts were read."""
    out = {}
    for layer, (q, k, v, kw, got) in sorted(spy.kept.items()):
        qb, kb, vb = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        # one sequence at a time: the f32 scores of all four are 13 GB
        # at qwen3-32b's 64 heads
        plain = torch.cat([ref_attention(*_f32(qb[i:i + 1], kb[i:i + 1],
                                               vb[i:i + 1]), **kw)
                           for i in range(qb.shape[0])])
        err, row, ok = _flash_close(got.transpose(1, 2), plain)
        print(f"    flash on the main path, call {layer} "
              f"{list(qb.shape)} kv {kb.shape[1]} {kw}: "
              f"max_abs_err={err:.3e}  tol={FLASH_TOL[torch.bfloat16]:g}"
              f"*(1+|plain|)  row error {row:.3e} (limit "
              f"{FLASH_BF16_ROW_TOL:g})")
        if not ok:
            raise AssertionError(f"{arch}: flash off the plain version at "
                                 f"call {layer} of the main path")
        control = _flash_control(
            f"call {layer}, the last key tile dropped",
            _flash_padded(qb, kb, vb, qb.shape[2] - 64, **kw), plain)
        out[layer] = {"shape": list(qb.shape), "kv_heads": kb.shape[1],
                      "causal": kw.get("causal", True),
                      "window": kw.get("window", 0),
                      "softcap": kw.get("softcap"), "max_abs_err": err,
                      "row_err": row, "control_row_err": control}
        del plain, qb, kb, vb
    spy.kept.clear()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _plain_scores_f32():
    """The plain branch's attention with q, k and v upcast, so its scores
    stay in f32 as the flash kernel keeps them; its output rounded back
    to v's type once."""
    real = lm_attention.gqa_scores_softmax

    def f32(q, k, v, mask, logit_cap):
        return real(q.float(), k.float(), v.float(), mask,
                    logit_cap).to(v.dtype)

    lm_attention.gqa_scores_softmax = f32
    try:
        yield
    finally:
        lm_attention.gqa_scores_softmax = real


def _plain_floor(cfg, change, params, batch, plain_last) -> float:
    """The plain branch's last logits with ``change`` against its own."""
    changed = cfg if change == F32_SCORES else override(cfg, **change)
    with (_plain_scores_f32() if change == F32_SCORES
          else contextlib.nullcontext()):
        last = make_prefill_step(changed, _prompt_len(batch) + LM_GEN,
                                 use_kernels=False)(params, batch)[0]
    return _rel_max(last, plain_last)


def _lm_run(cfg, params, batch, gen_len, use_kernels: bool,
            routing=None, spy=None) -> dict:
    """``serve_lm``'s path: one prefill of ``batch`` (``_lm_batch``),
    then greedy decoding; host-clock times around work that ends in a
    synchronize. ``routing`` records the prefill's MoE choices, ``spy``
    its flash calls."""
    prompt = _prompt_len(batch)
    device = next(iter(batch.values())).device
    prefill = make_prefill_step(cfg, prompt + gen_len,
                                use_kernels=use_kernels)
    t0 = time.perf_counter()
    with routing or contextlib.nullcontext(), \
            spy or contextlib.nullcontext():
        last, cache = prefill(params, batch)
    first = torch.argmax(last, dim=-1)[:, None]
    _sync(device)
    t1 = time.perf_counter()
    after_prefill = _counts()
    rest, _ = greedy_decode(cfg, params, cache, first, prompt, gen_len - 1)
    _sync(device)
    t2 = time.perf_counter()
    return {"last": last, "tokens": torch.cat([first, rest], dim=1),
            "launches_prefill": after_prefill, "launches": _counts(),
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": (t2 - t1) * 1e3 / max(gen_len - 1, 1),
            "prefill": lambda: prefill(params, batch)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _forced_decode(cfg, params, cache, tokens, start: int) -> torch.Tensor:
    """The decode logits (B, n, V) of feeding ``tokens`` (B, n) one at a
    time from ``start``, into ``cache`` in place."""
    serve = make_serve_step(cfg)
    return torch.stack([serve(params, cache, tokens[:, i:i + 1],
                              start + i)[0] for i in range(tokens.shape[1])],
                       dim=1)


def _bytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in tree.values())


def _ring_check(cfg, params, prompts, generated) -> dict:
    """The gemmas' ring cache on the card: the kernel prefill's full
    cache, converted by ``ring_cache_from_full``, decodes the greedy
    run's tokens (``generated`` (B, n): each fed as the greedy loop fed
    it) against the full cache decoding the same tokens; no kernel
    launches in either decode."""
    b, p = prompts.shape
    max_seq = p + generated.shape[1]
    tokens = generated[:, :-1]
    ring_cfg = override(cfg, ring_cache=True)
    assert uses_ring_cache(ring_cfg)
    _, full = make_prefill_step(cfg, max_seq)(params, {"tokens": prompts})
    ring = ring_cache_from_full(ring_cfg, full, p - 1, b, max_seq)
    full_bytes, ring_bytes = _bytes(full), _bytes(ring)
    _zero_counts()
    _sync(prompts.device)
    t0 = time.perf_counter()
    want = _forced_decode(cfg, params, full, tokens, p)
    _sync(prompts.device)
    t1 = time.perf_counter()
    got = _forced_decode(ring_cfg, params, ring, tokens, p)
    _sync(prompts.device)
    t2 = time.perf_counter()
    launches = {k: v for k, v in _counts().items() if v}
    if launches:
        raise AssertionError(f"{cfg.name}: decode launched {launches}")
    rel = _rel_max(got, want)
    tol = LM_RING_TOL[cfg.activation_dtype]
    agree = (got.argmax(-1) == want.argmax(-1)).sum().item()
    print(f"    ring cache ({cfg.activation_dtype}): {tokens.shape[1]}"
          f" tokens decoded from the converted prefill cache against the "
          f"full cache: max_abs/max|logit| = {rel:.3e} (bound {tol:g}); "
          f"argmax agree {agree}/{want.shape[0] * want.shape[1]}; bytes "
          f"{ring_bytes} ({sorted(ring)}) against the full cache's "
          f"{full_bytes}; decode {(t1 - t0) * 1e3 / tokens.shape[1]:.2f} "
          f"ms/token full, {(t2 - t1) * 1e3 / tokens.shape[1]:.2f} ring")
    if not (rel <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"{cfg.name}: ring decode off the full cache's")
    return {"rel": rel, "bound": tol, "argmax_agree": agree,
            "ring_bytes": ring_bytes, "full_bytes": full_bytes,
            "full_decode_ms_per_token": (t1 - t0) * 1e3 / tokens.shape[1],
            "ring_decode_ms_per_token": (t2 - t1) * 1e3 / tokens.shape[1]}


def serve_lm(dev) -> dict:
    """Phase 4d: ``serve_lm``'s path for every arch at full width in bf16
    (depth cut where ``LM_ARCHS`` says; random weights from the seed,
    batch 4, prompt 2048 (whisper's 416, beside 1500 frames; llava's
    from embeddings), 32 tokens): launch counts, the kernel run against
    the plain-branch run on the card, timing and one profiled prefill;
    the MoE archs' dropped pairs and the routing choices that differ
    between the two runs; the gemmas' ring decode against the full
    cache's; then an f32 run at the same depth, kernel against plain
    branch (and the gemmas' ring again), and one at a few layers against
    the CPU."""
    out = {}
    for arch, (kernels, _, reorder) in LM_ARCHS.items():
        cfg = _lm_cfg(arch)
        full_depth = get_arch(arch).num_layers
        prompt_len = LM_PROMPTS.get(arch, LM_PROMPT)
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, device=dev)
        batch = _lm_batch(cfg, gen, LM_BATCH, prompt_len)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params)
                       if t is not None)
        cut = (f"depth cut to {cfg.num_layers} of {full_depth}: "
               f"{LM_DEPTH_WHY[arch]}" if cfg.num_layers < full_depth
               else "full depth")
        print(f"  {arch}: {n_params / 1e6:.1f} M params ({cfg.param_dtype}, "
              f"{cfg.num_layers} layers, {cut}) initialised on the card in "
              f"{init_s:.2f}s")
        routes = {"plain": _Routing(), "kernel": _Routing()} \
            if cfg.is_moe else {}
        plain = _lm_run(cfg, params, batch, LM_GEN, use_kernels=False,
                        routing=routes.get("plain"))
        floor = None
        if reorder:
            floor = _plain_floor(cfg, reorder, params, batch,
                                 plain["last"])
        bound = max(LM_BF16_TOL, LM_FLOOR_FACTOR * (floor or 0.0))
        torch.cuda.reset_peak_memory_stats()
        # the main path: the counters from 0, one prefill, then decode
        spy = _FlashSpy() if "flash_attention" in kernels else None
        _zero_counts()
        run = _lm_run(cfg, params, batch, LM_GEN, use_kernels=True,
                      routing=routes.get("kernel"), spy=spy)
        launches = run["launches"]
        # _lm_launches' in the prefill, none in decode
        want = {**dict.fromkeys(_COUNTED, 0), **_lm_launches(cfg)}
        if {k for k, n in want.items() if n} != set(kernels):
            raise AssertionError(f"{arch}: LM_ARCHS names {kernels}, the "
                                 f"config launches {_lm_launches(cfg)}")
        if run["launches_prefill"] != want or launches != want:
            raise AssertionError(
                f"{arch} launches {run['launches_prefill']} after the "
                f"prefill, {launches} after decoding; want {want}")
        on_path = None if spy is None else _flash_on_path(arch, spy)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rel = _rel_max(run["last"], plain["last"])
        diff = (run["last"] - plain["last"]).abs().max(dim=-1).values
        top2 = plain["last"].topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        first_ok = ((run["tokens"][:, 0] == plain["tokens"][:, 0])
                    | (margin <= diff))
        agree = (run["tokens"] == plain["tokens"]).sum().item()
        moe_rec = None
        if cfg.is_moe:
            dropped, pairs = routes["kernel"].dropped()
            moe_rec = {"dropped_pairs": dropped, "pairs": pairs,
                       "dropped_share": dropped / pairs,
                       "capacity_factor": cfg.moe_capacity_factor,
                       **_flipped(routes["kernel"], routes["plain"],
                                  prompt_len - 1)}
            print(f"    MoE routing in the prefill: {dropped} of {pairs} "
                  f"(token, choice) pairs dropped at capacity factor "
                  f"{cfg.moe_capacity_factor} ({dropped / pairs:.4%}); "
                  f"(token, layer) choices that differ between the kernel "
                  f"and the plain run: {moe_rec['flipped']} of "
                  f"{moe_rec['choices']}, {moe_rec['flipped_last']} at the "
                  f"last position")
        print(f"    prefill {run['prefill_ms']:.2f} ms, decode "
              f"{run['decode_ms_per_token']:.2f} ms/token (plain branch: "
              f"{plain['prefill_ms']:.2f} ms, "
              f"{plain['decode_ms_per_token']:.2f} ms/token); launches "
              f"{ {k: v for k, v in launches.items() if v} } (decode: 0); "
              f"peak {peak_gb:.2f} GB")
        print(f"    last logits vs the plain branch: max_abs/max|logit| = "
              f"{rel:.3e} (bound {bound:.3e}; the plain branch against "
              f"itself with {reorder}: {floor}); greedy tokens agree "
              f"{agree}/{run['tokens'].numel()}; first-token margins "
              f"{margin.tolist()} against diffs {diff.tolist()}")
        if not (rel <= bound and bool(first_ok.all())
                and torch.isfinite(run["last"]).all()):
            raise AssertionError(f"{arch}: kernel run off the plain branch")
        ring_rec = None
        if any(w > 0 for w in cfg.window_pattern):
            ring_rec = _ring_check(cfg, params, batch["tokens"],
                                   run["tokens"])
        # steady prefills, after the counted one: kernel, plain, plain,
        # kernel, the best of each
        walls = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (run if which == "kernel" else plain)["prefill"]()
            torch.cuda.synchronize()
            walls[which].append((time.perf_counter() - t0) * 1e3)
        prefill_ms = min(walls["kernel"])
        plain_prefill_ms = min(walls["plain"])
        decode_ms = run["decode_ms_per_token"]
        tokens_s = LM_BATCH * LM_GEN / ((prefill_ms + decode_ms
                                         * (LM_GEN - 1)) / 1e3)
        prof = _profile(run["prefill"], trace=f"lm_{arch}_trace.json",
                        match=kernels)
        rec = {
            "params_m": n_params / 1e6, "init_s": init_s,
            "layers": cfg.num_layers, "full_depth": full_depth,
            "batch": LM_BATCH, "prompt": prompt_len, "generated": LM_GEN,
            "inputs": {k: list(v.shape) for k, v in batch.items()},
            "launches": {k: v for k, v in launches.items() if v},
            "prefill_ms": prefill_ms, "first_prefill_ms": run["prefill_ms"],
            "decode_ms_per_token": decode_ms, "tokens_per_s": tokens_s,
            "plain_prefill_ms": plain_prefill_ms,
            "first_plain_prefill_ms": plain["prefill_ms"],
            "plain_decode_ms_per_token": plain["decode_ms_per_token"],
            "peak_gb": peak_gb, "rel_logits_vs_plain": rel,
            "plain_reordered": {"change": reorder, "rel": floor},
            "bound": bound,
            "first_token_margin": margin.tolist(),
            "first_token_diff": diff.tolist(), "tokens_agree": agree,
            "moe": moe_rec, "ring": ring_rec, "flash_on_path": on_path,
            "profile": {k: prof[k] for k in ("wall_ms", "kernel_ms",
                                             "busy_share", "top",
                                             "matched")}}
        print(f"    steady prefill {prefill_ms:.2f} ms (plain branch "
              f"{plain_prefill_ms:.2f} ms); {tokens_s:.1f} "
              f"generated tokens/s; profiled prefill: busy "
              f"{prof['busy_share']:.3f}, "
              + ", ".join(f"{k} {prof['matched'][k]['ms']:.2f} ms"
                          for k in kernels)
              + f" of {prof['kernel_ms']:.2f} ms kernel time; top "
              f"{[(t['name'][:40], round(t['ms'], 2)) for t in prof['top']]}")
        generated = run["tokens"]
        del params, plain, run, routes
        torch.cuda.empty_cache()

        # f32 at full width and the served depth: the kernel prefill
        # against the plain branch's, on the card
        full32 = _lm_cfg(arch, param_dtype="float32",
                         activation_dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(full32, gen, device=dev)
        lasts = [make_prefill_step(full32, prompt_len + LM_GEN,
                                   use_kernels=uk)(params, batch)[0]
                 for uk in (True, False)]
        rel_deep = _rel_max(*lasts)
        print(f"    f32, {full32.num_layers} layers, prompt {prompt_len}: "
              f"last logits kernel vs plain branch max_abs/max|logit| = "
              f"{rel_deep:.3e} (bound {LM_F32_TOL:g})")
        if not (rel_deep <= LM_F32_TOL and torch.isfinite(lasts[0]).all()):
            raise AssertionError(f"{arch}: f32 kernel run off the plain "
                                 "branch")
        del lasts
        ring32 = None
        if ring_rec is not None:
            ring32 = _ring_check(full32, params, batch["tokens"], generated)
        del params
        torch.cuda.empty_cache()

        # f32 at full width and a few layers: the card against the CPU
        layers, n_seq, prompt = LM_F32_CPU.get(arch, LM_F32_CPU_DEFAULT)
        enc = {"enc_layers": layers} if cfg.is_encoder_decoder else {}
        cfg32 = _lm_cfg(arch, param_dtype="float32",
                        activation_dtype="float32", num_layers=layers, **enc)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        params = init_params(cfg32, gen, device=dev)
        batch = _lm_batch(cfg32, gen, n_seq, prompt)
        card = _lm_run(cfg32, params, batch, LM_F32_GEN, use_kernels=True)
        t0 = time.perf_counter()
        cpu_params = _cpu_tree(params)
        del params
        torch.cuda.empty_cache()
        cpu = _lm_run(cfg32, cpu_params, {k: v.cpu() for k, v in
                                          batch.items()}, LM_F32_GEN,
                      use_kernels=True)
        cpu_s = time.perf_counter() - t0
        rel32 = _rel_max(card["last"].cpu(), cpu["last"])
        agree32 = (card["tokens"].cpu() == cpu["tokens"]).sum().item()
        print(f"    f32, {layers} layers, batch {n_seq}, prompt {prompt}: "
              f"last logits card vs CPU max_abs/max|logit| = {rel32:.3e} "
              f"(bound {LM_F32_TOL:g}); greedy tokens agree {agree32}/"
              f"{cpu['tokens'].numel()}; CPU run {cpu_s:.1f}s")
        if not (rel32 <= LM_F32_TOL and torch.isfinite(card["last"]).all()):
            raise AssertionError(f"{arch}: f32 card run off the CPU run")
        del cpu_params, card, cpu
        torch.cuda.empty_cache()
        out[arch] = {**rec, "f32_rel_logits_vs_plain": rel_deep,
                     "f32_ring": ring32,
                     "f32_cpu_run": {"layers": layers, "batch": n_seq,
                                     "prompt": prompt, **enc},
                     "f32_rel_logits_vs_cpu": rel32,
                     "f32_tokens_agree": agree32, "f32_cpu_s": cpu_s}
    return out


def _cpu_tree(tree):
    return tree_map(lambda x: x.cpu(), tree)


def _flex_attention(q, k, v, window: int, softcap, plain) -> tuple:
    """(the call, its description, its check): ``flex_attention`` on q
    (B, H, S, hd) and k, v (B, KV, S, hd), compiled once here, outside
    any timed region, with the causal window as a block mask (the tiles
    outside it skipped) and the softcap as a score_mod on the scaled
    scores; its output held to ``plain`` (the plain version in f32 on the
    same inputs) under FLASH_TOL, or it does not compute the function.
    Inductor's caches go to the git-ignored ``build/``, and it compiles
    in this process."""
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    inductor_config.compile_threads = 1
    s = q.shape[2]
    w = window if window > 0 else s

    def mask_mod(b, h, q_idx, kv_idx):
        return (kv_idx <= q_idx) & (q_idx - kv_idx < w)

    score_mod = None
    if softcap is not None:
        def score_mod(score, b, h, q_idx, kv_idx):
            return softcap * torch.tanh(score / softcap)

    block_mask = create_block_mask(mask_mod, None, None, s, s,
                                   device=q.device)
    compiled = torch.compile(flex_attention, dynamic=False)

    def call():
        return compiled(q, k, v, score_mod=score_mod, block_mask=block_mask,
                        enable_gqa=True)

    t0 = time.perf_counter()
    got = call()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    err, ok = _close(got.float(), plain, FLASH_TOL[got.dtype])
    row = _row_rel(got, plain)
    print(f"  flex_attention (window {window}, softcap {softcap}): compiled "
          f"in {compile_s:.1f}s; against the plain version in f32 "
          f"max_abs_err={err:.3e}  tol={FLASH_TOL[got.dtype]:g}*(1+|plain|)"
          f"  row error {row:.3e}")
    if not ok:
        raise AssertionError("flex_attention does not compute the plain "
                             "version's function")
    desc = ("torch.compile(flex_attention)(q, k, v, block_mask=the causal "
            f"window {w} (create_block_mask), "
            + ("" if softcap is None else
               f"score_mod={softcap:g}*tanh(score/{softcap:g}), ")
            + "enable_gqa=True)")
    return call, desc, {"max_abs_err": err, "row_err": row,
                        "compile_s": compile_s}


def _backbone_rows(dev, lm_rec, card_name, worst) -> list:
    """Phase 5's rows for the LM backbones' kernels at the prefill shapes
    of the LM phase: flash at qwen2-0.5b's (B 4, H 14, KV 2, S 2048, hd
    64, bf16, causal), at qwen3-32b's heads (batch 1), at the gemmas'
    local layers, whisper-small's encoder (non-causal, S 1500) and
    decoder (S 416), llava-next-34b's and zamba2-1.2b's shared block;
    SSD at mamba2-780m's (b 4, s 2048, h 48, p 64, n 128, chunk 128,
    bf16, with the final state) and zamba2-1.2b's (h 64, n 64). The
    bound is at the bf16 tensor-core rate and the memory rate. The row's
    launches are phase 4d's bf16 prefills'."""
    peaks = (_BF16_PEAKS[_card_row(card_name)], _peaks(card_name)[1])
    g = _gen(SEED + 3)
    bf = torch.bfloat16
    rows = []

    def flash_timed(b, h, kv, s, hd, window=0, softcap=None, flex=False,
                    causal=True):
        """Times at one shape, after the bf16 kernel is held there to the
        plain version in f32 (and a planted fault, the last key tile
        dropped, is shown to fail that check). An S that is not a
        multiple of the 128-row query block is padded to one, as
        ``ops.flash_attention`` pads it, and the kernel and the plain
        version mask the keys past S; the library call reads the S rows
        alone. The library call is SDPA, causal or not; with ``flex``,
        ``flex_attention`` (the window as a block mask, the softcap as a
        score_mod), held to the same plain version first, and beside it
        SDPA with the window's boolean mask where there is no softcap
        (SDPA has none)."""
        s_pad = s + (-s) % 128
        q = torch.randn((b, h, s, hd), generator=g).to(dev, bf)
        k, v = (torch.randn((b, kv, s, hd), generator=g).to(dev, bf)
                for _ in range(2))
        qp, kp, vp = (F.pad(t, (0, 0, 0, s_pad - s)).contiguous()
                      for t in (q, k, v))
        kw = dict(causal=causal, window=window, softcap=softcap)
        f32 = [t.float() for t in (qp, kp, vp)]
        got = flash_attention_bhsd(qp, kp, vp, kv_len=s, **kw)[:, :, :s]
        again = flash_attention_bhsd(qp, kp, vp, kv_len=s, **kw)[:, :, :s]
        plain = ref_attention(*f32, kv_len=s, **kw)[:, :, :s]
        torch.cuda.synchronize()
        err, row, ok = _flash_close(got, plain)
        same = torch.equal(got, again)
        print(f"  flash_attention bf16 at {[b, h, kv, s, hd]} (padded to "
              f"{s_pad}) {kw}: max_abs_err={err:.3e}  tol="
              f"{FLASH_TOL[bf]:g}*(1+|plain|)  row error {row:.3e} (limit "
              f"{FLASH_BF16_ROW_TOL:g})  repeat bit-equal: {same}")
        if not (ok and same):
            raise AssertionError(f"flash_attention mismatch at "
                                 f"{(b, h, kv, s, hd, kw)}")
        control = _flash_control(
            "the last key tile dropped",
            flash_attention_bhsd(qp, kp, vp, kv_len=s - 64, **kw)[:, :, :s],
            plain)
        extra = {}
        if flex:
            library, call, extra["library_check"] = _flex_attention(
                q, k, v, window, softcap, plain)
            if softcap is None:
                pos = torch.arange(s, device=dev)
                mask = ((pos[None, :] <= pos[:, None])
                        & (pos[:, None] - pos[None, :] < window))
                extra["sdpa_mask_call"] = (
                    "F.scaled_dot_product_attention(q, k, v, attn_mask="
                    "the causal window's boolean mask, enable_gqa=True)")
                extra["sdpa_mask_ms"] = _time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True))[0]
        else:
            call = ("F.scaled_dot_product_attention(q, k, v, "
                    f"is_causal={causal}, enable_gqa=True)")

            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        del got, again, plain, f32
        torch.cuda.empty_cache()
        times = _timed(lambda: flash_attention_bhsd(qp, kp, vp, kv_len=s,
                                                    **kw),
                       lambda: ref_attention(qp, kp, vp, kv_len=s, **kw),
                       library)
        # the (query, key) pairs the causal window keeps; all S² when
        # non-causal
        w = window if window > 0 else s
        band = (sum(min(i + 1, w) for i in range(s)) if causal
                else s * min(w, s))
        bound, by = _bound_ms(2 * (2 * b * h * s * hd + 2 * b * kv * s * hd),
                              4 * b * h * band * hd, peaks)
        return {"shape": [b, h, kv, s, hd], "dtype": "bfloat16",
                "causal": causal, "padded_to": s_pad,
                "window": window, "softcap": softcap,
                "check": {"max_abs_err": err, "row_err": row,
                          "row_limit": FLASH_BF16_ROW_TOL,
                          "control_row_err": control},
                **times, "library_call": call, **extra, "bound_ms": bound,
                "bound_by": by}

    # qwen2-0.5b's prefill; qwen3-32b's widths (64/8 heads of 128) at the
    # same S, batch 1; and the gemmas' prefills (32/16 heads of 128):
    # gemma2's local layer (window 4096, softcap 50) and gemma3's (window
    # 1024)
    qwen2 = flash_timed(LM_BATCH, 14, 2, LM_PROMPT, 64)
    extra = {
        "hd128": {"name": "flash_attention hd 128",
                  **flash_timed(1, 64, 8, LM_PROMPT, 128)},
        "gemma2": {"name": "flash_attention gemma2-27b local",
                   **flash_timed(LM_BATCH, 32, 16, LM_PROMPT, 128,
                                 window=4096, softcap=50.0, flex=True)},
        "gemma3": {"name": "flash_attention gemma3-27b local",
                   **flash_timed(LM_BATCH, 32, 16, LM_PROMPT, 128,
                                 window=1024, flex=True)},
        # whisper-small's encoder over its 1500 frames and decoder at its
        # 416-token prompt; llava-next-34b's g 7 at hd 128; zamba2-1.2b's
        # shared block (g 1)
        "whisper_enc": {"name": "flash_attention whisper-small encoder",
                        **flash_timed(LM_BATCH, 12, 12, 1500, 64,
                                      causal=False)},
        "llava": {"name": "flash_attention llava-next-34b",
                  **flash_timed(LM_BATCH, 56, 8, LM_PROMPT, 128)},
        "zamba2": {"name": "flash_attention zamba2-1.2b shared block",
                   **flash_timed(LM_BATCH, 32, 32, LM_PROMPT, 64)},
        "whisper_dec": {"name": "flash_attention whisper-small decoder",
                        **flash_timed(LM_BATCH, 12, 12,
                                      LM_PROMPTS["whisper-small"], 64)}}
    # whisper's cross-attention runs plain, once a decoder layer (the
    # kernel takes as many keys as queries): its scores at the prefill's
    # shape, beside SDPA on the same q, k and v
    wq = torch.randn((LM_BATCH, LM_PROMPTS["whisper-small"], 12, 64),
                     generator=g).to(dev, bf)
    wk, wv = (torch.randn((LM_BATCH, 1500, 12, 64), generator=g).to(dev, bf)
              for _ in range(2))
    every = torch.ones((LM_BATCH, wq.shape[1], 1500), dtype=torch.bool,
                       device=dev)
    wt = [t.transpose(1, 2) for t in (wq, wk, wv)]
    cross_plain = {
        "shape": {"q": list(wq.shape), "k": list(wk.shape)},
        "plain_ms": _time_ms(lambda: lm_attention.gqa_scores_softmax(
            wq, wk, wv, every, None))[0],
        "sdpa_ms": _time_ms(
            lambda: F.scaled_dot_product_attention(*wt))[0],
        "per_prefill": lm_rec.get("whisper-small", {}).get(
            "layers", 0)}
    print(f"  whisper's cross-attention (plain, {cross_plain['shape']}): "
          f"{cross_plain['plain_ms'] * 1e3:.2f}us a layer, SDPA "
          f"{cross_plain['sdpa_ms'] * 1e3:.2f}us; "
          f"{cross_plain['per_prefill']} a prefill")
    del wq, wk, wv, wt, every
    flash_by_arch = {arch: rec["launches"]["flash_attention"]
                     for arch, rec in lm_rec.items()
                     if "flash_attention" in rec["launches"]}
    on_path = [c for rec in lm_rec.values()
               for c in (rec["flash_on_path"] or {}).values()]
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:36",
        "tpu_kernel": "src/repro/kernels/flash_attention.py::_flash_kernel "
                      "(flash_attention_bhsd)",
        "design": {
            "bfloat16": "flash_attention_fwd_bf16_kernel: tensor cores, "
                        "mma.sync m16n8k16 bf16 -> f32, cp.async ring of "
                        "3 K/V tiles, ldmatrix",
            "float32": "flash_attention_fwd_f32_kernel: CUDA cores, f32 "
                       "tiles in shared memory"},
        "launches": sum(flash_by_arch.values()),
        "launches_by_arch": flash_by_arch,
        "launches_from": "one bf16 prefill of each attention arch of "
                         "phase 4d (decode: 0)",
        "max_abs_err": max([worst["flash_attention"],
                            qwen2["check"]["max_abs_err"]]
                           + [r["check"]["max_abs_err"]
                              for r in extra.values()]
                           + [c["max_abs_err"] for c in on_path]),
        "bf16_row_err": {"phase1": worst["flash_bf16_row"],
                         "main_path": max(c["row_err"] for c in on_path),
                         "limit": FLASH_BF16_ROW_TOL,
                         "controls_min": min(
                             [worst["flash_bf16_control"],
                              qwen2["check"]["control_row_err"]]
                             + [r["check"]["control_row_err"]
                                for r in extra.values()]
                             + [c["control_row_err"] for c in on_path])},
        "whisper_cross_plain": cross_plain, **qwen2, **extra})

    def ssd_timed(b, s=LM_PROMPT, h=48, p=64, n=128, chunk=128):
        """SSD at mamba2-780m's prefill widths (or zamba2-1.2b's: h 64,
        n 64), batch b: the kernel (bf16) held to the plain version in
        f32 (and, at batch 4, the planted faults shown to fail), then
        timed; at batch 4 also the f32 kernel and the chunked plain
        branch (``ssd_chunked``: several einsums and a loop, not one
        library call)."""
        x = (torch.randn((b, s, h, p), generator=g) * 0.5).to(dev, bf)
        dt = F.softplus(torch.randn((b, s, h), generator=g) - 4.0).to(dev)
        a_log = torch.log(torch.rand((h,), generator=g) * 15 + 1).to(dev)
        bm, cm = ((torch.randn((b, s, n), generator=g) * 0.5).to(dev, bf)
                  for _ in range(2))
        d = torch.ones((h,), device=dev)
        args = (x, dt, a_log, bm, cm, d)
        y, state = ssd_scan_bhsp(*args, chunk=chunk, return_state=True)
        y2, state2 = ssd_scan_bhsp(*args, chunk=chunk, return_state=True)
        py, pstate = ref_ssd(*_f32(*args))
        torch.cuda.synchronize()
        ey, oky = _close(y.float(), py, SSD_TOL[bf])
        row = _row_rel(y, py)
        es, oks = _close(state, pstate, SSD_TOL[torch.float32])
        same = torch.equal(y, y2) and torch.equal(state, state2)
        width = p_width_for(b, h, p, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        print(f"  ssd_scan bf16 at {[b, s, h, p, n, chunk]} (p_width "
              f"{width}): y max_abs_err={ey:.3e}  row error {row:.3e} "
              f"(limit {SSD_BF16_ROW_TOL:g})  state max_abs_err={es:.3e}  "
              f"repeat bit-equal: {same}")
        if not (oky and row <= SSD_BF16_ROW_TOL and oks and same):
            raise AssertionError(f"ssd_scan mismatch at {(b, s, h, p, n)}")
        check = {"max_abs_err": max(ey, es), "row_err": row,
                 "row_limit": SSD_BF16_ROW_TOL}
        del y, y2, state, state2, py, pstate
        if b == LM_BATCH:
            check["control_row_err"], check["control_state_err"] = (
                _ssd_controls(args, chunk))
        ms, eager = _time_ms(lambda: ssd_scan_bhsp(
            *args, chunk=chunk, return_state=True))
        # the plain recurrence is s steps of a few launches: one call a rep
        plain, plain_eager = _time_ms(lambda: ref_ssd(*args), iters=1,
                                      reps=3)
        tri = chunk * (chunk + 1) // 2  # (i, j) pairs with j <= i
        per_chunk = 2 * (tri * n + tri * p + 2 * chunk * p * n)
        bound, by = _bound_ms(
            2 * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + 2 * h)
            + 4 * b * h * p * n, b * h * (s // chunk) * per_chunk, peaks)
        rec = {"shape": [b, s, h, p, n, chunk], "dtype": "bfloat16",
               "p_width": width, "check": check,
               "ms": ms, "kernel_ms": ms, "plain_ms": plain,
               "library_ms": None,
               "eager_ms": {"kernel": eager, "plain": plain_eager,
                            "library": None},
               "bound_ms": bound, "bound_by": by}
        if b == LM_BATCH:
            f32 = _f32(x, dt, a_log, bm, cm, d)
            rec["f32_kernel_ms"] = _time_ms(lambda: ssd_scan_bhsp(
                *f32, chunk=chunk, return_state=True), iters=10, reps=5)[0]
            rec["chunked_plain_ms"] = _time_ms(
                lambda: ssd_chunked(*args, chunk), iters=10, reps=5)[0]
        return rec

    mamba2 = ssd_timed(LM_BATCH)
    batch1 = {"name": "ssd_scan batch 1", **ssd_timed(1)}
    zamba2 = {"name": "ssd_scan zamba2-1.2b", **ssd_timed(LM_BATCH, h=64,
                                                          n=64)}
    ssd_by_arch = {arch: rec["launches"]["ssd_scan"]
                   for arch, rec in lm_rec.items()
                   if "ssd_scan" in rec["launches"]}
    rows.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:28",
        "tpu_kernel": "src/repro/kernels/ssd_scan.py::_ssd_kernel "
                      "(ssd_scan_bhsp)",
        "design": {
            "bfloat16": "ssd_scan_bf16_kernel: tensor cores, mma.sync "
                        "m16n8k16 bf16 -> f32 with hi/lo f32 operands, "
                        "scores in registers, cp.async double buffer, a "
                        "block per (batch, head, p_width columns)",
            "float32": "ssd_scan_kernel: CUDA cores, f32 register tiles"},
        "launches": sum(ssd_by_arch.values()),
        "launches_by_arch": ssd_by_arch,
        "launches_from": "one bf16 prefill of each Mamba2 arch of phase "
                         "4d (decode: 0)",
        "max_abs_err": max(worst["ssd_scan"],
                           mamba2["check"]["max_abs_err"],
                           batch1["check"]["max_abs_err"],
                           zamba2["check"]["max_abs_err"]),
        "bf16_row_err": {"phase1": worst["ssd_bf16_row"],
                         "limit": SSD_BF16_ROW_TOL,
                         "controls_min": min(
                             worst["ssd_bf16_control"],
                             mamba2["check"]["control_row_err"],
                             zamba2["check"]["control_row_err"]),
                         "state_controls_min": min(
                             worst["ssd_state_control"],
                             mamba2["check"]["control_state_err"],
                             zamba2["check"]["control_state_err"])},
        **mamba2, "library_call": None, "batch1": batch1, "zamba2": zamba2})
    for r in rows + [rows[0][k] for k in extra] + [batch1, zamba2]:
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.2f}us")
        print(f"  {r['name']} at {r['shape']} bf16, "
              f"device (CUDA graph): kernel {r['ms'] * 1e3:.2f}us  plain "
              f"{r['plain_ms'] * 1e3:.2f}us  library {lib}  bound "
              f"{r['bound_ms'] * 1e3:.3f}us ({r['bound_by']})"
              + ("" if "sdpa_mask_ms" not in r else
                 f"  SDPA with the boolean mask "
                 f"{r['sdpa_mask_ms'] * 1e3:.2f}us"))
    print(f"  ssd_scan bf16 p_width: batch {LM_BATCH} {mamba2['p_width']}, "
          f"batch 1 {batch1['p_width']}, zamba2 {zamba2['p_width']}; f32 "
          f"kernel {mamba2['f32_kernel_ms'] * 1e3:.2f}us (zamba2 "
          f"{zamba2['f32_kernel_ms'] * 1e3:.2f}us), chunked plain branch "
          f"(ssd_chunked) {mamba2['chunked_plain_ms'] * 1e3:.2f}us "
          f"(zamba2 {zamba2['chunked_plain_ms'] * 1e3:.2f}us)")
    return rows


def timing(dev, serve_rec, pred_rec, train_rec, strat_rec, priv_rec,
           exp_rec, stage_rec, card_name, worst) -> list:
    """Phase 5: kernel, plain and library times at main-path shapes."""
    peaks = _peaks(card_name)
    g = _gen(SEED + 2)
    out = []
    train_launches, rounds = train_rec["launches"], train_rec["rounds"]
    # each aggregation kernel's launches over the strategies phase's
    # kernel runs, and over phase 4f's
    strat_launches = {k: sum(r["launches"].get(k, 0)
                             for r in strat_rec.values())
                      for k in _COUNTED}
    stage_launches = {k: sum(r["launches"].get(k, 0)
                             for label, r in stage_rec.items()
                             if label in STAGE_RUNS)
                      for k in _COUNTED}

    # every layer's shape at the largest decode and prefill of the run:
    # device time of the kernel and of cuBLAS on the dequantized weight
    by_shape = []
    for m in (serve_rec["max_decode_rows"], serve_rec["max_prefill_rows"]):
        for k, n in INT8_SHAPES[:5]:
            x, q, s = _int8_inputs(m, k, n, g, dev)
            w = q.float() * s[None, :]
            bound, _ = _bound_ms(4 * m * k + k * n + 4 * n + 4 * m * n,
                                 2 * m * k * n, peaks)
            by_shape.append({
                "shape": [m, k, n],
                "ms": _time_ms(lambda: int8_matmul_flat(x, q, s))[0],
                "library_ms": _time_ms(lambda: torch.matmul(x, w))[0],
                "bound_ms": bound})
            print(f"  int8_matmul {by_shape[-1]['shape']}: kernel "
                  f"{by_shape[-1]['ms'] * 1e3:.2f}us  library "
                  f"{by_shape[-1]['library_ms'] * 1e3:.2f}us (device)  "
                  f"bound {bound * 1e3:.3f}us")

    def int8_timed(m, k, n):
        x, q, s = _int8_inputs(m, k, n, g, dev)
        w = q.float() * s[None, :]
        times = _timed(lambda: int8_matmul_flat(x, q, s),
                       lambda: ref_int8_matmul(x, q, s),
                       lambda: torch.matmul(x, w))
        bound, by = _bound_ms(4 * m * k + k * n + 4 * n + 4 * m * n,
                              2 * m * k * n, peaks)
        print(f"  int8_matmul {[m, k, n]}, device (CUDA graph): kernel "
              f"{times['ms'] * 1e3:.2f}us  plain {times['plain_ms'] * 1e3:.2f}"
              f"us  cuBLAS {times['library_ms'] * 1e3:.2f}us  bound "
              f"{bound * 1e3:.3f}us ({by})")
        return times, bound, by

    # decode's w1, where the table's row sits; and a synthetic shape, the
    # corner of the kernel's serving range (M 1280, K = N = 256), which no
    # GPO layer has and no step of the trace reaches: the run's real
    # prefill shapes are in by_shape
    m, k, n = serve_rec["max_decode_rows"], 128, 256
    times, bound, by = int8_timed(m, k, n)
    large_shape = [INT8_M_ROWS[-1], 256, 256]
    large_times, large_bound, large_by = int8_timed(*large_shape)
    out.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:68",
        "tpu_kernel": "src/repro/kernels/quant_matmul.py::"
                      "_int8_matmul_kernel (int8_matmul_flat)",
        "launches": serve_rec["launches"],
        "launches_per_step": serve_rec["launches"] / serve_rec["steps"],
        "max_abs_err": worst["int8_matmul"],
        "shape": [m, k, n], **times, "bound_ms": bound, "bound_by": by,
        "library_call": "torch.matmul(x, dequantize_linear(w))",
        "by_shape": by_shape,
        "synthetic": {"shape": large_shape, **large_times,
                  "bound_ms": large_bound, "bound_by": large_by}})

    # every product runs as three TF32 passes on the tensor cores: the
    # attention kernels' bounds price them at the TF32 rate; the f32
    # CUDA-core rate's price is printed beside (both from the data sheet)
    tf32 = (_TF32_PEAKS[_card_row(card_name)] / 3, peaks[1])

    def attn_bounds(name, nbytes, flops) -> dict:
        bound, by = _bound_ms(nbytes, flops, tf32)
        print(f"  {name} bound {bound * 1e3:.3f}us ({by}); its products "
              f"priced at the data sheet's rates: "
              f"{flops / tf32[0] * 1e6:.3f}us at the TF32 rate (3 passes), "
              f"{flops / peaks[0] * 1e6:.3f}us at the f32 rate")
        return {"bound_ms": bound, "bound_by": by}

    # the forward at training's shape, where its launches come from, and
    # at predict's shape (7 held-out groups x 4 heads)
    fwd_rows = []
    for bh, s_len, nc in ATTN_SHAPES[:2]:
        q, k, v = _attn_inputs(bh, s_len, g, dev)
        pos = torch.arange(s_len, device=dev)
        mask = (pos[None, :] < nc) | (pos[None, :] == pos[:, None])
        times = _timed(lambda: gpo_attention_fwd(q, k, v, num_ctx=nc),
                       lambda: ref_gpo_attention(q, k, v, num_ctx=nc),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask))
        keys = s_len * nc + (s_len - nc)  # the band: context keys + self
        # q, k, v read, o and lse written once; q.k and p.v a pair
        fwd_rows.append({"shape": [bh, s_len, nc, HEAD_DIM], **times,
                         **attn_bounds(f"gpo_attention_fwd BH={bh}",
                                       4 * bh * (4 * s_len * HEAD_DIM + s_len),
                                       4 * bh * keys * HEAD_DIM)})
    # what sets the forward's pace: its device time against the number of
    # 32-key stages its blocks walk, and one bh alone (a single wave)
    bh, s_len, nc = ATTN_SHAPES[0]
    q, k, v = _attn_inputs(bh, s_len, g, dev)
    fwd_pace = {}
    for label, pbh, pnc in (("num_ctx 32", bh, 32), (f"num_ctx {nc}", bh, nc),
                            (f"num_ctx {s_len}", bh, s_len), ("bh 1", 1, nc)):
        pq, pk, pv = (t[:pbh] for t in (q, k, v))
        fwd_pace[label] = _time_ms(
            lambda: gpo_attention_fwd(pq, pk, pv, num_ctx=pnc))[0]
        print(f"  gpo_attention_fwd pace at BH={pbh} num_ctx={pnc}: "
              f"{fwd_pace[label] * 1e3:.2f}us")
    train_row, predict_row = fwd_rows
    out.append({
        "name": "gpo_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gpo_attention_fwd.cu",
        "replaces": "src/repro/kernels/gpo_attention.py:117",
        "tpu_kernel": "src/repro/kernels/gpo_attention.py::"
                      "_gpo_fwd_kernel (_gpo_forward)",
        "launches": train_launches["gpo_attention_fwd"],
        "launches_from": "train (shape, times and bound are training's)",
        "launches_per_round": train_launches["gpo_attention_fwd"] / rounds,
        "launches_by_path": {"predict": pred_rec["launches"],
                             "train": train_launches["gpo_attention_fwd"]},
        "launches_per_call": pred_rec["launches"] / pred_rec["calls"],
        "max_abs_err": worst["gpo_attention_fwd"],
        "f64_mean_err": worst["gpo_attention_fwd_f64"],
        **train_row, "pace": fwd_pace,
        "library_call": "F.scaled_dot_product_attention(q, k, v, "
                        "attn_mask=boolean NP mask)",
        "predict_path": predict_row})

    # the backward at the training shape: 10 clients x 4 heads. No PyTorch
    # call computes dq or dk/dv alone; SDPA's backward computes dq, dk and
    # dv together, so both rows carry it as their library time, beside
    # the port's whole backward through the GPOAttention Function (delta,
    # dq, dk/dv), each replayed from one retained autograd graph; and
    # ``fwd_bwd``, the forward and backward of each (and of the plain
    # forward under autograd).
    bh, s_len, nc = BWD_SHAPES[0]
    q, k, v, do = _attn_inputs(bh, s_len, g, dev, n=4)
    o, lse = gpo_attention_fwd(q, k, v, num_ctx=nc)
    delta = (do * o).sum(-1)
    pos = torch.arange(s_len, device=dev)
    mask = (pos[None, :] < nc) | (pos[None, :] == pos[:, None])
    leaf = [t.clone().requires_grad_() for t in (q, k, v)]

    def gpo_forward(*a):
        return GPOAttention.apply(*a, nc)

    def sdpa_forward(*a):
        return F.scaled_dot_product_attention(*a, attn_mask=mask)

    def fwd_bwd(forward):
        return lambda: torch.autograd.grad(forward(*leaf), leaf, do)

    chain = {
        "kernels_ms": _time_ms(fwd_bwd(gpo_forward))[0],
        "plain_ms": _time_ms(fwd_bwd(
            lambda *a: ref_gpo_attention(*a, num_ctx=nc)[0]))[0],
        "library_ms": _time_ms(fwd_bwd(sdpa_forward))[0]}
    backward = {"gpo_attention_ms": _bwd_alone(gpo_forward, leaf, do)[0]}
    sdpa_bwd = _bwd_alone(sdpa_forward, leaf, do)
    backward["library_ms"] = sdpa_bwd[0]
    print(f"  attention backward alone at {[bh, s_len, nc, HEAD_DIM]}, "
          f"device (CUDA graph): GPOAttention (delta, dq, dk/dv) "
          f"{backward['gpo_attention_ms'] * 1e3:.2f}us  SDPA's backward "
          f"{backward['library_ms'] * 1e3:.2f}us")
    # what sets the pace: each kernel's device time against the number
    # of 32-row stages its blocks walk (num_ctx for dq, S for dk/dv's
    # context blocks), and one bh alone (a single wave of blocks)
    pace = {}
    for label, pbh, pnc in (("num_ctx 32", bh, 32),
                            (f"num_ctx {s_len}", bh, s_len), ("bh 1", 1, nc)):
        pq, pk, pv, pdo = (t[:pbh] for t in (q, k, v, do))
        po, plse = gpo_attention_fwd(pq, pk, pv, num_ctx=pnc)
        pops = (pq, pk, pv, pdo, plse, (pdo * po).sum(-1))
        pace[label] = {
            "gpo_attention_bwd_dq": _time_ms(
                lambda: gpo_attention_bwd_dq(*pops, num_ctx=pnc))[0],
            "gpo_attention_bwd_dkdv": _time_ms(
                lambda: gpo_attention_bwd_dkdv(*pops, num_ctx=pnc))[0]}
        print(f"  pace at BH={pbh} num_ctx={pnc}: dq "
              f"{pace[label]['gpo_attention_bwd_dq'] * 1e3:.2f}us  dk/dv "
              f"{pace[label]['gpo_attention_bwd_dkdv'] * 1e3:.2f}us")
    band = s_len * nc + (s_len - nc)  # allowed (query, key) pairs
    for name, kfn, pfn, n_out, per_pair, src_key in (
            ("gpo_attention_bwd_dq", gpo_attention_bwd_dq,
             ref_gpo_attention_bwd_dq, 1, 6, "223"),
            ("gpo_attention_bwd_dkdv", gpo_attention_bwd_dkdv,
             ref_gpo_attention_bwd_dkdv, 2, 8, "261")):
        ops = (q, k, v, do, lse, delta)
        times = _timed(lambda: kfn(*ops, num_ctx=nc),
                       lambda: pfn(*ops, num_ctx=nc), None)
        times["library_ms"], times["eager_ms"]["library"] = sdpa_bwd
        # q, k, v, do, lse and delta read once; each output written once
        bounds = attn_bounds(name,
                             4 * bh * ((4 + n_out) * s_len * HEAD_DIM
                                       + 2 * s_len),
                             per_pair * bh * band * HEAD_DIM)
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gpo_attention_bwd.cu",
            "replaces": f"src/repro/kernels/gpo_attention.py:{src_key}",
            "tpu_kernel": "src/repro/kernels/gpo_attention.py::"
                          f"_{name.replace('gpo_attention_', 'gpo_')}"
                          "_kernel (_gpo_backward)",
            "launches": train_launches[name],
            "launches_per_round": train_launches[name] / rounds,
            "max_abs_err": worst[name],
            "f64_mean_err": worst["gpo_attention_bwd_f64"],
            "shape": [bh, s_len, nc, HEAD_DIM], **times, **bounds,
            "pace": {label: t[name] for label, t in pace.items()},
            "library_call": (
                "SDPA's backward alone, dq, dk and dv together: "
                "torch.autograd.grad through F.scaled_dot_product_attention("
                "q, k, v, attn_mask=boolean NP mask), replayed"),
            "library_covers": (
                "the whole backward, not this kernel alone: compare it "
                "with backward.gpo_attention_ms, not with ms"),
            "backward": {**backward, "library_call": (
                "the same SDPA backward, against the GPOAttention "
                "Function's backward (delta, dq, dk/dv)")},
            "fwd_bwd": {**chain, "library_call": (
                "forward + backward of F.scaled_dot_product_attention("
                "attn_mask=boolean NP mask) through torch.autograd.grad, "
                "against kernels_ms")}})

    # the Eq. 3 reduce at the quickstart's (C, P). Inputs rotate over 4
    # copies (85 MB, beyond the 50 MB L2), so each call reads its deltas
    # from device memory.
    c, p = FEDAVG_SHAPES[0]
    xs = [torch.randn((c, p), generator=g).to(dev) for _ in range(4)]
    w = torch.rand((c,), generator=g) + 0.1
    w = (w / w.sum()).to(dev)

    def rotating(fn):
        turn = [0]

        def call():
            turn[0] += 1
            return fn(xs[turn[0] % len(xs)])

        return call

    times = _timed(rotating(lambda x: fedavg_reduce_flat(x, w)),
                   rotating(lambda x: ref_fedavg_flat(x, w)),
                   rotating(lambda x: w @ x))
    bound, by = _bound_ms(4 * (c * p + p + c), 2 * c * p, peaks)
    out.append({
        "name": "fedavg_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/agg_reduce.py:100",
        "tpu_kernel": "src/repro/kernels/agg_reduce.py::_fedavg_kernel "
                      "(fedavg_reduce_flat)",
        "launches": train_launches["fedavg_reduce"],
        "launches_per_round": train_launches["fedavg_reduce"] / rounds,
        "launches_by_path": {"train": train_launches["fedavg_reduce"],
                             "strategies": strat_launches["fedavg_reduce"],
                             "stages": stage_launches["fedavg_reduce"]},
        "max_abs_err": worst["fedavg_reduce"],
        "shape": [c, p], **times, "bound_ms": bound, "bound_by": by,
        "library_call": "weights @ stacked (cuBLAS gemv)"})

    # the other aggregation kernels at the same (C, P), inputs rotated
    # the same way; launches from the strategies phase
    def agg_row(name, src, line, fn, times, nbytes, flops, **extra):
        bound, by = _bound_ms(nbytes, flops, peaks)
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}.cu",
                "replaces": f"src/repro/kernels/agg_reduce.py:{line}",
                "tpu_kernel": f"src/repro/kernels/agg_reduce.py::{fn}",
                "launches": strat_launches[name],
                "launches_per_round": strat_launches[name] / rounds,
                "launches_by_path": {"strategies": strat_launches[name],
                                     "stages": stage_launches[name]},
                "max_abs_err": worst[name], "shape": [c, p], **times,
                "bound_ms": bound, "bound_by": by, **extra}

    m = torch.randn((p,), generator=g).to(dev)
    beta = STRATEGIES["fedavgm"]["momentum"]
    out.append(agg_row(
        "momentum_reduce", "momentum_reduce", 139,
        "_moment_kernel (momentum_reduce_flat)",
        _timed(rotating(lambda x: momentum_reduce_flat(x, w, m, beta=beta)),
               rotating(lambda x: ref_momentum_reduce_flat(x, w, m,
                                                           beta=beta)),
               rotating(lambda x: torch.addmv(m, x.T, w, beta=beta))),
        4 * (c * p + 3 * p + c), 2 * c * p + 2 * p,
        library_call="torch.addmv(m, stacked.T, w, beta=beta): beta*m + "
                     "delta in one call, without delta itself"))
    # the median's trim, (C-1)//2; trimmed_mean's trim of 1 beside it
    trim = (c - 1) // 2
    out.append(agg_row(
        "trimmed_reduce", "trimmed_reduce", 475,
        "_trim_kernel (trimmed_reduce_flat)",
        _timed(rotating(lambda x: trimmed_reduce_flat(x, w, trim=trim)),
               rotating(lambda x: ref_trimmed_flat(x, w, trim=trim)), None),
        4 * (c * p + p + c), c * c * p, trim=trim,
        library_call=None,
        sort_path_note="plain_ms is the dense path's stable torch.sort "
                       "over the clients (not one library call)",
        trim_1={"kernel_ms": _time_ms(rotating(
            lambda x: trimmed_reduce_flat(x, w, trim=1)))[0],
            "plain_ms": _time_ms(rotating(
                lambda x: ref_trimmed_flat(x, w, trim=1)))[0]}))
    # cdist's matrix-product mode is the kernel's expansion form in one
    # call; its direct mode and cuBLAS's Gram alone (not the function)
    # beside it
    out.append(agg_row(
        "pairwise_dists", "pairwise_dists", 522,
        "_pairwise_kernel (pairwise_dists_flat)",
        _timed(rotating(pairwise_dists_flat),
               rotating(ref_pairwise_sq_dists),
               rotating(lambda x: torch.cdist(
                   x, x, compute_mode="use_mm_for_euclid_dist").square())),
        4 * c * p, c * (c + 1) * p,
        library_call="torch.cdist(x, x, compute_mode="
                     "'use_mm_for_euclid_dist').square()",
        f64_mean_err=worst["pairwise_dists_f64"],
        library_calls={
            "cdist_direct": _time_ms(rotating(
                lambda x: torch.cdist(x, x).square()))[0],
            "gram_mm": _time_ms(rotating(lambda x: torch.mm(x, x.T)))[0]}))

    # the DP clip and the transport codecs at the same (C, P), every
    # operand rotated over 4 copies; launches from the DP and codec phase
    priv_launches = {k: sum(r["launches"].get(k, 0)
                            for r in priv_rec.values()) for k in _COUNTED}
    # deltas of about the clip's norm, dp_noise's σ = 0.8 · 0.475
    clip = _DP["clip_norm"]
    sets = [tuple(t.to(dev) for t in (
        torch.randn((c, p), generator=g) * (clip / p ** 0.5),
        torch.randn((c, p), generator=g) * (_DP["noise_multiplier"] * clip),
        torch.randn((c, p), generator=g) * 1e-4,
        torch.rand((c, p), generator=g))) for _ in range(4)]

    def rotating_sets(fn):
        turn = [0]

        def call():
            turn[0] += 1
            return fn(*sets[turn[0] % len(sets)])

        return call

    def private_row(name, line, fn, times, nbytes, flops, **extra):
        bound, by = _bound_ms(nbytes, flops, peaks)
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": f"src/repro/kernels/agg_reduce.py:{line}",
                "tpu_kernel": f"src/repro/kernels/agg_reduce.py::{fn}",
                "launches": priv_launches[name],
                "launches_per_round": priv_launches[name] / rounds,
                "max_abs_err": worst[name], "shape": [c, p], **times,
                "bound_ms": bound, "bound_by": by, "library_call": None,
                **extra}

    # with noise (dp_noise, dp_median's release); the clip alone beside;
    # the design the card picks there, the other design of the same
    # source (its C entry called with width 0: two launches) and, on
    # chip, its phases from the stamped build
    clip_only = _timed(
        rotating_sets(lambda x, n, r, u: clip_reduce_flat(x, w, clip=clip)),
        rotating_sets(lambda x, n, r, u: ref_clip_reduce(x, w, clip=clip)),
        None)
    clip_design = clip_reduce_flat.design
    clip_fn = backend.kernel("clip_reduce", "clip_reduce_launch",
                             _CLIP_ARGTYPES)
    two_launch = {label: _time_ms(rotating_sets(
        lambda x, n, r, u, k=k: _clip_entry(clip_fn, x, n if k else None, w,
                                            clip, "two_launch")))[0]
        for label, k in (("ms", True), ("clip_only_ms", False))}
    phases = None if clip_design != "on_chip" else {
        label: _clip_phases(sets, w, clip, k)
        for label, k in (("noise", True), ("clip_only", False))}
    out.append(private_row(
        "clip_reduce", 211,
        "_clip_reduce_kernel / _clip_reduce_noise_kernel (clip_reduce_flat)",
        _timed(rotating_sets(lambda x, n, r, u: clip_reduce_flat(
            x, w, clip=clip, noise=n)),
            rotating_sets(lambda x, n, r, u: ref_clip_reduce(
                x, w, clip=clip, noise=n)), None),
        4 * (2 * c * p + p + c), 6 * c * p,
        design=clip_design, two_launch=two_launch, phases=phases,
        clip_only={"kernel_ms": clip_only["ms"],
                   "plain_ms": clip_only["plain_ms"],
                   "bound_ms": _bound_ms(4 * (c * p + p + c), 5 * c * p,
                                         peaks)[0]}))
    # every operand (dp_int8_ef's call); int8_ef's (residual and uniforms,
    # no clip) beside
    ef_only = _timed(
        rotating_sets(lambda x, n, r, u: quant_clip_reduce_flat(
            x, w, uniform=u, resid=r)),
        rotating_sets(lambda x, n, r, u: ref_quant_clip_reduce(
            x, w, uniform=u, resid=r)), None)
    out.append(private_row(
        "quant_clip_reduce", 264,
        "_quant_clip_reduce_kernel (quant_clip_reduce_flat)",
        _timed(rotating_sets(lambda x, n, r, u: quant_clip_reduce_flat(
            x, w, clip=clip, noise=n, uniform=u, resid=r)),
            rotating_sets(lambda x, n, r, u: ref_quant_clip_reduce(
                x, w, clip=clip, noise=n, uniform=u, resid=r)), None),
        4 * (5 * c * p + p + c), 14 * c * p,
        design=quant_clip_reduce_flat.design,
        int8_ef={"kernel_ms": ef_only["ms"], "plain_ms": ef_only["plain_ms"],
                 "bound_ms": _bound_ms(4 * (4 * c * p + p + c), 10 * c * p,
                                       peaks)[0]}))
    # with the residual (topk_ef's call); the thresholds, torch.topk
    # outside the kernel in both packages, timed beside (eager)
    taus = [cx.topk_thresholds(st[0], TOPK_FRAC) for st in sets]
    turn = [0]

    def topk_call(fn):
        def call():
            turn[0] += 1
            i = turn[0] % len(sets)
            return fn(sets[i][0], w, taus[i], with_residual=True)
        return call

    thresholds_ms = _time_ms(rotating_sets(
        lambda x, n, r, u: cx.topk_thresholds(x, TOPK_FRAC)),
        graph=False)[1]
    out.append(private_row(
        "topk_reduce", 419, "_topk_kernel (topk_reduce_flat)",
        _timed(topk_call(topk_reduce_flat), topk_call(ref_topk_mask_reduce),
               None),
        4 * (2 * c * p + p + 2 * c), 5 * c * p,
        thresholds={"call": "torch.topk(|u|, k).values[:, -1], "
                            f"k = ceil({TOPK_FRAC}·P), eager",
                    "ms": thresholds_ms}))

    _experiment_timings(out, exp_rec, peaks, attn_bounds, g, dev)
    for r in out:
        e = r["eager_ms"]
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.2f}us")
        print(f"  {r['name']} at {r['shape']}, device (CUDA graph): kernel "
              f"{r['ms'] * 1e3:.2f}us  plain {r['plain_ms'] * 1e3:.2f}us  "
              f"library {lib}  bound {r['bound_ms'] * 1e3:.3f}us "
              f"({r['bound_by']}); eager: kernel {e['kernel'] * 1e3:.2f}us  "
              f"plain {e['plain'] * 1e3:.2f}us")
    pair_row = next(r for r in out if r["name"] == "pairwise_dists")
    print("  pairwise_dists beside it, device: "
          + ", ".join(f"{k} {v * 1e3:.2f}us"
                      for k, v in pair_row["library_calls"].items()))
    clip_row, quant_row, topk_row = out[-3:]
    for label, extra in (("clip_reduce without noise", clip_row["clip_only"]),
                         ("quant_clip_reduce as int8_ef calls it (residual "
                          "and uniforms, no clip)", quant_row["int8_ef"])):
        print(f"  {label}, device: kernel {extra['kernel_ms'] * 1e3:.2f}us  "
              f"plain {extra['plain_ms'] * 1e3:.2f}us  bound "
              f"{extra['bound_ms'] * 1e3:.3f}us")
    print(f"  clip_reduce's design {clip_row['design']}; its two launches at "
          f"the same inputs, device: with noise "
          f"{clip_row['two_launch']['ms'] * 1e3:.2f}us, clip only "
          f"{clip_row['two_launch']['clip_only_ms'] * 1e3:.2f}us")
    for label, ph in (clip_row["phases"] or {}).items():
        print(f"  clip_reduce on chip, {label}, phases (stamped build, median "
              f"per block over 20 calls): tile load {ph['tile_us']:.2f}us "
              f"({4 * c * p / ph['tile_us'] * 1e-6:.2f} TB/s of x), barrier "
              f"wait {ph['barrier_us']:.2f}us, reduce {ph['reduce_us']:.2f}us;"
              f" span {ph['span_us']:.2f}us")
    print(f"  top-k thresholds ({topk_row['thresholds']['call']}): "
          f"{topk_row['thresholds']['ms'] * 1e3:.2f}us")
    print(f"  gpo_attention_fwd at predict's {predict_row['shape']}, device: "
          f"kernel {predict_row['ms'] * 1e3:.2f}us  plain "
          f"{predict_row['plain_ms'] * 1e3:.2f}us  library "
          f"{predict_row['library_ms'] * 1e3:.2f}us  bound "
          f"{predict_row['bound_ms'] * 1e3:.3f}us")
    print(f"  attention forward + backward at {[bh, s_len, nc, HEAD_DIM]}, "
          f"device: kernels (fwd, dq, dk/dv through GPOAttention) "
          f"{chain['kernels_ms'] * 1e3:.2f}us  plain under autograd "
          f"{chain['plain_ms'] * 1e3:.2f}us  SDPA fwd+bwd "
          f"{chain['library_ms'] * 1e3:.2f}us")
    return out


def _experiment_timings(out, exp_rec, peaks, attn_bounds, g, dev) -> None:
    """Phase 5 at the paper experiment's shapes (phase 4e): the attention
    kernels at S 120, num_ctx 60, head_dim 24, with BH = clients x heads
    (a federated step), heads (a centralized step) and held-out groups x
    heads (an eval, the forward only), and the FedAvg reduce at (clients,
    P); each beside its plain version, SDPA (or cuBLAS's gemv) and its
    bound, added to the kernel's row as ``experiment_path`` with phase
    4e's launches."""
    cfg = exp_rec["config"]
    hd, heads, nc = cfg["head_dim"], cfg["heads"], cfg["num_context"] * 5
    s_len = (cfg["num_context"] + cfg["num_target"]) * 5
    band = s_len * nc + (s_len - nc)
    pos = torch.arange(s_len, device=dev)
    mask = (pos[None, :] < nc) | (pos[None, :] == pos[:, None])
    rows = {r["name"]: r for r in out}
    bhs = {"fed": cfg["clients"] * heads, "cen": heads,
           "eval": cfg["eval_groups"] * heads}
    kernels = (("gpo_attention_fwd", None, 0, 4),
               ("gpo_attention_bwd_dq", gpo_attention_bwd_dq, 1, 6),
               ("gpo_attention_bwd_dkdv", gpo_attention_bwd_dkdv, 2, 8))
    for name, bwd, n_out, per_pair in kernels:
        shapes = []
        for path, bh in bhs.items():
            if bwd is not None and path == "eval":
                continue  # no backward in an eval
            q, k, v, do = _attn_inputs(bh, s_len, g, dev, hd=hd, n=4)
            if bwd is None:
                times = _timed(
                    lambda: gpo_attention_fwd(q, k, v, num_ctx=nc),
                    lambda: ref_gpo_attention(q, k, v, num_ctx=nc),
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask))
                nbytes = 4 * bh * (4 * s_len * hd + s_len)
            else:
                o, lse = gpo_attention_fwd(q, k, v, num_ctx=nc)
                ops = (q, k, v, do, lse, (do * o).sum(-1))
                plain = (ref_gpo_attention_bwd_dq if n_out == 1
                         else ref_gpo_attention_bwd_dkdv)
                times = _timed(lambda: bwd(*ops, num_ctx=nc),
                               lambda: plain(*ops, num_ctx=nc), None)
                times["library_ms"] = _bwd_alone(
                    lambda *a: F.scaled_dot_product_attention(
                        *a, attn_mask=mask),
                    [t.clone().requires_grad_() for t in (q, k, v)], do)[0]
                nbytes = 4 * bh * ((4 + n_out) * s_len * hd + 2 * s_len)
            shapes.append({"path": path, "shape": [bh, s_len, nc, hd],
                           **times, **attn_bounds(
                               f"{name} BH={bh} S={s_len} hd={hd}", nbytes,
                               per_pair * bh * band * hd)})
        rows[name]["experiment_path"] = {
            "launches": {p: exp_rec[p]["launches"][name]
                         for p in ("fed", "cen")},
            "rounds": exp_rec["rounds"], "shapes": shapes,
            "library_call": rows[name]["library_call"]}

    # the reduce at (clients, P): 8 rotated copies (73 MB, beyond the 50
    # MB L2), so each call reads its deltas from device memory
    c, p = cfg["clients"], cfg["params"]
    xs = [torch.randn((c, p), generator=g).to(dev) for _ in range(8)]
    w = torch.rand((c,), generator=g) + 0.1
    w = (w / w.sum()).to(dev)
    turn = [0]

    def rotating(fn):
        def call():
            turn[0] += 1
            return fn(xs[turn[0] % len(xs)])
        return call

    times = _timed(rotating(lambda x: fedavg_reduce_flat(x, w)),
                   rotating(lambda x: ref_fedavg_flat(x, w)),
                   rotating(lambda x: w @ x))
    bound, by = _bound_ms(4 * (c * p + p + c), 2 * c * p, peaks)
    rows["fedavg_reduce"]["experiment_path"] = {
        "launches": {"fed": exp_rec["fed"]["launches"]["fedavg_reduce"],
                     "cen": 0},
        "rounds": exp_rec["rounds"],
        "shapes": [{"path": "fed", "shape": [c, p], **times,
                    "bound_ms": bound, "bound_by": by}],
        "library_call": rows["fedavg_reduce"]["library_call"]}
    for name in ("gpo_attention_fwd", "gpo_attention_bwd_dq",
                 "gpo_attention_bwd_dkdv", "fedavg_reduce"):
        xp = rows[name]["experiment_path"]
        for sh in xp["shapes"]:
            lib = ("n/a" if sh["library_ms"] is None
                   else f"{sh['library_ms'] * 1e3:.2f}us")
            print(f"  {name} at the experiment's {sh['path']} shape "
                  f"{sh['shape']}, device (CUDA graph): kernel "
                  f"{sh['ms'] * 1e3:.2f}us  plain {sh['plain_ms'] * 1e3:.2f}"
                  f"us  library {lib}  bound {sh['bound_ms'] * 1e3:.3f}us "
                  f"({sh['bound_by']}); launches in phase 4e "
                  f"{xp['launches']}")


# ---------------------------------------------------------------------------
# Phase 4i: LM training (core/trainer.py) on the card
# ---------------------------------------------------------------------------
def _lm_train_tree_diff(a, b) -> float:
    """max over leaves of max |a - b| over max |b|."""
    return max(float((x.float() - y.float()).abs().max())
               / max(float(y.float().abs().max()), 1e-30)
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def _lm_beyond(a, b) -> int:
    """The entries of payload ``a`` further from ``b`` than a bf16 ulp of
    their value (2^-7 |b|) and ``LM_LORA_PAYLOAD_TOL`` of their leaf's
    largest entry: a bf16 rounding that went the other way moves an
    entry by one ulp, which this does not count."""
    n = 0
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        x, y = x.float(), y.float()
        lim = 2.0 ** -7 * y.abs() + LM_LORA_PAYLOAD_TOL * y.abs().max()
        n += int(((x - y).abs() > lim).sum())
    return n


def _krum_nn_scores(d: torch.Tensor, f: int) -> torch.Tensor:
    """Krum's scores (``core/aggregation.py::krum_scores``, every row
    active) from a (C, C) distance matrix."""
    c = d.shape[0]
    d = torch.where(torch.eye(c, dtype=torch.bool, device=d.device),
                    torch.full_like(d, 1e30), d)
    nn = max(1, min(c - f - 2, c - 1))
    return torch.sort(d, dim=1)[0][:, :nn].sum(dim=1)


class _PairwiseSpy:
    """Stands in for ``kernel_ops.pairwise_dists_flat`` during a Krum
    run: each call's distances are held to the plain version on the same
    (C, P) operand (phase 1's 1e-5·max |x_i|²), and Krum's pick from
    them must be a pick of the plain distances too: its score within
    that tolerance of their least. At C 4 and f 1 a score is one
    nearest-neighbour distance, so the closest pair ties exactly in the
    kernel's symmetric matrix, and the plain version's rounding may
    break the tie the other way; the runs' payloads then part."""

    def __init__(self, f: int):
        self.f, self.calls = f, []

    def __call__(self, x):
        out = pairwise_dists_flat(x)
        plain = ref_pairwise_sq_dists(x)
        atol = 1e-5 * float((x * x).sum(dim=1).max())
        sk, sp = (_krum_nn_scores(d, self.f) for d in (out, plain))
        pick = int(torch.argmin(sk))
        self.calls.append({
            "max_abs_err": float((out - plain).abs().max()), "tol": atol,
            "pick": pick, "plain_pick": int(torch.argmin(sp)),
            "tied": int((sk == sk.min()).sum()) > 1,
            "ok": bool(float((out - plain).abs().max()) <= atol
                       and float(sp[pick] - sp.min()) <= atol)})
        return out


@contextlib.contextmanager
def _spy_pairwise(f: int):
    spy = _PairwiseSpy(f)
    kernel_ops.pairwise_dists_flat = spy
    try:
        yield spy
    finally:
        kernel_ops.pairwise_dists_flat = pairwise_dists_flat


def _lm_train_counts(what: str, want: dict) -> dict:
    """The launches since the last ``_zero_counts``: exactly ``want``
    (kernel -> launches), every other kernel 0."""
    got = {k: n for k, n in _counts().items() if n}
    print(f"    {what}: launches {got or 'none'}")
    if got != {k: n for k, n in want.items() if n}:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return got


class _FedAvgSpy:
    """Stands in for ``kernel_ops.fedavg_reduce_flat`` during a run: it
    calls the wrapper, and on its first call also holds the result
    against the plain version on the same (C, P) operand (phase 1's
    tolerance, 1e-6·(1 + |plain|)); the plain call launches nothing."""

    def __init__(self):
        self.first = None

    def __call__(self, x, w):
        out = fedavg_reduce_flat(x, w)
        if self.first is None:
            plain = ref_fedavg_flat(x, w)
            err, ok = _close(out, plain, 1e-6)
            del plain
            self.first = {"shape": list(x.shape), "max_abs_err": err,
                          "ok": ok}
        return out


@contextlib.contextmanager
def _spy_fedavg():
    spy = _FedAvgSpy()
    kernel_ops.fedavg_reduce_flat = spy
    try:
        yield spy
    finally:
        kernel_ops.fedavg_reduce_flat = fedavg_reduce_flat


@contextlib.contextmanager
def _plain_versions():
    """Every kernel wrapper takes its plain PyTorch version on CUDA
    operands too, after the same contract checks: a run keeps its code
    path (the fused momentum step, the pipeline's fused DP and codec
    reduces) with each kernel swapped for its plain version, and
    launches nothing."""
    real = backend.on_cpu
    backend.on_cpu = lambda what, *ts, dtypes: (
        real(what, *ts, dtypes=dtypes) or True)
    try:
        yield
    finally:
        backend.on_cpu = real


def _lm_fed_batches(cfg, dev, seed: int, rounds: int, spec: dict) -> list:
    """``rounds`` rounds of client-stacked batches (C, local_steps, B,
    S) from ``synthetic_lm_batches``, made once on ``dev``."""
    it = synthetic_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=spec["seq"],
        global_batch=spec["batch"], seed=seed), device=dev)
    return [stack_client_batches(it, spec["clients"], spec["local_steps"])
            for _ in range(rounds)]


def _lm_fed_run(cfg, params, payload, mode: str, run: dict, pallas: bool,
                batches: list, dev, spec=LM_FED) -> dict:
    """``len(batches)`` rounds of the backbone FedAvg (``mode`` "full")
    or FedLoRA round from ``payload``, the aggregation built for the
    kernels (``pallas``; under ``_plain_versions`` each runs its plain
    version) or leafwise, the release draws from the round's device
    generator (the same seed in every run): per-round client losses and
    walls, the final global payload (a copy)."""
    c, steps = spec["clients"], spec["local_steps"]
    # the cache's free blocks back to the card: the full-parameter
    # round's 7.9 GB ravel needs one contiguous block
    torch.cuda.empty_cache()
    agg = make_aggregator(AggConfig(**run.get("agg", {})), num_clients=c,
                          use_pallas=pallas)
    priv = PrivacyConfig(**run.get("privacy", {}))
    comp = CompressionConfig(**run.get("compression", {}))
    opt = lm_adam(spec["lr"])
    kw = dict(agg=agg, privacy=priv, compression=comp,
              use_pallas_aggregation=pallas, seed=SEED)
    rnd = (make_backbone_fedavg_round(cfg, opt, steps, **kw)
           if mode == "full" else
           make_fedlora_round(cfg, params, opt, steps, **kw))
    weights = torch.full((c,), 1.0 / c, device=dev)
    client = broadcast_to_clients(payload, c)
    state = opt.init(client, num_clients=c)
    server = agg.init(payload)
    extra = ((torch.zeros((c, tree_count_params(payload)), device=dev),)
             if comp.enabled and comp.error_feedback else ())
    losses, walls = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rnd(client, state, b, weights, server, *extra)
        client, state, loss, server = out[:4]
        extra = tuple(out[4:])
        losses.append(loss.tolist())
        walls.append((time.perf_counter() - t0) * 1e3)
    final = tree_map(torch.clone, tree_index(client, 0))
    return {"losses": losses, "round_ms": walls, "payload": final}


def _lm_standard(dev, cfg, params, steps: int) -> dict:
    """``steps`` Adam steps of ``make_train_step`` on batches from the
    seed: the losses (which must fall), the median step after the first,
    the peak memory, and no kernel launched."""
    spec = LM_TRAIN_STD
    it = synthetic_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=spec["seq"],
        global_batch=spec["batch"], seed=SEED), device=dev)
    opt = lm_adam(spec["lr"])
    step = make_train_step(cfg, opt)
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, walls = [], []
    for _ in range(steps):
        batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = _lm_train_counts(f"{cfg.name} standard", {})
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec = {"losses": losses, "step_ms": float(np.median(walls[1:])),
           "first_step_ms": walls[0], "peak_gib": peak,
           "launches": launches, "batch": spec["batch"], "seq": spec["seq"],
           "layers": cfg.num_layers}
    print(f"  {cfg.name} standard: {steps} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {rec['step_ms']:.1f} ms a step (median "
          f"after the first), peak {peak:.2f} GiB")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name}: the loss did not fall: {losses}")
    return rec, params


def _lm_f32_cpu(dev) -> dict:
    """(d): qwen2-0.5b at full width, LM_F32_CPU_TRAIN's layers, f32: one
    FedAvg and one FedLoRA round on the card (kernels) against the same
    rounds on the CPU (plain), from the same params and batches."""
    spec = LM_F32_CPU_TRAIN
    cfg = override(get_arch(LM_TRAIN_ARCH), num_layers=spec["layers"],
                   param_dtype="float32", activation_dtype="float32")
    cpu = torch.device("cpu")
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device=cpu)
    lora = init_lora(params, torch.Generator().manual_seed(SEED + 1),
                     rank=LM_LORA_RANK)
    batches = _lm_fed_batches(cfg, cpu, SEED + 2, 1, spec)
    out = {}
    for mode, payload in (("full", params), ("lora", lora)):
        card, host = (_lm_fed_run(
            cfg, tree_map(lambda x: x.to(where), params),
            tree_map(lambda x: x.to(where), payload), mode, {},
            where.type == "cuda",
            [tree_map(lambda x: x.to(where), b) for b in batches], where,
            spec) for where in (dev, cpu))
        loss_err = float(np.abs(np.array(card["losses"])
                                - np.array(host["losses"])).max())
        payload_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree_leaves(card["payload"]), tree_leaves(host["payload"])))
        ok = loss_err <= LM_F32_CPU_TOL and payload_err <= LM_F32_CPU_TOL
        out[mode] = {"loss_max_abs": loss_err,
                     "payload_max_abs": payload_err, "ok": ok}
        print(f"  f32 {mode} round, card against CPU ({cfg.num_layers} "
              f"layers, full width): losses {loss_err:.2e}, payload "
              f"{payload_err:.2e} (tol {LM_F32_CPU_TOL:g})")
        if not ok:
            raise AssertionError(f"f32 {mode} round off the CPU's: {out}")
    return out


def train_lm(dev) -> dict:
    """Phase 4i: LM training at full width through ``core/trainer.py``:
    (a) standard Adam steps on qwen2-0.5b and (a') mamba2-780m; (b) the
    full-parameter backbone FedAvg round through the FedAvg kernel at P
    = 494,032,768, against its plain version on the card; (c) the
    FedLoRA round under each of ``LM_LORA_RUNS`` through its kernel,
    against its plain version on the card; (d) f32 rounds against
    the CPU; (e) the FedLoRA example in both modes; (f)
    ``BackboneEmbedder`` through the flash kernel against the plain
    branch. Every train step launches no flash and no SSD kernel."""
    rec = {"part_s": {}}
    t_phase = time.perf_counter()

    def part(name):  # the seconds since the last part ended
        now = time.perf_counter()
        rec["part_s"][name] = now - t_phase - sum(rec["part_s"].values())
        print(f"  ({name}: {rec['part_s'][name]:.1f}s)")

    cfg = get_arch(LM_TRAIN_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    p_full = tree_count_params(params)
    print(f"  {cfg.name}: {p_full} params ({cfg.param_dtype}, "
          f"{cfg.num_layers} layers, full depth)")
    # (a) standard training, then (a') the SSM family
    rec["standard"], trained = _lm_standard(dev, cfg, params,
                                            LM_TRAIN_STD["steps"])
    ssm_arch, ssm_steps = LM_TRAIN_SSM
    ssm_cfg = get_arch(ssm_arch)
    ssm_params = init_params(ssm_cfg, torch.Generator(device=dev)
                             .manual_seed(SEED), device=dev)
    rec["standard_ssm"], _ = _lm_standard(dev, ssm_cfg, ssm_params,
                                          ssm_steps)
    del ssm_params
    torch.cuda.empty_cache()
    part("a")

    # (b) the full-parameter round through the FedAvg kernel
    batches = _lm_fed_batches(cfg, dev, SEED + 3, LM_FED["rounds"], LM_FED)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with _spy_fedavg() as spy:
        kern = _lm_fed_run(cfg, params, params, "full", {}, True, batches,
                           dev)
    launches = _lm_train_counts("full-parameter fedavg",
                                {"fedavg_reduce": LM_FED["rounds"]})
    peak = torch.cuda.max_memory_allocated() / 2**30
    _zero_counts()
    with _plain_versions():
        plain = _lm_fed_run(cfg, params, params, "full", {}, True, batches,
                            dev)
    _lm_train_counts("full-parameter fedavg (plain versions)", {})
    loss_err = float(np.abs(np.array(kern["losses"])
                            - np.array(plain["losses"])).max())
    full = {"P": p_full, "clients": LM_FED["clients"],
            "launches": launches, "reduce_check": spy.first,
            "losses": kern["losses"], "plain_losses": plain["losses"],
            "loss_max_abs": loss_err,
            "payload_rel": _lm_train_tree_diff(kern["payload"],
                                               plain["payload"]),
            "round_ms": kern["round_ms"], "plain_round_ms": plain["round_ms"],
            "peak_gib": peak}
    print(f"  full-parameter fedavg, {LM_FED['clients']} clients, P = "
          f"{p_full}: the kernel on the round's own (C, P) operand "
          f"max_abs_err {spy.first['max_abs_err']:.3e}; losses against "
          f"the plain versions {loss_err:.2e} (tol "
          f"{LM_TRAIN_LOSS_TOL:g}); rounds {kern['round_ms']} ms; peak "
          f"{peak:.2f} GiB")
    if not (spy.first["ok"] and spy.first["shape"] == [LM_FED["clients"],
                                                       p_full]
            and loss_err <= LM_TRAIN_LOSS_TOL):
        raise AssertionError(f"full-parameter fedavg: {full}")
    rec["fedavg_full"] = full
    del kern, plain
    torch.cuda.empty_cache()
    part("b")

    # (c) FedLoRA under each strategy and stage
    lora = init_lora(params, torch.Generator(device=dev).manual_seed(SEED),
                     rank=LM_LORA_RANK)
    p_lora = tree_count_params(lora)
    lora_rec = {"P": p_lora}
    for label, run in LM_LORA_RUNS.items():
        _zero_counts()
        krum = label == "krum"
        spy = (_spy_pairwise(run["agg"]["num_malicious"]) if krum
               else contextlib.nullcontext())
        with spy as pairs:
            kern = _lm_fed_run(cfg, params, lora, "lora", run, True,
                               batches, dev)
        launches = _lm_train_counts(
            f"fedlora {label}", {LM_LORA_KERNEL[label]: LM_FED["rounds"]})
        _zero_counts()
        with _plain_versions():
            plain = _lm_fed_run(cfg, params, lora, "lora", run, True,
                                batches, dev)
        _lm_train_counts(f"fedlora {label} (plain versions)", {})
        loss_err = float(np.abs(np.array(kern["losses"])
                                - np.array(plain["losses"])).max())
        rel = _lm_train_tree_diff(kern["payload"], plain["payload"])
        beyond = _lm_beyond(kern["payload"], plain["payload"])
        if krum:  # the picks, each call: see _PairwiseSpy
            ok = all(c["ok"] for c in pairs.calls) and len(
                pairs.calls) == LM_FED["rounds"]
        else:
            ok = loss_err <= LM_TRAIN_LOSS_TOL and beyond <= LM_MAX_BEYOND
        lora_rec[label] = {"launches": launches, "losses": kern["losses"],
                           "loss_max_abs": loss_err, "payload_rel": rel,
                           "beyond": beyond,
                           "round_ms": kern["round_ms"],
                           "plain_round_ms": plain["round_ms"], "ok": ok}
        if krum:
            lora_rec[label]["krum_calls"] = pairs.calls
        print(f"  fedlora {label}: P = {p_lora}, against the plain "
              f"versions: losses {loss_err:.2e}, adapters {rel:.2e} of "
              f"their leaf's largest, {beyond} entries beyond a bf16 ulp "
              f"and {LM_LORA_PAYLOAD_TOL:g} of it; rounds "
              f"{[round(x, 1) for x in kern['round_ms']]} ms"
              + (f"; picks {pairs.calls}" if krum else ""))
        if not ok:
            raise AssertionError(f"fedlora {label}: {lora_rec[label]}")
    rec["fedlora"] = lora_rec
    part("c")

    # (d) f32 rounds on the card against the CPU
    rec["f32_cpu"] = _lm_f32_cpu(dev)
    part("d")

    # (e) the example, both modes
    ex = {}
    for mode in ("full", "lora"):
        _zero_counts()
        r = fedlora_finetune.main(["--rounds", str(LM_EXAMPLE_ROUNDS),
                                   "--mode", mode, "--device", str(dev)])
        launches = _lm_train_counts(f"example {mode}", {
            "fedavg_reduce": LM_EXAMPLE_ROUNDS})
        if not (np.isfinite(r["losses"]).all()
                and r["losses"][-1] < r["losses"][0]):
            raise AssertionError(f"example {mode}: {r['losses']}")
        ex[mode] = {**r, "launches": launches}
    rec["example"] = ex
    part("e")

    # (f) BackboneEmbedder through the flash kernel
    tokens = next(synthetic_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_STD["seq"],
        global_batch=LM_TRAIN_STD["batch"], seed=SEED + 4),
        device=dev))["tokens"]
    embs = {}
    for kernels in (True, False):
        emb = BackboneEmbedder(
            lambda p, t, k=kernels: hidden_states(p, cfg, tokens=t,
                                                  use_kernels=k)[0],
            trained, cfg.d_model, LM_EMBED_DIM, seed=SEED, device=dev)
        _zero_counts()
        embs[kernels] = emb.embed_tokens(tokens)
        want = {"flash_attention": cfg.num_layers} if kernels else {}
        launches = _lm_train_counts(f"BackboneEmbedder kernels={kernels}",
                                    want)
    err = float((embs[True] - embs[False]).abs().max())
    rec["embedder"] = {"launches": {"flash_attention": cfg.num_layers},
                       "max_abs": err, "tol": LM_BF16_TOL}
    print(f"  BackboneEmbedder through flash against the plain branch: "
          f"{err:.2e} (tol {LM_BF16_TOL:g})")
    if not (err <= LM_BF16_TOL and torch.isfinite(embs[True]).all()):
        raise AssertionError(f"BackboneEmbedder: {rec['embedder']}")
    part("f")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 4i: {rec['seconds']:.1f}s")
    return rec


def _lm_train_rows(dev, rec: dict, kernels: list, peaks) -> None:
    """Phase 5 for phase 4i: the FedAvg reduce at the full-parameter
    round's (C, P) and the FedAvg and momentum reduces at the LoRA
    payload's, each beside its plain version, cuBLAS's gemv or addmv and
    the card's least time, attached to the kernels' rows; each row's
    launches on the LM training path under ``launches_by_path``."""
    g = _gen(SEED + 5)
    c = LM_FED["clients"]
    torch.cuda.empty_cache()  # (4, 494 M) f32 is one 7.9 GB block
    by_name = {row["name"]: row for row in kernels}
    path = {}
    for part in [rec["fedavg_full"]] + [
            v for k, v in rec["fedlora"].items() if k != "P"] + list(
            rec["example"].values()) + [rec["embedder"]]:
        for k, n in part["launches"].items():
            path[k] = path.get(k, 0) + n
    for k, n in path.items():
        by_name[k].setdefault("launches_by_path", {})["lm_train"] = n
    w = torch.rand((c,), generator=g) + 0.1
    w = (w / w.sum()).to(dev)
    for p, what in ((rec["fedavg_full"]["P"], "full-parameter round"),
                    (rec["fedlora"]["P"], "LoRA payload")):
        x = torch.randn((c, p), generator=g, device="cpu").to(dev)
        big = p > 10**8  # 7.9 GB: few calls a timing
        time_ms = ((lambda f: _time_ms(f, iters=3, reps=3)) if big
                   else _time_ms)
        err, _ = _close(fedavg_reduce_flat(x, w), ref_fedavg_flat(x, w),
                        1e-6)
        ms, plain, lib = (time_ms(f)[0] for f in (
            lambda: fedavg_reduce_flat(x, w),
            lambda: ref_fedavg_flat(x, w), lambda: w @ x))
        bound, by = _bound_ms(4 * (c * p + p + c), 2 * c * p, peaks)
        by_name["fedavg_reduce"].setdefault("lm_train_shapes", []).append({
            "path": what, "shape": [c, p], "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound, "bound_by": by,
            "max_abs_err": err})
        print(f"  fedavg_reduce at ({c}, {p}) ({what}): {ms:.4f} ms, plain "
              f"{plain:.4f}, gemv {lib:.4f}, bound {bound:.4f} ({by})")
        if not big:
            m = torch.randn((p,), generator=g).to(dev)
            beta = STRATEGIES["fedavgm"]["momentum"]
            err = max(_close(a, b, 1e-6)[0] for a, b in zip(
                momentum_reduce_flat(x, w, m, beta=beta),
                ref_momentum_reduce_flat(x, w, m, beta=beta)))
            ms, plain, lib = (time_ms(f)[0] for f in (
                lambda: momentum_reduce_flat(x, w, m, beta=beta),
                lambda: ref_momentum_reduce_flat(x, w, m, beta=beta),
                lambda: torch.addmv(m, x.T, w, beta=beta)))
            bound, by = _bound_ms(4 * (c * p + 3 * p + c),
                                  2 * c * p + 2 * p, peaks)
            by_name["momentum_reduce"].setdefault(
                "lm_train_shapes", []).append({
                    "path": what, "shape": [c, p], "ms": ms,
                    "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                    "bound_by": by, "max_abs_err": err})
            print(f"  momentum_reduce at ({c}, {p}) ({what}): {ms:.4f} ms, "
                  f"plain {plain:.4f}, addmv {lib:.4f}, bound {bound:.4f} "
                  f"({by})")
            del m
        del x
        torch.cuda.empty_cache()


def serve_trained(dev) -> dict:
    """Phase 4j: ``python -m repro_torch.launch.serve --gpo`` in-process
    on the card, as a user runs it: 60 FedAvg rounds through the GPO
    attention kernels (each local step's forward, dq and dk/dv, and the
    evals' forward) and the FedAvg reduce, the checkpoint saved, the
    default trace served int8 (the int8 matmul); then ``--restore``
    serves it f32 (no kernel: the engine's prefix and decode attention
    is its plain split, as phase 2 holds), and once more on the CPU,
    whose rows must match the card's within SERVE_CPU_TOL. The wrappers'
    launches of rows 1-5 held nonzero. The launcher trains under the
    default ``engine="scan"``: one eager warm-up round, then the round's
    CUDA graph captured (its wrappers called once, launching nothing)
    and replayed once a round, so the training and int8 serving run once
    more under the profiler, where the kernels are counted by name: each
    nonzero, the FedAvg reduce once a round and once in the warm-up."""
    ckpt = ROOT / "build" / "serve_4j"
    shutil.rmtree(ckpt, ignore_errors=True)
    base = ["--gpo", "--ckpt-dir", str(ckpt), "--device", str(dev)]
    _zero_counts()
    t0 = time.perf_counter()
    int8 = serve_cli.main(base + ["--agg", "fedavg", "--int8"])
    torch.cuda.synchronize()
    wall_int8 = time.perf_counter() - t0
    launches = {k: v for k, v in _counts().items() if v}
    _zero_counts()
    f32 = serve_cli.main(base + ["--restore"])
    torch.cuda.synchronize()
    launches_f32 = {k: v for k, v in _counts().items() if v}
    cpu = serve_cli.main(["--gpo", "--ckpt-dir", str(ckpt), "--restore",
                          "--device", "cpu"])
    missing = [k for k in SERVE_TRAIN_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 4j launched no {missing}: {launches}")
    if launches_f32:
        raise AssertionError(f"phase 4j f32 serving launched {launches_f32}")
    names = {k: KERNEL_NAMES[k] for k in SERVE_TRAIN_KERNELS}
    prof = _profile(lambda: serve_cli.main(base + ["--agg", "fedavg",
                                                   "--int8"]),
                    trace="serve_train_trace.json",
                    match=[n for ns in names.values() for n in ns])
    by_name = {k: sum(prof["matched"][n]["launches"] for n in ns)
               for k, ns in names.items()}
    if not all(by_name.values()) or launches["fedavg_reduce"] != 2 or \
            by_name["fedavg_reduce"] != SERVE_TRAIN_ROUNDS + 1:
        raise AssertionError(
            f"phase 4j's profile counted {by_name}, the wrappers "
            f"{launches}: under engine=\"scan\" the FedAvg wrapper runs "
            f"in the warm-up and the capture, and the kernel "
            f"{SERVE_TRAIN_ROUNDS} + 1 times (each replay and the warm-up)")
    card = {c.rid: c.pred for c in f32["results"]}
    host = {c.rid: c.pred for c in cpu["results"]}
    if set(card) != set(host) or not card:
        raise AssertionError(f"phase 4j: the card served {sorted(card)}, "
                             f"the CPU {sorted(host)}")
    err = max(float(np.abs(card[r] - host[r]).max()) for r in card)
    if not err <= SERVE_CPU_TOL:
        raise AssertionError(f"phase 4j: the card's f32 rows are {err:.3e} "
                             f"from the CPU's (tol {SERVE_CPU_TOL})")
    keys = ("p50_ms", "p99_ms", "qps", "completed", "hit_rate")
    rec = {"rounds": SERVE_TRAIN_ROUNDS, "train_s": int8["train_s"],
           # the launcher's training seconds over its rounds: the
           # warm-up round, the capture and the evals are in them
           "train_ms_over_rounds": (int8["train_s"] * 1e3
                                    / SERVE_TRAIN_ROUNDS),
           "wall_train_and_int8_s": wall_int8,
           "launches": launches, "launches_f32": launches_f32,
           "replayed_in_profile": by_name,
           "profile": {k: prof[k] for k in ("wall_ms", "kernel_ms",
                                            "kernels", "busy_share")},
           "int8": {k: int8["summary"][k] for k in keys},
           "f32": {k: f32["summary"][k] for k in keys},
           "cpu_f32": {k: cpu["summary"][k] for k in keys},
           "cpu_max_abs": err, "checkpoint": latest_checkpoint(str(ckpt))}
    print(f"  trained {SERVE_TRAIN_ROUNDS} rounds in {rec['train_s']:.2f}s "
          f"({rec['train_ms_over_rounds']:.2f} ms a round, the warm-up, "
          f"the capture and the evals included); int8 p50 "
          f"{rec['int8']['p50_ms']:.2f} p99 {rec['int8']['p99_ms']:.2f} ms "
          f"qps {rec['int8']['qps']:.1f}; f32 p50 {rec['f32']['p50_ms']:.2f}"
          f" p99 {rec['f32']['p99_ms']:.2f} ms qps {rec['f32']['qps']:.1f}; "
          f"CPU rows within {err:.2e}; wrapper launches {launches}; by name "
          f"in the profiled rerun {by_name}")
    return rec


def _meta(batch: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items()}


def _start_sweep(out_dir: Path) -> list:
    """The dry-run sweep, one process an arch, started at once, with no
    card visible to them (the sweep counts on meta)."""
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    return [(arch, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--out",
         str(out_dir / f"{arch}.jsonl"), "--arch", arch], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for arch in ALL_ARCHS]


def _finish_sweep(procs: list, out_dir: Path) -> list:
    """Wait for the sweep's processes (killing them all if one fails or
    outlasts SWEEP_TIMEOUT) and read their records."""
    try:
        for arch, p in procs:
            log, _ = p.communicate(timeout=SWEEP_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"the sweep of {arch} exited "
                                     f"{p.returncode}:\n{log[-3000:]}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = [json.loads(line) for arch, _ in procs
            for line in (out_dir / f"{arch}.jsonl").read_text().splitlines()]
    bad = [(r["arch"], r["shape"]) for r in recs if "error" in r]
    if bad or len(recs) != len(ALL_ARCHS) * 4:
        raise AssertionError(f"the sweep: {len(recs)} records, errors {bad}")
    return recs


def _mfu(flops: float, ms: float, peak: float) -> float:
    return flops / (ms * 1e-3 * peak)


def tooling(dev, lm_train_rec: dict, lm_rec: dict, card_name: str) -> dict:
    """Phase 4k: the dry-run tooling against the card. (a) The sweep of
    all ten archs x four shapes on meta (``launch/sweep.py``), one
    process an arch with no card visible: every record ok, and its
    seconds. (b) Phase 4i's qwen2-0.5b train step: ``analyze_step``'s
    FLOPs counted on meta equal ``FlopCounterMode``'s around the same
    step on the card, exactly. (c) ``lower_pair`` on a (1, 1) mesh at
    phase 4i's shape: params + optimizer + batch bytes no larger than
    4i's measured peak. (d) mfu, ``model_flops`` (6·N·D a train step,
    2·N·D a prefill of D prompt tokens, N the active parameters) over
    (measured time x the bf16 dense peak), of 4i's step and 4d's
    prefills: the model's work, not the plain branch's count, which
    holds the masked half of the causal scores that flash skips."""
    from torch.utils.flop_counter import FlopCounterMode

    rec = {"card": card_name}
    peak = _BF16_PEAKS[_card_row(card_name)]
    out_dir = ROOT / "build" / "sweep_4k"
    t0 = time.perf_counter()
    procs = _start_sweep(out_dir)
    recs = _finish_sweep(procs, out_dir)
    rec["sweep_s"] = time.perf_counter() - t0
    rec["sweep"] = {f"{r['arch']} x {r['shape']}": {
        "count_s": r["count_s"], "bottleneck": r["roofline"]["bottleneck"],
        "flops_per_chip": r["roofline"]["flops_per_chip"],
        "useful_ratio": r["roofline"]["useful_ratio"],
        "argument_bytes": r["memory"]["argument_size_in_bytes"]}
        for r in recs}
    print(f"  (a) sweep: {len(recs)} pairs ok on meta in "
          f"{rec['sweep_s']:.1f}s ({len(ALL_ARCHS)} processes, no card "
          f"visible)")

    # (b) 4i's step, counted on the card and on meta
    cfg, spec = get_arch(LM_TRAIN_ARCH), LM_TRAIN_STD
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    opt = lm_adam(spec["lr"])
    state = opt.init(params)
    batch = next(synthetic_lm_batches(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=spec["seq"],
        global_batch=spec["batch"], seed=SEED), device=dev))
    step = make_train_step(cfg, opt)
    with FlopCounterMode(display=False) as counter:
        step(params, state, batch)
        torch.cuda.synchronize()
    card_flops = float(counter.get_total_flops())
    del params, state
    torch.cuda.empty_cache()
    meta_params = init_params(cfg, None, device="meta")
    meta = analyze_step(step, meta_params, opt.init(meta_params),
                        _meta(batch))
    rec["train_step"] = {"card_flops": card_flops, "meta_flops": meta.flops,
                         "meta_bytes": meta.bytes, "ops": meta.ops}
    print(f"  (b) qwen2-0.5b step ({spec['batch']} x {spec['seq']}): "
          f"{card_flops:.6e} FLOPs counted on the card, {meta.flops:.6e} "
          f"on meta")
    if card_flops != meta.flops:
        raise AssertionError(f"phase 4k: the step's FLOPs on the card "
                             f"{card_flops} != on meta {meta.flops}")

    # (c) the dry run's bytes at 4i's shape on one device
    shape = InputShape("phase_4i", spec["seq"], spec["batch"], "train")
    pair = dryrun.lower_pair(LM_TRAIN_ARCH, shape, verbose=False,
                             mesh=MeshShape((1, 1), ("data", "model")))
    mem = pair["memory"]
    args = mem["params_bytes"] + mem["optimizer_bytes"] + mem["batch_bytes"]
    peak_bytes = lm_train_rec["standard"]["peak_gib"] * 2**30
    rec["lower_pair_1x1"] = {"memory": mem, "args_bytes": args,
                             "phase_4i_peak_bytes": peak_bytes}
    print(f"  (c) lower_pair at 4i's shape on (1, 1): params + optimizer + "
          f"batch {args / 2**30:.3f} GiB, 4i's measured peak "
          f"{peak_bytes / 2**30:.3f} GiB")
    if args > peak_bytes:
        raise AssertionError("phase 4k: the dry run's bytes exceed the "
                             "measured peak")

    # (d) mfu of 4i's step and 4d's prefills, from the model's FLOPs
    step_ms = lm_train_rec["standard"]["step_ms"]
    flops = rl.model_flops(cfg, shape, 1)
    rec["mfu"] = {"lm-train qwen2-0.5b": {
        "flops": flops, "ms": step_ms, "mfu": _mfu(flops, step_ms, peak)}}
    for arch in LM_ARCHS:
        c = _lm_cfg(arch)
        prompt = LM_PROMPTS.get(arch, LM_PROMPT)
        flops = rl.model_flops(
            c, InputShape("phase_4d", prompt, LM_BATCH, "prefill"), 1)
        ms = lm_rec[arch]["prefill_ms"]
        rec["mfu"][f"lm-{arch}"] = {"flops": flops, "ms": ms,
                                    "layers": c.num_layers,
                                    "mfu": _mfu(flops, ms, peak)}
    for name, m in rec["mfu"].items():
        print(f"  (d) {name}: {m['flops']:.4e} model FLOPs in "
              f"{m['ms']:.2f} ms, "
              f"mfu {m['mfu']:.4f} of {peak / 1e12:.0f} TFLOP/s bf16 "
              f"({card_name})")
    return rec


def _ptxas_kernels(log: str) -> list:
    """Each entry function of a ptxas -v report: its name (the template
    argument kept: gpo_attention_fwd_kernel<256>), registers and spill
    bytes."""
    rows = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+((?:gpo_attention|"
                      r"trimmed|gram)_\w*?_kernel)(?:IL[ib](\d+)E"
                      r"(?:L[ib](\d+)E)?)?", ln)
        if m:
            args = ", ".join(a for a in m.groups()[1:] if a is not None)
            rows.append({"kernel": m.group(1) + (f"<{args}>" if args
                                                 else ""),
                         "registers": None, "spill_stores": None,
                         "spill_loads": None})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and rows:
            rows[-1]["spill_stores"] = int(m.group(1))
            rows[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    # the register trimmed kernel's 32 instantiations in one line
    regs = [r for r in rows
            if r["kernel"].startswith("trimmed_reduce_kernel<")]
    return [r for r in rows if r not in regs] + (
        [{"kernel": f"trimmed_reduce_kernel<1..{len(regs)}>",
          "registers": max(r["registers"] or 0 for r in regs),
          "spill_stores": max(r["spill_stores"] or 0 for r in regs),
          "spill_loads": max(r["spill_loads"] or 0 for r in regs)}]
        if regs else [])


def _build_report() -> dict:
    """Each source's nvcc seconds and ptxas -v report, printed: one
    report per kernel (trimmed_reduce has one per C); the sources phase
    4l widened by kernel and width (``_ptxas_kernels``), the others as
    their range of registers and their spills."""
    rec = {"seconds": dict(backend.BUILD_SECONDS), "ptxas": {}}
    for src, log in backend.BUILD_LOG.items():
        if src in COVER_SOURCES:
            rec["ptxas"][src] = _ptxas_kernels(log)
            print(f"  {src}: " + "; ".join(
                f"{r['kernel']} {r['registers']} regs, spills "
                f"{r['spill_stores']}/{r['spill_loads']} B"
                for r in rec["ptxas"][src]))
            continue
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and " 0 bytes spill stores, 0 "
                         "bytes spill loads" not in ln})
        print(f"  {src}: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers a thread, spills: "
              f"{'; '.join(spills) or 'none'}")
    return rec


def _bits_equal(a, b) -> bool:
    """Bit for bit, NaN payloads included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _cover_attention(dev, g) -> dict:
    """Phase 4l (a): the forward, dq and dk/dv kernels at ``COVER_HDS``
    and ``COVER_ATTN`` against their plain versions (o and lse within
    1e-5, the backward within 1e-5·(1 + |plain|)), each call counted as a
    launch of its kernel, two calls bit-equal."""
    out = {}
    for hd in COVER_HDS:
        for bh, s_len, nc in COVER_ATTN:
            q, k, v, do = _attn_inputs(bh, s_len, g, dev, hd, n=4)
            po, plse = ref_gpo_attention(q, k, v, num_ctx=nc)
            plain = ref_gpo_attention_bwd(q, k, v, po, plse, do, num_ctx=nc)
            ops = (q, k, v, do, plse, (do * po).sum(-1))
            before = _counts()
            runs = [(*gpo_attention_fwd(q, k, v, num_ctx=nc),
                     *_attention_bwd(ops, nc)) for _ in range(2)]
            torch.cuda.synchronize()
            moved = {n: _counts()[n] - before[n] for n in before}
            want = {n: (2 if n.startswith("gpo_attention") else 0)
                    for n in before}
            eo = (runs[0][0] - po).abs().max().item()
            el = (runs[0][1] - plse).abs().max().item()
            errs = [_close(a, b, 1e-5) for a, b in zip(runs[0][2:], plain)]
            same = all(_bits_equal(a, b) for a, b in zip(*runs))
            label = f"hd {hd} {bh}x{s_len}x{nc}"
            out[label] = {"o": eo, "lse": el, "dq": errs[0][0],
                          "dk": errs[1][0], "dv": errs[2][0],
                          "repeat_bit_equal": same, "launches": moved}
            print(f"  gpo_attention {label} (built width "
                  f"{head_width_for(hd)}): max_abs_err o {eo:.2e} lse "
                  f"{el:.2e} dq {errs[0][0]:.2e} dk {errs[1][0]:.2e} dv "
                  f"{errs[2][0]:.2e}; repeat bit-equal {same}; launches "
                  f"{ {n: c for n, c in moved.items() if c} }")
            if not (eo <= 1e-5 and el <= 1e-5 and all(ok for _, ok in errs)
                    and torch.isfinite(runs[0][0]).all()):
                raise AssertionError(f"gpo_attention off the plain version "
                                     f"at {label}")
            if not same or moved != want:
                raise AssertionError(f"gpo_attention at {label}: repeat "
                                     f"bit-equal {same}, launches {moved}")
    return out


def _cover_inputs(c, p, dev, seed, ties=False):
    """``_agg_inputs`` drawn on the card (a (1024, 534016) draw on the
    host takes seconds): deltas, normalised weights."""
    gd = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((c, p), generator=gd, device=dev)
    if ties:
        x = torch.round(2 * x) / 2
    w = torch.rand((c,), generator=gd, device=dev) + 0.1
    return x, w / w.sum()


def _cover_reduces(dev) -> dict:
    """Phase 4l (b): the trimmed reduce (trim 0, 1 and the median) and
    the pairwise distances at ``COVER_CS`` clients and ``COVER_P``
    columns against their plain versions, each call a launch of the
    design past 32 clients, two calls bit-equal. The trimmed reduce's
    deltas have ties (values on a grid of 1/2), NaNs in a few entries
    and one column of NaN, and one infinity: NaN and infinity where the
    plain version has them, the rest within 1e-6·(1 + |plain|); the
    pairwise distances within 1e-5·max_i |x_i|^2, exactly symmetric, the
    diagonal exactly 0, and at ``COVER_F64_CS`` clients against float64
    as phase 1 holds the C <= 32 design (``_pairwise_f64``). The plain
    pairwise call is timed (CUDA events): phase 5's row at C 1024 takes
    that time rather than run a call of seconds again."""
    out = {}
    for i, c in enumerate(COVER_CS):
        x, w = _cover_inputs(c, COVER_P, dev, SEED + 40 + i, ties=True)
        x[3, 5] = float("nan")
        x[c // 2, 11] = float("nan")
        x[:, 7] = float("nan")
        x[c - 1, 13] = float("inf")
        design = trimmed_design_for(c)
        for trim in sorted({0, 1, (c - 1) // 2}):
            before = trimmed_reduce_flat.launches
            got = trimmed_reduce_flat(x, w, trim=trim)
            again = trimmed_reduce_flat(x, w, trim=trim)
            moved = trimmed_reduce_flat.launches - before
            plain = ref_trimmed_flat(x, w, trim=trim)
            torch.cuda.synchronize()
            fin = torch.isfinite(plain)
            err, ok = _close(got[fin], plain[fin], 1e-6)
            odd = (torch.equal(torch.isnan(got), torch.isnan(plain))
                   and torch.equal(got[torch.isinf(plain)],
                                   plain[torch.isinf(plain)]))
            same = _bits_equal(got, again)
            label = f"C {c} trim {trim}"
            out[f"trimmed_reduce {label}"] = {
                "max_abs_err": err, "nan_inf_as_plain": odd,
                "nan_columns": int(torch.isnan(got).sum()),
                "repeat_bit_equal": same, "launches": moved,
                "design": design}
            print(f"  trimmed_reduce {label} P={COVER_P} ({design}): "
                  f"max_abs_err {err:.2e} (tol 1e-6*(1+|plain|)); NaN and "
                  f"inf as the plain version {odd} "
                  f"({int(torch.isnan(got).sum())} NaN columns); repeat "
                  f"bit-equal {same}; launches {moved}")
            if not (ok and odd and same and moved == 2
                    and design == "select"):
                raise AssertionError(f"trimmed_reduce at {label}")
        del x, plain, got, again
        x, _ = _cover_inputs(c, COVER_P, dev, SEED + 50 + i)
        design = pairwise_design_for(c)
        before = pairwise_dists_flat.launches
        got = pairwise_dists_flat(x)
        again = pairwise_dists_flat(x)
        moved = pairwise_dists_flat.launches - before
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        plain = ref_pairwise_sq_dists(x)
        b.record()
        b.synchronize()
        atol = 1e-5 * (x * x).sum(dim=1).max().item()
        err = (got - plain).abs().max().item()
        same = _bits_equal(got, again)
        exact = (bool((torch.diagonal(got) == 0).all())
                 and torch.equal(got, got.T))
        rec = out[f"pairwise_dists C {c}"] = {
            "max_abs_err": err, "atol": atol, "repeat_bit_equal": same,
            "diag_zero_symmetric": exact, "launches": moved,
            "design": design, "split": list(pairwise_split(c, COVER_P)),
            "plain_ms": a.elapsed_time(b)}
        print(f"  pairwise_dists C {c} P={COVER_P} ({design}, "
              f"chunk, blocks {pairwise_split(c, COVER_P)}): max_abs_err "
              f"{err:.3e} (tol {atol:.3e}); zero diagonal and symmetric "
              f"{exact}; repeat bit-equal {same}; launches {moved}")
        if not (err <= atol and same and exact and moved == 2
                and torch.isfinite(got).all() and design == "tiled"):
            raise AssertionError(f"pairwise_dists at C {c}")
        del plain, got, again
        if c in COVER_F64_CS:
            f64 = rec["f64"] = _pairwise_f64(x, ("pairwise_one_pass",))
            print(f"  pairwise_dists C {c} P={COVER_P} mean |err| vs "
                  f"float64: f32 expansion form "
                  f"{f64['plain_mean_abs_err']:.3e}; the kernel "
                  f"{f64['kernel']:.3f}x that (limit {PAIRWISE_F64_RATIO}), "
                  f"one-pass control {f64['pairwise_one_pass']:.3f}x")
            _pairwise_f64_verdict(f64, f"C {c}")
        del x
        torch.cuda.empty_cache()
    return out


def _cover_run(label, gcfg, fcfg, data, tr, ev, dev, want) -> dict:
    """3 rounds of ``FederatedGPO`` through the kernels (launches
    counted against ``want``), against the same run on the CPU within
    ``TRAIN_TOL``."""
    fed = FederatedGPO(gcfg, fcfg, data, tr, ev, device=dev)
    _zero_counts()
    t0 = time.perf_counter()
    hist = fed.run(rounds=TRAIN_ROUNDS, engine="loop")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    cpu = FederatedGPO(gcfg, fcfg, data, tr, ev, device="cpu")
    cpu_hist = cpu.run(rounds=TRAIN_ROUNDS, engine="loop")
    agree = _agreement(hist, fed.global_params, cpu_hist, cpu.global_params)
    rec = {"clients": len(tr), "head_dim": gcfg.d_model // gcfg.num_heads,
           "launches": {k: v for k, v in launches.items() if v},
           "wall_ms_per_round": wall / TRAIN_ROUNDS * 1e3,
           "round_loss": hist.round_loss, "agreement_cpu": agree}
    print(f"  {label}: {len(tr)} clients, head_dim {rec['head_dim']}, "
          f"{rec['wall_ms_per_round']:.1f} ms/round; launches "
          f"{rec['launches']}; vs cpu: loss rel "
          f"{agree['round_loss_rel']:.2e} eval {agree['eval_abs']:.2e} "
          f"params {agree['params_max_abs']:.2e}")
    full = {**dict.fromkeys(_COUNTED, 0), **want}
    if launches != full:
        raise AssertionError(f"{label}: launches {launches}, want {full}")
    if not _within(agree):
        raise AssertionError(f"{label}: off the CPU run (tolerance "
                             f"{TRAIN_TOL})")
    return rec


def _cover_dryrun(device) -> dict:
    """Phase 4l's dry run ``--gpo-fed --pallas-attn --clients 8`` on
    ``device``."""
    return dryrun.lower_gpo_round("fedavg", clients=8,
                                  use_pallas_attention=True, verbose=False,
                                  device=device)


def _cover_users(dev, cpu_dryrun: dict | None = None) -> dict:
    """Phase 4l (c): the users the kernels refused before they took
    these shapes, through the kernels against their CPU runs:
    ``benchmarks/bench_round.py``'s round (17 groups, d_model 8 in one
    head: head_dim 8); the paper's 60/40 split of 67 groups (40 training
    clients) under krum and the median; the dry run ``--gpo-fed
    --pallas-attn --clients 8`` (d_model 32 in two heads: head_dim 16),
    its processes' launches and losses."""
    out = {}
    data = make_survey_data(SurveyConfig(num_groups=17, num_questions=16,
                                         d_embed=4, seed=0), _gen(SEED))
    tr, ev = split_groups(data, train_frac=0.6, seed=0)
    gcfg = GPOConfig(d_embed=4, d_model=8, num_layers=1, num_heads=1,
                     d_ff=16)
    fcfg = FedConfig(num_clients=len(tr), local_epochs=6, eval_every=1,
                     num_context=1, num_target=1,
                     use_pallas_attention=True, use_pallas_aggregation=True)
    out["bench_round hd 8"] = _cover_run(
        "bench_round's round", gcfg, fcfg, data, tr, ev, dev,
        {**_attention_launches(gcfg, fcfg, TRAIN_ROUNDS),
         "fedavg_reduce": TRAIN_ROUNDS})

    data = make_survey_data(SurveyConfig(num_groups=67), _gen(SEED))
    tr, ev = split_groups(data, seed=SEED)
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    base = FedConfig(num_clients=len(tr), local_epochs=6, lr=3e-4,
                     eval_every=1, use_pallas_attention=True,
                     use_pallas_aggregation=True)
    for label in ("krum", "median"):
        kern = _strategy_cfg(base, label)
        out[f"{label} C {len(tr)}"] = _cover_run(
            f"{label} over {len(tr)} clients", gcfg, kern, data, tr, ev, dev,
            {**_attention_launches(gcfg, kern, TRAIN_ROUNDS),
             STRATEGY_KERNEL[label]: TRAIN_ROUNDS})
        out[f"{label} C {len(tr)}"]["design"] = (
            pairwise_design_for if label == "krum" else
            trimmed_design_for)(len(tr))

    card = _cover_dryrun(dev)
    cpu = _cover_dryrun("cpu") if cpu_dryrun is None else cpu_dryrun
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        card["client_losses"] + [card["params_sq_norm"]],
        cpu["client_losses"] + [cpu["params_sq_norm"]]))
    launched = {k: n for k, n in card["kernel_launches"].items() if n}
    out["dryrun gpo-fed hd 16"] = {
        "launches": launched, "run_s": card["run_s"],
        "cpu_run_s": cpu["run_s"], "rel_diff_cpu": rel,
        "collective_bytes_by_kind": card["collective_bytes_by_kind"]}
    print(f"  dryrun --gpo-fed --pallas-attn --clients 8 (head_dim 16): "
          f"{card['run_s']}s, launches over the processes {launched}; "
          f"client losses and params' squared norm vs cpu: rel {rel:.2e}")
    if not all(launched.get(k, 0) > 0 for k in (
            "gpo_attention_fwd", "gpo_attention_bwd_dq",
            "gpo_attention_bwd_dkdv")):
        raise AssertionError("the dry run's round ran no attention kernel")
    if rel > TRAIN_TOL["round_loss_rtol"] or (
            card["collective_bytes_by_kind"]
            != cpu["collective_bytes_by_kind"]):
        raise AssertionError("the dry run's round on the card is off its "
                             "CPU run")
    return out


def kernel_coverage(dev, cpu_dryrun: dict | None = None) -> dict:
    """Phase 4l: the GPO attention kernels at head widths other than 24
    and 32, the trimmed and pairwise kernels past 32 clients, and the
    users that need them. ``cpu_dryrun``: the dry run's CPU half, when
    it ran already (``main`` runs it beside phase 1); else it runs here,
    after the card's."""
    t0 = time.perf_counter()
    rec = {"attention": _cover_attention(dev, _gen(SEED + 30)),
           "reduces": _cover_reduces(dev)}
    rec["checks_s"] = time.perf_counter() - t0
    rec["users"] = _cover_users(dev, cpu_dryrun)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _coverage_rows(dev, kernels: list, cover: dict, card_name: str) -> None:
    """Phase 5's rows of phase 4l's shapes, nested in each kernel's row
    under ``coverage``: the attention kernels at ``COVER_ROW_HDS`` (the
    training shape, beside SDPA with the mask), the trimmed reduce
    (median) and the pairwise distances at ``COVER_ROW_CS`` clients
    (beside ``torch.cdist``'s matrix-product mode)."""
    peaks = _peaks(card_name)
    tf32_peak = _TF32_PEAKS[_card_row(card_name)]
    tf32 = (tf32_peak / 3, peaks[1])  # 3xTF32: three products a FMA
    rows = {r["name"]: r for r in kernels}
    g = _gen(SEED + 31)
    bh, s_len, nc = COVER_ATTN[0]
    band = s_len * nc + (s_len - nc)
    pos = torch.arange(s_len, device=dev)
    mask = (pos[None, :] < nc) | (pos[None, :] == pos[:, None])
    users = cover["users"]
    for hd in COVER_ROW_HDS:
        q, k, v, do = _attn_inputs(bh, s_len, g, dev, hd, n=4)
        o, lse = gpo_attention_fwd(q, k, v, num_ctx=nc)
        ops = (q, k, v, do, lse, (do * o).sum(-1))
        leaf = [t.clone().requires_grad_() for t in (q, k, v)]
        sdpa_bwd = _bwd_alone(
            lambda *a: F.scaled_dot_product_attention(*a, attn_mask=mask),
            leaf, do)
        checked = cover["attention"][f"hd {hd} {bh}x{s_len}x{nc}"]
        path = (users["bench_round hd 8"]["launches"] if hd == 8 else {})
        for name, kfn, pfn, lib, n_out, per_pair, err in (
                ("gpo_attention_fwd",
                 lambda: gpo_attention_fwd(q, k, v, num_ctx=nc),
                 lambda: ref_gpo_attention(q, k, v, num_ctx=nc),
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        attn_mask=mask),
                 1, 4, max(checked["o"], checked["lse"])),
                ("gpo_attention_bwd_dq",
                 lambda: gpo_attention_bwd_dq(*ops, num_ctx=nc),
                 lambda: ref_gpo_attention_bwd_dq(*ops, num_ctx=nc), None,
                 1, 6, checked["dq"]),
                ("gpo_attention_bwd_dkdv",
                 lambda: gpo_attention_bwd_dkdv(*ops, num_ctx=nc),
                 lambda: ref_gpo_attention_bwd_dkdv(*ops, num_ctx=nc), None,
                 2, 8, max(checked["dk"], checked["dv"]))):
            times = _timed(kfn, pfn, lib)
            if lib is None:  # SDPA's whole backward, as the hd 32 rows
                times["library_ms"], times["eager_ms"]["library"] = sdpa_bwd
            # fwd: q, k, v read, o and lse written; bwd: q, k, v, do, lse
            # and delta read, each output written
            nbytes = (4 * bh * (4 * s_len * hd + s_len) if n_out == 1
                      and name.endswith("fwd") else
                      4 * bh * ((4 + n_out) * s_len * hd + 2 * s_len))
            bound, by = _bound_ms(nbytes, per_pair * bh * band * hd, tf32)
            entry = {"name": f"{name} hd {hd}", "shape": [bh, s_len, nc, hd],
                     "built_width": head_width_for(hd),
                     "launches": path.get(name, 0),
                     "launches_from": "phase 4l's bench_round round"
                                      if hd == 8 else "no path at this width",
                     "max_abs_err": err, **times, "bound_ms": bound,
                     "bound_by": by}
            rows[name].setdefault("coverage", {})[f"hd {hd}"] = entry
            print(f"  {entry['name']} {entry['shape']}: kernel "
                  f"{times['ms'] * 1e3:.2f}us  plain "
                  f"{times['plain_ms'] * 1e3:.2f}us  SDPA"
                  f"{'' if lib else ' backward'} "
                  f"{times['library_ms'] * 1e3:.2f}us  bound "
                  f"{bound * 1e3:.3f}us ({by})")
        del q, k, v, do, o, lse, ops, leaf
    for c in COVER_ROW_CS:
        xs = [_cover_inputs(c, COVER_P, dev, SEED + 60 + j)
              for j in range(2 if c > 64 else 4)]
        w = xs[0][1]
        xs = [x for x, _ in xs]
        turn = [0]

        def rot(fn):
            def call():
                turn[0] += 1
                return fn(xs[turn[0] % len(xs)])
            return call

        trim = (c - 1) // 2
        # at C 1024 a call of the kernel takes milliseconds and one of
        # each plain version up to seconds (and the sort's scratch is
        # gigabytes, which a graph would keep): fewer calls, the trimmed
        # plain version once after a warm call, eager, and the pairwise
        # one the timed call of phase 4l's check; at C 64 the plain
        # versions (milliseconds a call) over fewer calls than the kernels
        few = dict(iters=3, reps=3) if c > 64 else {}
        kt = _time_ms(rot(lambda x: trimmed_reduce_flat(x, w, trim=trim)),
                      **few)
        plain = rot(lambda x: ref_trimmed_flat(x, w, trim=trim))
        pt = _once_ms(plain) if c > 64 else _time_ms(plain, iters=5, reps=3)
        # the select design's compares: a radix select of the key's 32
        # bits over the C clients for each of the two ranks (one at an
        # odd C's median), then the walk
        selects = 1 if c - 1 - trim == trim else 2
        bound, by = _bound_ms(4 * (c * COVER_P + COVER_P + c),
                              (32 * selects + 1) * c * COVER_P, peaks)
        checked = cover["reduces"][f"trimmed_reduce C {c} trim {trim}"]
        rows["trimmed_reduce"].setdefault("coverage", {})[f"C {c}"] = {
            "name": f"trimmed_reduce C {c}", "shape": [c, COVER_P],
            "trim": trim, "design": trimmed_design_for(c),
            "launches": 0, "launches_from": "no path at this C (phase 4l's "
            "median ran C 40)", "max_abs_err": checked["max_abs_err"],
            "ms": kt[0], "plain_ms": pt[0] if pt[0] is not None else pt[1],
            "library_ms": None,
            "eager_ms": {"kernel": kt[1], "plain": pt[1]},
            "bound_ms": bound, "bound_by": by}
        print(f"  trimmed_reduce C {c} median: kernel {kt[0] * 1e3:.1f}us  "
              f"plain {(pt[0] or pt[1]) * 1e3:.1f}us  bound {bound * 1e3:.2f}us ({by})")
        checked = cover["reduces"][f"pairwise_dists C {c}"]
        kp = _time_ms(rot(pairwise_dists_flat), **few)
        pp = ((None, checked["plain_ms"]) if c > 64 else
              _time_ms(rot(ref_pairwise_sq_dists), iters=5, reps=3))
        lp = _time_ms(rot(lambda x: torch.cdist(
            x, x, compute_mode="use_mm_for_euclid_dist").square()), **few)
        # the C (C + 1) / 2 dot products, each of its FMAs computed as
        # GRAM_TILE_PRODUCTS tensor-core products at the TF32 rate
        bound, by = _bound_ms(4 * c * COVER_P, c * (c + 1) * COVER_P,
                              (tf32_peak / GRAM_TILE_PRODUCTS, peaks[1]))
        rows["pairwise_dists"].setdefault("coverage", {})[f"C {c}"] = {
            "name": f"pairwise_dists C {c}", "shape": [c, COVER_P],
            "design": pairwise_design_for(c),
            "split": list(pairwise_split(c, COVER_P)),
            "launches": 0, "launches_from": "no path at this C (phase 4l's "
            "krum ran C 40)", "max_abs_err": checked["max_abs_err"],
            "ms": kp[0], "plain_ms": pp[0] if pp[0] is not None else pp[1],
            "library_ms": lp[0],
            "library_call": "torch.cdist(x, x, compute_mode="
                            "'use_mm_for_euclid_dist').square()",
            "eager_ms": {"kernel": kp[1], "plain": pp[1], "library": lp[1]},
            "bound_ms": bound, "bound_by": by}
        print(f"  pairwise_dists C {c}: kernel {kp[0] * 1e3:.1f}us  plain "
              f"{(pp[0] or pp[1]) * 1e3:.1f}us  cdist {lp[0] * 1e3:.1f}us  "
              f"bound {bound * 1e3:.2f}us ({by})")
        del xs
        torch.cuda.empty_cache()
    # the 40-client runs' launches on the rows
    for label, name in (("krum", "pairwise_dists"),
                        ("median", "trimmed_reduce")):
        run = next(r for k, r in users.items() if k.startswith(label))
        rows[name].setdefault("launches_by_path", {})[
            f"coverage {label} C {run['clients']}"] = run["launches"][name]


def _limit_flash(dev, g) -> dict:
    """Phase 4m (a): flash at ``LIMIT_FLASH_HDS`` in both dtypes over
    ``LIMIT_FLASH_CASES``, each against the plain version in f32 at
    phase 1's tolerances (``_flash_close``), twice and bit-equal, one
    launch a call; then phase 1's two planted bf16 faults at hd 256."""
    out = {}
    for hd in LIMIT_FLASH_HDS:
        for dtype in (torch.float32, torch.bfloat16):
            for b, s_len, h, kv, kw in LIMIT_FLASH_CASES:
                q = torch.randn((b, h, s_len, hd), generator=g).to(dev, dtype)
                k, v = (torch.randn((b, kv, s_len, hd), generator=g).to(
                    dev, dtype) for _ in range(2))
                before = flash_attention_bhsd.launches
                got = flash_attention_bhsd(q, k, v, **kw)
                again = flash_attention_bhsd(q, k, v, **kw)
                moved = flash_attention_bhsd.launches - before
                plain = ref_attention(q.float(), k.float(), v.float(), **kw)
                torch.cuda.synchronize()
                err, row, ok = _flash_close(got, plain)
                same = _bits_equal(got.float(), again.float())
                label = (f"hd {hd} {str(dtype)[6:]} {b}x{s_len}x{h}x{kv} "
                         f"{kw}")
                out[label] = {"max_abs_err": err, "row_err": row,
                              "built_width": flash_width_for(hd),
                              "repeat_bit_equal": same, "launches": moved}
                print(f"  flash_attention {label} (built width "
                      f"{flash_width_for(hd)}): max_abs_err {err:.3e} (tol "
                      f"{FLASH_TOL[dtype]:g}*(1+|plain|)) row error "
                      f"{row:.3e}; repeat bit-equal {same}; launches "
                      f"{moved}")
                if not (ok and same and moved == 2):
                    raise AssertionError(f"flash_attention at {label}")
    hd = 256
    q = torch.randn((1, 4, 256, hd), generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn((1, 2, 256, hd), generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    f32 = [t.float() for t in (q, k, v)]
    out["controls hd 256"] = [
        _flash_control("window 8 for 7, hd 256",
                       flash_attention_bhsd(q, k, v, window=8, softcap=20.0),
                       ref_attention(*f32, window=7, softcap=20.0)),
        _flash_control("the last key tile dropped, non-causal, hd 256",
                       flash_attention_bhsd(q, k, v, causal=False,
                                            kv_len=256 - 64),
                       ref_attention(*f32, causal=False))]
    return out


def _limit_ssd(dev, g) -> dict:
    """Phase 4m (b): the SSD scan at ``LIMIT_SSD`` (chunk 256, p 128, n
    256, each alone), f32 and bf16, with the final state, against the
    plain version at phase 1's tolerances (bf16 also by each row of y),
    twice and bit-equal, one launch a call."""
    out = {}
    for b, s_len, h, p, n, chunk in LIMIT_SSD:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(g, dev, dtype, b, s_len, h, p, n)
            before = ssd_scan_bhsp.launches
            y, state = ssd_scan_bhsp(*args, chunk=chunk, return_state=True)
            y2, state2 = ssd_scan_bhsp(*args, chunk=chunk, return_state=True)
            moved = ssd_scan_bhsp.launches - before
            fy, pstate = ref_ssd(*_f32(*args))
            torch.cuda.synchronize()
            ey, oky = _close(y.float(), fy.to(dtype).float(), SSD_TOL[dtype])
            es, oks = _close(state, pstate, SSD_TOL[torch.float32])
            row = _row_rel(y, fy) if dtype == torch.bfloat16 else 0.0
            same = _bits_equal(y.float(), y2.float()) and _bits_equal(
                state, state2)
            label = f"{str(dtype)[6:]} {b}x{s_len}x{h}x{p}x{n} chunk {chunk}"
            out[label] = {"y_max_abs_err": ey, "state_max_abs_err": es,
                          "row_err": row, "repeat_bit_equal": same,
                          "launches": moved}
            print(f"  ssd_scan {label}: y max_abs_err {ey:.3e} (tol "
                  f"{SSD_TOL[dtype]:g}*(1+|plain|)) row error {row:.3e} "
                  f"(limit {SSD_BF16_ROW_TOL:g}) state max_abs_err {es:.3e}; "
                  f"repeat bit-equal {same}; launches {moved}")
            if not (oky and oks and row <= SSD_BF16_ROW_TOL and same
                    and moved == 2):
                raise AssertionError(f"ssd_scan at {label}")
    return out


def _twice(fn, counter) -> tuple:
    """Two calls of ``fn`` (a wrapper whose launches ``counter`` counts):
    the first result, whether the two are bit-equal, the launches."""
    before = counter.launches
    a, b = fn(), fn()
    moved = counter.launches - before
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    return a, all(x is None or _bits_equal(x, y) for x, y in pairs), moved


def _limit_reduces(dev) -> dict:
    """Phase 4m (c): the trimmed register design's NaN columns (C.13) at
    ``LIMIT_NAN_CS`` against the plain version (NaN exactly where it is,
    the rest within 1e-6·(1 + |plain|)); the clip and quant reduces at
    ``LIMIT_ROW_C`` clients (with and without noise; int8 with error
    feedback alone and under the DP release), clip within
    1e-5·(1 + |plain|) and quant as phase 1 holds it (``_quant_close``);
    the trimmed reduce (trim
    1 and the median) and the pairwise distances at ``LIMIT_WIDE_CS``
    clients as phase 4l holds them. Each twice, bit-equal, one launch a
    call, the design that ran printed."""
    out = {}
    gd = torch.Generator(device=dev).manual_seed(SEED + 70)
    for c in LIMIT_NAN_CS:
        x = torch.round(2 * torch.randn((c, 64), generator=gd,
                                        device=dev)) / 2
        x[1, 3] = float("nan")
        x[c - 1, 5] = float("inf")
        x[0, 7] = -float("inf")
        x[:, 11] = float("nan")
        w = torch.rand((c,), generator=gd, device=dev) + 0.1
        for trim in (1, (c - 1) // 2):
            got, same, moved = _twice(
                lambda: trimmed_reduce_flat(x, w, trim=trim),
                trimmed_reduce_flat)
            plain = ref_trimmed_flat(x, w, trim=trim)
            fin = torch.isfinite(plain)
            err, ok = _close(got[fin], plain[fin], 1e-6)
            nan = torch.equal(torch.isnan(got), torch.isnan(plain))
            cols = torch.isnan(got).nonzero().flatten().tolist()
            label = f"trimmed_reduce NaN C {c} trim {trim}"
            out[label] = {"max_abs_err": err, "nan_columns": cols,
                          "nan_as_plain": nan, "repeat_bit_equal": same,
                          "launches": moved}
            print(f"  {label}: NaN columns {cols} as the plain version's "
                  f"{nan}; max_abs_err {err:.2e}; repeat bit-equal {same}; "
                  f"launches {moved}")
            if not (ok and nan and set(cols) >= {3, 5, 7, 11} and same
                    and moved == 2):
                raise AssertionError(label)
    c = LIMIT_ROW_C
    for p in LIMIT_ROW_PS:
        x = torch.randn((c, p), generator=gd, device=dev)
        noise, resid = (0.01 * torch.randn((c, p), generator=gd, device=dev)
                        for _ in range(2))
        uni = torch.rand((c, p), generator=gd, device=dev)
        w = torch.rand((c,), generator=gd, device=dev) + 0.1
        w = w / w.sum()
        clip = float(x.norm(dim=1).median())
        level = (x.abs().max() + noise.abs().max()
                 + resid.abs().max()).item() / 127.0
        for label, fn, pfn, counter in (
                ("clip_reduce noise",
                 lambda: clip_reduce_flat(x, w, clip=clip, noise=noise),
                 lambda: ref_clip_reduce(x, w, clip=clip, noise=noise),
                 clip_reduce_flat),
                ("clip_reduce",
                 lambda: clip_reduce_flat(x, w, clip=clip),
                 lambda: ref_clip_reduce(x, w, clip=clip), clip_reduce_flat),
                ("quant_clip_reduce int8_ef",
                 lambda: quant_clip_reduce_flat(x, w, uniform=uni,
                                                resid=resid),
                 lambda: ref_quant_clip_reduce(x, w, uniform=uni,
                                               resid=resid),
                 quant_clip_reduce_flat),
                ("quant_clip_reduce dp_int8_ef",
                 lambda: quant_clip_reduce_flat(
                     x, w, clip=clip, noise=noise, uniform=uni, resid=resid),
                 lambda: ref_quant_clip_reduce(
                     x, w, clip=clip, noise=noise, uniform=uni, resid=resid),
                 quant_clip_reduce_flat)):
            got, same, moved = _twice(fn, counter)
            plain = pfn()
            design = counter.design
            if isinstance(got, tuple):  # phase 1's rule for the quant
                err, flips, ok = _quant_close(got, plain, level)
                tol = f"2e-5+level={2e-5 + level:.3e}"
            else:
                (err, ok), flips = _close(got, plain, 1e-5), 0
                tol = "1e-5*(1+|plain|)"
            key = f"{label} C {c} P {p}"
            out[key] = {"max_abs_err": err, "coords_beyond_2e-5": flips,
                        "design": design, "repeat_bit_equal": same,
                        "launches": moved}
            print(f"  {key} ({design}): max_abs_err {err:.2e} (tol {tol}); "
                  f"coords beyond 2e-5 {flips}; repeat bit-equal {same}; "
                  f"launches {moved}")
            if not (ok and same and moved == 2):
                raise AssertionError(key)
        del x, noise, resid, uni
    for c in LIMIT_WIDE_CS:
        x, w = _cover_inputs(c, LIMIT_WIDE_P, dev, SEED + 80 + c, ties=True)
        for trim in (1, (c - 1) // 2):
            got, same, moved = _twice(
                lambda: trimmed_reduce_flat(x, w, trim=trim),
                trimmed_reduce_flat)
            err, ok = _close(got, ref_trimmed_flat(x, w, trim=trim), 1e-6)
            key = f"trimmed_reduce C {c} trim {trim}"
            out[key] = {"max_abs_err": err,
                        "design": trimmed_design_for(c),
                        "repeat_bit_equal": same, "launches": moved}
            print(f"  {key} P={LIMIT_WIDE_P} ({trimmed_design_for(c)}): "
                  f"max_abs_err {err:.2e}; repeat bit-equal {same}; "
                  f"launches {moved}")
            if not (ok and same and moved == 2):
                raise AssertionError(key)
        x, _ = _cover_inputs(c, LIMIT_WIDE_P, dev, SEED + 90 + c)
        got, same, moved = _twice(lambda: pairwise_dists_flat(x),
                                  pairwise_dists_flat)
        atol = 1e-5 * (x * x).sum(dim=1).max().item()
        err = (got - ref_pairwise_sq_dists(x)).abs().max().item()
        exact = (bool((torch.diagonal(got) == 0).all())
                 and torch.equal(got, got.T))
        key = f"pairwise_dists C {c}"
        out[key] = {"max_abs_err": err, "atol": atol,
                    "diag_zero_symmetric": exact,
                    "split": list(pairwise_split(c, LIMIT_WIDE_P)),
                    "repeat_bit_equal": same, "launches": moved}
        print(f"  {key} P={LIMIT_WIDE_P} (tiled, chunk, blocks "
              f"{pairwise_split(c, LIMIT_WIDE_P)}): max_abs_err {err:.3e} "
              f"(tol {atol:.3e}); zero diagonal and symmetric {exact}; "
              f"repeat bit-equal {same}; launches {moved}")
        if not (err <= atol and exact and same and moved == 2):
            raise AssertionError(key)
        del x
    return out


def _limit_users(dev) -> dict:
    """Phase 4m (d): the users that need the new shapes, through the
    kernels against their plain branches on the card: each ``LIMIT_LM``
    config's prefill (bf16 within LM_BF16_TOL, or 1.5x the plain
    branch's own rounding floor as phase 4d bounds mamba2; f32 within
    LM_F32_TOL), its launches counted from 0; ``private_delta_flat`` on
    ``LIMIT_ROW_C`` client rows under FedAvg and the median; the
    registry's median and krum on ``LIMIT_WIDE_CS[0]`` rows."""
    out = {}
    for arch, kw in LIMIT_LM.items():
        for dtype in ("bfloat16", "float32"):
            cfg = override(get_arch(arch), param_dtype=dtype,
                           activation_dtype=dtype, **kw)
            gen = torch.Generator(device=dev).manual_seed(SEED + 5)
            params = init_params(cfg, gen, device=dev)
            batch = _lm_batch(cfg, gen, LIMIT_LM_BATCH, LIMIT_LM_PROMPT)
            plain = make_prefill_step(cfg, LIMIT_LM_PROMPT + 1,
                                      use_kernels=False)(params, batch)[0]
            _zero_counts()
            last = make_prefill_step(cfg, LIMIT_LM_PROMPT + 1,
                                     use_kernels=True)(params, batch)[0]
            torch.cuda.synchronize()
            launches = {k: n for k, n in _counts().items() if n}
            rel = _rel_max(last, plain)
            floor = None
            if dtype == "float32":
                bound = LM_F32_TOL
            else:
                reorder = LM_ARCHS[arch][2]
                if reorder:
                    floor = _plain_floor(cfg, reorder, params, batch, plain)
                bound = max(LM_BF16_TOL, LM_FLOOR_FACTOR * (floor or 0.0))
            want = _lm_launches(cfg)
            label = f"{arch} {dtype}"
            out[label] = {"overrides": kw, "launches": launches,
                          "rel_logits_vs_plain": rel, "bound": bound,
                          "plain_floor": floor}
            print(f"  {arch} ({kw}), {dtype}, batch {LIMIT_LM_BATCH}, prompt "
                  f"{LIMIT_LM_PROMPT}: last logits kernel vs plain branch "
                  f"max_abs/max|logit| {rel:.3e} (bound {bound:.3e}); "
                  f"launches {launches}")
            if not (rel <= bound and launches == want
                    and torch.isfinite(last).all()):
                raise AssertionError(f"{label}: off the plain branch or "
                                     f"launches {launches}, want {want}")
            del params, plain, last
            torch.cuda.empty_cache()
    gd = torch.Generator(device=dev).manual_seed(SEED + 95)
    c, p = LIMIT_ROW_C, LIMIT_ROW_PS[0]
    vecs = torch.randn((c, p), generator=gd, device=dev) * 0.1
    noise = torch.randn((c, p), generator=gd, device=dev) * 0.01
    w = torch.rand((c,), generator=gd, device=dev) + 0.1
    w = w / w.sum()
    privacy = PrivacyConfig(clip_norm=float(vecs.norm(dim=1).median()),
                            noise_multiplier=0.8)
    for name, kernel in (("fedavg", "clip_reduce"),
                         ("median", "trimmed_reduce")):
        got = {}
        for pallas in (True, False):
            agg = make_aggregator(AggConfig(name=name), num_clients=c,
                                  use_pallas=pallas)
            _zero_counts()
            got[pallas] = dp.private_delta_flat(vecs, w, noise, privacy, agg,
                                                use_pallas=pallas)
            torch.cuda.synchronize()
            if pallas:
                launches = {k: n for k, n in _counts().items() if n}
        err, ok = _close(got[True], got[False],
                         1e-5 if name == "fedavg" else 1e-6)
        label = f"private_delta_flat {name} C {c}"
        out[label] = {"max_abs_err": err, "launches": launches}
        print(f"  {label} P={p}: kernels vs plain on the card max_abs_err "
              f"{err:.2e}; launches {launches}")
        if not (ok and launches == {kernel: 1}):
            raise AssertionError(label)
    c = LIMIT_WIDE_CS[0]
    vecs, w = _cover_inputs(c, LIMIT_WIDE_P, dev, SEED + 96)
    for name, kernel, cfg in (
            ("median", "trimmed_reduce", AggConfig(name="median")),
            ("krum", "pairwise_dists", AggConfig(name="krum",
                                                 num_malicious=3))):
        got = {}
        for pallas in (True, False):
            agg = make_aggregator(cfg, num_clients=c, use_pallas=pallas)
            _zero_counts()
            got[pallas] = agg.reduce_flat(vecs, w)
            torch.cuda.synchronize()
            if pallas:
                launches = {k: n for k, n in _counts().items() if n}
        err, ok = _close(got[True], got[False], 1e-6)
        if name == "krum":  # the same row picked
            ok = torch.equal(got[True], got[False])
        label = f"{name} C {c}"
        out[label] = {"max_abs_err": err, "launches": launches}
        print(f"  the registry's {label} P={LIMIT_WIDE_P}: kernels vs plain "
              f"on the card max_abs_err {err:.2e}; launches {launches}")
        if not (ok and launches == {kernel: 1}):
            raise AssertionError(label)
    return out


def kernel_limits(dev) -> dict:
    """Phase 4m: the kernels at the shapes they refused before (flash
    head widths 1-256, the SSD scan past its tiles, clip and quant past
    4096 clients, trimmed and pairwise past 1024) and the trimmed
    register design's NaN columns, then the users that need them."""
    t0 = time.perf_counter()
    g = _gen(SEED + 60)
    rec = {"flash": _limit_flash(dev, g), "ssd": _limit_ssd(dev, g),
           "reduces": _limit_reduces(dev)}
    rec["checks_s"] = time.perf_counter() - t0
    rec["users"] = _limit_users(dev)
    rec["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return rec


def _limit_rows(dev, kernels: list, limits: dict, card_name: str) -> None:
    """Phase 5's rows of phase 4m's shapes, nested in each kernel's row
    under ``limits``, each held once to its plain version where it is
    timed: flash at ``LIMIT_TIME_FLASH`` (bf16, causal; beside SDPA), the
    SSD scan at mamba2-780m's prefill widths at chunk 256 (chunk 128's
    kernel time beside it), clip and quant at ``LIMIT_TIME_ROW_C``
    clients and trimmed (the median) and pairwise (beside
    ``torch.cdist``'s matrix-product mode) at ``LIMIT_TIME_WIDE_C``, P
    ``LIMIT_WIDE_P``. Launches: phase 4m's users' where one ran the
    shape, else 0."""
    peaks = _peaks(card_name)
    bf_peaks = (_BF16_PEAKS[_card_row(card_name)], peaks[1])
    tf32_peak = _TF32_PEAKS[_card_row(card_name)]
    rows = {r["name"]: r for r in kernels}
    users = limits["users"]
    g = _gen(SEED + 61)
    bf = torch.bfloat16

    def put(name, label, entry):
        rows[name].setdefault("limits", {})[label] = entry
        lib = entry.get("library_ms")
        print(f"  {name} {label} {entry['shape']}: kernel "
              f"{entry['ms'] * 1e3:.2f}us  plain "
              f"{entry['plain_ms'] * 1e3:.2f}us  library "
              f"{'n/a' if lib is None else f'{lib * 1e3:.2f}us'}  bound "
              f"{entry['bound_ms'] * 1e3:.3f}us ({entry['bound_by']}); "
              f"max_abs_err {entry['max_abs_err']:.3e}; launches "
              f"{entry['launches']}")

    gemma = users["gemma2-27b bfloat16"]["launches"].get("flash_attention",
                                                           0)
    for row, (b, h, kv, s_len, hd) in LIMIT_TIME_FLASH.items():
        q = torch.randn((b, h, s_len, hd), generator=g).to(dev, bf)
        k, v = (torch.randn((b, kv, s_len, hd), generator=g).to(dev, bf)
                for _ in range(2))
        err, rerr, ok = _flash_close(flash_attention_bhsd(q, k, v),
                                     ref_attention(q.float(), k.float(),
                                                   v.float()))
        if not ok:
            raise AssertionError(f"flash_attention off the plain version "
                                 f"at row {row}")
        times = _timed(lambda: flash_attention_bhsd(q, k, v),
                       lambda: ref_attention(q, k, v),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, is_causal=True, enable_gqa=True))
        band = s_len * (s_len + 1) // 2
        bound, by = _bound_ms(2 * (2 * b * h * s_len * hd
                                   + 2 * b * kv * s_len * hd),
                              4 * b * h * band * hd, bf_peaks)
        put("flash_attention", row, {
            "name": f"flash_attention hd {hd}", "shape": [b, h, kv, s_len, hd],
            "dtype": "bfloat16", "causal": True,
            "built_width": flash_width_for(hd),
            "launches": gemma if hd == 256 else 0,
            "launches_from": ("phase 4m's 2-layer gemma2-27b at Gemma 2 "
                              "9B's widths, bf16 prefill" if hd == 256 else
                              "no path at this width"),
            "max_abs_err": err, "row_err": rerr, **times,
            "library_call": "F.scaled_dot_product_attention(q, k, v, "
                            "is_causal=True, enable_gqa=True)",
            "bound_ms": bound, "bound_by": by})
        del q, k, v
    torch.cuda.empty_cache()

    # the SSD scan at mamba2-780m's prefill (b 4, s 2048, h 48, p 64, n
    # 128, bf16, with the state) at chunk 256, and chunk 128 beside
    b, s_len, h, p, n, chunk = LM_BATCH, LM_PROMPT, 48, 64, 128, 256
    args = _ssd_inputs(g, dev, bf, b, s_len, h, p, n)
    y, state = ssd_scan_bhsp(*args, chunk=chunk, return_state=True)
    py, pstate = ref_ssd(*_f32(*args))
    ey, oky = _close(y.float(), py.to(bf).float(), SSD_TOL[bf])
    es, oks = _close(state, pstate, SSD_TOL[torch.float32])
    if not (oky and oks and _row_rel(y, py) <= SSD_BF16_ROW_TOL):
        raise AssertionError("ssd_scan off the plain version at chunk 256")
    del y, state, py, pstate
    ms, eager = _time_ms(lambda: ssd_scan_bhsp(*args, chunk=chunk,
                                               return_state=True))
    at128 = _time_ms(lambda: ssd_scan_bhsp(*args, chunk=128,
                                           return_state=True))[0]
    plain, plain_eager = _time_ms(lambda: ref_ssd(*args), iters=1, reps=3)
    tri = chunk * (chunk + 1) // 2
    bound, by = _bound_ms(
        2 * (2 * b * s_len * h * p + 2 * b * s_len * n)
        + 4 * (b * s_len * h + 2 * h) + 4 * b * h * p * n,
        b * h * (s_len // chunk) * 2 * (tri * n + tri * p + 2 * chunk * p
                                        * n), bf_peaks)
    put("ssd_scan", "13d", {
        "name": "ssd_scan chunk 256", "shape": [b, s_len, h, p, n, chunk],
        "dtype": "bfloat16",
        "launches": users["mamba2-780m bfloat16"]["launches"].get(
            "ssd_scan", 0),
        "launches_from": "phase 4m's 2-layer mamba2-780m at chunk 256, "
                         "bf16 prefill (batch 2, prompt 1024)",
        "max_abs_err": max(ey, es), "ms": ms, "kernel_ms": ms,
        "chunk_128_ms": at128, "plain_ms": plain, "library_ms": None,
        "eager_ms": {"kernel": eager, "plain": plain_eager,
                     "library": None},
        "bound_ms": bound, "bound_by": by})
    del args
    torch.cuda.empty_cache()

    # clip (with noise) and quant (every operand) at LIMIT_TIME_ROW_C
    c, p = LIMIT_TIME_ROW_C, LIMIT_WIDE_P
    gd = torch.Generator(device=dev).manual_seed(SEED + 62)
    x = torch.randn((c, p), generator=gd, device=dev)
    noise, resid = (0.01 * torch.randn((c, p), generator=gd, device=dev)
                    for _ in range(2))
    uni = torch.rand((c, p), generator=gd, device=dev)
    w = torch.rand((c,), generator=gd, device=dev) + 0.1
    w = w / w.sum()
    clip = float(x.norm(dim=1).median())
    level = (x.abs().max() + noise.abs().max()
             + resid.abs().max()).item() / 127.0
    for name, row, kfn, pfn, nbytes, flops in (
            ("clip_reduce", "7c",
             lambda: clip_reduce_flat(x, w, clip=clip, noise=noise),
             lambda: ref_clip_reduce(x, w, clip=clip, noise=noise),
             4 * (2 * c * p + p + c), 6 * c * p),
            ("quant_clip_reduce", "8c",
             lambda: quant_clip_reduce_flat(x, w, clip=clip, noise=noise,
                                            uniform=uni, resid=resid),
             lambda: ref_quant_clip_reduce(x, w, clip=clip, noise=noise,
                                           uniform=uni, resid=resid),
             4 * (5 * c * p + p + c), 14 * c * p)):
        got, want = kfn(), pfn()
        if isinstance(got, tuple):
            err, _, ok = _quant_close(got, want, level)
        else:
            err, ok = _close(got, want, 1e-5)
        del got, want
        if not ok:
            raise AssertionError(f"{name} off the plain version at C {c}")
        bound, by = _bound_ms(nbytes, flops, peaks)
        put(name, row, {
            "name": f"{name} C {c}", "shape": [c, p],
            "design": _COUNTED[name].design, "launches": 0,
            "launches_from": f"no path at this C (phase 4m's DP release "
                             f"ran C {LIMIT_ROW_C})",
            "max_abs_err": err, **_timed(kfn, pfn, None),
            "bound_ms": bound, "bound_by": by})
    del x, noise, resid, uni
    torch.cuda.empty_cache()

    # trimmed (the median) and pairwise at LIMIT_TIME_WIDE_C
    c = LIMIT_TIME_WIDE_C
    x, w = _cover_inputs(c, p, dev, SEED + 63)
    trim = (c - 1) // 2
    err, ok = _close(trimmed_reduce_flat(x, w, trim=trim),
                     ref_trimmed_flat(x, w, trim=trim), 1e-6)
    if not ok:
        raise AssertionError(f"trimmed_reduce off the plain version at C {c}")
    kt = _time_ms(lambda: trimmed_reduce_flat(x, w, trim=trim))
    pt = _time_ms(lambda: ref_trimmed_flat(x, w, trim=trim))
    bound, by = _bound_ms(4 * (c * p + p + c), (32 * 2 + 1) * c * p, peaks)
    put("trimmed_reduce", "10d", {
        "name": f"trimmed_reduce C {c}", "shape": [c, p], "trim": trim,
        "design": trimmed_design_for(c),
        "launches": 0, "launches_from": f"no path at this C (phase 4m's "
        f"median ran C {LIMIT_WIDE_CS[0]})", "max_abs_err": err,
        "ms": kt[0], "plain_ms": pt[0], "library_ms": None,
        "eager_ms": {"kernel": kt[1], "plain": pt[1]},
        "bound_ms": bound, "bound_by": by})
    got = pairwise_dists_flat(x)
    pp = _once_ms(lambda: ref_pairwise_sq_dists(x))
    err = (got - ref_pairwise_sq_dists(x)).abs().max().item()
    atol = 1e-5 * (x * x).sum(dim=1).max().item()
    if not err <= atol:
        raise AssertionError(f"pairwise_dists off the plain version at C {c}")
    del got
    kp = _time_ms(lambda: pairwise_dists_flat(x))
    lp = _time_ms(lambda: torch.cdist(
        x, x, compute_mode="use_mm_for_euclid_dist").square())
    bound, by = _bound_ms(4 * c * p, c * (c + 1) * p,
                          (tf32_peak / GRAM_TILE_PRODUCTS, peaks[1]))
    put("pairwise_dists", "11d", {
        "name": f"pairwise_dists C {c}", "shape": [c, p],
        "design": pairwise_design_for(c),
        "split": list(pairwise_split(c, p)), "launches": 0,
        "launches_from": f"no path at this C (phase 4m's krum ran C "
                         f"{LIMIT_WIDE_CS[0]})", "max_abs_err": err,
        "ms": kp[0], "plain_ms": pp[1], "library_ms": lp[0],
        "library_call": "torch.cdist(x, x, compute_mode="
                        "'use_mm_for_euclid_dist').square()",
        "eager_ms": {"kernel": kp[1], "plain": pp[1], "library": lp[1]},
        "bound_ms": bound, "bound_by": by})
    del x
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    dev = backend.resolve_device("cuda")
    t_run = time.perf_counter()

    def _lap():  # the run's clock after each phase
        print(f"  [{time.perf_counter() - t_run:.1f}s into the run]")

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32, stated
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} ({card}); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off")

    t0 = time.perf_counter()
    _start_control_builds()  # phase 1's planted controls, alongside
    paths = backend.build()
    print(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.1f}s; "
          "each source's nvcc, seconds: " + ", ".join(
              f"{k} {v:.1f}" for k, v in sorted(
                  backend.BUILD_SECONDS.items(), key=lambda kv: kv[1])))
    build_rec = _build_report()

    # phase 4l's dry run on the CPU, in processes of its own (it reads no
    # card), beside phase 1's checks, which time nothing; it is waited
    # for before phase 4i, whose step and rounds are timed
    with ThreadPoolExecutor(1) as pool:
        cpu_dryrun = pool.submit(_cover_dryrun, "cpu")
        print("[1] kernels against their plain versions on the card")
        worst = check_kernels(dev)
        _lap()
        t0 = time.perf_counter()
        cpu_dryrun = cpu_dryrun.result()
    print(f"  phase 4l's CPU dry run, run beside phase 1: "
          f"{cpu_dryrun['run_s']}s; waited {time.perf_counter() - t0:.1f}s "
          "after phase 1")
    # LM training first, while the card's memory is whole: the
    # full-parameter round peaks at about 57 GiB
    print("[4i] LM training at full width: the train step, the backbone "
          "FedAvg and FedLoRA rounds through the aggregation kernels")
    lm_train_rec = train_lm(dev)
    torch.cuda.empty_cache()
    _lap()

    data = make_survey_data(SurveyConfig(), _gen(SEED))
    tr, held_out = split_groups(data, seed=SEED)
    gcfg = GPOConfig(d_embed=data.phi.shape[-1])
    params = init_gpo_params(gcfg, _gen(SEED), device=dev)
    print("[2] PreferenceServer, ServeConfig() defaults, GPOConfig() width")
    serve_rec = serve(dev, data, list(held_out), gcfg, params)
    _lap()
    print("[3] predict_preferences through the attention kernel")
    pred_rec = predict(dev, data, held_out, gcfg, params)
    _lap()
    print("[4] FederatedGPO at GPOConfig() width, the quickstart's "
          "FedConfig, through the kernels")
    train_rec = train(dev, data, tr, held_out)
    _lap()
    print("[4b] the aggregation registry's strategies, 3 rounds each, "
          "through the kernels")
    strat_rec = train_strategies(dev, data, tr, held_out)
    _lap()
    print("[4c] the DP and codec stages, 3 rounds each, through the "
          "kernels")
    priv_rec = train_private(dev, data, tr, held_out)
    _lap()
    print("[4c] every survey group a client: one replayed DP and one int8 "
          "round through the designs past the on-chip capacity")
    wide_rec = train_private_wide(dev, data, tr, held_out)
    _lap()
    print("[4f] the adversary, availability and hierarchy stages, 3 rounds "
          "each, through the kernels")
    stage_rec = train_stages(dev, data, tr, held_out)
    _lap()
    print("[4g] the sharded round on processes (torch.distributed), 3 "
          "rounds each, through the kernels")
    shard_rec = train_sharded(dev, data, tr, held_out)
    _lap()
    print("[4d] LM serving: all ten archs at full width, bf16, through "
          "the flash-attention and SSD kernels")
    t0 = time.perf_counter()
    lm_rec = serve_lm(dev)
    _lap()
    print(f"  phase 4d: {time.perf_counter() - t0:.1f}s")
    print("[4e] the paper's experiment: FedAvg vs centralized at the "
          "reference's widths through the kernels, then partial "
          "participation and optimizer resets")
    exp_rec = experiment(dev)
    _lap()
    print("[4h] engine=\"scan\" on the card: the round replayed from a CUDA "
          "graph, against the eager card run")
    cap_rec = train_captured(dev, data, tr, held_out)
    _lap()
    print("[4j] serve --gpo as a user runs it: 60 FedAvg rounds through "
          "the kernels, the checkpoint saved, int8 and f32 serving")
    t0 = time.perf_counter()
    serve_train_rec = serve_trained(dev)
    _lap()
    print(f"  phase 4j: {time.perf_counter() - t0:.1f}s")
    print("[4k] the dry-run tooling against the card: the sweep on meta, "
          "the counted FLOPs, the dry run's bytes, mfu")
    t0 = time.perf_counter()
    tool_rec = tooling(dev, lm_train_rec, lm_rec, card)
    _lap()
    print(f"  phase 4k: {time.perf_counter() - t0:.1f}s")
    print("[4l] kernel coverage: the attention kernels at other head "
          "widths, the trimmed and pairwise kernels past 32 clients, and "
          "the users that need them")
    t0 = time.perf_counter()
    cover_rec = {"build": build_rec, **kernel_coverage(dev, cpu_dryrun)}
    _lap()
    print(f"  phase 4l: {time.perf_counter() - t0:.1f}s")
    print("[4m] the kernels' last shape limits: flash at head widths to "
          "256, the SSD scan past its tiles, clip and quant past 4096 "
          "clients, trimmed and pairwise past 1024, the C <= 32 trimmed "
          "kernel's NaN columns, and the users that need them")
    t0 = time.perf_counter()
    limit_rec = kernel_limits(dev)
    _lap()
    print(f"  phase 4m: {time.perf_counter() - t0:.1f}s")
    print("[5] timing at the main paths' shapes (CUDA events, median)")
    kernels = timing(dev, serve_rec, pred_rec, train_rec, strat_rec,
                     priv_rec, exp_rec, stage_rec, name, worst)
    t0 = time.perf_counter()
    kernels += _backbone_rows(dev, lm_rec, name, worst)
    print(f"  phase 5's LM rows: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    _lm_train_rows(dev, lm_train_rec, kernels, _peaks(name))
    print(f"  phase 5's LM training rows: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    _coverage_rows(dev, kernels, cover_rec, name)
    print(f"  phase 5's coverage rows: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    _limit_rows(dev, kernels, limit_rec, name)
    print(f"  phase 5's limit rows: {time.perf_counter() - t0:.1f}s")
    _lap()
    # phase 4g's launches, over its processes and configurations
    sharded = {}
    for part in shard_rec.values():
        for run in part["runs"].values():
            for per_rank in run["launches"]:
                for k, n in per_rank.items():
                    sharded[k] = sharded.get(k, 0) + n
    # phase 4h's replayed launches, read from its profiles by name
    captured = {}
    for run in cap_rec["runs"].values():
        for k, n in run["replayed_in_profile"].items():
            captured[k] = captured.get(k, 0) + n
    for row in kernels:
        if row["name"] in serve_train_rec["launches"]:
            by_path = row.setdefault("launches_by_path", {})
            by_path["serve_train"] = serve_train_rec["launches"][row["name"]]
            by_path["serve_train_by_name"] = \
                serve_train_rec["replayed_in_profile"][row["name"]]
        if row["name"] in sharded:
            row.setdefault("launches_by_path", {})["sharded"] = \
                sharded[row["name"]]
        if row["name"] in captured:
            row.setdefault("launches_by_path", {})["captured"] = \
                captured[row["name"]]
    _wait_control_builds()

    print(json.dumps({"engine": {
        k: serve_rec[k] for k in ("steps", "launches", "prefill_requests",
                                  "summaries", "profile_int8",
                                  "profile_f32")}}))
    print(json.dumps({"train": train_rec}))
    print(json.dumps({"strategies": strat_rec}))
    print(json.dumps({"private": priv_rec, "private_wide": wide_rec}))
    print(json.dumps({"lm": lm_rec}))
    print(json.dumps({"experiment": exp_rec}))
    print(json.dumps({"stages": stage_rec}))
    print(json.dumps({"sharded": shard_rec}))
    print(json.dumps({"captured": cap_rec}))
    print(json.dumps({"lm_train": lm_train_rec}))
    print(json.dumps({"serve_train": serve_train_rec}))
    print(json.dumps({"tooling": tool_rec}))
    print(json.dumps({"coverage": cover_rec}))
    print(json.dumps({"limits": limit_rec}))
    for row in kernels:  # the calls behind each time (_time_ms's count)
        row["time_iters"] = _iters_of(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
