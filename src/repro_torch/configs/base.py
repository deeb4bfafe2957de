"""Config classes of the port: the GPO predictor, serving, and the
federated runtime.

Every class copies the JAX package's class of the same name field for
field: same names, same defaults, same ``validate()`` (a test holds the
two field lists equal). Configs are frozen dataclasses so they hash and
compare by value. The federated runtime of the port runs the default
round (full participation, FedAvg); the other stages' configs are
carried so that a config moves between the packages unchanged, and the
trainers refuse what they do not run yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class GPOConfig:
    """The paper's module: the transformer-based preference predictor.

    An in-context neural process (Zhao et al. 2023, GPO): inputs are
    (embedding, preference) context pairs and embedding-only targets; the
    model predicts the target preferences. PluralLLM trains this with
    FedAvg across groups.
    """

    d_embed: int = 64  # frozen-backbone embedding width (4096 for Alpaca-7B)
    d_model: int = 128
    num_layers: int = 4
    num_heads: int = 4
    d_ff: int = 256
    dropout: float = 0.0
    norm_eps: float = 1e-6
    # Gaussian likelihood: if learn_sigma the head emits (mu, log_sigma),
    # else sigma=1 and Eq. 1's NLL reduces to MSE (GPO's practice).
    learn_sigma: bool = False
    param_dtype: str = "float32"
    # route the neural-process attention of gpo_apply through the
    # hand-written CUDA kernels (kernels/gpo_attention.py: the forward,
    # and under autograd the dq and dk/dv backward kernels) instead of
    # the dense masked-softmax einsum.
    use_pallas_attention: bool = False
    # kept for field parity with the JAX config; PyTorch runs the layer
    # loop eagerly, so there is nothing to unroll.
    layer_unroll: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclass(frozen=True)
class ServeConfig:
    """Multi-tenant reward-model serving engine (DESIGN.md §12).

    Drives ``core/serving.py::PreferenceServer``: a FIFO request queue
    with admission control, a continuous batcher that pads ragged
    context/target lengths to a small static *bucket* set, an LRU prefix
    cache of per-layer context K/V keyed on the shared ICL context (hits
    skip prefill entirely and are bit-equal to the cold path), and an
    optional int8 weight-only inference path that quantizes checkpoint
    weights at load time.
    """

    # largest number of requests fused into one decode dispatch
    max_batch: int = 8
    # padded batch sizes: a partial batch pads up to the smallest bucket
    # >= its size (dummy rows, sliced off)
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # padded context / target lengths in POINTS (m questions x A
    # options). Target buckets must be multiples of the survey's
    # num_options so padded rows reshape into whole questions.
    ctx_buckets: Tuple[int, ...] = (40, 80, 160)
    tgt_buckets: Tuple[int, ...] = (20, 40, 80, 160)
    # admission control: submissions beyond this queue depth are
    # rejected. 0 = unbounded.
    max_queue: int = 128
    # prefix-cache capacity in entries (LRU eviction); 0 disables it
    cache_entries: int = 256
    # quantize the dense weights to int8 at load time and serve through
    # the int8 matmul kernel (DESIGN.md §12)
    int8_weights: bool = False

    def validate(self) -> None:
        for name, buckets in (("batch_buckets", self.batch_buckets),
                              ("ctx_buckets", self.ctx_buckets),
                              ("tgt_buckets", self.tgt_buckets)):
            if not buckets or list(buckets) != sorted(set(buckets)):
                raise ValueError(
                    f"{name} must be non-empty strictly ascending, got "
                    f"{buckets}")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_batch > self.batch_buckets[-1]:
            raise ValueError(
                f"max_batch={self.max_batch} exceeds the largest batch "
                f"bucket {self.batch_buckets[-1]}")
        if self.max_queue < 0 or self.cache_entries < 0:
            raise ValueError("max_queue and cache_entries must be >= 0")


@dataclass(frozen=True)
class PrivacyConfig:
    """Differential privacy on the client→server delta path (DESIGN.md
    §9): per-client L2 clip of the flat delta to ``clip_norm`` and
    Gaussian noise of std ``noise_multiplier * clip_norm``, with Rényi-DP
    accounting (``core/privacy.py::RdpAccountant``, one sampled Gaussian
    mechanism a round, q = 1 under full participation; the per-round ε
    at ``target_delta`` lands in ``History.round_eps``). ``clip_norm ==
    0`` disables it."""

    clip_norm: float = 0.0
    noise_multiplier: float = 0.0
    target_delta: float = 1e-5
    accountant_orders: Tuple[int, ...] = tuple(range(2, 33)) + (
        48, 64, 128, 256)

    @property
    def enabled(self) -> bool:
        return self.clip_norm > 0.0

    @property
    def sigma(self) -> float:
        """Per-client noise standard deviation (z * S)."""
        return self.noise_multiplier * self.clip_norm

    def validate(self) -> None:
        if self.clip_norm < 0.0 or self.noise_multiplier < 0.0:
            raise ValueError("clip_norm and noise_multiplier must be >= 0")
        if self.noise_multiplier > 0.0 and self.clip_norm == 0.0:
            raise ValueError(
                "noise_multiplier > 0 requires clip_norm > 0: the noise "
                "scale is z * clip_norm, and unclipped deltas have "
                "unbounded sensitivity (no finite-σ DP guarantee exists)")
        if not 0.0 < self.target_delta < 1.0:
            raise ValueError("target_delta must lie in (0, 1)")


@dataclass(frozen=True)
class AvailabilityConfig:
    """Client availability / failure simulator (DESIGN.md §11): per-round
    offline, crash-after-training and straggler draws. The benign default
    disables it (the port runs only that case so far)."""

    online_prob: float = 1.0
    crash_prob: float = 0.0
    straggler_prob: float = 0.0
    max_staleness: int = 0
    rejoin_rounds: int = 0

    @property
    def enabled(self) -> bool:
        return (self.online_prob < 1.0 or self.crash_prob > 0.0
                or self.straggler_prob > 0.0)

    def validate(self) -> None:
        if not 0.0 <= self.online_prob <= 1.0:
            raise ValueError("online_prob must lie in [0, 1]")
        if not 0.0 <= self.crash_prob <= 1.0:
            raise ValueError("crash_prob must lie in [0, 1]")
        if not 0.0 <= self.straggler_prob <= 1.0:
            raise ValueError("straggler_prob must lie in [0, 1]")
        if self.max_staleness < 0 or self.rejoin_rounds < 0:
            raise ValueError(
                "max_staleness and rejoin_rounds must be >= 0")
        if self.straggler_prob > 0.0 and self.max_staleness < 1:
            raise ValueError(
                "straggler_prob > 0 requires max_staleness >= 1: a "
                "straggler's delay is drawn from [1, max_staleness]")


@dataclass(frozen=True)
class AdversaryConfig:
    """Byzantine adversarial-client simulator (DESIGN.md §13):
    ``num_attackers`` clients per round corrupt their deltas (or, for
    ``label_flip``, their training data). ``kind="none"`` disables it
    (the port runs only that case so far)."""

    # none | sign_flip | scaled | gaussian | alie | label_flip
    kind: str = "none"
    num_attackers: int = 0
    scale: float = 10.0
    noise_std: float = 1.0
    alie_z: float = 1.0

    @property
    def enabled(self) -> bool:
        return self.kind != "none" and self.num_attackers > 0

    def validate(self) -> None:
        kinds = ("none", "sign_flip", "scaled", "gaussian", "alie",
                 "label_flip")
        if self.kind not in kinds:
            raise ValueError(
                f"adversary kind {self.kind!r} must be one of {kinds}")
        if self.num_attackers < 0:
            raise ValueError("num_attackers must be >= 0")
        if self.noise_std < 0.0:
            raise ValueError("noise_std must be >= 0")


@dataclass(frozen=True)
class CompressionConfig:
    """Client→server delta compression (DESIGN.md §10): int8 stochastic
    quantization or top-k sparsification, with an EF21 error-feedback
    residual (``core/compression.py``). ``kind="none"`` disables it."""

    kind: str = "none"  # none | int8 | topk
    topk_frac: float = 0.01
    error_feedback: bool = True
    stochastic: bool = True

    @property
    def enabled(self) -> bool:
        return self.kind != "none"

    @property
    def needs_rng(self) -> bool:
        """The codec draws per-client randomness (stochastic rounding)."""
        return self.kind == "int8" and self.stochastic

    def validate(self) -> None:
        if self.kind not in ("none", "int8", "topk"):
            raise ValueError(
                f"compression kind {self.kind!r} must be one of "
                "'none' | 'int8' | 'topk'")
        if self.kind == "topk" and not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac={self.topk_frac} must lie in (0, 1]")


@dataclass(frozen=True)
class AggConfig:
    """Server-aggregation strategy (DESIGN.md §7). The paper's Eq. 2-3
    FedAvg is ``name="fedavg"`` with the defaults below; the registry's
    strategies are in ``core/aggregation.py``."""

    # registry name: fedavg | fedavgm | fedadam | fedyogi | fedprox |
    # trimmed_mean | median | adaptive | fedbuff | krum | multi_krum |
    # geomedian
    name: str = "fedavg"
    # server learning rate on the aggregated delta (1.0 == paper FedAvg)
    server_lr: float = 1.0
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.99
    tau: float = 1e-3
    # FedProx client-side proximal coefficient mu (0.0 == plain Adam)
    prox_mu: float = 0.0
    trim_frac: float = 0.1
    fair_temp: float = 1.0
    fair_decay: float = 0.9
    buffer_k: int = 4
    staleness_power: float = 0.5
    num_malicious: int = 0
    multi_krum_m: int = 3
    geomedian_iters: int = 8
    geomedian_eps: float = 1e-6
    norm_bound: float = 0.0


@dataclass(frozen=True)
class HierarchyConfig:
    """Two-level client→edge→server aggregation (DESIGN.md §14).
    ``num_edges == 1`` disables it (the port runs only that case so
    far)."""

    num_edges: int = 1

    @property
    def enabled(self) -> bool:
        return self.num_edges > 1

    def validate(self, num_clients: Optional[int] = None) -> None:
        if self.num_edges < 1:
            raise ValueError("num_edges must be >= 1")
        if (num_clients is not None and self.enabled
                and num_clients % self.num_edges != 0):
            raise ValueError(
                f"hierarchy.num_edges={self.num_edges} must divide the "
                f"round's participant count ({num_clients}): edges are "
                "contiguous equal-size client shards")


@dataclass(frozen=True)
class FedConfig:
    """PluralLLM federated runtime (paper §3.1–3.2, §4.3)."""

    num_clients: int = 10  # |G_train|
    num_eval_groups: int = 7  # |G_eval| (60/40 split in the paper)
    rounds: int = 1300  # communication rounds (paper: 1300)
    local_epochs: int = 6  # paper: 6 local epochs per round
    lr: float = 3e-4  # paper: Adam 3e-4
    eval_every: int = 10  # paper: every 10 rounds
    num_context: int = 16  # m context questions per local epoch
    num_target: int = 16  # target questions per local epoch
    batch_groups: int = 0  # 0 => all clients participate each round
    reset_opt_each_round: bool = False
    # round driver: "scan" or "loop"; the port runs the per-round
    # driver for both (core/federated.py)
    engine: str = "scan"
    scan_unroll: int = 1
    # run the round's client-axis work (the strategy's reduce, the DP
    # clip, the int8 / top-k transport) through the hand-written CUDA
    # kernels on the raveled (C, P) matrix instead of per-leaf sums
    use_pallas_aggregation: bool = False
    agg: AggConfig = AggConfig()
    privacy: PrivacyConfig = PrivacyConfig()
    compression: CompressionConfig = CompressionConfig()
    avail: AvailabilityConfig = AvailabilityConfig()
    adversary: AdversaryConfig = AdversaryConfig()
    hierarchy: HierarchyConfig = HierarchyConfig()
    strict_privacy: bool = False
    # runtime override of GPOConfig.use_pallas_attention: None defers to
    # the model config; True/False forces the attention path for every
    # trainer built from this FedConfig
    use_pallas_attention: Optional[bool] = None
    seed: int = 0

    def resolve_gpo(self, gpo_cfg: GPOConfig) -> GPOConfig:
        """GPOConfig with this runtime's overrides applied."""
        if (self.use_pallas_attention is not None
                and self.use_pallas_attention
                != gpo_cfg.use_pallas_attention):
            gpo_cfg = replace(
                gpo_cfg, use_pallas_attention=self.use_pallas_attention)
        return gpo_cfg
