"""Config classes of the serving slice.

``GPOConfig`` and ``ServeConfig`` copy the JAX package's classes field
for field: same names, same defaults, same ``validate()``. Configs are
frozen dataclasses so they hash and compare by value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
    # hand-written CUDA kernel (kernels/gpo_attention.py) instead of the
    # dense masked-softmax einsum. Forward only in this package so far.
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
