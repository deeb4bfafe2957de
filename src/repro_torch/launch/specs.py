"""Meta-device stand-ins for every model input (no allocation), and the
per-architecture dry-run training settings (the reference's
``launch/specs.py``).

A stand-in is a ``torch.empty(..., device="meta")`` tensor, which has a
shape and a dtype and holds no storage: it takes the place of the
reference's ``jax.ShapeDtypeStruct``. ``input_specs(cfg, shape)`` mirrors
what the data pipeline and the serving frontend produce:

* token archs: {"tokens": (B, S) int32, "labels": (B, S) int32};
* VLM (llava): pre-projected patch and text embeddings (B, S, d_model)
  in the activation dtype (+ labels), the frontend being a stub;
* audio (whisper): encoder frames (B, enc_seq_len, d_model) beside the
  decoder's tokens;
* decode shapes: ONE new token (B, 1), the pre-allocated cache (the
  port's ``init_cache`` on meta) and the position, a () int32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import InputShape, ModelConfig, override
from repro_torch.models import init_cache, init_params
from repro_torch.utils.pytree import tree_leaves

META = torch.device("meta")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


@dataclass(frozen=True)
class TrainSettings:
    optimizer: str  # "adam" | "adafactor"
    microbatch: int
    remat: bool = True
    fsdp: bool = True


# chosen by parameter count (DESIGN.md §6): adafactor and deep
# microbatching for the >=5B archs, adam for the small ones (the
# reference's table)
ARCH_TRAIN_SETTINGS: dict[str, TrainSettings] = {
    "grok-1-314b": TrainSettings("adafactor", 4),
    "llava-next-34b": TrainSettings("adafactor", 16),
    "qwen3-32b": TrainSettings("adafactor", 16),
    "gemma2-27b": TrainSettings("adafactor", 16),
    "gemma3-27b": TrainSettings("adafactor", 16),
    "granite-moe-3b-a800m": TrainSettings("adam", 8),
    "zamba2-1.2b": TrainSettings("adam", 8),
    "mamba2-780m": TrainSettings("adam", 1),
    "whisper-small": TrainSettings("adam", 4),
    "qwen2-0.5b": TrainSettings("adam", 8),
}


def train_settings(cfg: ModelConfig) -> TrainSettings:
    return ARCH_TRAIN_SETTINGS.get(cfg.name, TrainSettings("adam", 1))


def serving_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The long-context serving variant where required: pure
    full-attention archs run long_500k only as the documented
    sliding-window variant (DESIGN.md §5)."""
    if shape.name == "long_500k" and cfg.long_context_variant:
        return override(cfg, window_pattern=(cfg.long_context_window,))
    return cfg


def batch_specs(cfg: ModelConfig, shape: InputShape, *,
                with_labels: bool) -> dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    adt = _DTYPES[cfg.activation_dtype]
    out: dict[str, torch.Tensor] = {}
    if cfg.input_kind == "embeddings":
        out["embeds"] = _spec((b, s, cfg.d_model), adt)
    else:
        out["tokens"] = _spec((b, s), torch.int32)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = _spec((b, cfg.enc_seq_len, cfg.d_model), adt)
    if with_labels:
        out["labels"] = _spec((b, s), torch.int32)
    return out


def cache_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """``init_cache`` on meta: no allocation."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def decode_specs(cfg: ModelConfig, shape: InputShape):
    """(cache, tokens, cache_pos) specs for the serve step."""
    cache = cache_specs(cfg, shape)
    tokens = _spec((shape.global_batch, 1), torch.int32)
    pos = _spec((), torch.int32)
    return cache, tokens, pos


def params_specs(cfg: ModelConfig) -> Any:
    return init_params(cfg, None, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Every model input for the given workload shape, as meta
    tensors."""
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False)}
    cache, tokens, pos = decode_specs(cfg, shape)
    return {"cache": cache, "tokens": tokens, "cache_pos": pos}


def count_params(cfg: ModelConfig) -> int:
    return int(sum(math.prod(x.shape)
                   for x in tree_leaves(params_specs(cfg))))
