"""The LM backbones of the PyTorch port (``models/``): every family of
the JAX package (dense, MoE, pure SSM, the zamba2 hybrid, whisper's
encoder-decoder, llava's embeddings input), and the weight bridge from
the JAX package's params.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.transformer import (  # noqa: F401
    encode,
    forward,
    hidden_states,
    init_cache,
    init_params,
)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(cfg, tree, device=None) -> dict:
    """The JAX package's params for ``cfg`` as the port's, leaf for leaf.

    ``tree`` holds the reference's params as nested dicts of numpy arrays
    (a NamedTuple such as ``AttnParams`` as a dict by field name; an
    absent leaf such as ``bq`` or ``q_norm`` as None). The result lives on
    ``device`` (CUDA unless the caller names another). The tree must have
    exactly the keys, shapes and dtypes ``init_params(cfg)`` makes, or
    this raises ``ValueError``."""
    dev = resolve_device(device)
    like = init_params(cfg, None, device="meta")

    def convert(ref, want, path):
        if isinstance(want, dict):
            if not isinstance(ref, dict) or set(ref) != set(want):
                got = sorted(ref) if isinstance(ref, dict) else type(ref)
                raise ValueError(f"params{path}: keys {got}, expected "
                                 f"{sorted(want)}")
            return {k: convert(ref[k], want[k], f"{path}[{k!r}]")
                    for k in want}
        if want is None or ref is None:
            if want is not None or ref is not None:
                raise ValueError(f"params{path}: None in one tree only")
            return None
        t = _tensor(ref, dev)
        if t.shape != want.shape or t.dtype != want.dtype:
            raise ValueError(f"params{path}: {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(want.shape)} {want.dtype}")
        return t

    return convert(tree, like, "")
