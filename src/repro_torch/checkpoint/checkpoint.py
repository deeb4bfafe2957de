"""Params checkpointing to .npz (atomic, step-indexed), in the JAX
package's format: the same flat key strings (``['in_proj']``,
``['layers'].wq``, ``['head'].q`` for a quantized leaf, with ``/`` stored
as ``|``), the same ``__crc32__`` content checksum. A checkpoint either
package saved restores into the other.

``restore_checkpoint`` recomputes the checksum on load and raises
``ValueError`` on mismatch or on a corrupt zip container (checkpoints
without the entry still load).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
import zlib
from typing import Any, Iterator, Tuple

import numpy as np
import torch

PyTree = Any
_SEP = "|"  # flat-key separator (path components may contain '/')
_CRC_KEY = "__crc32__"  # reserved npz entry: content checksum


def _content_crc(stored: dict[str, np.ndarray]) -> int:
    """CRC32 over the checkpoint payload: sorted (name, dtype, shape,
    bytes) per leaf, chained."""
    crc = 0
    for k in sorted(stored):
        arr = np.ascontiguousarray(stored[k])
        crc = zlib.crc32(k.encode(), crc)
        crc = zlib.crc32(str(arr.dtype).encode(), crc)
        crc = zlib.crc32(str(arr.shape).encode(), crc)
        crc = zlib.crc32(arr.tobytes(), crc)
    return crc & 0xFFFFFFFF


def _leaves(tree: PyTree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key string, leaf) pairs named as ``jax.tree_util.keystr`` names
    them: ``[repr(key)]`` for dict entries (in sorted key order),
    ``.field`` for NamedTuple fields, ``[i]`` for other sequences."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(like: PyTree, fn, path: str = "") -> PyTree:
    """``like``'s structure with each leaf replaced by fn(key, leaf)."""
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, f"{path}[{k!r}]") for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), fn, f"{path}.{f}")
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, fn, f"{path}[{i}]")
                          for i, v in enumerate(like))
    return fn(path, like)


def _flatten(tree: PyTree) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                # numpy has no bfloat16: store as f32 (exact superset);
                # restore casts back to the model dtype
                leaf = leaf.float()
            arr = leaf.detach().cpu().numpy()
        else:
            arr = np.asarray(leaf)
        flat[key] = arr
    return flat


def _fsync_dir(directory: str) -> None:
    """fsync the directory entry so a rename survives power loss."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(directory: str, path: str, write) -> None:
    """Write via a same-directory temp file, fsync, rename, fsync dir."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(directory)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(directory: str, step: int, tree: PyTree,
                    metadata: dict | None = None) -> str:
    """Atomic + durable save of ``tree`` as ``ckpt_<step>.npz`` (and its
    metadata as ``ckpt_<step>.json``). A crash mid-save leaves either the
    old checkpoint or the new one, never a torn file."""
    os.makedirs(directory, exist_ok=True)
    stored = {k.replace("/", _SEP): v for k, v in _flatten(tree).items()}
    stored[_CRC_KEY] = np.asarray(_content_crc(stored), np.uint32)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    _atomic_write(directory, path, lambda f: np.savez(f, **stored))
    if metadata is not None:
        meta_path = os.path.join(directory, f"ckpt_{step:08d}.json")
        text = json.dumps(metadata, indent=2, default=str).encode()
        _atomic_write(directory, meta_path, lambda f: f.write(text))
    return path


def restore_checkpoint(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like``: each leaf gets ``like``'s
    dtype and device, shapes are validated. Verifies the ``__crc32__``
    content checksum when present; raises ``ValueError`` on mismatch or
    a corrupt zip container, ``KeyError`` on a missing leaf."""
    try:
        with np.load(path) as data:
            stored = {k: data[k] for k in data.files}
    except zipfile.BadZipFile as e:
        raise ValueError(f"corrupt checkpoint {path!r}: {e}") from e
    crc = stored.pop(_CRC_KEY, None)
    if crc is not None:
        expect = int(np.asarray(crc).ravel()[0])
        actual = _content_crc(stored)
        if actual != expect:
            raise ValueError(
                f"checkpoint {path!r} failed its content checksum "
                f"(stored crc32 {expect:#010x}, recomputed "
                f"{actual:#010x}): the file was corrupted after save")
    flat = {k.replace(_SEP, "/"): v for k, v in stored.items()}

    def load(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs model {tuple(leaf.shape)}")
        return torch.as_tensor(arr, dtype=leaf.dtype, device=leaf.device)

    return _rebuild(like, load)


def restore_checkpoint_quantized(path: str, like: PyTree) -> PyTree:
    """Serving load path (DESIGN.md §12): restore the f32 GPO params and
    quantize the dense weights to int8 ``QuantizedLinear`` in one step.
    Checkpoints on disk stay f32."""
    from repro_torch.core.serving import quantize_gpo_params

    return quantize_gpo_params(restore_checkpoint(path, like))


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for fn in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", fn)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, fn), int(m.group(1))
    return best
