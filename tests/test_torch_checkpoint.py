"""Checkpoints across the two packages, and the port's serve launcher.

The port reads and writes the JAX package's ``.npz`` format (same key
strings, same ``__crc32__``), so a checkpoint either package saved
restores into the other and serves the same rows (atol 1e-5, float32).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import restore_checkpoint_quantized as jax_restore_q
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import GPOConfig as JaxGPOConfig
from repro.core import init_gpo_params as jax_init
from repro.core import predict_preferences as jax_predict
from repro_torch.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    restore_checkpoint_quantized,
    save_checkpoint,
)
from repro_torch.checkpoint.checkpoint import _leaves
from repro_torch.configs import GPOConfig
from repro_torch.core import (
    init_gpo_params,
    params_from_numpy,
    predict_preferences,
)
from repro_torch.kernels import QuantizedLinear
from repro_torch.launch import serve as serve_cli

GKW = dict(d_embed=16, d_model=32, num_layers=2, num_heads=4, d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _like(**kw):
    return init_gpo_params(GPOConfig(**{**GKW, **kw}),
                           torch.Generator().manual_seed(9), device="cpu")


def _jax_ckpt(tmp_path, step=1, **kw):
    jp = jax_init(JaxGPOConfig(**{**GKW, **kw}), jax.random.PRNGKey(0))
    return jp, jax_save(str(tmp_path), step, jp, metadata={"step": step})


def test_jax_checkpoint_restores_into_port_and_serves_equal_rows(tmp_path):
    jp, path = _jax_ckpt(tmp_path)
    restored = restore_checkpoint(path, _like())
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for (ka, a), (kb, b) in zip(_leaves(restored), _leaves(want)):
        assert ka == kb and torch.equal(a, b), ka
    rng = np.random.default_rng(0)
    ctx_x = rng.standard_normal((20, 16)).astype(np.float32)
    ctx_y = rng.uniform(size=20).astype(np.float32)
    tgt_x = rng.standard_normal((10, 16)).astype(np.float32)
    rows = predict_preferences(restored, GPOConfig(**GKW), ctx_x, ctx_y,
                               tgt_x, 5, device="cpu")
    ref = jax_predict(jax_restore(path, jp), JaxGPOConfig(**GKW), ctx_x,
                      ctx_y, tgt_x, 5)
    np.testing.assert_allclose(rows.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_restore_quantized_bit_equal_to_reference(tmp_path):
    jp, path = _jax_ckpt(tmp_path)
    port = restore_checkpoint_quantized(path, _like())
    ref = jax_restore_q(path, jp)
    assert isinstance(port["head"], QuantizedLinear)
    assert port["layers"].w1.q.dtype == torch.int8
    assert port["layers"].ln2.dtype == torch.float32
    for f in ("wq", "w2"):
        np.testing.assert_array_equal(getattr(port["layers"], f).q.numpy(),
                                      np.asarray(getattr(ref["layers"], f).q))
    np.testing.assert_array_equal(port["in_proj"].scale.numpy(),
                                  np.asarray(ref["in_proj"].scale))


def test_port_checkpoint_restores_into_jax(tmp_path):
    port = _like()
    path = save_checkpoint(str(tmp_path), 3, port, metadata={"by": "port"})
    assert os.path.exists(path.replace(".npz", ".json"))
    like = jax_init(JaxGPOConfig(**GKW), jax.random.PRNGKey(1))
    ref = jax_restore(path, like)
    flat = dict(_leaves(port))
    for p, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        np.testing.assert_array_equal(
            np.asarray(leaf), flat[jax.tree_util.keystr(p)].numpy())
    back = restore_checkpoint(path, _like())
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_leaves(back), _leaves(port)))


def test_flipped_byte_and_corrupt_file_raise_value_error(tmp_path):
    _, path = _jax_ckpt(tmp_path)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(ValueError):
        restore_checkpoint(path, _like())
    bad = tmp_path / "ckpt_00000009.npz"
    bad.write_bytes(b"not a real npz")
    with pytest.raises(ValueError):
        restore_checkpoint(str(bad), _like())


def test_shape_mismatch_and_missing_leaf(tmp_path):
    _, path = _jax_ckpt(tmp_path)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(path, _like(d_model=64))
    like = _like()
    like["extra"] = torch.zeros(3)
    with pytest.raises(KeyError):
        restore_checkpoint(path, like)


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    for step in (2, 10, 7):
        _jax_ckpt(tmp_path, step=step)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_00000010.npz")


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------
def test_serve_without_restore_names_the_training_slice(capsys):
    with pytest.raises(SystemExit, match="launch.train --trainer gpo"):
        serve_cli.main(["--gpo", "--device", "cpu"])
    # LM serving runs every arch now, zamba2's hybrid the last to come:
    # its smoke variant serves on the CPU
    capsys.readouterr()
    serve_cli.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                    "--prompt-len", "8", "--gen-len", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("arch=zamba2-1.2b-smoke batch=4 prompt=8 "
                        "generated=4 device=cpu")
    assert sum(ln.startswith("  seq") for ln in lines) == 4


def test_serve_restore_errors_are_actionable(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint under"):
        serve_cli.main(["--gpo", "--restore", "--ckpt-dir",
                        str(tmp_path / "empty"), "--device", "cpu"])
    _jax_ckpt(tmp_path)  # d_embed 16: not the launcher's GPOConfig
    with pytest.raises(SystemExit, match="does not match"):
        serve_cli.main(["--gpo", "--restore", "--ckpt-dir", str(tmp_path),
                        "--device", "cpu"])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_serve_restores_a_jax_checkpoint(tmp_path, capsys, int8):
    jp = jax_init(JaxGPOConfig(d_embed=64), jax.random.PRNGKey(0))
    jax_save(str(tmp_path), 5, jp)
    args = ["--gpo", "--restore", "--ckpt-dir", str(tmp_path), "--device",
            "cpu", "--requests", "12", "--max-batch", "4"]
    serve_cli.main(args + (["--int8"] if int8 else []))
    out = capsys.readouterr().out
    assert "restored GPO predictor" in out
    assert "served 12/12 requests" in out
    assert ("int8" if int8 else "f32") in out
