"""The port's rules: it imports neither JAX nor the JAX package, its
configs copy the reference's field for field, its entry points run on
CUDA unless told otherwise, and a kernel wrapper handed CUDA tensors
launches its kernel or raises, never falling back to the plain version.
"""
import dataclasses
import importlib
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as jax_configs
import repro_torch
from repro_torch.configs import GPOConfig, ServeConfig
from repro_torch.kernels import backend

ROOT = Path(__file__).resolve().parents[1]
qm = importlib.import_module("repro_torch.kernels.quant_matmul")
ga = importlib.import_module("repro_torch.kernels.gpo_attention")
ar = importlib.import_module("repro_torch.kernels.agg_reduce")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_the_port_pulls_in_no_jax_and_builds_nothing():
    """Every module of the port, and chip_smoke.py's imports, in a fresh
    interpreter that refuses to start a process (no nvcc at import)."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started at import')\n"
        "subprocess.Popen = refuse\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("clean")
    assert len(_port_modules()) >= 20


def test_no_jax_or_reference_import_in_the_port_sources():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)"
                     r"|from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    files = list((ROOT / "src/repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("name", [
    "GPOConfig", "ServeConfig", "FedConfig", "AggConfig", "PrivacyConfig",
    "AvailabilityConfig", "AdversaryConfig", "CompressionConfig",
    "HierarchyConfig"])
def test_configs_copy_the_reference_field_for_field(name):
    port, ref = getattr(repro_torch.configs, name), getattr(jax_configs, name)

    def spec(cls):  # a sub-config default compares by its own fields
        return [(f.name, (type(f.default).__name__, spec(f.default))
                 if dataclasses.is_dataclass(f.default) else f.default)
                for f in dataclasses.fields(cls)]

    assert spec(port) == spec(ref)
    if name == "GPOConfig":
        assert port(d_model=96, num_heads=3).head_dim == 32


@pytest.mark.parametrize("kw", [
    dict(ctx_buckets=()), dict(ctx_buckets=(40, 40)),
    dict(max_batch=16, batch_buckets=(1, 8)), dict(max_batch=0),
    dict(max_queue=-1), dict(cache_entries=-1)])
def test_serve_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        jax_configs.ServeConfig(**kw).validate()
    with pytest.raises(ValueError):
        ServeConfig(**kw).validate()


@pytest.mark.parametrize("name,kw", [
    ("PrivacyConfig", dict(clip_norm=-1.0)),
    ("PrivacyConfig", dict(noise_multiplier=1.0)),
    ("PrivacyConfig", dict(clip_norm=1.0, target_delta=1.0)),
    ("AvailabilityConfig", dict(online_prob=1.5)),
    ("AvailabilityConfig", dict(straggler_prob=0.5)),
    ("AdversaryConfig", dict(kind="bogus")),
    ("CompressionConfig", dict(kind="topk", topk_frac=0.0)),
    ("HierarchyConfig", dict(num_edges=0))])
def test_fed_subconfig_validation_matches_reference(name, kw):
    for mod in (jax_configs, repro_torch.configs):
        with pytest.raises(ValueError):
            getattr(mod, name)(**kw).validate()
    assert (jax_configs.FedConfig(use_pallas_attention=True).resolve_gpo(
        jax_configs.GPOConfig()).use_pallas_attention
        is repro_torch.configs.FedConfig(
            use_pallas_attention=True).resolve_gpo(
            GPOConfig()).use_pallas_attention is True)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device "
                    "is usable")


def test_entry_points_refuse_to_run_on_the_cpu_unasked():
    _no_card()
    from repro_torch.core import (
        PreferenceServer,
        init_gpo_params,
        params_from_numpy,
        predict_preferences,
    )
    from repro_torch.launch import serve

    cfg = GPOConfig(d_embed=8, d_model=16, num_layers=1, num_heads=2,
                    d_ff=16)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_gpo_params(cfg, gen)
    params = init_gpo_params(cfg, gen, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PreferenceServer(params, cfg, num_options=5)
    x = np.zeros((5, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_preferences(params, cfg, x, np.zeros(5, np.float32), x, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({k: v.numpy() if isinstance(v, torch.Tensor)
                           else v for k, v in params.items()}, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gpo", "--restore"])
    # and on the CPU when asked
    rows = predict_preferences(params, cfg, x, np.zeros(5, np.float32), x,
                               5, device="cpu")
    assert rows.shape == (1, 5)


def test_training_entry_points_refuse_to_run_on_the_cpu_unasked():
    _no_card()
    from repro_torch.configs import FedConfig
    from repro_torch.core import CentralizedGPO, FederatedGPO
    from repro_torch.data import SurveyConfig, make_survey_data
    from repro_torch.launch import train

    data = make_survey_data(SurveyConfig(num_groups=5, num_questions=20,
                                         d_embed=8))
    cfg = GPOConfig(d_embed=8, d_model=16, num_layers=1, num_heads=2,
                    d_ff=16)
    for trainer in (FederatedGPO, CentralizedGPO):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer(cfg, FedConfig(num_clients=3), data, [0, 1, 2], [3, 4])
        trainer(cfg, FedConfig(num_clients=3), data, [0, 1, 2], [3, 4],
                device="cpu")  # and on the CPU when asked
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--trainer", "gpo", "--rounds", "1"])


def _counts():
    return (qm.int8_matmul_flat.launches, ga.gpo_attention_fwd.launches,
            ga.gpo_attention_bwd_dq.launches,
            ga.gpo_attention_bwd_dkdv.launches,
            ar.fedavg_reduce_flat.launches, ar.momentum_reduce_flat.launches,
            ar.trimmed_reduce_flat.launches, ar.pairwise_dists_flat.launches,
            ar.clip_reduce_flat.launches, ar.quant_clip_reduce_flat.launches,
            ar.topk_reduce_flat.launches)


def test_kernel_wrappers_raise_on_cuda_tensors_without_a_library():
    _no_card()
    before = _counts()
    with FakeTensorMode():
        x = torch.empty((4, 8), device="cuda")
        q = torch.empty((8, 3), dtype=torch.int8, device="cuda")
        s = torch.empty((3,), device="cuda")
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            qm.int8_matmul_flat(x, q, s)
        a = torch.empty((2, 10, 32), device="cuda")
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ga.gpo_attention_fwd(a, a, a, num_ctx=4)
        with pytest.raises(ValueError, match="head_dim"):
            ga.gpo_attention_fwd(*(torch.empty((2, 10, 16), device="cuda")
                                   for _ in range(3)), num_ctx=4)
        # operands that need a gradient reach the same launch (the
        # GPOAttention Function differentiates it)
        g = torch.empty((2, 10, 32), device="cuda", requires_grad=True)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ga.gpo_attention_fwd(g, a, a, num_ctx=4)
        r = torch.empty((2, 10), device="cuda")
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ga.gpo_attention_bwd_dq(a, a, a, a, r, r, num_ctx=4)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ga.gpo_attention_bwd_dkdv(a, a, a, a, r, r, num_ctx=4)
        w = torch.empty((4,), device="cuda")
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ar.fedavg_reduce_flat(x, w)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ar.momentum_reduce_flat(x, w, torch.empty((8,), device="cuda"),
                                    beta=0.9)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ar.trimmed_reduce_flat(x, w, trim=1)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ar.pairwise_dists_flat(x)
        # the operand contract and the trim and client caps come first,
        # on a CUDA tensor as on the CPU
        with pytest.raises(ValueError, match="trim=2 must satisfy"):
            ar.trimmed_reduce_flat(x, w, trim=2)
        with pytest.raises(ValueError, match="holds 1 to 32"):
            ar.pairwise_dists_flat(torch.empty((33, 8), device="cuda"))
        with pytest.raises(ValueError, match="different devices"):
            ar.momentum_reduce_flat(x, w, torch.empty((8,)), beta=0.9)
        with pytest.raises(ValueError, match="different devices"):
            qm.int8_matmul_flat(x, q.cpu(), s)
    assert _counts() == before


def _transport_call(name, dev, **over):
    """One call of a transport kernel's wrapper on (4, 8) operands."""
    x = over.get("x", torch.empty((4, 8), device=dev))
    w = over.get("w", torch.empty((4,), device=dev))
    m = over.get("m", torch.empty((4, 8), device=dev))
    if name == "clip_reduce":
        return ar.clip_reduce_flat(x, w, clip=over.get("clip", 0.5), noise=m)
    if name == "quant_clip_reduce":
        return ar.quant_clip_reduce_flat(x, w, clip=over.get("clip", 0.5),
                                         noise=m, uniform=m, resid=m)
    return ar.topk_reduce_flat(x, w, over.get("tau", w),
                               with_residual=True)


TRANSPORT = ["clip_reduce", "quant_clip_reduce", "topk_reduce"]


@pytest.mark.parametrize("name", TRANSPORT)
def test_transport_wrappers_launch_or_raise_on_cuda_tensors(name):
    """The DP clip, int8 and top-k wrappers on CUDA tensors without a
    card: the operand contract and the argument checks come first, then
    the launch raises; no plain version runs and nothing is counted."""
    _no_card()
    before = _counts()
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            _transport_call(name, "cuda")
        with pytest.raises(ValueError, match="different devices"):
            _transport_call(name, "cuda", w=torch.empty((4,)))
        with pytest.raises(ValueError, match="shapes"):
            _transport_call(name, "cuda",
                            w=torch.empty((5,), device="cuda"))
        if name != "topk_reduce":
            # no release without a clip bound: noise needs clip > 0
            with pytest.raises(ValueError, match="clip"):
                _transport_call(name, "cuda", clip=0.0)
            with pytest.raises(ValueError, match="holds 1 to 4096"):
                _transport_call(name, "cuda",
                                x=torch.empty((4097, 8), device="cuda"),
                                w=torch.empty((4097,), device="cuda"),
                                m=torch.empty((4097, 8), device="cuda"))
    assert _counts() == before


@pytest.mark.parametrize("name", TRANSPORT)
def test_transport_wrappers_hold_the_contract_on_the_cpu(name):
    """The same contract on CPU tensors, where the plain version runs
    and the launch counter stays put."""
    before = _counts()
    x = torch.randn((4, 8))
    out = _transport_call(name, "cpu", x=x, w=torch.full((4,), 0.25),
                          m=torch.zeros((4, 8)))
    out = out[0] if isinstance(out, tuple) else out
    assert out.shape == (8,) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="contiguous"):
        _transport_call(name, "cpu", x=torch.zeros((8, 4)).T)
    with pytest.raises(ValueError, match="expected torch.float32"):
        _transport_call(name, "cpu", x=torch.zeros((4, 8),
                                                   dtype=torch.float64))
    assert _counts() == before


def test_operand_contract_is_held_on_the_cpu_too():
    x = torch.zeros((4, 8))
    q = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="contiguous"):
        qm.int8_matmul_flat(torch.zeros((8, 4)).T, q, torch.ones(3))
    with pytest.raises(ValueError, match="expected torch.int8"):
        qm.int8_matmul_flat(x, q.float(), torch.ones(3))
    a = torch.zeros((3, 10, 2))
    with pytest.raises(ValueError, match="contiguous"):
        ga.gpo_attention_fwd(a.transpose(1, 2).contiguous().transpose(1, 2),
                             a, a, num_ctx=2)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        backend.build()


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # hide any card: the script must fail
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
