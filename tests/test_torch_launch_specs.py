"""The workload shapes, the meta-device specs, the FLOP count and the
roofline, port against reference on the CPU.

The ten archs are held at full size by shapes alone: the port's specs
are meta tensors, the reference's ``ShapeDtypeStruct``s from
``jax.eval_shape`` (made once per arch; long_500k's cache is never
allocated in either). ``count_params``, ``train_settings``,
``model_flops`` and ``input_specs`` must equal the reference's exactly.
The counted FLOPs (``launch/hlo_cost.py``) run on the smoke variants,
where ``model_flops``' 6·N·D (train) and 2·N·D (prefill) is held to a
band per family, each side with its reason.
"""
import dataclasses
import resource

import jax
import pytest
import torch

import repro.configs as jc
from repro.launch import roofline as jrl
from repro.launch import specs as jspecs
import repro_torch.configs as pc
from repro_torch.checkpoint.checkpoint import _leaves
from repro_torch.core import make_prefill_step, make_train_step
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as pspecs
from repro_torch.launch.hlo_cost import CostTotals, analyze_step
from repro_torch.optim import adam

ARCHS = list(pc.ALL_ARCHS)
SHAPES = list(pc.INPUT_SHAPES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_input_shapes_are_the_references():
    assert [f.name for f in dataclasses.fields(pc.InputShape)] == \
        [f.name for f in dataclasses.fields(jc.InputShape)]
    assert {k: dataclasses.astuple(v) for k, v in pc.INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jc.INPUT_SHAPES.items()}
    assert list(pc.INPUT_SHAPES) == list(jc.INPUT_SHAPES)
    for arch in ARCHS:
        assert pc.config_dict(pc.get_arch(arch)) == \
            jc.config_dict(jc.get_arch(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_settings_and_param_counts_are_the_references(arch):
    cfg, jcfg = pc.get_arch(arch), jc.get_arch(arch)
    assert dataclasses.astuple(pspecs.train_settings(cfg)) == \
        dataclasses.astuple(jspecs.train_settings(jcfg))
    assert pspecs.count_params(cfg) == jspecs.count_params(jcfg)
    assert {k: dataclasses.astuple(v)
            for k, v in pspecs.ARCH_TRAIN_SETTINGS.items()} == \
        {k: dataclasses.astuple(v)
         for k, v in jspecs.ARCH_TRAIN_SETTINGS.items()}


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    return {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for p, v in _leaves(tree)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_shape_for_shape(arch, shape):
    """Every input of every arch x shape, shape and dtype (int32 tokens,
    labels and position; the caches leaf for leaf), all on meta."""
    cfg = pspecs.serving_config(pc.get_arch(arch), pc.INPUT_SHAPES[shape])
    jcfg = jspecs.serving_config(jc.get_arch(arch), jc.INPUT_SHAPES[shape])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = pspecs.input_specs(cfg, pc.INPUT_SHAPES[shape])
    want = jspecs.input_specs(jcfg, jc.INPUT_SHAPES[shape])
    assert _port_leaves(got) == _ref_leaves(want)
    assert all(v.device.type == "meta" for _, v in _leaves(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_are_the_references(arch):
    cfg, jcfg = pc.get_arch(arch), jc.get_arch(arch)
    for shape in SHAPES:
        for chips in (256, 512):
            assert rl.model_flops(cfg, pc.INPUT_SHAPES[shape], chips) == \
                jrl.model_flops(jcfg, jc.INPUT_SHAPES[shape], chips)


# (FLOPs, counted bytes, bytes moved at least once) -> bottleneck: named
# only where the upper and the lower bound of the memory term agree
@pytest.mark.parametrize("flops,nbytes,lower,want", [
    (989e12, 3.35e12, 3.35e12, "compute"),  # compute = the upper bound
    (989e12, 3.35e12, None, "compute"),
    (989e9, 3.35e12, 3.35e10, "memory"),  # the lower bound 10x compute
    (989e12, 6.7e12, 3.35e11, "undetermined"),  # compute between them
    (989e12, 6.7e12, None, "undetermined"),
])
def test_roofline_names_a_bottleneck_only_where_the_bounds_agree(
        flops, nbytes, lower, want):
    roof = rl.analyze(CostTotals(flops=2 * flops, bytes=2 * nbytes), 2,
                      lower_bytes_per_chip=lower)
    assert roof.compute_s == pytest.approx(flops / rl.PEAK_FLOPS)
    assert roof.memory_s == pytest.approx(nbytes / rl.HBM_BW)
    assert roof.bottleneck == want
    d = roof.as_dict()
    assert d["collective_s"] is None and d["collective_bytes"] is None
    assert d["memory_lower_s"] == (None if lower is None
                                   else lower / rl.HBM_BW)


# counted matmul FLOPs / model_flops on the smoke variants (B 2, S 64):
# above 1, the attention scores and probabilities (2 products of S x hd
# a token, head and layer) and the SSD chunk products; below 1, the
# embedding gather (V x d params that do no product unless tied to the
# head) and whisper's encoder (its params see enc_seq_len 32 frames, not
# the 64 tokens model_flops charges them); far above, the MoE experts'
# capacity slots (smoke capacity factor 4.0: ~4x the routed pairs)
BANDS = {
    "dense": (1.0, 1.1),  # tied embeddings (qwen2, the gemmas)
    "dense-untied": (0.9, 1.0),  # qwen3
    "vlm": (0.9, 1.0),  # llava, untied
    "ssm": (1.0, 1.15),
    "hybrid": (1.0, 1.15),
    "audio": (0.7, 0.9),
    "moe": (2.5, 3.5),
}


def _family(cfg) -> str:
    if cfg.family == "dense" and not cfg.tie_embeddings:
        return "dense-untied"
    return cfg.family


@pytest.mark.parametrize("arch", ARCHS)
def test_counted_flops_lie_in_the_families_band(arch):
    cfg = pc.smoke_variant(pc.get_arch(arch))
    p = pspecs.params_specs(cfg)
    lo, hi = BANDS[_family(cfg)]
    opt = adam(1e-3)
    train = pc.InputShape("t", 64, 2, "train")
    prefill = pc.InputShape("p", 64, 2, "prefill")
    t = analyze_step(make_train_step(cfg, opt), p, opt.init(p),
                     pspecs.batch_specs(cfg, train, with_labels=True))
    f = analyze_step(make_prefill_step(cfg, 64, use_kernels=False), p,
                     pspecs.batch_specs(cfg, prefill, with_labels=False))
    for got, shape in ((t, train), (f, prefill)):
        ratio = got.flops / rl.model_flops(cfg, shape, 1)
        assert lo <= ratio <= hi, (shape.kind, ratio)
    # the backward's two products a forward product: 3x the forward
    assert t.flops == 3 * f.flops
    assert f.bytes > 0 and f.ops > 0


def test_a_meta_step_allocates_nothing(monkeypatch):
    """qwen2-0.5b's train_4k pair counted at full size on meta: no CUDA
    call, and the process's peak memory grows by far less than the
    model's 0.99 GB of bf16 params."""
    def refuse(*a, **k):
        raise AssertionError("torch.cuda was touched")

    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec = dryrun.lower_pair("qwen2-0.5b", "train_4k", verbose=False)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    params_bytes = 2 * rec["params"]
    assert grown < params_bytes / 4, grown
    assert rec["counted"]["flops"] > 0 and rec["roofline"]["bottleneck"] in (
        "compute", "memory", "undetermined")
