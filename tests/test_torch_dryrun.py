"""The dry run and the sweep, on the CPU.

``lower_pair`` counts a pair on meta: its per-device bytes of params and
Adam state equal a count made from the reference's own
``params_shardings`` and ``adam_state_shardings`` on an ``AbstractMesh``
of the production shape; its folded train-step count equals the whole
step's, exactly. ``lower_gpo_round`` runs one sharded round on two
processes (gloo, CPU) and reports the reference's byte contracts
(DESIGN.md §7), written as expressions of the GPO param count P and the
client count C: FedAvg one all-reduce of the P-float delta, Krum one
all-gather of the (C, P) rows beside the (C,) weights. The sweep resumes
from its JSON lines, and ``main`` ends with ``DRYRUN ok``.
"""
import dataclasses
import json
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jc
from repro.launch import sharding as js
from repro.launch import specs as jspecs
from repro.optim import adam as jax_adam
import repro_torch.configs as pc
from repro_torch.configs import GPOConfig
from repro_torch.core import init_gpo_params, make_train_step
from repro_torch.launch import dryrun, sweep
from repro_torch.launch import specs as pspecs
from repro_torch.launch.hlo_cost import analyze_step
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.partitioning import activation_sharding
from repro_torch.optim import adafactor, adam
from repro_torch.utils.pytree import tree_count_params

SMALL = pc.InputShape("small_train", 64, 32, "train")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smoke_changes(arch) -> dict:
    """The smoke variant's fields that differ from the arch's, its name
    and dtypes aside (lower_pair sets bf16 and keys on the name)."""
    full = dataclasses.asdict(pc.get_arch(arch))
    smoke = dataclasses.asdict(pc.smoke_variant(pc.get_arch(arch)))
    return {k: v for k, v in smoke.items() if v != full[k]
            and k not in ("name", "param_dtype", "activation_dtype")}


def _ref_bytes(tree, shardings) -> int:
    shard = jax.tree.leaves(shardings)
    return sum(math.prod(s.shard_shape(tuple(x.shape))) * x.dtype.itemsize
               for x, s in zip(jax.tree.leaves(tree), shard))


@pytest.mark.parametrize("sizes", [(16, 16), (2, 16, 16), (3, 5)])
def test_lower_pair_bytes_are_the_references_count(sizes):
    axes = ("pod", "data", "model")[-len(sizes):]
    changes = _smoke_changes("qwen2-0.5b")
    rec = dryrun.lower_pair("qwen2-0.5b", SMALL, cfg_overrides=changes,
                            mesh=MeshShape(sizes, axes), verbose=False)
    jcfg = jc.override(jc.get_arch("qwen2-0.5b"), param_dtype="bfloat16",
                       activation_dtype="bfloat16", **changes)
    jmesh = AbstractMesh(sizes, axes)
    jp = jspecs.params_specs(jcfg)
    jshard = js.params_shardings(jp, jcfg, jmesh, fsdp=True)
    jopt = jax.eval_shape(jax_adam(1e-3).init, jp)
    mem = rec["memory"]
    assert mem["params_bytes"] == _ref_bytes(jp, jshard)
    assert mem["optimizer_bytes"] == _ref_bytes(
        jopt, js.adam_state_shardings(jshard, jmesh))
    assert mem["temp_size_in_bytes"] is None and mem["temp_why_none"]
    assert rec["optimizer"] == "adam" and rec["microbatch"] == 8
    assert rec["num_chips"] == math.prod(sizes)
    roof = rec["roofline"]
    assert roof["collective_s"] is None and roof["collective_why_none"]
    # the memory term's bounds: the per-device arguments, moved at least
    # once, under the unfused count
    assert roof["lower_bytes_per_chip"] == mem["argument_size_in_bytes"]
    assert roof["memory_lower_s"] <= roof["memory_s"]
    assert roof["bottleneck"] in ("compute", "memory", "undetermined")
    assert roof["flops_per_chip"] == rec["counted"]["flops"] / math.prod(
        sizes)


@pytest.mark.parametrize("opt_name", ["adam", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m",
                                  "zamba2-1.2b", "whisper-small"])
def test_folded_train_step_count_is_the_whole_steps(arch, opt_name):
    cfg = pc.smoke_variant(pc.get_arch(arch))
    opt = adam(1e-3) if opt_name == "adam" else adafactor(1e-3)
    p = pspecs.params_specs(cfg)
    o = opt.init(p)
    b = pspecs.batch_specs(cfg, pc.InputShape("t", 32, 4, "train"),
                           with_labels=True)
    with activation_sharding(MeshShape((2, 2), ("data", "model"))):
        whole = analyze_step(make_train_step(cfg, opt, microbatch=2,
                                             remat=True), p, o, b)
        folded = dryrun.train_step_cost(cfg, opt, p, o, b, microbatch=2,
                                        remat=True)
    assert (folded.flops, folded.bytes, folded.ops, folded.flops_by_op) == \
        (whole.flops, whole.bytes, whole.ops, whole.flops_by_op)


def test_gpo_round_keeps_the_references_byte_contracts():
    c = 2
    p = tree_count_params(init_gpo_params(
        GPOConfig(d_embed=16, d_model=32, num_layers=1, num_heads=2,
                  d_ff=32), torch.Generator().manual_seed(0), device="cpu"))
    fedavg = dryrun.lower_gpo_round("fedavg", clients=c, device="cpu",
                                    verbose=False)
    assert fedavg["linear"]
    assert fedavg["collective_ops"] == [["all-reduce", 4.0 * p, 1.0]]
    assert fedavg["collective_bytes_by_kind"] == {"all-reduce": 4 * p}
    krum = dryrun.lower_gpo_round("krum", clients=c, device="cpu",
                                  verbose=False)
    assert not krum["linear"]
    assert krum["collective_ops"] == [["all-gather", 4.0 * c * p, 1.0],
                                      ["all-gather", 4.0 * c, 1.0]]
    assert krum["collective_bytes_by_kind"] == {"all-gather": 4 * c * p
                                                + 4 * c}


def test_sweep_resumes_and_main_prints_dryrun_ok(tmp_path, capsys):
    out = tmp_path / "sweep.jsonl"
    out.write_text(
        json.dumps({"arch": "qwen2-0.5b", "shape": "train_4k",
                    "multi_pod": False}) + "\n"
        + json.dumps({"arch": "qwen2-0.5b", "shape": "prefill_32k",
                      "multi_pod": False, "error": "x"}) + "\n"
        + "{not json\n")
    assert sweep.done_keys(str(out)) == {("qwen2-0.5b", "train_4k", False)}
    argv = ["--out", str(out), "--arch", "qwen2-0.5b"]
    sweep.main(argv + ["--shape", "long_500k"])
    assert "1 pairs to run (skipping 1 done)" in capsys.readouterr().out
    assert ("qwen2-0.5b", "long_500k", False) in sweep.done_keys(str(out))
    sweep.main(argv + ["--shape", "long_500k"])
    assert "0 pairs to run (skipping 2 done)" in capsys.readouterr().out
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                 "--out", str(tmp_path / "one.jsonl")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "DRYRUN ok: qwen2-0.5b x decode_32k multi_pod=False"
    one = json.loads((tmp_path / "one.jsonl").read_text())
    assert one["kind"] == "decode" and one["memory"]["cache_bytes"] > 0
    assert one["collectives"] is None and one["collectives_why_none"]
