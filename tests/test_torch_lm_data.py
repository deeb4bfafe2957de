"""The LM training slice's trees, data and frontends, port against
reference on the CPU:

* the leaf walk (``utils.pytree``, ``checkpoint._leaves``): the key
  strings, order and count of ``jax.tree_util.tree_flatten_with_path``
  for every arch's smoke params (None skipped, the reference's
  NamedTuples walked in field order) and for the LoRA tree;
* a backbone checkpoint saved by the port restores into the
  reference's tree;
* ``synthetic_lm_batches`` bit for bit;
* ``init_lora``'s keys and shapes, ``apply_lora`` on carried adapters;
* ``StubEmbedder``'s norm and determinism, ``BackboneEmbedder`` on the
  reference's projection within 1e-5;
* ``launch.train`` for the three backbone trainers and the FedLoRA
  example at a tiny size with ``--device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.configs import ALL_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import apply_lora as jax_apply_lora
from repro.core import init_lora as jax_init_lora
from repro.data import BackboneEmbedder as JaxBackboneEmbedder
from repro.data.lm_data import LMDataConfig as JaxLMDataConfig
from repro.data.lm_data import synthetic_lm_batches as jax_lm_batches
from repro.models import hidden_states as jax_hidden_states
from repro.models import init_params as jax_init_params
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch, override, smoke_variant
from repro_torch.core import apply_lora, init_lora, lora_from_reference
from repro_torch.core.lora import lora_param_count
from repro_torch.data import (
    BackboneEmbedder,
    LMDataConfig,
    StubEmbedder,
    synthetic_lm_batches,
)
from repro_torch.examples import fedlora_finetune
from repro_torch.launch import train as train_launcher
from repro_torch.models import hidden_states, init_params
from repro_torch.models import params_from_reference
from repro_torch.utils.pytree import (
    tree_leaves,
    tree_paths,
    tree_ravel_clients,
)
from test_torch_backbone import _numpy_tree
from test_torch_zoo_dense import reference_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_flat(tree):
    return list(zip(tree_paths(tree),
                    [tuple(x.shape) for x in tree_leaves(tree)]))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_leaf_walk_is_the_references(arch):
    """Paths, order and count of tree_flatten_with_path on the smoke
    params; the raveled client matrix lays the leaves out in that
    order."""
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    params = init_params(smoke_variant(get_arch(arch)), None, device="meta")
    assert _port_flat(params) == _flat(shapes)
    assert None not in tree_leaves(params)


def test_leaf_walk_of_the_lora_tree_and_the_client_matrix():
    jcfg = jax_smoke_variant(jax_get_arch("qwen2-0.5b"))
    cfg = smoke_variant(get_arch("qwen2-0.5b"))
    jparams = reference_params(jcfg, 5)
    params = params_from_reference(cfg, _numpy_tree(jparams), device="cpu")
    jlora = jax_init_lora(jparams, jax.random.PRNGKey(1), rank=4)
    lora = init_lora(params, torch.Generator().manual_seed(1), rank=4)
    assert _port_flat(lora) == _flat(jlora)
    # the (C, P) matrix of a carried tree is the reference's ravel
    carried = lora_from_reference(_numpy_tree(jlora), device="cpu")
    stacked = {"adapters": {k: {n: torch.stack([x, 2 * x]) for n, x in
                                ad.items()}
                            for k, ad in carried["adapters"].items()},
               "scale": torch.stack([carried["scale"],
                                     2 * carried["scale"]])}
    want = np.concatenate([np.asarray(x).reshape(-1) for x in
                           jax.tree_util.tree_leaves(jlora)])
    got = tree_ravel_clients(stacked).numpy()
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], 2 * want)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b",
                                  "granite-moe-3b-a800m"])
def test_port_checkpoint_restores_into_the_reference(arch, tmp_path):
    """The reference's key names (``['layers']['attn'].wq``), no None
    entries; the reference's restore returns the port's values."""
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    cfg = smoke_variant(get_arch(arch))
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    path = save_checkpoint(str(tmp_path), 3, params)
    with np.load(path) as data:
        keys = set(data.files) - {"__crc32__"}
    assert keys == {k for k, _ in _flat(jax.eval_shape(
        lambda: jax_init_params(jcfg, jax.random.PRNGKey(0))))}
    like = jax_init_params(jcfg, jax.random.PRNGKey(0))
    restored = jax_restore(path, like)
    for got, want in zip(jax.tree_util.tree_leaves(restored),
                         tree_leaves(params), strict=True):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_synthetic_lm_batches_are_the_references_bit_for_bit():
    cfg = dict(vocab_size=300, seq_len=20, global_batch=3, seed=4)
    it = synthetic_lm_batches(LMDataConfig(**cfg), device="cpu")
    jit = jax_lm_batches(JaxLMDataConfig(**cfg))
    for _ in range(3):
        got, want = next(it), next(jit)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    assert LMDataConfig() == LMDataConfig(**{
        f: getattr(JaxLMDataConfig(), f) for f in
        JaxLMDataConfig.__dataclass_fields__})


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m"])
def test_init_lora_keys_shapes_and_apply_lora_match_jax(arch):
    """The adapters' flat-leaf keys and shapes, the draw's scale, and
    apply_lora on the reference's adapters (B made nonzero) within
    1e-6."""
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    cfg = smoke_variant(get_arch(arch))
    jparams = reference_params(jcfg, 6)
    params = params_from_reference(cfg, _numpy_tree(jparams), device="cpu")
    jlora = jax_init_lora(jparams, jax.random.PRNGKey(2), rank=4)
    lora = init_lora(params, torch.Generator().manual_seed(2), rank=4)
    assert sorted(lora["adapters"]) == sorted(jlora["adapters"])
    for k, ad in lora["adapters"].items():
        for n in ("a", "b"):
            assert tuple(ad[n].shape) == jlora["adapters"][k][n].shape
        assert not ad["b"].any()
        d = ad["a"].shape[-2]
        assert abs(float(ad["a"].std()) * np.sqrt(d) - 1.0) < 0.2
    assert lora_param_count(lora) == sum(
        x.size for ad in jlora["adapters"].values() for x in ad.values())
    rng = np.random.default_rng(3)
    jlora = {"adapters": {k: {"a": ad["a"], "b": jnp.asarray(
        rng.standard_normal(ad["b"].shape), jnp.float32)}
        for k, ad in jlora["adapters"].items()}, "scale": jlora["scale"]}
    want = jax.tree_util.tree_leaves(jax_apply_lora(jparams, jlora))
    got = tree_leaves(apply_lora(params, lora_from_reference(
        _numpy_tree(jlora), device="cpu")))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_stub_embedder_unit_norm_and_deterministic():
    emb = StubEmbedder(48, seed=1, device="cpu")
    a = emb.embed_qa("Is it?", "yes")
    assert a.shape == (48,)
    assert abs(float(torch.linalg.vector_norm(a)) - 1.0) < 1e-6
    assert torch.equal(a, StubEmbedder(48, seed=1, device="cpu").embed_qa(
        "Is it?", "yes"))
    assert not torch.equal(a, emb.embed_qa("Is it?", "no"))
    assert not torch.equal(a, StubEmbedder(48, seed=2, device="cpu")
                           .embed_qa("Is it?", "yes"))
    batch = emb.embed_batch([f"t{i}" for i in range(200)])
    assert batch.shape == (200, 48)
    # unit normals, normed: each coordinate has mean 0 and variance 1/d
    assert abs(float(batch.mean())) < 0.01
    assert abs(float(batch.var()) * 48 - 1.0) < 0.1


def test_backbone_embedder_matches_jax():
    """The masked mean-pool of the hidden states, projected by the
    reference's matrix and normed, within 1e-5; a padded row's embedding
    equals the same row unpadded."""
    jcfg = jax_smoke_variant(jax_get_arch("qwen2-0.5b"))
    cfg = smoke_variant(get_arch("qwen2-0.5b"))
    jparams = reference_params(jcfg, 7)
    params = params_from_reference(cfg, _numpy_tree(jparams), device="cpu")
    jemb = JaxBackboneEmbedder(
        lambda p, t: jax_hidden_states(p, jcfg, tokens=t)[0], jparams,
        cfg.d_model, 32, seed=3)
    emb = BackboneEmbedder(
        lambda p, t: hidden_states(p, cfg, tokens=t)[0], params,
        cfg.d_model, 32, proj=np.asarray(jemb.proj), device="cpu")
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab_size, (3, 12), dtype=np.int32)
    mask = np.ones((3, 12), np.float32)
    mask[1, 7:] = 0.0
    want = np.asarray(jemb.embed_tokens(jnp.asarray(tokens),
                                        jnp.asarray(mask)))
    got = emb.embed_tokens(torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        emb.embed_tokens(torch.from_numpy(tokens)).numpy(),
        np.asarray(jemb.embed_tokens(jnp.asarray(tokens))), rtol=0,
        atol=1e-5)
    drawn = BackboneEmbedder(lambda p, t: hidden_states(p, cfg, tokens=t)[0],
                             params, cfg.d_model, 32, seed=3, device="cpu")
    assert drawn.proj.shape == (cfg.d_model, 32)


@pytest.mark.parametrize("trainer", ["standard", "fedavg", "fedlora"])
def test_launch_train_backbone_trainers_on_the_cpu(trainer, tmp_path,
                                                   capsys):
    argv = ["--trainer", trainer, "--smoke", "--device", "cpu",
            "--steps", "3", "--rounds", "2", "--local-steps", "1",
            "--clients", "2", "--batch", "2", "--seq", "8",
            "--ckpt-dir", str(tmp_path)]
    if trainer == "fedlora":
        argv += ["--agg", "median", "--clip-norm", "0.5",
                 "--noise-multiplier", "0.5", "--compress", "int8"]
    train_launcher.main(argv)
    out = capsys.readouterr().out
    assert "done:" in out and "nan" not in out
    if trainer == "fedlora":
        assert "eps=" in out
    assert len(list(tmp_path.glob("ckpt_*.npz"))) == 1


@pytest.mark.parametrize("mode", ["full", "lora"])
def test_fedlora_example_on_the_cpu(mode):
    """The example at a tiny member of its family; the full
    configuration's count from the meta device."""
    tiny = override(fedlora_finetune.hundred_m_config(), num_layers=1,
                    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                    d_ff=128, vocab_size=256)
    rec = fedlora_finetune.main(["--rounds", "2", "--seq", "8", "--mode",
                                 mode, "--agg", "fedavgm", "--device",
                                 "cpu"], cfg=tiny)
    assert len(rec["losses"]) == 2 and np.isfinite(rec["losses"]).all()
    assert (rec["payload_params"] == rec["backbone_params"]) == (
        mode == "full")
    assert fedlora_finetune.count_params(
        fedlora_finetune.hundred_m_config()) == 114_887_296
