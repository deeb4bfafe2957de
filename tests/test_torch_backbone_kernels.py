"""The LM backbones' two kernels, port against reference on the CPU: the
flash-attention forward and the Mamba2 SSD chunked scan.

Both packages get the same numpy inputs (seeded). The JAX wrappers in
``repro.kernels.ops`` run their Pallas kernels in interpret mode; the
port's wrappers in ``repro_torch.kernels.ops`` run the kernels' plain
versions on CPU tensors (``ref_attention``, ``ref_ssd``), through the
same padding and layout code that feeds the CUDA kernels on the card.
The sweeps and tolerances are those of ``tests/test_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import ssd_scan as jax_ssd_scan
from repro.kernels.ref import ref_attention as jax_ref_attention
from repro.kernels.ref import ref_ssd as jax_ref_ssd
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.ref import ref_attention, ref_ssd
from repro_torch.kernels.ssd_scan import ssd_scan_bhsp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores, and a pool the size of the machine in each oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _both(a: np.ndarray, dtype: str = "float32"):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (both round f32 to bf16 to nearest even, so they hold equal values)."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _qkv(seed, b, s, h, kv, hd=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), np.float32),
            rng.standard_normal((b, s, kv, hd), np.float32),
            rng.standard_normal((b, s, kv, hd), np.float32))


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("s", [64, 100, 257])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(s, h, kv, dtype):
    (jq, q), (jk, k), (jv, v) = (_both(a, dtype)
                                 for a in _qkv(0, 2, s, h, kv))
    want = jax_flash_attention(jq, jk, jv, causal=True, bq=32, bk=32)
    got = ops.flash_attention(q, k, v, causal=True, bq=32)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("window", [1, 7, 64])
@pytest.mark.parametrize("softcap", [None, 20.0])
def test_flash_attention_window_softcap_matches_jax(window, softcap):
    (jq, q), (jk, k), (jv, v) = (_both(a) for a in _qkv(3, 1, 128, 4, 2))
    want = jax_flash_attention(jq, jk, jv, causal=True, window=window,
                               softcap=softcap, bq=32, bk=32)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=softcap, bq=32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,bq,window", [(20, 16, 0), (100, 32, 0),
                                         (257, 128, 64)])
def test_flash_attention_non_causal_ragged_matches_ref(s, bq, window):
    """Non-causal attention at an S that is not a multiple of the block.

    The reference's wrapper pads K/V with zeros up to the block and its
    kernel has no length mask, so without the causal mask real queries
    attend to the zero keys (at S 20, block 16 it lands 0.29 max-abs away
    from ``ref_attention``): it is not the reference here. The port's
    kernel takes the unpadded length and masks the keys past it, so the
    port is held to ``ref_attention`` itself."""
    (jq, q), (jk, k), (jv, v) = (_both(a) for a in _qkv(5, 2, s, 4, 2))
    tr = (0, 2, 1, 3)
    want = jax_ref_attention(jq.transpose(tr), jk.transpose(tr),
                             jv.transpose(tr), causal=False,
                             window=window).transpose(tr)
    got = ops.flash_attention(q, k, v, causal=False, window=window, bq=bq)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


# head_dim 128 (qwen3-32b, gemma2/3): the same checks at small B and S

@pytest.mark.parametrize("s,h,kv", [(64, 4, 2), (100, 8, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_hd128_matches_jax(s, h, kv, dtype):
    (jq, q), (jk, k), (jv, v) = (_both(a, dtype)
                                 for a in _qkv(11, 2, s, h, kv, hd=128))
    want = jax_flash_attention(jq, jk, jv, causal=True, bq=32, bk=32)
    got = ops.flash_attention(q, k, v, causal=True, bq=32)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("window,softcap", [(7, 20.0), (64, None),
                                            (1, 50.0)])
def test_flash_attention_hd128_window_softcap_matches_jax(window, softcap):
    (jq, q), (jk, k), (jv, v) = (_both(a)
                                 for a in _qkv(13, 1, 128, 4, 2, hd=128))
    want = jax_flash_attention(jq, jk, jv, causal=True, window=window,
                               softcap=softcap, bq=32, bk=32)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=softcap, bq=32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,bq", [(20, 16), (100, 32)])
def test_flash_attention_hd128_non_causal_ragged_matches_ref(s, bq):
    """As the head_dim 64 case: held to ``ref_attention`` itself, since
    the reference's wrapper leaves the padded keys unmasked."""
    (jq, q), (jk, k), (jv, v) = (_both(a)
                                 for a in _qkv(17, 2, s, 4, 2, hd=128))
    tr = (0, 2, 1, 3)
    want = jax_ref_attention(jq.transpose(tr), jk.transpose(tr),
                             jv.transpose(tr), causal=False).transpose(tr)
    got = ops.flash_attention(q, k, v, causal=False, bq=bq)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


# no backward yet: an operand that requires grad under grad mode is
# refused on the CPU as on the card, and runs under no_grad

@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_wrapper_refuses_autograd(which):
    ops_in = dict(zip("qkv", (torch.from_numpy(a).transpose(1, 2)
                              .contiguous() for a in _qkv(19, 1, 20, 4, 2))))
    ops_in[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward yet"):
        flash_attention_bhsd(**ops_in, kv_len=17)
    with torch.no_grad():
        got = flash_attention_bhsd(**ops_in, kv_len=17)
        want = ref_attention(**ops_in, kv_len=17)
    assert got.grad_fn is None and torch.equal(got, want)


@pytest.mark.parametrize("which", ["x", "dt", "A_log", "B", "C", "D"])
def test_ssd_wrapper_refuses_autograd(which):
    inp = {k: torch.from_numpy(v)
           for k, v in _ssd_inputs(23, 1, 32, 2, 8, 4).items()}
    inp[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward yet"):
        ssd_scan_bhsp(**inp, chunk=16, return_state=True)
    with torch.no_grad():
        y, state = ssd_scan_bhsp(**inp, chunk=16, return_state=True)
        want_y, want_state = ref_ssd(**inp)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m"])
def test_hidden_states_refuses_a_gradient_through_the_kernels(arch):
    """``hidden_states`` runs under grad mode (unlike ``forward``): with
    params that require grad it raises at the flash or SSD wrapper rather
    than return states whose gradient skips the attention or the scan.
    The plain branch differentiates, and ``no_grad`` runs the kernels."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import hidden_states, init_params
    from repro_torch.utils.pytree import tree_leaves

    cfg = smoke_variant(get_arch(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for t in tree_leaves(params):
        if t is not None and t.is_floating_point():
            t.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    with pytest.raises(RuntimeError, match="no backward yet"):
        hidden_states(params, cfg, tokens)
    plain, _ = hidden_states(params, cfg, tokens, use_kernels=False)
    assert plain.grad_fn is not None
    with torch.no_grad():
        got, _ = hidden_states(params, cfg, tokens)
    np.testing.assert_allclose(got.numpy(), plain.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=(rng.standard_normal((b, s, h, p)) * 0.5).astype(f),
        dt=np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f),
        A_log=(rng.standard_normal(h) * 0.5).astype(f),
        B=(rng.standard_normal((b, s, n)) * 0.5).astype(f),
        C=(rng.standard_normal((b, s, n)) * 0.5).astype(f),
        D=rng.standard_normal(h).astype(f))


def _ssd_args(inp, dtype="float32"):
    """(jax args, torch args): x, B and C in ``dtype``, dt, A_log, D f32,
    as the reference's sweep types them."""
    order = ("x", "dt", "A_log", "B", "C", "D")
    lo = ("x", "B", "C")
    pairs = [_both(inp[k], dtype if k in lo else "float32") for k in order]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("s,chunk", [(64, 16), (75, 16), (128, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_jax(s, chunk, dtype):
    jargs, targs = _ssd_args(_ssd_inputs(2, 2, s, 3, 16, 8), dtype)
    want = jax_ssd_scan(*jargs, chunk=chunk)
    got = ops.ssd_scan(*targs, chunk=chunk)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,chunk", [(48, 16), (75, 16), (128, 32)])
def test_ssd_final_state_matches_jax_model_path(s, chunk):
    """The state the port's prefill hands to decode, against the
    reference model's ``ssd_chunked`` final state (the TPU kernel keeps
    its state in VMEM and returns none)."""
    jargs, targs = _ssd_args(_ssd_inputs(4, 1, s, 2, 8, 4))
    y_model, state_model = jax_ssd_chunked(*jargs, chunk=chunk)
    y, state = ops.ssd_scan_with_state(*targs, chunk=chunk)
    np.testing.assert_allclose(_f32(state), _f32(state_model), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_f32(y), _f32(y_model), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(y), _f32(jax_ref_ssd(*jargs)),
                               rtol=1e-4, atol=1e-4)


def test_ssd_padded_tail_leaves_y_and_state_exact():
    """dt = 0 steps neither decay the state (exp(0) = 1) nor add to it
    (x·0 = 0): the recurrence over the padded sequence gives the unpadded
    y and final state bit for bit, and the wrapper, which pads S = 75 to
    80, gives them within the kernel tolerance."""
    inp = _ssd_inputs(6, 2, 75, 3, 16, 8)
    _, targs = _ssd_args(inp)
    y, state = ref_ssd(*targs)
    pad = {k: np.concatenate([v, np.zeros((2, 5) + v.shape[2:], v.dtype)],
                             axis=1) if k in ("x", "dt", "B", "C") else v
           for k, v in inp.items()}
    _, pargs = _ssd_args(pad)
    y_pad, state_pad = ref_ssd(*pargs)
    assert torch.equal(y_pad[:, :75], y) and torch.equal(state_pad, state)
    y_k, state_k = ops.ssd_scan_with_state(*targs, chunk=16)
    assert y_k.shape == y.shape
    np.testing.assert_allclose(y_k.numpy(), y.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state_k.numpy(), state.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_kernels_plain_and_model_paths_agree_at_mamba2_widths():
    """p 64, n 128 as mamba2-780m, at the chunk 128 the kernel runs,
    over two chunks: the wrapper's plain version and the port's model
    path (``ssd_chunked``) agree."""
    from repro_torch.models.ssm import ssd_chunked

    _, targs = _ssd_args(_ssd_inputs(7, 1, 256, 2, 64, 128))
    y, state = ops.ssd_scan_with_state(*targs, chunk=128)
    y_m, state_m = ssd_chunked(*targs, chunk=128)
    np.testing.assert_allclose(y.numpy(), y_m.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), state_m.numpy(), rtol=1e-4,
                               atol=1e-4)
