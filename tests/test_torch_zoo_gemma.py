"""gemma2-27b and gemma3-27b, port against reference on the CPU: the 1:1
and 5:1 local:global windows (4096 and 1024, 16 at smoke size), gemma2's
attention and final softcaps, gemma3's qk-norm and two rope thetas, and
both models' post-norms, through the forward, prefill and decode, and
greedy decoding. The checks and their tolerances are
``tests/test_torch_zoo_dense.py``'s.
"""
import pytest

from test_torch_zoo_dense import (  # noqa: F401
    _one_torch_thread,
    check_decode,
    check_forward,
    check_greedy,
)

GEMMAS = ["gemma2-27b", "gemma3-27b"]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", GEMMAS)
def test_forward_logits_match_jax(arch, use_kernels):
    check_forward(arch, use_kernels)


@pytest.mark.parametrize("arch", GEMMAS)
def test_prefill_then_decode_matches_jax_and_teacher_forcing(arch):
    check_decode(arch)


@pytest.mark.parametrize("arch", GEMMAS)
def test_greedy_tokens_match_jax(arch):
    check_greedy(arch)
