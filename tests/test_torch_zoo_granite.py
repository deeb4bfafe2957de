"""granite-moe-3b-a800m (32 experts, top-8, fine-grained experts of
d_ff 512), port against reference on the CPU: its smoke variant (4
experts, top-2, capacity factor 4) through the forward with its aux
loss, prefill and decode, and greedy decoding, with
``tests/test_torch_zoo_dense.py``'s weights, checks and tolerances.
"""
import pytest

from test_torch_zoo_dense import (  # noqa: F401
    _one_torch_thread,
    check_decode,
    check_forward,
    check_greedy,
)

ARCH = "granite-moe-3b-a800m"


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_logits_and_aux_match_jax(use_kernels):
    check_forward(ARCH, use_kernels)


def test_prefill_then_decode_matches_jax_and_teacher_forcing():
    check_decode(ARCH)


def test_greedy_tokens_match_jax():
    check_greedy(ARCH)
