"""PyTorch / CUDA port of the PluralLLM reproduction, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors it file
for file, slice by slice, and never imports it. Entry points run on CUDA
unless the caller passes ``device="cpu"``; the hand-written kernels under
``kernels/csrc`` are built with ``nvcc`` at first use.
"""
