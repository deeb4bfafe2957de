"""The port's counterparts of the repository's ``examples/``; each runs
as ``python -m repro_torch.examples.<name>``, on CUDA unless given
``--device cpu``."""
