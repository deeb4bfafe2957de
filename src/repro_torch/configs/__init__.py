"""Config classes of the PyTorch port (the serving slice so far)."""
from repro_torch.configs.base import GPOConfig, ServeConfig  # noqa: F401
