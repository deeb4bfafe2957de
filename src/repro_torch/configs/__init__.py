"""Config classes of the PyTorch port."""
from repro_torch.configs.base import (  # noqa: F401
    AdversaryConfig,
    AggConfig,
    AvailabilityConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
    HierarchyConfig,
    PrivacyConfig,
    ServeConfig,
)
