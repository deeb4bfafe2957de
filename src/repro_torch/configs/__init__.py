"""Config classes of the PyTorch port. Importing this package registers
the ported architectures in ``ARCHITECTURES``."""
from repro_torch.configs.base import (  # noqa: F401
    ARCHITECTURES,
    ATTN,
    GLOBAL,
    MAMBA,
    PENDING_ARCHS,
    AdversaryConfig,
    AggConfig,
    AvailabilityConfig,
    CompressionConfig,
    FedConfig,
    GPOConfig,
    HierarchyConfig,
    ModelConfig,
    PrivacyConfig,
    ServeConfig,
    get_arch,
    override,
    smoke_variant,
)

# registration side effects
from repro_torch.configs import mamba2_780m, qwen2_0_5b  # noqa: F401,E402

ALL_ARCHS = tuple(ARCHITECTURES.names())
