"""Config classes of the PyTorch port. Importing this package registers
the ported architectures in ``ARCHITECTURES``."""
from repro_torch.configs.base import (  # noqa: F401
    ARCHITECTURES,
    ATTN,
    GLOBAL,
    MAMBA,
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
from repro_torch.configs import (  # noqa: F401,E402
    gemma2_27b,
    gemma3_27b,
    granite_moe_3b_a800m,
    grok_1_314b,
    llava_next_34b,
    mamba2_780m,
    qwen2_0_5b,
    qwen3_32b,
    whisper_small,
    zamba2_1_2b,
)

ALL_ARCHS = tuple(ARCHITECTURES.names())
