"""granite-moe-3b-a800m — fine-grained MoE, 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ARCHITECTURES, ATTN, GLOBAL, ModelConfig


@ARCHITECTURES.register("granite-moe-3b-a800m")
def granite_moe_3b_a800m() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base (granite 3.0 MoE)",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,  # GQA kv=8
        head_dim=64,  # 24 * 64 == 1536
        d_ff=512,  # per-expert (fine-grained experts)
        vocab_size=49155,
        num_experts=32,
        experts_per_token=8,
        block_pattern=(ATTN,),
        window_pattern=(GLOBAL,),
        tie_embeddings=True,
        long_context_variant=True,
        long_context_window=4096,
    )
