"""grok-1-314b — 314B-parameter MoE decoder [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ARCHITECTURES, ATTN, GLOBAL, ModelConfig


@ARCHITECTURES.register("grok-1-314b")
def grok_1_314b() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        source="hf:xai-org/grok-1",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,  # GQA kv=8
        head_dim=128,  # 48 * 128 == 6144
        d_ff=32768,
        vocab_size=131072,
        num_experts=8,
        experts_per_token=2,
        block_pattern=(ATTN,),
        window_pattern=(GLOBAL,),
        rope_theta=10_000.0,
        tie_embeddings=False,
        # pure full attention: long_500k uses the documented SWA variant
        long_context_variant=True,
        long_context_window=4096,
    )
