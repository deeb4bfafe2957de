"""gemma3-27b — dense, 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt
family card]."""
from repro_torch.configs.base import ARCHITECTURES, ATTN, GLOBAL, ModelConfig


@ARCHITECTURES.register("gemma3-27b")
def gemma3_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        source="hf:google/gemma-3-1b-pt (Gemma 3 family)",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,  # GQA kv=16
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        qk_norm=True,
        block_pattern=(ATTN,),
        # 5 local : 1 global, local window 1024
        window_pattern=(1024, 1024, 1024, 1024, 1024, GLOBAL),
        rope_theta=10_000.0,  # local layers
        rope_theta_global=1_000_000.0,  # global layers (128k scaling)
        final_logit_softcap=None,  # gemma3 dropped softcap; qk-norm instead
        tie_embeddings=True,
        scale_embeddings=True,
        use_post_norm=True,
    )
