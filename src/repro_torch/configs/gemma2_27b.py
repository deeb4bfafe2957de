"""gemma2-27b — dense, 1:1 local:global alternation, logit softcapping
[arXiv:2408.00118]."""
from repro_torch.configs.base import ARCHITECTURES, ATTN, GLOBAL, ModelConfig


@ARCHITECTURES.register("gemma2-27b")
def gemma2_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        source="arXiv:2408.00118 (Gemma 2)",
        num_layers=46,
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,  # GQA kv=16
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        block_pattern=(ATTN,),
        window_pattern=(4096, GLOBAL),  # local, global alternating
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        rope_theta=10_000.0,
        tie_embeddings=True,
        scale_embeddings=True,
        use_post_norm=True,
    )
