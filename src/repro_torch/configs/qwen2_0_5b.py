"""qwen2-0.5b — small dense GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ARCHITECTURES, ATTN, GLOBAL, ModelConfig


@ARCHITECTURES.register("qwen2-0.5b")
def qwen2_0_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        source="arXiv:2407.10671 (Qwen2)",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,  # GQA kv=2
        head_dim=64,  # 14 * 64 == 896
        d_ff=4864,
        vocab_size=151936,
        qkv_bias=True,
        block_pattern=(ATTN,),
        window_pattern=(GLOBAL,),
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        long_context_variant=True,
        long_context_window=4096,
    )
