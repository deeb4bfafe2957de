"""qwen3-32b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family card]."""
from repro_torch.configs.base import ARCHITECTURES, ATTN, GLOBAL, ModelConfig


@ARCHITECTURES.register("qwen3-32b")
def qwen3_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        source="hf:Qwen/Qwen3-8B (Qwen3 family)",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,  # GQA kv=8
        head_dim=128,  # qwen3 uses explicit head_dim=128 (q_dim != d_model)
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        block_pattern=(ATTN,),
        window_pattern=(GLOBAL,),
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        long_context_variant=True,
        long_context_window=4096,
    )
