"""zamba2-1.2b — Mamba2 trunk + shared-weight attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ARCHITECTURES, MAMBA, ModelConfig


@ARCHITECTURES.register("zamba2-1.2b")
def zamba2_1_2b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        source="arXiv:2411.15242 (Zamba2: Mamba2 + shared attn blocks)",
        num_layers=38,  # 38 Mamba2 trunk layers
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,  # spec: GQA kv=32 (== MHA for the shared block)
        head_dim=64,  # 32 * 64 == 2048
        d_ff=8192,  # MLP of the shared attention block
        vocab_size=32000,
        ssm_state_size=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        block_pattern=(MAMBA,),
        shared_attn_every=6,  # one shared-weight attn+MLP block every 6 layers
        tie_embeddings=True,
    )
