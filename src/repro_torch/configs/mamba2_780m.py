"""mamba2-780m — attention-free SSM with state-space duality [arXiv:2405.21060]."""
from repro_torch.configs.base import ARCHITECTURES, MAMBA, ModelConfig


@ARCHITECTURES.register("mamba2-780m")
def mamba2_780m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        source="arXiv:2405.21060 (Mamba2 / SSD)",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,  # attention-free, no separate MLP (Mamba2 block includes it)
        vocab_size=50280,
        ssm_state_size=128,
        ssm_expand=2,  # d_inner = 3072
        ssm_head_dim=64,  # 48 SSD heads
        ssm_conv_width=4,
        ssm_chunk=128,
        block_pattern=(MAMBA,),
        tie_embeddings=True,
    )
