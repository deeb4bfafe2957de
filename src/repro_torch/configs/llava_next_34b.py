"""llava-next-34b — VLM language backbone; anyres vision tiling is a stub
frontend that supplies patch embeddings [hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from repro_torch.configs.base import ARCHITECTURES, ATTN, GLOBAL, ModelConfig


@ARCHITECTURES.register("llava-next-34b")
def llava_next_34b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf (anyres tiling)",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,  # GQA kv=8
        head_dim=128,  # 56 * 128 == 7168
        d_ff=20480,
        vocab_size=64000,
        block_pattern=(ATTN,),
        window_pattern=(GLOBAL,),
        # the ViT/SigLIP encoder + projector are a STUB: input_specs()
        # provides pre-projected patch+text embeddings of shape (B, S, d).
        input_kind="embeddings",
        tie_embeddings=False,
        long_context_variant=True,
        long_context_window=4096,
    )
