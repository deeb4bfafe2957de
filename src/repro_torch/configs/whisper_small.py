"""whisper-small — encoder-decoder audio model; mel+conv frontend is a stub
that supplies frame embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import ARCHITECTURES, ATTN, GLOBAL, ModelConfig


@ARCHITECTURES.register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        source="arXiv:2212.04356 (Whisper)",
        num_layers=12,  # decoder layers
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        block_pattern=(ATTN,),
        window_pattern=(GLOBAL,),
        is_encoder_decoder=True,
        enc_layers=12,
        enc_seq_len=1500,  # 30 s of audio after the conv frontend (stubbed)
        input_kind="tokens",  # decoder side; encoder consumes frame embeddings
        tie_embeddings=True,
        long_context_variant=True,  # decoder self-attn SWA for long_500k
        long_context_window=4096,
    )
