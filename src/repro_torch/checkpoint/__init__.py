from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_checkpoint,
    restore_checkpoint,
    restore_checkpoint_quantized,
    save_checkpoint,
)
