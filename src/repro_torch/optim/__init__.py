from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState,
    Optimizer,
    adam,
    clip_by_global_norm,
)
