from repro_torch.optim.optimizers import (  # noqa: F401
    AdafactorState,
    AdamState,
    Optimizer,
    SGDState,
    adafactor,
    adam,
    adamw,
    clip_by_global_norm,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)
