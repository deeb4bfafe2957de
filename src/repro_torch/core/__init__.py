# The serving slice of the PyTorch port: the GPO preference predictor,
# its multi-tenant serving engine, and the alignment metrics that score
# served rows. Federated training comes with the next slice.
from repro_torch.core.gpo import (  # noqa: F401
    GPOPrefix,
    gpo_apply,
    gpo_decode,
    gpo_prefill,
    init_gpo_params,
    params_from_numpy,
    predict_preferences,
)
from repro_torch.core.serving import (  # noqa: F401
    BatchRecord,
    Completed,
    PreferenceServer,
    Request,
    latency_summary,
    make_request_trace,
    quantize_gpo_params,
)
from repro_torch.core import fairness  # noqa: F401
