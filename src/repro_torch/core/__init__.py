# The PyTorch port's core: the GPO preference predictor, its federated
# trainer (with the server-aggregation registry, the DP release and the
# delta codecs) and centralized trainer, the multi-tenant serving
# engine, and the alignment and fairness metrics.
from repro_torch.core.aggregation import (  # noqa: F401
    AGGREGATORS,
    AggState,
    ServerAggregator,
    make_aggregator,
)
from repro_torch.core.centralized import CentralizedGPO  # noqa: F401
from repro_torch.core.fedavg import (  # noqa: F401
    broadcast_to_clients,
    fedavg_flat,
    fedavg_stacked,
    normalize_weights,
)
from repro_torch.core.federated import FederatedGPO, History  # noqa: F401
from repro_torch.core.gpo import (  # noqa: F401
    GPOPrefix,
    gpo_apply,
    gpo_decode,
    gpo_loss,
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
