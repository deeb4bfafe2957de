# The PyTorch port's core: the GPO preference predictor, its federated
# trainer (with the server-aggregation registry, the round's stage
# pipeline: the Byzantine adversary, the DP release, the delta codecs,
# the availability faults and the edge hierarchy) and centralized
# trainer, the multi-tenant serving engine, the alignment and fairness
# metrics, and the LM backbones' serving steps.
from repro_torch.core.adversary import (  # noqa: F401
    apply_attack,
    attacker_draws,
    attacker_mask,
    check_defense_composition,
    flip_preferences,
    honest_stats,
    norm_clip_rows,
)
from repro_torch.core.aggregation import (  # noqa: F401
    AGGREGATORS,
    AggState,
    ServerAggregator,
    make_aggregator,
)
from repro_torch.core.availability import (  # noqa: F401
    FaultDraws,
    FaultState,
    RoundSchedule,
    advance_fault_state,
    fault_draws,
    init_fault_state,
    masked_mean_weights,
    masked_robust_reduce_flat,
    round_schedule,
    staleness_discount,
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
from repro_torch.core.pipeline import (  # noqa: F401
    STAGE_NAMES,
    AttackDraws,
    RoundPipeline,
    make_pipeline,
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
from repro_torch.core.trainer import (  # noqa: F401
    greedy_decode,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.core import fairness  # noqa: F401
