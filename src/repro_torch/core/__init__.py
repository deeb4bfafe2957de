# The PyTorch port's core: the GPO preference predictor, its federated
# trainers (the stacked one and the sharded round over processes, with
# the server-aggregation registry, the round's stage pipeline: the
# Byzantine adversary, the DP release, the delta codecs, the
# availability faults and the edge hierarchy) and centralized trainer, the multi-tenant serving engine, the alignment and fairness
# metrics, the LM backbones' training and serving steps, FedLoRA, and the
# federated backbone trainers.
from repro_torch.core.adversary import (  # noqa: F401
    apply_attack,
    attacker_draws,
    attacker_mask,
    check_defense_composition,
    flip_preferences,
    honest_stats,
    honest_stats_sharded,
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
    trim_depth,
    tree_where,
)
from repro_torch.core.centralized import CentralizedGPO  # noqa: F401
from repro_torch.core.fedavg import (  # noqa: F401
    broadcast_to_clients,
    fedavg_allreduce,
    fedavg_flat,
    fedavg_stacked,
    normalize_weights,
)
from repro_torch.core.federated import (  # noqa: F401
    FederatedGPO,
    History,
    ShardedGPO,
    ShardedOut,
    make_sharded_round,
)
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
from repro_torch.core.lora import (  # noqa: F401
    apply_lora,
    init_lora,
    lora_from_reference,
    lora_param_count,
)
from repro_torch.core.trainer import (  # noqa: F401
    RoundDraws,
    greedy_decode,
    lm_loss,
    make_backbone_fedavg_round,
    make_fedlora_round,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.core import fairness  # noqa: F401
