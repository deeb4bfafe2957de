# Hand-written CUDA kernels for Hopper (sm_90a): the GPO neural-process
# attention forward and backward (dq, dk/dv), the server-aggregation
# reduces (Eq. 3 FedAvg, the FedAvgM momentum step, the rank-trimmed mean,
# the Krum pairwise distances), the DP clip reduce and the int8 and top-k
# transport reduces (DESIGN.md §9, §10), and the int8 weight-only
# inference matmul (DESIGN.md §12). Each wrapper runs its plain PyTorch
# version (kernels/ref.py) on CPU tensors and its kernel on CUDA tensors.
from repro_torch.kernels.ops import (  # noqa: F401
    agg_clip_reduce,
    agg_momentum_reduce,
    agg_pairwise_dists,
    agg_quant_clip_reduce,
    agg_topk_reduce,
    agg_trimmed_reduce,
    fedavg_reduce,
    fedavg_reduce_tree,
    gpo_attention,
    int8_matmul,
)
from repro_torch.kernels.quant_matmul import (  # noqa: F401
    QuantizedLinear,
    dequantize_linear,
    quantize_linear,
)
from repro_torch.kernels import ref  # noqa: F401
