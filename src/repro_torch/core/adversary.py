"""Server-side norm bounding (``AggConfig.norm_bound``, DESIGN.md §13),
the one piece of the reference's ``core/adversary.py`` that the port
runs so far. The attack simulator is ROADMAP.md queue A.4."""
from __future__ import annotations

import torch


def norm_clip_rows(vecs: torch.Tensor, bound: float) -> torch.Tensor:
    """Scale each received client row of the (C, P) delta matrix to L2
    norm ≤ ``bound``, so no single client can pull a linear aggregate
    further than bound/C · server_lr. Zero rows keep scale 1 (the norm
    is floored at 1e-12). Returns float32."""
    x = vecs.float()
    norms = torch.sqrt(torch.square(x).sum(dim=1))
    scale = torch.clamp(bound / torch.clamp(norms, min=1e-12), max=1.0)
    return x * scale[:, None]
