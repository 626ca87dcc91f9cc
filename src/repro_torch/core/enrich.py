"""Geo enrichment operator: the paper's technique as a pipeline stage
(port of src/repro/core/enrich.py).

``enrich(index, xy, cfg, n_feature_tokens)`` maps a batch of (lon, lat)
locations onto census blocks with the fast index and returns per-point
state / county / block ids and a feature token — cheap enough to run
inside a data pipeline's host-to-device stage, so demographic features
join the token stream at data-pipeline rate (paper §I).
"""
from __future__ import annotations

import torch

from repro_torch.core.fast import FastConfig, FastIndex, assign_fast


def enrich(index: FastIndex, xy, cfg: FastConfig = FastConfig(),
           n_feature_tokens: int = 1024) -> dict:
    """xy [N, 2] (lon, lat; moved to the index's device) -> dict of
    per-point census features: ``state``, ``county``, ``block`` ([N] i32,
    -1 off the map), ``feature_token`` (block id mod
    ``n_feature_tokens``; ``n_feature_tokens`` itself, the OOV bucket,
    off the map) and ``stats``."""
    pts = torch.as_tensor(xy, dtype=torch.float32, device=index.device)
    sid, cid, bid, stats = assign_fast(index, pts, cfg)
    feature = (bid.clamp(min=0) % n_feature_tokens).to(torch.int32)
    feature = torch.where(bid >= 0, feature, n_feature_tokens)
    return {"state": sid, "county": cid, "block": bid,
            "feature_token": feature, "stats": stats}
