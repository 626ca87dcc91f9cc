"""Deterministic, stateless data pipeline (port of src/repro/data)."""
from repro_torch.data.pipeline import (GeoEnriched, SyntheticLM, cell_points,
                                       lm_tokens, make_source)

__all__ = ["GeoEnriched", "SyntheticLM", "cell_points", "lm_tokens",
           "make_source"]
