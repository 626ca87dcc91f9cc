"""Deterministic, stateless data pipeline (port of
src/repro/data/pipeline.py).

Every batch is a pure function of (seed, step) — ``batch_at(step)`` — so a
restarted job resumes bit for bit with no pipeline state in the
checkpoint, and elastic re-sharding only re-slices the same global batch.

The random draws and the arithmetic are kept apart.  The draws of a step
come from a CPU ``torch.Generator`` seeded from (seed, step)
(``step_generator``) and are then moved to the device, so a batch is the
same on either device.  The arithmetic is a plain function of the draws:
``lm_tokens`` (tokens from topic, base and bias draws) and
``cell_points`` (a point inside a covering cell from a cell draw and a
jitter draw).  The JAX package draws with ``jax.random``, whose bits the
port cannot reproduce; its arithmetic is the same.

Two sources:
  * SyntheticLM  — reproducible token streams (a uniform unigram mixed
    with a per-sequence "topic" so the loss is learnable, not pure noise).
  * GeoEnriched  — wraps another source and joins each record's (lon, lat)
    onto census blocks through a GeoEngine, writing the block id into the
    first token — the paper's technique as a pipeline stage
    (core/enrich.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.fast import demorton


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws: seeded from (seed, step)
    alone, so every call for the same pair draws the same numbers."""
    state = np.random.SeedSequence((int(seed), int(step))).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(state))


def lm_tokens(topic: torch.Tensor, base: torch.Tensor,
              use_bias: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, S + 1] int32 tokens from the draws: ``topic`` [B, 1] in [0,
    n_topics), ``base`` [B, S + 1] in [0, vocab), ``use_bias`` [B, S + 1]
    bool.  Where ``use_bias``, the token is the topic's biased token
    ``(topic * 97 + position % 13) % vocab``, else ``base``."""
    pos = torch.arange(base.shape[1], device=base.device)
    bias = (topic * 97 + pos % 13) % vocab
    return torch.where(use_bias, bias, base).to(torch.int32)


def cell_points(index, r: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[N, 2] f32 (lon, lat) points from the draws: ``r`` [N] covering
    cell rows, ``u`` [N, 2] f32 in [0, 1).  Each point lies in the first
    leaf cell of its covering cell (a covering cell always contains its
    own leaf cells, so no point falls in an off-map gap), its jitter kept
    off the leaf borders so the fp32 re-quantization cannot move it into
    a neighbouring cell."""
    ix, iy = demorton(index.cell_lo[r])
    u = 0.05 + 0.9 * u
    q = index.quant
    return torch.stack([q[0] + (ix + u[:, 0]) / q[2],
                        q[1] + (iy + u[:, 1]) / q[3]], dim=-1)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """batch_at(step) -> {"tokens", "labels"} (+ modality stubs), int32
    [batch, seq] on ``device``."""

    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    n_topics: int = 64
    device: Any = "cuda"

    def draws(self, step: int) -> dict:
        """The step's random draws, on the CPU."""
        g = step_generator(self.seed, step)
        shape = (self.batch, self.seq + 1)
        out = {"topic": torch.randint(0, self.n_topics, (self.batch, 1),
                                      generator=g),
               "base": torch.randint(0, self.cfg.vocab, shape, generator=g),
               "use_bias": torch.rand(shape, generator=g) < 0.5}
        if self.cfg.family == "vlm":
            out["img"] = torch.randn(
                (self.batch, self.cfg.n_img_tokens, self.cfg.d_vision),
                generator=g)
        if self.cfg.family == "encdec":
            out["frames"] = torch.randn(
                (self.batch, self.seq, self.cfg.d_model), generator=g)
        return out

    def batch_at(self, step: int) -> dict:
        d = {k: v.to(self.device) for k, v in self.draws(step).items()}
        toks = lm_tokens(d["topic"], d["base"], d["use_bias"],
                         self.cfg.vocab)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for stub in ("img", "frames"):
            if stub in d:
                out[stub] = d[stub].to(torch.bfloat16)
        return out


@dataclasses.dataclass
class GeoEnriched:
    """Wraps a source; each sequence carries a (lon, lat) and its census
    block's feature token ``block_id % n_geo_tokens`` (mod the vocab)
    replaces its first token.

    The mapping runs through a ``core.engine.GeoEngine`` with a cell index
    (strategy "fast" or "hybrid": points are drawn from the covering
    cells, so a simple-only engine is rejected); the legacy
    ``fast_index``/``fast_cfg`` pair is still accepted and wrapped into a
    fast-strategy engine on first use.
    """

    source: SyntheticLM
    engine: object = None            # core.engine.GeoEngine
    fast_index: object = None        # legacy: core.fast.FastIndex
    fast_cfg: object = None          # legacy: core.fast.FastConfig
    points_seed: int = 7
    n_geo_tokens: int = 1024

    def _engine(self):
        if self.engine is None:
            from repro_torch.core.engine import EngineConfig, GeoEngine
            fcfg = self.fast_cfg
            cfg = EngineConfig() if fcfg is None else EngineConfig(
                mode=fcfg.mode, cap_boundary=fcfg.cap_boundary,
                backend=fcfg.backend)
            self.engine = GeoEngine("fast", cfg, fast_index=self.fast_index)
        if self.engine.fast_index is None:
            raise ValueError("GeoEnriched needs an engine with a cell "
                             "index (strategy 'fast' or 'hybrid'); got "
                             f"strategy {self.engine.strategy!r}")
        return self.engine

    def point_draws(self, step: int, batch: int):
        """The step's point draws, on the CPU: ([batch] covering cell
        rows, [batch, 2] f32 jitter in [0, 1))."""
        g = step_generator(self.points_seed, step)
        n_cells = self._engine().fast_index.cell_lo.shape[0]
        return (torch.randint(0, n_cells, (batch,), generator=g),
                torch.rand((batch, 2), generator=g))

    def sample_points(self, step: int, batch: int) -> torch.Tensor:
        """[batch, 2] f32 on-map points on the engine's device."""
        engine = self._engine()
        r, u = self.point_draws(step, batch)
        return cell_points(engine.fast_index, r.to(engine.device),
                           u.to(engine.device))

    def batch_at(self, step: int) -> dict:
        out = dict(self.source.batch_at(step))
        tokens = out["tokens"].clone()
        xy = self.sample_points(step, tokens.shape[0])
        bid = self._engine().assign(xy).block
        geo_tok = (bid.clamp(min=0) % self.n_geo_tokens).to(torch.int32)
        tokens[:, 0] = (geo_tok % self.source.cfg.vocab).to(tokens.device)
        out["tokens"] = tokens
        out["geo_block"] = bid
        return out


def make_source(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                geo=None, device="cuda"):
    """A SyntheticLM of ``shape`` on ``device``; with ``geo`` (a
    GeoEngine, or the legacy (FastIndex, FastConfig) pair) wrapped in
    GeoEnriched."""
    src = SyntheticLM(cfg=cfg, batch=shape.global_batch, seq=shape.seq_len,
                      seed=seed, device=device)
    if geo is None:
        return src
    if isinstance(geo, tuple):
        index, fcfg = geo
        return GeoEnriched(source=src, fast_index=index, fast_cfg=fcfg)
    return GeoEnriched(source=src, engine=geo)
