"""Serving step builders (port of ``make_prefill_step`` and
``make_serve_step`` in src/repro/runtime/steps.py; the loss and the
train step come with the training slice).

The port's model holds its parameters, so the steps take none:
``prefill_step(batch) -> last logits [B, V]`` and
``serve_step(tokens [B, 1], cache) -> (next tokens [B, 1] i32, cache)``.
Both run under ``torch.inference_mode()``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.model import Model


def make_prefill_step(model: Model, run: RunConfig):
    """Forward-only step over a full sequence (the inference-prefill cell)."""

    @torch.inference_mode()
    def prefill_step(batch):
        logits, _ = model.forward(run, batch)
        # Next-token logits for the last position only.
        return logits[:, -1, :]

    return prefill_step


def make_serve_step(model: Model, run: RunConfig):
    """One greedy decode step against a KV cache."""

    @torch.inference_mode()
    def serve_step(tokens, cache):
        logits, cache = model.decode_step(run, tokens, cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step
