"""Feed-forward variants (port of src/repro/models/ffn.py): SwiGLU (llama
family), squared-ReLU (nemotron), GELU (enc-dec).

The activations are written op for op as ``jax.nn.silu`` and
``jax.nn.gelu`` (its tanh form) lower, each op in the activation dtype
and their constants rounded to it, so in bf16 they give ``repro``'s bits
(``F.silu`` / ``F.gelu`` compute in f32 and round once: one bf16 ulp
off in about a third of the elements).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense, dense_spec


def ffn_spec(d, d_ff, act: str):
    if act == "swiglu":
        return {
            "w_gate": dense_spec(d, d_ff, ("embed", "mlp")),
            "w_up": dense_spec(d, d_ff, ("embed", "mlp")),
            "w_down": dense_spec(d_ff, d, ("mlp", "embed")),
        }
    return {
        "w_up": dense_spec(d, d_ff, ("embed", "mlp")),
        "w_down": dense_spec(d_ff, d, ("mlp", "embed")),
    }


def silu(x):
    """``jax.nn.silu``: x * (1 / (1 + exp(-x)))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x):
    """``jax.nn.gelu`` (approximate=True)."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = const(math.sqrt(2.0 / math.pi)) * (
        x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def ffn(params, x, act: str):
    if act == "swiglu":
        g = dense(params["w_gate"], x)
        u = dense(params["w_up"], x)
        h = silu(g) * u
    elif act == "relu2":
        h = torch.square(torch.relu(dense(params["w_up"], x)))
    elif act == "gelu":
        h = gelu_tanh(dense(params["w_up"], x))
    else:
        raise ValueError(act)
    return dense(params["w_down"], h)
