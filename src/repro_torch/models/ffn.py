"""Feed-forward variants (port of src/repro/models/ffn.py): SwiGLU (llama
family), squared-ReLU (nemotron), GELU (enc-dec).

The activations are written op for op as ``jax.nn.silu`` and
``jax.nn.gelu`` (its tanh form) lower, each op in the activation dtype
and their constants rounded to it, so in bf16 they give ``repro``'s bits
(``F.silu`` / ``F.gelu`` compute in f32 and round once: one bf16 ulp
off in about a third of the elements).

Under a mesh whose "model" axis splits the hidden width
(``sharding.rules.tp_layout``), ``ffn`` takes this rank's column blocks
of ``w_gate`` / ``w_up`` and its row block of ``w_down`` (Megatron's
column / row layout): the input enters through ``psum_bwd``, the bf16
partials leave through ``layers.dense_rows``.  Under the
sequence-parallel residual (``sp``: the input is this rank's sequence
block) the input is all-gathered along the sequence and the partials
leave by a reduce-scatter along it; an FFN whose hidden width does not
split runs on the rank's own tokens, its leaves through
``layers.sp_tree``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense, dense_rows, dense_spec, \
    model_block, seq_gather, sigmoid, sp_tree


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
    return x * sigmoid(x)


def gelu_tanh(x):
    """``jax.nn.gelu`` (approximate=True)."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = const(math.sqrt(2.0 / math.pi)) * (
        x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def ffn(params, x, act: str, mesh=None, d_ff=None, sp=False):
    """x [..., D] -> [..., D].  With ``d_ff`` (the config's width) and a
    ``w_down`` whose rows are this rank's block of it, tensor-parallel
    over ``mesh``'s "model" axis; with ``sp``, x [B, S / m, D] is this
    rank's sequence block and so is the output (see the module doc)."""
    tp = d_ff is not None and model_block(
        mesh, params["w_down"]["w"].shape[0], d_ff)
    if tp:
        x = seq_gather(x, mesh, sp)
    else:
        params = sp_tree(params, mesh, sp)
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
    if tp:
        return dense_rows(params["w_down"], h, mesh, sp)
    return dense(params["w_down"], h)
