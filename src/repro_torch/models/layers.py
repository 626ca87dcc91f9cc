"""Shared layers: norms, embeddings, RoPE, dense (port of
src/repro/models/layers.py).

The upcasts are ``repro``'s, op for op: ``rmsnorm`` / ``layernorm`` and
``apply_rope`` compute in f32 and cast back, ``unembed`` gives f32
logits, ``dense`` casts ``w`` and ``b`` to the activation dtype.  A
product that ``repro`` takes in bf16 with an f32 result
(``preferred_element_type``) is taken here on f32 copies of the bf16
operands, which is the same arithmetic.  ``repro``'s ``shard_act`` /
``act_spec`` are no-ops without a mesh; they come with the distributed
slice.  ``params`` is a ``ParamTree`` or a plain dict of tensors.
"""
from __future__ import annotations

import torch

from repro_torch.models.module import P

ACT_DTYPE = torch.bfloat16


def rmsnorm_spec(d):
    return {"scale": P((d,), (None,), init="ones")}


def rmsnorm(params, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dt)


def layernorm_spec(d):
    return {"scale": P((d,), (None,), init="ones"),
            "bias": P((d,), (None,), init="zeros")}


def layernorm(params, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"] + params["bias"]).to(dt)


def embed_spec(vocab, d):
    return {"table": P((vocab, d), ("vocab", "embed"), init="normal")}


def embed(params, tokens):
    # Gather, then cast: the same bits as repro's cast-then-gather
    # without casting the whole table.
    return params["table"][tokens].to(ACT_DTYPE)


def unembed_spec(vocab, d):
    return {"w": P((d, vocab), ("embed", "vocab"), init="fanin", fan_in=d)}


def unembed(params, x):
    # Logits in f32 for a stable softmax / argmax.
    return x.float() @ params["w"].float()


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """positions [S] (or [B, S]) -> (sin, cos) [..., S, dim/2] f32."""
    assert dim % 2 == 0
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x [..., S, H, D]; sin/cos [S, D/2] or [B, S, D/2] (broadcast over H)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if sin.dim() == 2:   # [S, D/2] -> broadcast over batch and heads
        s = sin[None, :, None, :]
        c = cos[None, :, None, :]
    else:                # [B, S, D/2]
        s = sin[:, :, None, :]
        c = cos[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


def dense_spec(d_in, d_out, axes, bias=False, init="fanin"):
    s = {"w": P((d_in, d_out), axes, init=init, fan_in=d_in)}
    if bias:
        s["b"] = P((d_out,), (axes[1],), init="zeros")
    return s


def dense(params, x):
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y
