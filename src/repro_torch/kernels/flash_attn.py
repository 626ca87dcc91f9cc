"""Flash attention (port of src/repro/kernels/flash_attn.py).  Kernel:
``csrc/flash_attn.cu``.

``flash_attn_bhsd`` replaces the Pallas ``flash_attn_bhsd``
(src/repro/kernels/flash_attn.py:78): causal or full online-softmax
attention over [BH, S, D], scale 1 / sqrt(D), the softmax state (m, l,
acc) in f32 and never in device memory.  The Pallas kernel needs S to be
a multiple of its tiles; the CUDA kernel takes any S (it masks the
ragged tail itself).  It is bound by operations at the prefill's shapes
(see the source for the design and what it leaves for later).

``flash_attn`` is ``repro``'s [B, S, H, D] convenience wrapper (GQA by
repeating the KV heads), with its tile-multiple assert for callers that
pass ``bq`` / ``bk``; the dense model's prefill and forward reach it
through ``ops.flash_attn``.  ``make_flash_attn_trainable`` (a backward that recomputes
through ``blockwise_attn``) comes with the training slice.

CPU tensors go to the plain twin ``ref.flash_attn_bhsd`` at the kernel's
KV tile (``KV_TILE`` keys), so the CPU computes what the card computes up
to summation order; CUDA tensors launch the kernel on the current
stream, without synchronizing.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

KV_TILE = 32                  # keys per tile in csrc/flash_attn.cu
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_BH = 65535                # the kernel's grid y extent


def flash_attn_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v [BH, S, D] (f32 or bf16, one dtype, contiguous, D in
    ``HEAD_DIMS``) -> [BH, S, D] in q's dtype."""
    if q.device.type == "cpu":
        return ref.flash_attn_bhsd(q, k, v, causal=causal, bk=KV_TILE)
    dev = q.device
    bh, s, d = q.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attn_bhsd: dtype {q.dtype} not in {DTYPES}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, name, q.dtype, (bh, s, d), dev)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attn_bhsd: head dim {d} not in {HEAD_DIMS}")
    if bh > MAX_BH or s * d >= 2**31:
        raise ValueError(f"flash_attn_bhsd: [{bh}, {s}, {d}] out of range")
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.repro_flash_attn_bhsd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            bh, s, d, int(q.dtype == torch.bfloat16), int(causal),
            ctypes.c_float(1.0 / math.sqrt(d)), _build.stream_of(q))
    _build.check(status, "flash_attn_bhsd")
    return out


def attend_bshd(fn, q, k, v, *, causal: bool):
    """Run the [BH, S, D] function ``fn`` on q [B, S, H, D] and k / v
    [B, S, KH, D] (KV heads repeated to H, as ``jnp.repeat`` does):
    [B, S, H, D] out."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)

    def bhsd(x):
        return x.transpose(1, 2).reshape(b * h, s, d)

    o = fn(bhsd(q), bhsd(k), bhsd(v), causal=causal)
    return o.reshape(b, h, s, d).transpose(1, 2)


def flash_attn(q, k, v, *, causal: bool = True, bq: int | None = None,
               bk: int | None = None):
    """``repro``'s wrapper: q [B,S,H,D], k/v [B,S,KH,D] (KV repeated to H)
    -> [B,S,H,D], any S.  The kernel picks its own tiles; a caller that
    passes ``bq`` / ``bk`` keeps ``repro``'s contract that S is a multiple
    of each (clamped to S)."""
    s = q.shape[1]
    assert all(t is None or s % min(t, s) == 0 for t in (bq, bk)), \
        f"seq {s} must be a multiple of the tile ({bq}, {bk})"
    return attend_bshd(flash_attn_bhsd, q, k, v, causal=causal)
