"""Flash attention (port of src/repro/kernels/flash_attn.py).  Kernels:
``csrc/flash_attn_wgmma.cu`` and ``csrc/flash_attn.cu``.

``flash_attn_bhsd`` replaces the Pallas ``flash_attn_bhsd``
(src/repro/kernels/flash_attn.py:78): causal or full online-softmax
attention over [BH, S, D], scale 1 / sqrt(D), the softmax state (m, l,
acc) in f32 and never in device memory.  The Pallas kernel needs S to be
a multiple of its tiles; the CUDA kernels take any S (they mask the
ragged tail themselves).  It is bound by operations at the prefill's
shapes.

Two CUDA kernels, picked by ``flash_route(dtype, D)``, a route by shape
and never a fallback (a launch that fails raises):

* ``"wgmma"``: bf16 at a padded D of 64 or 128, every full-width config
  the repo ships.  Hopper's tensor cores (wgmma, with TMA filling a
  2-stage K / V ring), 128 query rows a block, ``KV_TILE`` keys a tile.
* ``"simt"``: f32 at every D (the tensor cores would compute in TF32,
  not the reference's f32) and bf16 at a padded D of 16 or 32 (the
  reduced test configs).  f32 arithmetic on the CUDA cores,
  ``SIMT_KV_TILE`` keys a tile.

A head dim the kernels lack (MiniCPM-2B's reduced 12, say) is
zero-padded up to the next of ``HEAD_DIMS`` and launched with the true
D's scale, 1 / sqrt(D); zero columns add nothing to q . k, and V's zero
columns give zero output columns, which are sliced off.  The route
follows the padded D.  D > 128 raises (MLA's 192 / 24 come with the MLA
slice).  A call over more than ``MAX_BH`` heads (the kernels' grid y
extent) launches in chunks of at most ``MAX_BH`` heads on the same
stream, so any B * H runs, as the Pallas grid takes any.
``run_padded`` does both, around the kernel launch or, in the CPU
tests, the twin.

``_build.LAUNCHES["flash_attn_bhsd"]`` counts every launch and
``_build.ROUTE_LAUNCHES["flash_attn_bhsd:<route>"]`` the launches of each
route.

``flash_attn`` is ``repro``'s [B, S, H, D] convenience wrapper (GQA by
repeating the KV heads), with its tile-multiple assert for callers that
pass ``bq`` / ``bk``; the dense model's prefill and its forward without
grad reach it through ``ops.flash_attn``.  Neither is differentiable:
``flash_attn_bhsd`` raises when grad is enabled and an input requires
grad (the kernel's launch is invisible to autograd, so its inputs would
get no gradient).  ``make_flash_attn_trainable`` (``repro``'s
``custom_vjp``, here a ``torch.autograd.Function``) is the path under
autograd: its forward is ``flash_attn``, its backward recomputes
through ``models.attention.blockwise_attn`` at ``chunk = min(chunk, S)``
and returns that program's gradients.  ``repro`` has no backward kernel,
and neither has the port.

Tensors off the card (CPU or meta) go to the plain twin
``ref.flash_attn_bhsd`` at the KV tile of the route the call would take
on the card (``kv_tile``), so the CPU computes what the card computes up
to summation order (``ops.resolve_backend``'s rule); CUDA tensors launch
the route's kernel on the current stream, without synchronizing, and
never fall back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

KV_TILE = 128                 # keys per tile in csrc/flash_attn_wgmma.cu
SIMT_KV_TILE = 32             # keys per tile in csrc/flash_attn.cu
HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_BH = 65535                # the kernels' grid y extent: heads a launch


def padded_head_dim(d: int) -> int:
    """The kernels' head dim for a call's true ``d``: the least entry of
    ``HEAD_DIMS`` that holds it.  Raises for d > 128."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"flash_attn_bhsd: head dim {d} > {HEAD_DIMS[-1]}, the "
                     f"kernels' largest (MLA's head dims come with the MLA "
                     f"slice)")


def flash_route(dtype, d: int) -> str:
    """The kernel a [BH, S, d] call of ``dtype`` takes, by its padded head
    dim: ``"wgmma"`` (the tensor cores) for bf16 at a padded d in
    ``WGMMA_HEAD_DIMS``, else ``"simt"`` (f32 on the CUDA cores)."""
    if (dtype == torch.bfloat16 and d <= HEAD_DIMS[-1]
            and padded_head_dim(d) in WGMMA_HEAD_DIMS):
        return "wgmma"
    return "simt"


def kv_tile(dtype, d: int) -> int:
    """Keys per KV tile of the route a (dtype, d) call takes."""
    return KV_TILE if flash_route(dtype, d) == "wgmma" else SIMT_KV_TILE


def run_padded(fn, q, k, v, *, causal: bool, chunk: int = MAX_BH):
    """``fn`` over q, k, v [BH, S, D] with D zero-padded to
    ``padded_head_dim(D)`` and BH cut into chunks of at most ``chunk``
    heads: ``fn(q, k, v, out, causal=, scale=)`` fills ``out`` (views of
    one [BH, S, Dp] tensor, in order) at the true D's scale.  Returns
    [BH, S, D] (padded columns sliced off)."""
    bh, s, d = q.shape
    dp = padded_head_dim(d)
    if dp != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    for h0 in range(0, bh, chunk):
        sl = slice(h0, h0 + chunk)
        fn(q[sl], k[sl], v[sl], out[sl], causal=causal, scale=scale)
    return out if dp == d else out[..., :d].contiguous()


def _launch(q, k, v, out, *, causal: bool, scale: float) -> None:
    """One launch of the route's kernel over [n <= MAX_BH, S, Dp]."""
    bh, s, d = q.shape
    route = flash_route(q.dtype, d)
    lib = _build.load()
    qkvo = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out))
    with torch.cuda.device(q.device):
        if route == "wgmma":
            status = lib.repro_flash_attn_wgmma(
                *qkvo, bh, s, d, int(causal), ctypes.c_float(scale),
                _build.stream_of(q))
        else:
            status = lib.repro_flash_attn_simt(
                *qkvo, bh, s, d, int(q.dtype == torch.bfloat16),
                int(causal), ctypes.c_float(scale), _build.stream_of(q))
    _build.check(status, "flash_attn_bhsd", route)


def flash_attn_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v [BH, S, D] (f32 or bf16, one dtype, contiguous, D <= 128)
    -> [BH, S, D] in q's dtype.  On the card, D is padded and BH chunked
    (at most ``MAX_BH`` heads a launch) by ``run_padded``."""
    bh, s, d = q.shape
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attn_bhsd is not differentiable: use "
                           "make_flash_attn_trainable under autograd")
    if q.device.type != "cuda":
        return ref.flash_attn_bhsd(q, k, v, causal=causal,
                                   bk=kv_tile(q.dtype, d))
    dev = q.device
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attn_bhsd: dtype {q.dtype} not in {DTYPES}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, name, q.dtype, (bh, s, d), dev)
    dp = padded_head_dim(d)
    if s * dp >= 2**31:
        raise ValueError(f"flash_attn_bhsd: [{bh}, {s}, {d}] out of range")
    if bh == 0 or s == 0:
        return torch.empty_like(q)
    if dp == d and flash_route(q.dtype, d) == "wgmma":
        # TMA reads from 16-byte bases (a padded copy is a new allocation).
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            _build.require_aligned(t, name, 16)
    return run_padded(_launch, q, k, v, causal=causal)


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
        # contiguous(): at B = 1 the reshape is a strided view (F10).
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

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


class _TrainableFlash(torch.autograd.Function):
    """``repro``'s ``custom_vjp``: forward by ``flash_attn``, backward by
    autograd through ``blockwise_attn`` recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk = causal, chunk
        return flash_attn(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import blockwise_attn, repeat_kv
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        h, s = q.shape[2], q.shape[1]
        c = min(ctx.chunk, s)
        with torch.enable_grad():
            # repeat_kv is jnp.repeat(axis=2) by expand + reshape: its
            # backward sums the group in a fixed order.
            o = blockwise_attn(q, repeat_kv(k, h), repeat_kv(v, h),
                               causal=ctx.causal, chunk_q=c, chunk_kv=c)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None


def make_flash_attn_trainable(*, causal: bool = True, bq: int | None = None,
                              bk: int | None = None, chunk: int = 1024):
    """Training-capable flash attention (src/repro/kernels/flash_attn.py
    ``make_flash_attn_trainable``): the forward runs ``flash_attn`` (the
    kernel on the card, its twin on the CPU); the backward recomputes
    through ``blockwise_attn`` at chunk ``min(chunk, S)``, no score tiles
    saved.  ``bq`` / ``bk`` keep ``flash_attn``'s tile-multiple contract.

    Returns f(q [B,S,H,D], k/v [B,S,KH,D]) -> [B,S,H,D].
    """
    def f(q, k, v):
        s = q.shape[1]
        assert all(t is None or s % min(t, s) == 0 for t in (bq, bk)), \
            f"seq {s} must be a multiple of the tile ({bq}, {bk})"
        return _TrainableFlash.apply(q, k, v, causal, chunk)
    return f
