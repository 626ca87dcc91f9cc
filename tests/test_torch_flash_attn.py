"""The port's flash attention (src/repro_torch/kernels/flash_attn.py)
against the JAX package's, on the same numpy inputs.

The plain twin ``ref.flash_attn_bhsd`` — the CPU backend, and what
chip_smoke.py holds the CUDA kernel against on the card — is held
against the Pallas kernel run in interpret mode, with the sweep of
tests/test_flash_attn.py plus S = 100, and against an f64 numpy softmax.
Tolerances, stated per dtype: in f32 the twin and the Pallas kernel take
the same tiles and differ only in summation order, so 2e-6 absolute on
outputs of unit scale; in bf16 both round p and the output to bf16, so
two bf16 ulps of the output (1 / 64 relative) plus 1e-3 absolute for
outputs near zero and for a p that the two round to neighbouring bf16
values (a step of 2^-7 of p).  The port's ``flash_attn`` wrapper keeps repro's
tile-multiple assert; ``ops.flash_attn`` takes any S.

The wrapper routes by shape (``flash_route``): bf16 at D 64 / 128 to the
tensor-core kernel (128-key tiles), everything else to the CUDA-core one
(32-key tiles); on the CPU it runs the twin at the tile of that route.
The CUDA kernels run only on a card: the cases marked ``cuda`` hold them
against the twin there and skip elsewhere (chip_smoke.py runs the same
sweep on the card).  There bf16 is held element by element to two bf16
ulps of the twin's output plus 2^-7 times the twin's spread, sum_j p_j
|v_j| / l: kernel and twin may round a p at a bf16 rounding edge apart,
a step of at most 2^-7 p_j.  The CPU cases below show that bound holds,
at either route's tile, for a twin that only reorders its sums (another
KV tile) and fails for one that skips a KV tile.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as j_flash
from repro.models.attention import blockwise_attn as j_blockwise
from repro_torch.kernels import flash_attn, ops, ref

NEEDS_CUDA = "needs a CUDA device; chip_smoke.py checks it"
F32_ATOL = 2e-6
BF16_RTOL = 2.0 ** -6             # two bf16 ulps of the output
BF16_ATOL = 1e-3

SWEEP = [(2, 64, 4, 4, 16), (1, 128, 4, 2, 32), (2, 256, 8, 1, 16),
         (1, 100, 2, 2, 64)]


def _qkv(rng, b, s, h, kh, d):
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kh, d)).astype(np.float32),
            rng.normal(size=(b, s, kh, d)).astype(np.float32))


def _to_bhsd(x, h):
    b, s, kh, d = x.shape
    x = np.repeat(x, h // kh, axis=2)
    return np.ascontiguousarray(np.moveaxis(x, 2, 1).reshape(b * h, s, d))


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)


def _np_attention(q, k, v, causal):
    """f64 softmax attention over [BH, S, D]."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = q @ np.swapaxes(k, 1, 2) / np.sqrt(q.shape[-1])
    if causal:
        n = q.shape[1]
        s = np.where(np.tril(np.ones((n, n), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def _flash_over(got, want, spread):
    """Max |got - want| / (two bf16 ulps of want + 2^-7 spread), equal
    elements 0 (chip_smoke.py ``flash_over``)."""
    want = want.float()
    diff = (got.float() - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
    tol = 2.0 * ulp + 2.0 ** -7 * spread
    return float(torch.where(diff == 0, 0.0, diff / tol).max())


def _twin_skipping(q, k, v, skip, bk=32):
    """The twin's causal loop with KV tile ``skip`` left out: a planted
    fault."""
    bh, s, d = q.shape
    qpos = torch.arange(s)[:, None]
    m = torch.full((bh, s, 1), -1.0e30)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, d))
    for k0 in range(0, s, bk):
        if k0 // bk == skip:
            continue
        kt, vt = k[:, k0:k0 + bk].float(), v[:, k0:k0 + bk]
        sc = (q.float() @ kt.transpose(1, 2)) / math.sqrt(d)
        kpos = k0 + torch.arange(kt.shape[1])
        sc = torch.where(kpos[None, :] <= qpos, sc, -1.0e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        r = torch.exp(m - m_new)
        l = l * r + p.sum(-1, keepdim=True)
        acc = acc * r + p.to(v.dtype).float() @ vt.float()
        m = m_new
    return (acc / l).to(q.dtype)


def _jdt(dtype):
    return jnp.float32 if dtype == "f32" else jnp.bfloat16


def _tdt(dtype):
    return torch.float32 if dtype == "f32" else torch.bfloat16


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kh,d", SWEEP)
def test_twin_matches_pallas_interpret(b, s, h, kh, d, causal, dtype):
    """The twin at the Pallas kernel's KV tile equals the kernel run in
    interpret mode (q, k, v rounded to the dtype on both sides)."""
    rng = np.random.default_rng(b * s + h + d)
    q, k, v = (_to_bhsd(x, h) for x in _qkv(rng, b, s, h, kh, d))
    tile = min(32, s) if s % 32 == 0 else s
    want = j_flash.flash_attn_bhsd(
        *(jnp.asarray(x, _jdt(dtype)) for x in (q, k, v)), causal=causal,
        bq=tile, bk=tile, interpret=True)
    got = ref.flash_attn_bhsd(
        *(torch.as_tensor(x).to(_tdt(dtype)) for x in (q, k, v)),
        causal=causal, bk=tile)
    assert got.dtype == _tdt(dtype)
    _close(got.float(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kh,d", SWEEP)
def test_port_flash_attn_matches_repro(b, s, h, kh, d, causal, dtype):
    """The port's [B, S, H, D] wrapper (CPU: the twin at the KV tile of
    the route the card would take) against repro's, Pallas in interpret
    mode at its default tiles, GQA repeat included."""
    rng = np.random.default_rng(7 * s + kh)
    q, k, v = _qkv(rng, b, s, h, kh, d)
    want = j_flash.flash_attn(
        *(jnp.asarray(x, _jdt(dtype)) for x in (q, k, v)), causal=causal,
        interpret=True)
    got = flash_attn.flash_attn(
        *(torch.as_tensor(x).to(_tdt(dtype)) for x in (q, k, v)),
        causal=causal)
    assert got.shape == (b, s, h, d) and got.dtype == _tdt(dtype)
    _close(got.float(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,bk", [(64, 64), (100, 64), (300, 64),
                                  (300, 32), (7, 64)])
def test_twin_matches_f64_softmax(s, bk, causal):
    """The twin at any S and KV tile (ragged last tile included) against
    plain f64 softmax attention: f32 rounding only (2e-6)."""
    rng = np.random.default_rng(s + bk)
    q, k, v = (rng.normal(size=(3, s, 16)).astype(np.float32)
               for _ in range(3))
    got = ref.flash_attn_bhsd(*(torch.as_tensor(x) for x in (q, k, v)),
                              causal=causal, bk=bk)
    np.testing.assert_allclose(got.numpy(), _np_attention(q, k, v, causal),
                               atol=F32_ATOL, rtol=0)


def test_causal_tile_skip_is_exact():
    """A KV tile wholly above the diagonal leaves (m, l, acc) bit-equal
    (p = 0, rescale 1): the twin on the first 64 rows of a 256-key causal
    problem equals the twin on those rows alone, bit for bit — what lets
    the kernel skip those tiles."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 256, 32)),
                               dtype=torch.float32) for _ in range(3))
    full = ref.flash_attn_bhsd(q, k, v, causal=True, bk=32)
    head = ref.flash_attn_bhsd(q[:, :64].contiguous(), k[:, :64].contiguous(),
                               v[:, :64].contiguous(), causal=True, bk=32)
    assert torch.equal(full[:, :64], head)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kh,d", [(2, 100, 4, 2, 16),
                                        (1, 37, 4, 1, 32)])
def test_ops_flash_attn_any_length(b, s, h, kh, d, dtype):
    """``ops.flash_attn`` takes a length that is no tile multiple (the
    dense prefill's prompts) and agrees with repro's blockwise_attn on
    the repeated KV; in bf16 blockwise rounds p before summing l, so the
    bf16 tolerance covers that too."""
    rng = np.random.default_rng(s)
    q, k, v = _qkv(rng, b, s, h, kh, d)
    g = h // kh
    want = j_blockwise(
        *(jnp.asarray(x, _jdt(dtype)) for x in (q, np.repeat(k, g, 2),
                                               np.repeat(v, g, 2))),
        causal=True, chunk_q=32, chunk_kv=32)
    got = ops.flash_attn(*(torch.as_tensor(x).to(_tdt(dtype))
                           for x in (q, k, v)), causal=True)
    if dtype == "f32":     # blockwise's chunks sum in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=10 * F32_ATOL, rtol=0)
    else:
        _close(got.float(), np.asarray(want, np.float32), dtype)


def test_flash_attn_keeps_tile_multiple_assert():
    q = torch.zeros(1, 100, 2, 16)
    with pytest.raises(AssertionError, match="multiple of the tile"):
        flash_attn.flash_attn(q, q, q, bq=64, bk=64)
    assert flash_attn.flash_attn(q, q, q).shape == q.shape   # one tile


def test_cpu_wrapper_runs_the_twin_and_counts_nothing():
    """A CPU tensor takes the twin (at its route's tile) and launches
    nothing; the ref backend refuses nothing on the CPU."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 70, 16)),
                               dtype=torch.float32) for _ in range(3))
    before = (dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES))
    got = flash_attn.flash_attn_bhsd(q, k, v, causal=True)
    assert (dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES)) == before
    assert torch.equal(got, ref.flash_attn_bhsd(
        q, k, v, causal=True, bk=flash_attn.kv_tile(torch.float32, 16)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", flash_attn.HEAD_DIMS)
def test_flash_route_by_dtype_and_head_dim(dtype, d):
    """bf16 at D 64 / 128 (every full-width config) takes the tensor
    cores; f32 at every D (no TF32) and bf16 at D 16 / 32 the CUDA
    cores.  The KV tile follows the route."""
    route = flash_attn.flash_route(dtype, d)
    tensor_cores = dtype == torch.bfloat16 and d in (64, 128)
    assert route == ("wgmma" if tensor_cores else "simt")
    assert flash_attn.kv_tile(dtype, d) == (
        flash_attn.KV_TILE if tensor_cores else flash_attn.SIMT_KV_TILE)
    assert (flash_attn.KV_TILE, flash_attn.SIMT_KV_TILE) == (128, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_cpu_wrapper_calls_twin_at_route_tile(monkeypatch, dtype, d):
    """On the CPU the wrapper calls the twin once, at the KV tile of the
    route the same call takes on the card."""
    calls = []
    twin = ref.flash_attn_bhsd

    def spy(*args, **kw):
        calls.append(kw["bk"])
        return twin(*args, **kw)

    monkeypatch.setattr(ref, "flash_attn_bhsd", spy)
    rng = np.random.default_rng(d)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 40, d))).to(dtype)
               for _ in range(3))
    got = flash_attn.flash_attn_bhsd(q, k, v, causal=True)
    want = 128 if flash_attn.flash_route(dtype, d) == "wgmma" else 32
    assert calls == [want]
    assert torch.equal(got, twin(q, k, v, causal=True, bk=want))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CUDA)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(64, 16), (300, 32), (100, 64),
                                 (300, 128), (2048, 64)])
def test_cuda_kernel_matches_twin(cuda_device, s, d, causal, dtype):
    """Both routes (bf16 at D 64 / 128 on the tensor cores, the rest on
    the CUDA cores) against the twin at their tiles; a second launch
    bit-equal."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.as_tensor(rng.normal(size=(4, s, d)), dtype=dtype,
                               device=cuda_device) for _ in range(3))
    route = f"flash_attn_bhsd:{flash_attn.flash_route(dtype, d)}"
    before = _build.ROUTE_LAUNCHES[route]
    got = flash_attn.flash_attn_bhsd(q, k, v, causal=causal)
    again = flash_attn.flash_attn_bhsd(q, k, v, causal=causal)
    want = ref.flash_attn_bhsd(q, k, v, causal=causal,
                               bk=flash_attn.kv_tile(dtype, d))
    torch.cuda.synchronize()
    assert _build.ROUTE_LAUNCHES[route] == before + 2
    assert torch.equal(got, again)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, rtol=0)
    else:
        _, spread = ref.flash_attn_bhsd(q, k, v, causal=causal,
                                        bk=flash_attn.kv_tile(dtype, d),
                                        spread=True)
        assert _flash_over(got, want, spread) <= 1.0


def test_twin_spread_is_sum_p_abs_v_over_l():
    """``spread=True`` returns the output unchanged and sum_j p_j |v_j| / l
    (f64 softmax weights, within f32 rounding)."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(2, 100, 16)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    out, spread = ref.flash_attn_bhsd(tq, tk, tv, causal=True, bk=32,
                                      spread=True)
    assert torch.equal(out, ref.flash_attn_bhsd(tq, tk, tv, causal=True,
                                                bk=32))
    s = q.astype(np.float64) @ np.swapaxes(k, 1, 2) / 4.0
    s = np.where(np.tril(np.ones((100, 100), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ np.abs(v.astype(np.float64))
    np.testing.assert_allclose(spread.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("s,tile,skip", [
    (512, 32, 12), (1024, 32, 24), (300, 32, 7),        # CUDA-core tile
    (512, 128, 3), (1024, 128, 6), (300, 128, 2)])      # tensor-core tile
def test_bf16_bound_passes_reordering_and_fails_a_skipped_tile(s, tile,
                                                               skip):
    """The bf16 bound chip_smoke.py holds the kernels to: the twin at a
    64-key tile (other rescale points, other sums) stays within it of the
    twin at a kernel's tile (32 keys on the CUDA cores, 128 on the tensor
    cores), and a twin that skips one tile of that size does not (v
    scaled as the LM's values, std 0.9)."""
    rng = np.random.default_rng(s)
    q, k = (torch.as_tensor(rng.normal(size=(4, s, 64)),
                            dtype=torch.bfloat16) for _ in range(2))
    v = torch.as_tensor(0.9 * rng.normal(size=(4, s, 64)),
                        dtype=torch.bfloat16)
    want, spread = ref.flash_attn_bhsd(q, k, v, causal=True, bk=tile,
                                       spread=True)
    reordered = ref.flash_attn_bhsd(q, k, v, causal=True, bk=64)
    assert _flash_over(reordered, want, spread) <= 1.0
    skipped = _twin_skipping(q, k, v, skip, bk=tile)
    assert _flash_over(skipped, want, spread) > 1.0
