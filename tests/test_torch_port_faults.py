"""Three inputs that ``repro`` takes and the port's kernels once refused
on the card, and the wrappers' repairs:

* F1, a head dim the flash kernels lack (MiniCPM-2B's reduced config has
  72 / 6 = 12): ``flash_attn.run_padded`` zero-pads D to the next of
  ``HEAD_DIMS``, launches at the true D's scale and slices the output.
  With the twin in place of the kernel it equals the unpadded twin in
  f32 within 2e-6 (the padded products sum the same terms plus exact
  zeros; only a different matmul blocking could reorder them), and the
  reduced MiniCPM-2B model runs end to end against ``repro``.
* F2, more than 65,535 heads (the kernels' grid y): ``run_padded`` cuts
  BH into chunks; with a small chunk and the twin it is bit-equal to one
  call (heads are independent).
* F3, a contiguous view that starts mid-vector (``flat[1:].view(-1,
  2)``): ``ops.aligned`` copies it, and every engine maps it as it maps
  the aligned copy.

Two more, found later:

* F4, the served footprint: ``GeoIndexSet.memory_footprint()`` counted
  the pool's ``live`` [P] i32 in ``edge_pool_bytes``, which ``repro``
  does not have, so a fused server's ``region0_*`` gauges differed from
  ``repro``'s.  It now counts ``blocks``, ``first`` and ``count``
  (``EdgePool.nbytes()`` stays the device total).
* F5, the launch counters under threads: ``_build.check`` incremented
  ``LAUNCHES`` outside any lock, and the async server's replica threads
  launch concurrently.  The increments now hold ``_build._count_lock``.

Two more, found by comparing the packages' public signatures:

* F6, ``FastIndex.nbytes()``: ``repro``'s sums the bytes of the cell
  lookup's five arrays (the Table I bench calls it); the port's index
  had no such method.  It now sums the same five, equal to ``repro``'s.
* F7, ``resolve_candidates(k=...)``: ``repro``'s cuts each candidate
  list to its first k slots right after the compaction; the port's
  refused the keyword.  It now cuts at the same point: ids and
  ``ResolveStats`` equal ``repro``'s at k = 1 and 2 on both schedules.

One more, found training on a data mesh (a rank's batch of one row):

* F10, flash at batch 1: ``attend_bshd`` reshaped q / k / v [1, S, H,
  D] to [H, S, D] after a transpose, which at B = 1 is a strided view,
  and the kernel wrapper refuses a non-contiguous tensor on the card
  (``q must be contiguous``): a one-prompt prefill or a rank's one-row
  training step failed there.  ``bhsd`` now makes it contiguous; the
  test hands ``attend_bshd`` a function that refuses what the card's
  wrapper refuses, at B = 1 and 3, with the twin's values.

Two more, found running the model on the meta device (the dry-run,
``launch.dryrun``):

* F12, the kernel wrappers sent only CPU tensors to their twins: a meta
  tensor took the CUDA route and failed building the kernels ("nvcc not
  found"), where ``ops.resolve_backend`` sends every tensor off the card
  to ``ref``.  Every wrapper now takes the twin for any tensor not on
  CUDA; the tests call flash (both routes' dtypes, a padded head dim),
  the two bbox kernels, the two pip kernels, the segment kernel (with
  and without a value column) and the candidate test on meta tensors,
  with ``_build.load`` refusing, and get meta tensors of the twin's
  shapes and dtypes;
* F13, the router's expert counts came from ``torch.bincount``, which
  the meta device lacks: they are now f32 ones added per expert
  (``index_add_``), exact below 2^24 and so bit-equal to the
  ``bincount``'s on the CPU, and the router runs on meta.

The cases marked ``cuda`` repeat each on the card, against the twins,
and skip here; chip_smoke.py runs the same on the H100.
"""
import dataclasses
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cells import build_cell_covering
from repro.core.compact import capacity_for
from repro.core.engine import EngineConfig as JConfig
from repro.core.engine import GeoEngine as JEngine
from repro.core.fast import cell_values as j_cell_values
from repro.core.resolve import resolve_candidates as j_resolve
from repro.serving import GeoServer as JServer
from repro.serving import ServeConfig as JServeConfig
from repro_torch.core.artifact import COVERING_KEYS
from repro_torch.core.cells import CellCovering
from repro_torch.core.engine import EngineConfig, GeoEngine
from repro_torch.core.resolve import resolve_candidates as t_resolve
from repro_torch import configs
from repro_torch.kernels import _build, flash_attn, gather_pip, ops, ref
from repro_torch.kernels import bbox as bbox_kernels
from repro_torch.kernels import pip as pip_kernels
from repro_torch.kernels import segment as segment_kernels
from repro_torch.models import moe as t_moe
from repro_torch.serving import GeoServer, ServeConfig

from covering_pair import shared_footprint

NEEDS_CUDA = "needs a CUDA device; chip_smoke.py checks it"
F32_ATOL = 2e-6
STRATEGIES = {"fast": ("fast", {}), "fast_fused": ("fast", {"fused": True}),
              "fast_onepass": ("fast_onepass", {}), "simple": ("simple", {}),
              "simple_fused": ("simple", {"fused": True}),
              "hybrid": ("hybrid", {})}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CUDA)
    return torch.device("cuda")


def _qkv(rng, bh, s, d, dtype, device="cpu"):
    return tuple(torch.as_tensor(rng.normal(size=(bh, s, d)),
                                 dtype=torch.float32).to(device, dtype)
                 for _ in range(3))


def _twin_into(q, k, v, out, *, causal, scale):
    """The twin with ``run_padded``'s launch signature."""
    out.copy_(ref.flash_attn_bhsd(
        q, k, v, causal=causal, scale=scale,
        bk=flash_attn.kv_tile(q.dtype, q.shape[2])))


# ------------------------------------------------------------------ F1
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [12, 24])
def test_padded_head_dim_equals_unpadded_twin(d, causal):
    rng = np.random.default_rng(d)
    q, k, v = _qkv(rng, 3, 70, d, torch.float32)
    got = flash_attn.run_padded(_twin_into, q, k, v, causal=causal)
    want = ref.flash_attn_bhsd(q, k, v, causal=causal,
                               bk=flash_attn.kv_tile(torch.float32, d))
    assert got.shape == (3, 70, d) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL,
                               rtol=0)


def test_padded_head_dims_and_routes():
    """D pads to the next kernel instance; the route follows the padded
    D; D > 128 is refused."""
    assert [flash_attn.padded_head_dim(d) for d in (1, 12, 16, 24, 33, 72,
                                                     128)] == \
        [16, 16, 16, 32, 64, 128, 128]
    assert flash_attn.flash_route(torch.bfloat16, 12) == "simt"
    assert flash_attn.flash_route(torch.bfloat16, 48) == "wgmma"
    assert flash_attn.flash_route(torch.float32, 48) == "simt"
    assert flash_attn.kv_tile(torch.bfloat16, 100) == flash_attn.KV_TILE
    with pytest.raises(ValueError, match="head dim 192"):
        flash_attn.padded_head_dim(192)
    q = torch.zeros(2, 8, 192)
    with pytest.raises(ValueError, match="head dim 192"):
        flash_attn.run_padded(_twin_into, q, q, q, causal=True)


def test_minicpm_reduced_forward_matches_repro():
    """MiniCPM-2B's reduced config (head dim 12) through the port's
    ``forward`` on the CPU twins, against repro's on the same weights
    (logits within 0.1, the model tests' bound): the path that reaches
    the padded flash call on the card."""
    import jax
    from repro import configs as j_configs
    from repro.configs.base import RunConfig as JRunConfig
    from repro.models.model import build_model as j_build_model
    from repro.models.module import init_params as j_init_params
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import module
    from repro_torch.models.model import build_model
    cfg = configs.get_reduced_config("minicpm-2b")
    assert cfg.d_model // cfg.n_heads == 12
    jm = j_build_model(j_configs.get_reduced_config("minicpm-2b"))
    jp = j_init_params(jm.specs, jax.random.key(0))
    tm = build_model(cfg, "cpu")
    module.params_from_numpy(tm, jax.tree.map(lambda a: np.array(a), jp))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)).astype(
        np.int32)
    kw = dict(remat="none", attn_chunk_q=16, attn_chunk_kv=16)
    want = jm.forward(jp, JRunConfig(**kw), {"tokens": jnp.asarray(toks)})[0]
    got, _ = tm.forward(RunConfig(**kw), {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=0.1, rtol=0)


# ------------------------------------------------------------------ F2
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 24])
def test_chunked_heads_equal_one_call(dtype, d):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 8, 40, d, dtype)
    one = flash_attn.run_padded(_twin_into, q, k, v, causal=True)
    for chunk in (1, 3, 8):
        assert torch.equal(flash_attn.run_padded(
            _twin_into, q, k, v, causal=True, chunk=chunk), one)


def test_chunks_cover_every_head_once():
    seen = []

    def record(q, k, v, out, *, causal, scale):
        seen.append(q.shape[0])
        out.fill_(len(seen))

    q = torch.zeros(10, 4, 16)
    out = flash_attn.run_padded(record, q, q, q, causal=True, chunk=4)
    assert seen == [4, 4, 2]
    assert out[:, 0, 0].tolist() == [1] * 4 + [2] * 4 + [3] * 2


# ------------------------------------------------------------------ F3
def test_aligned_copies_only_a_misaligned_view():
    flat = torch.arange(2 * 100 + 1, dtype=torch.float32)
    view = flat[1:].view(-1, 2)
    assert view.is_contiguous() and view.data_ptr() % 8 != 0
    got = ops.aligned(view, 8)
    assert got.data_ptr() % 8 == 0 and torch.equal(got, view)
    assert got.data_ptr() != view.data_ptr()
    ok = flat[2:200].view(-1, 2)
    assert ok.data_ptr() % 8 == 0
    assert ops.aligned(ok, 8) is ok
    strided = flat[:200].view(100, 2)[:, :1]
    assert ops.aligned(strided, 8).is_contiguous()


# ------------------------------------------------------------------ F4
def test_fused_footprint_and_gauges_match_repro(engines, points_small):
    """A fused ``fast`` index and a fused server built the same way in
    both packages: equal ``memory_footprint()`` and equal ``region0_*``
    gauges in ``snapshot()`` and in the metrics text."""
    census, cov, _, eng = engines
    j = JEngine.build(census, "fast", JConfig(backend="ref", fused=True,
                                              max_level=8), covering=cov)
    t = eng["fast_fused"]
    jfp, tfp = j.indices.memory_footprint(), t.indices.memory_footprint()
    assert shared_footprint(t.indices, jfp) == jfp
    assert tfp["edge_pool_bytes"] > 0
    pool = t.fast_index.edge_pool
    assert pool.nbytes() == tfp["edge_pool_bytes"] + 4 * pool.n_poly
    cfg = dict(buckets=(64, 256, 1024), cache=False)
    js, ts = JServer(j, JServeConfig(**cfg)), GeoServer(t, ServeConfig(**cfg))
    xy = points_small[0][:500]
    js.submit(jnp.asarray(xy))
    ts.submit(xy)

    def region_gauges(snap):
        return {k: v for k, v in snap["gauges"].items()
                if k.startswith("region0_")}

    jg, tg = region_gauges(js.snapshot()), region_gauges(ts.snapshot())
    assert set(tg) - set(jg) == {f"region0_{k}" for k in COVERING_KEYS}
    assert {k: tg[k] for k in jg} == jg and tg["region0_edge_pool_bytes"] > 0
    own = tuple(f"region0_{k}" for k in COVERING_KEYS)
    lines = [ln for ln in ts.metrics_text().splitlines()
             if "region0_" in ln and not ln.startswith("#")
             and not any(k in ln for k in own)]
    assert lines and lines == [
        ln for ln in js.metrics_text().splitlines()
        if "region0_" in ln and not ln.startswith("#")]


# ------------------------------------------------------------------ F5
def _hammer(n_threads=8, n_calls=10_000):
    """``n_threads`` threads each call ``check(0, "bbox_mask")``
    ``n_calls`` times, the interpreter switching threads as often as it
    can; returns the count a lock-safe counter must reach."""
    _build.reset_launches()
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(n_calls):
            _build.check(0, "bbox_mask", route="r")

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    return n_threads * n_calls


class _YieldingCounts(dict):
    """A counter dict that gives up the GIL between the read and the write
    of ``d[k] += n`` — the preemption the interpreter allows there but
    rarely takes."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counts_exact_under_threads(monkeypatch):
    """8 threads call ``check(0, "bbox_mask")`` 10,000 times each (status
    0 launches nothing, so this runs on the CPU): the count is exactly
    80,000, also when every increment is preempted between its read and
    its write."""
    monkeypatch.setattr(_build, "ROUTE_LAUNCHES",
                        {**_build.ROUTE_LAUNCHES, "bbox_mask:r": 0})
    want = _hammer()
    assert _build.LAUNCHES["bbox_mask"] == want
    assert _build.ROUTE_LAUNCHES["bbox_mask:r"] == want
    monkeypatch.setattr(_build, "LAUNCHES",
                        _YieldingCounts(_build.LAUNCHES))
    monkeypatch.setattr(_build, "ROUTE_LAUNCHES",
                        _YieldingCounts(_build.ROUTE_LAUNCHES))
    want = _hammer(n_calls=2_000)
    assert _build.LAUNCHES["bbox_mask"] == want
    assert _build.ROUTE_LAUNCHES["bbox_mask:r"] == want
    monkeypatch.undo()
    _build.reset_launches()


@pytest.fixture(scope="module")
def engines(synth_small):
    census = synth_small.census
    cov = build_cell_covering(census, max_level=8)
    t_cov = CellCovering(**dataclasses.asdict(cov))
    return census, cov, t_cov, {
        name: GeoEngine.build(census, strategy,
                              EngineConfig(max_level=8, **kw),
                              covering=t_cov, device="cpu")
        for name, (strategy, kw) in STRATEGIES.items()}


def _same(a, b):
    for f in ("state", "county", "block"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
    assert a.stats.as_dict() == b.stats.as_dict()


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_misaligned_points_map_like_aligned(engines, points_small, name):
    """Every engine on ``flat[1:].view(-1, 2)`` equals the aligned copy
    and ``repro``'s engine on the same points."""
    census, cov, _, eng = engines
    xy = points_small[0][:1000].astype(np.float32)
    flat = torch.empty(2 * len(xy) + 1)
    flat[1:] = torch.from_numpy(xy).reshape(-1)
    view = flat[1:].view(-1, 2)
    assert view.data_ptr() % 8 != 0
    got = eng[name].assign(view)
    _same(got, eng[name].assign(view.clone()))
    strategy, kw = STRATEGIES[name]
    want = JEngine.build(census, strategy, JConfig(backend="ref",
                                                   max_level=8, **kw),
                         covering=cov).assign(jnp.asarray(xy))
    np.testing.assert_array_equal(np.asarray(want.block),
                                  got.block.numpy())


# ------------------------------------------------------------ F6, F7
@pytest.fixture(scope="module")
def fast_pair(engines):
    """``repro``'s ``fast`` engine and the port's over one covering."""
    census, cov, _, eng = engines
    return JEngine.build(census, "fast", JConfig(backend="ref", max_level=8),
                         covering=cov), eng["fast"]


def test_fast_index_nbytes_matches_repro(fast_pair):
    j, t = fast_pair
    jidx, tidx = j.fast_index, t.fast_index
    want = jidx.nbytes()
    assert tidx.nbytes() == want > 0
    assert want == sum(np.asarray(getattr(jidx, f)).nbytes for f in (
        "cell_lo", "cell_hi", "cell_val", "cand", "top_start"))


@pytest.mark.parametrize("two_phase", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_resolve_candidates_truncates_to_k(fast_pair, points_small, k,
                                           two_phase):
    """The boundary points' candidate lists (K slots) cut to k in both
    packages: equal ids and counters, and equal to the port's call on
    the lists cut beforehand.  The cut is not idle: at k = 1 some point
    resolves otherwise than with the full list."""
    j, t = fast_pair
    jidx, tidx = j.fast_index, t.fast_index
    points = points_small[0].astype(np.float32)
    val = np.asarray(j_cell_values(jidx, jnp.asarray(points)))
    need = (val < 0) & (val > -2**30)
    table = np.asarray(jidx.cand)
    assert table.shape[1] > k
    cand = table[np.clip(-(val + 1), 0, len(table) - 1)]
    prior = np.where(val >= 0, val, -1).astype(np.int32)
    cap = capacity_for(len(points), 1.0)
    kw = dict(cap=cap, fallback="prior", two_phase=two_phase)
    aj, sj = j_resolve(jnp.asarray(points), jnp.asarray(cand),
                       jidx.block_edges, jnp.asarray(need), k=k,
                       backend="ref", prior=jnp.asarray(prior), **kw)
    at, st = t_resolve(torch.from_numpy(points), torch.from_numpy(cand),
                       tidx.block_edges, torch.from_numpy(need), k=k,
                       prior=torch.from_numpy(prior), **kw)
    np.testing.assert_array_equal(np.asarray(aj), at.numpy())
    for f in ("n_need", "n_pip", "overflow", "phase2_miss"):
        assert int(getattr(sj, f)) == int(getattr(st, f)), f
    def port(cand_ids):
        return t_resolve(torch.from_numpy(points), torch.from_numpy(
            np.ascontiguousarray(cand_ids)), tidx.block_edges,
            torch.from_numpy(need), prior=torch.from_numpy(prior), **kw)
    cut, scut = port(cand[:, :k])
    assert torch.equal(cut, at)
    for f in ("n_need", "n_pip", "overflow", "phase2_miss"):
        assert int(getattr(scut, f)) == int(getattr(st, f)), f
    assert int(need.sum()) > 0
    if k == 1:
        assert not torch.equal(port(cand)[0], at)


# ----------------------------------------------------------------- F10
@pytest.mark.parametrize("b", [1, 3])
def test_attend_bshd_hands_the_kernel_contiguous_heads(b):
    rng = np.random.default_rng(10)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, 64, h, 16)),
                               dtype=torch.float32) for h in (4, 2, 2))

    def kernel(q_, k_, v_, *, causal):
        for name, t in (("q", q_), ("k", k_), ("v", v_)):
            if not t.is_contiguous():       # _build.require's refusal
                raise ValueError(f"{name} must be contiguous")
        return ref.flash_attn_bhsd(q_, k_, v_, causal=causal, bk=32)

    def twin(q_, k_, v_, *, causal):
        return ref.flash_attn_bhsd(q_, k_, v_, causal=causal, bk=32)

    got = flash_attn.attend_bshd(kernel, q, k, v, causal=True)
    assert torch.equal(got, flash_attn.attend_bshd(twin, q, k, v,
                                                   causal=True))


# ----------------------------------------------------------------- F12
META_CALLS = ("flash_f32_d12", "flash_bf16_d64", "bbox_mask",
              "bbox_count_select", "bbox_select_children",
              "crossings_gathered", "crossings_one", "segment_counts",
              "segment_values", "crossings_candidates")


def _kernel_calls(rng) -> dict:
    """{name: (wrapper, CPU arguments, keywords)} of every kernel wrapper
    whose twin runs on meta (the cascade's reads its candidate counts)."""
    def f32(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, size=shape),
                               dtype=torch.float32)

    def i32(hi, *shape):
        return torch.as_tensor(rng.integers(0, hi, size=shape),
                               dtype=torch.int32)
    ids = torch.sort(i32(5, 40)).values
    qkv_bf16 = [f32(6, 40, 64).to(torch.bfloat16) for _ in range(3)]
    flash = flash_attn.flash_attn_bhsd
    i32s = [torch.tensor(v, dtype=torch.int32)
            for v in ([0, 1, 3], [1, 2, 1], [16, 20, 9])]
    return {
        "flash_f32_d12": (flash, [f32(6, 40, 12) for _ in range(3)],
                          {"causal": True}),
        "flash_bf16_d64": (flash, qkv_bf16, {"causal": False}),
        "bbox_mask": (bbox_kernels.bbox_mask, [f32(40, 2), f32(7, 4)], {}),
        "bbox_count_select": (bbox_kernels.bbox_count_select,
                              [f32(40, 2), f32(40, 3, 4)], {}),
        "bbox_select_children": (bbox_kernels.bbox_select_children,
                                 [f32(40, 2), i32(5, 40), i32(6, 6, 3),
                                  f32(7, 4), 2], {}),
        "crossings_gathered": (pip_kernels.crossings_gathered,
                               [f32(40, 2), f32(40, 5, 4)], {}),
        "crossings_one": (pip_kernels.crossings_one,
                          [f32(40, 2), f32(5, 4)], {}),
        "segment_counts": (segment_kernels.segment_reduce_sorted,
                           [ids, None, 4], {}),
        "segment_values": (segment_kernels.segment_reduce_sorted,
                           [ids, f32(40), 4], {}),
        "crossings_candidates": (gather_pip.crossings_candidates,
                                 [i32(3, 40), f32(40, 2), *i32s,
                                  f32(4, 4, 16), 2], {}),
    }


@pytest.mark.parametrize("name", META_CALLS)
def test_meta_tensors_take_the_twin(monkeypatch, name):
    """F12: a wrapper called on meta tensors runs its twin there (meta
    results of the twin's shapes and dtypes) and builds no kernel."""
    def refuse(*args, **kwargs):
        raise AssertionError("a meta call reached the kernel build")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "nvcc_path", refuse)
    fn, args, kw = _kernel_calls(np.random.default_rng(12))[name]
    want = fn(*args, **kw)
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta")
            if isinstance(a, torch.Tensor) else a for a in args]
    got = fn(*meta, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (w.shape, w.dtype)


# ----------------------------------------------------------------- F13
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_expert_counts_equal_bincount(seed):
    """F13: the router's ``ce`` bit-equal to the ``bincount`` it replaced
    (routing tilted so some experts get many picks and some none), and
    the router runs on meta."""
    cfg = configs.get_reduced_config("mixtral-8x7b")
    rng = np.random.default_rng(seed)
    t = 515
    x = torch.as_tensor(rng.normal(size=(t, cfg.d_model)),
                        dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(cfg.d_model, cfg.n_experts)),
                        dtype=torch.float32)
    w[:, 0] += 2.0 * seed
    params = {"router": {"w": w}}
    _, ids, (_, ce) = t_moe._router(params, cfg, x)
    want = torch.bincount(ids.reshape(-1).long(),
                          minlength=cfg.n_experts).float() / (t * cfg.top_k)
    assert torch.equal(ce, want)
    meta = {"router": {"w": w.to("meta")}}
    top_p, ids_m, (me, ce_m) = t_moe._router(meta, cfg, x.to("meta"))
    assert ce_m.device.type == "meta" and ce_m.shape == ce.shape
    assert ids_m.shape == ids.shape and top_p.shape == ids.shape


# ------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [12, 24])
def test_cuda_padded_head_dim_matches_twin(cuda_device, d, causal, dtype):
    rng = np.random.default_rng(d)
    q, k, v = _qkv(rng, 3, 100, d, dtype, cuda_device)
    got = flash_attn.flash_attn_bhsd(q, k, v, causal=causal)
    want, spread = ref.flash_attn_bhsd(
        q, k, v, causal=causal, bk=flash_attn.kv_tile(dtype, d),
        spread=True)
    assert got.shape == q.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs())) - 7)
        assert bool((diff <= 2 * ulp + 2.0 ** -7 * spread).all())


@pytest.mark.cuda
def test_cuda_minicpm_reduced_serves(cuda_device):
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as serve_mod
    cfg = get_reduced_config("minicpm-2b")
    model = serve_mod.load_model(cfg, seed=0, device=cuda_device)
    prompts = serve_mod.make_prompts(cfg, 2, 32, 0, cuda_device)
    before = _build.LAUNCHES["flash_attn_bhsd"]
    res = serve_mod.serve(model, prompts, 4)
    assert _build.LAUNCHES["flash_attn_bhsd"] - before >= cfg.n_layers
    assert res.tokens.shape == (2, 4)
    assert bool(torch.isfinite(res.prefill_logits).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [24, 64])
def test_cuda_chunked_heads_equal_one_launch(cuda_device, d):
    """The kernel launched over chunks of 4 heads (``run_padded`` around
    the wrapper's own launch) equals one launch over all 10."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 10, 128, d, torch.bfloat16, cuda_device)
    before = _build.LAUNCHES["flash_attn_bhsd"]
    one = flash_attn.flash_attn_bhsd(q, k, v, causal=True)
    chunked = flash_attn.run_padded(flash_attn._launch, q, k, v, causal=True,
                                    chunk=4)
    assert _build.LAUNCHES["flash_attn_bhsd"] - before == 1 + 3
    assert torch.equal(one, chunked)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STRATEGIES))
def test_cuda_misaligned_points_map_like_aligned(engines, points_small,
                                                 cuda_device, name):
    census, _, t_cov, _ = engines
    strategy, kw = STRATEGIES[name]
    eng = GeoEngine.build(census, strategy, EngineConfig(max_level=8, **kw),
                          covering=t_cov, device=cuda_device)
    xy = torch.from_numpy(points_small[0].astype(np.float32)).to(cuda_device)
    flat = torch.empty(2 * xy.shape[0] + 1, device=cuda_device)
    flat[1:] = xy.reshape(-1)
    view = flat[1:].view(-1, 2)
    assert view.data_ptr() % 8 != 0
    _same(eng.assign(view), eng.assign(view.clone()))
