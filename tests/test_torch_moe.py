"""The port's MoE family (src/repro_torch/{distributed/dispatch.py,
models/moe.py, models/model.py::MoEModel}) against the JAX package's, on
the same numpy inputs and with ``repro``'s weights carried across by
``params_from_numpy``.  MLA and DeepSeek-V2's own parts are in
tests/test_torch_mla.py; both files share tests/moe_pair.py.

Sizes: the reduced configs of mixtral-8x7b (GQA 2:1, window 32, 4
experts, top-2) and deepseek-v2-236b (MLA, a dense first layer, 8
experts + 2 shared, top-2).  Tolerances, as stated per test:

* dispatch (``plan_routes``, ``slot_tables``, ``scatter_to_buckets``,
  ``gather_from_buckets``): exactly ``repro``'s, bf16 sums included
  (both add an item's rows in slot order);
* ``moe_ffn`` on equal inputs: routed ids and ``dropped`` exact,
  ``lb_loss`` within 1e-6, probabilities within 1e-6, the output within
  two bf16 ulps plus 2^-8 (tests/test_torch_models.py's ffn bound: the
  experts are the same SwiGLU);
* whole models (forward, decode, serve): routing and logits as
  tests/moe_pair.py says — a differing choice only at a near tie, logits
  within 0.1 at every token it does not affect (as
  tests/test_torch_models.py's dense models), ``lb_loss`` within
  ``moe_pair.lb_tol``, ``dropped`` within k per affected token;
* one train step: loss and ce within 5e-3, the grad norm within 5e-3
  relative (tests/test_torch_train.py's bounds).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moe_pair as mp
from repro import configs as j_configs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.distributed import dispatch as j_dispatch
from repro.models import moe as j_moe
from repro.models.model import build_model as j_build_model
from repro.models.module import param_count as j_param_count
from repro.optim import adamw as j_adamw
from repro.runtime import steps as j_steps
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.distributed import dispatch
from repro_torch.kernels import _build
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import model as model_mod
from repro_torch.models import attention, module, moe
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mixtral-8x7b", "deepseek-v2-236b")
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 2.0 ** -8
LOSS_ATOL, GNORM_RTOL = 5e-3, 5e-3
TRAIN_KNOBS = dict(attn_chunk_q=16, attn_chunk_kv=16, learning_rate=1e-3,
                   warmup_steps=2, total_steps=100)


@pytest.fixture(scope="module", autouse=True)
def routes():
    r = mp.Routes()
    r.install()
    yield r
    r.uninstall()


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return mp.Pair(request.param)


# ---------------------------------------------------------------- dispatch
DISPATCH_CASES = {
    # n items, buckets, capacity, the ids' range (nb = "not mine")
    "overflow": (200, 4, 16, 5),
    "roomy": (64, 8, 32, 8),
    "empty-buckets": (50, 8, 4, 3),
    "all-sentinel": (12, 3, 2, 0),
    "one-bucket": (33, 1, 7, 2),
    "capacity-1": (40, 6, 1, 7),
}


def _bucket_ids(n, nb, hi, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, n) if hi else np.full(n, nb)
    return np.minimum(ids, nb).astype(np.int32)


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_plan_and_slot_tables_match_repro(case):
    """Every field of the plan, and both slot tables (item_of mapping
    entries to items, per-entry weights), exactly ``repro``'s."""
    n, nb, cap, hi = DISPATCH_CASES[case]
    ids = _bucket_ids(n, nb, hi, seed=n + nb)
    jplan = j_dispatch.plan_routes(jnp.asarray(ids), nb, cap)
    tplan = dispatch.plan_routes(torch.as_tensor(ids), nb, cap)
    for field in j_dispatch.RoutePlan._fields:
        got, want = getattr(tplan, field), np.asarray(getattr(jplan, field))
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    assert tplan.flat_ix.dtype == tplan.slot.dtype == torch.int32
    assert tplan.n_dropped.dtype == torch.int32
    rng = np.random.default_rng(1)
    item_of = (np.arange(n) // 2).astype(np.int32)
    weights = rng.random(n).astype(np.float32)
    for kw in ({}, {"item_of": item_of}, {"item_of": item_of,
                                          "weights": weights}):
        jt = j_dispatch.slot_tables(jplan, nb, cap, **{
            k: jnp.asarray(v) for k, v in kw.items()})
        tt = dispatch.slot_tables(tplan, nb, cap, **{
            k: torch.as_tensor(v) for k, v in kw.items()})
        for got, want in zip(tt, jt):
            assert got.dtype == (torch.int32 if want.dtype == np.int32
                                 else torch.float32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["overflow", "roomy", "capacity-1"])
def test_scatter_gather_match_repro(case, dtype):
    """``scatter_to_buckets`` and ``gather_from_buckets`` bit for bit,
    with up to three rows an item (three route entries per item, so bf16
    sums depend on their order: both add in slot order)."""
    n, nb, cap, hi = DISPATCH_CASES[case]
    ids = _bucket_ids(n, nb, hi, seed=7)
    rng = np.random.default_rng(2)
    per_item = 3
    items = -(-n // per_item)
    item_of = (np.arange(n) // per_item).astype(np.int32)
    weights = rng.random(n).astype(np.float32)
    payload = rng.normal(size=(items, 8)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jplan = j_dispatch.plan_routes(jnp.asarray(ids), nb, cap)
    tplan = dispatch.plan_routes(torch.as_tensor(ids), nb, cap)
    jt = j_dispatch.slot_tables(jplan, nb, cap, item_of=jnp.asarray(item_of),
                                weights=jnp.asarray(weights))
    tt = dispatch.slot_tables(tplan, nb, cap,
                              item_of=torch.as_tensor(item_of),
                              weights=torch.as_tensor(weights))
    jbuf = j_dispatch.scatter_to_buckets(jplan, jnp.asarray(payload, jdt), nb,
                                         cap, item_for_slot=jt[0])
    tbuf = dispatch.scatter_to_buckets(tplan, torch.as_tensor(payload).to(
        tdt), nb, cap, item_for_slot=tt[0])
    np.testing.assert_array_equal(mp.np32(tbuf), mp.np32(jbuf))
    h = rng.normal(size=(nb * cap, 8)).astype(np.float32)
    want = j_dispatch.gather_from_buckets(jt, jnp.asarray(h, jdt), items)
    for per in (per_item, None):        # the bound given, or read
        got = dispatch.gather_from_buckets(tt, torch.as_tensor(h).to(tdt),
                                           items, per_item=per)
        assert got.dtype == tdt and got.shape == (items, 8)
        np.testing.assert_array_equal(mp.np32(got), mp.np32(want))


@pytest.mark.parametrize("seed", range(8))
def test_dispatch_roundtrip_properties(seed):
    """tests/test_models.py::test_dispatch_roundtrip_properties on the
    port: kept items occupy unique slots in range, drops are exactly the
    over-capacity tail, and a scatter then gather with weight 1 gives the
    kept items back and zeros for the dropped."""
    rng = np.random.default_rng(seed)
    n, nb, cap = int(rng.integers(4, 200)), int(rng.integers(1, 9)), \
        int(rng.integers(1, 33))
    buckets = rng.integers(0, nb + 1, n).astype(np.int32)
    plan = dispatch.plan_routes(torch.as_tensor(buckets), nb, cap)
    keep, flat = plan.keep.numpy(), plan.flat_ix.numpy()
    kept_slots = flat[keep]
    assert len(set(kept_slots.tolist())) == keep.sum()
    assert (kept_slots < nb * cap).all() and (flat[~keep] == nb * cap).all()
    expect_drop = sum(max(0, int((buckets == i).sum()) - cap)
                      for i in range(nb))
    assert int(plan.n_dropped) == expect_drop
    payload = torch.as_tensor(rng.normal(size=(n, 4)).astype(np.float32))
    tabs = dispatch.slot_tables(plan, nb, cap)
    buf = dispatch.scatter_to_buckets(plan, payload, nb, cap,
                                      item_for_slot=tabs[0])
    out = dispatch.gather_from_buckets(tabs, buf, n).numpy()
    kept_items = np.zeros(n, bool)
    kept_items[plan.order.numpy()[keep]] = True
    np.testing.assert_array_equal(out[kept_items],
                                  payload.numpy()[kept_items])
    assert (out[~kept_items] == 0).all()


# ------------------------------------------------------------------ moe_ffn
def _moe_params(cfg, seed=3):
    rng = np.random.default_rng(seed)
    spec = moe.moe_spec(cfg)
    tree = module.tree_map(lambda p: (rng.normal(size=p.shape) / np.sqrt(
        p.shape[-2])).astype(np.float32), spec)
    # Experts stored as the serving build stores them (bf16); the router
    # in f32.
    return tree, module.tree_map(torch.as_tensor, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_repro(arch, routes):
    cfg = configs.get_reduced_config(arch)
    tree, tp = _moe_params(cfg)
    x = np.random.default_rng(4).normal(size=(96, cfg.d_model)).astype(
        np.float32)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        jp_, ji, (jme, jce) = j_moe._router(
            jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(x, dt))
        tp_, ti, (tme, tce) = moe._router(tp, cfg,
                                          torch.as_tensor(x).to(tdt))
        assert ti.dtype == torch.int32 and tp_.dtype == torch.float32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), atol=1e-6)
        np.testing.assert_allclose(tme.numpy(), np.asarray(jme), atol=1e-6)
        np.testing.assert_array_equal(tce.numpy(), np.asarray(jce))


def test_topk_ties_take_the_lower_index():
    """Tied probabilities: ``jax.lax.top_k``'s order (descending, the
    lower index first on a tie), which the port's stable sort keeps."""
    cfg = dataclasses.replace(configs.get_reduced_config("mixtral-8x7b"),
                              n_experts=6, top_k=3)
    w = np.zeros((4, 6), np.float32)
    w[0] = [1, 0, 1, 0, 1, 0]
    w[1] = [0, 2, 0, 2, 1, 2]
    w[2] = [1, 1, 1, 1, 1, 1]
    x = np.eye(4, dtype=np.float32)
    _, ti, _ = moe._router({"router": {"w": torch.as_tensor(w)}}, cfg,
                           torch.as_tensor(x))
    _, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x @ w), -1), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [0, 2, 4] and ti[2].tolist() == [0, 1, 2]
    assert ti[1].tolist() == [1, 3, 5]


@pytest.mark.parametrize("cf", [1.25, 0.5, "no-drop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_repro(arch, cf, routes):
    """Equal inputs (bf16 [2, 48, D]): routed ids and ``dropped`` exact,
    ``lb_loss`` within 1e-6, the output (shared experts included for
    deepseek) within the bf16 bound; at the published capacity factor,
    at a tight one (many drops) and at E / k (capacity = T, none)."""
    cfg = configs.get_reduced_config(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=(
        cfg.n_experts / cfg.top_k if cf == "no-drop" else cf))
    tree, tp = _moe_params(cfg)
    x = np.random.default_rng(5).normal(size=(2, 48, cfg.d_model))
    with routes.record():
        jy, jaux = j_moe.moe_ffn(jax.tree.map(jnp.asarray, tree), cfg,
                                 jnp.asarray(x, jnp.bfloat16))
        ty, taux = moe.moe_ffn(tp, cfg, torch.as_tensor(x).to(torch.bfloat16))
    (_, jids), = routes.j
    (tids,) = routes.t
    np.testing.assert_array_equal(tids, jids)
    assert taux["dropped"].dtype == torch.int32
    assert int(taux["dropped"]) == int(jaux["dropped"])
    if cf == "no-drop":
        assert int(taux["dropped"]) == 0
    elif cf == 0.5:
        assert int(taux["dropped"]) > 0
    assert abs(float(taux["lb_loss"]) - float(jaux["lb_loss"])) <= 1e-6
    assert ty.dtype == torch.bfloat16 and ty.shape == x.shape
    np.testing.assert_allclose(mp.np32(ty), mp.np32(jy), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


def test_moe_ffn_refuses_a_mesh():
    cfg = configs.get_reduced_config("mixtral-8x7b")
    _, tp = _moe_params(cfg)
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 7"):
        moe.moe_ffn(tp, cfg, x, mesh=object())


@pytest.mark.parametrize("tokens", [1, 8, 80, 16384])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_repro(arch, tokens):
    """``repro``'s ceil(T k / E * cf), at least 1: a decode step (T = B)
    gets a small capacity; full width too."""
    for cfg in (configs.get_reduced_config(arch), configs.get_config(arch)):
        want = max(1, int(np.ceil(tokens * cfg.top_k / cfg.n_experts
                                  * cfg.capacity_factor)))
        assert moe.capacity_of(cfg, tokens) == want
    assert moe.capacity_of(configs.get_config("mixtral-8x7b"), 8) == 3


# ------------------------------------------------------- params and builds
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_follows_repro(arch, reduced):
    """On the meta device (full width too: no memory): every stack of
    repro's tree (``dense_blocks`` included) split per layer, shape for
    shape, and the counts agree."""
    get = "get_reduced_config" if reduced else "get_config"
    cfg = getattr(configs, get)(arch)
    jm = j_build_model(getattr(j_configs, get)(arch))
    tm = build_model(cfg, "meta")
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jm.abstract_params())[0]:
        keys = [p.key for p in path]
        if keys[0] in ("blocks", "dense_blocks"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i)] + keys[1:])] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == want
    assert tm.param_count() == j_param_count(jm.specs)
    assert not hasattr(tm, "prefill")
    abstract = tm.abstract_params()
    assert jax.tree_util.tree_structure(jm.abstract_params()) == \
        jax.tree_util.tree_structure(module.tree_map(lambda t: 0, abstract))
    if not reduced and arch == "mixtral-8x7b":
        assert 4.6e10 < tm.param_count() < 4.7e10
        assert abstract["blocks"]["moe"]["w_gate"].shape == (32, 8, 4096,
                                                             14336)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_dtypes_by_use(arch):
    """The serving build stores each leaf in the dtype of its use: the
    router and MLA's ``wuk`` / ``wuv`` f32 (repro reads them in f32), the
    3-D experts and every dense weight bf16 (repro casts them), norms,
    the embedding and the unembedding f32; the training build all f32."""
    cfg = configs.get_config(arch)
    tm = build_model(cfg, "meta")
    f32 = ("moe.router.w", "attn.wuk.w", "attn.wuv.w")
    seen = set()
    for name, p in tm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith(f32):
            want = torch.float32
            seen.add(name.split(".", 2)[-1])
        elif "blocks." in name and leaf in ("w", "b", "w_gate", "w_up",
                                            "w_down"):
            want = torch.bfloat16
        else:
            want = torch.float32
        assert p.dtype == want, name
    assert "moe.router.w" in seen
    assert ("attn.wuk.w" in seen) == (arch == "deepseek-v2-236b")
    assert tm.blocks[0].moe.w_gate.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in build_model(
        cfg, "meta", trainable=True).parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_follow_repro(arch):
    """``cache_specs``, ``input_specs`` (train / prefill / decode) and the
    decode cache's layout (window-length k / v for mixtral, ckv / kr and
    dense_k / dense_v for deepseek) against repro's shapes and dtypes, on
    the meta device at full width."""
    cfg = configs.get_config(arch)
    jcfg = j_configs.get_config(arch)
    jm = j_build_model(jcfg)
    tm = build_model(cfg, "meta")
    jc = jm.cache_specs(4, 8192)
    tc = tm.cache_specs(4, 8192)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
        assert tc[k].device.type == "meta"
    if arch == "mixtral-8x7b":
        assert tc["k"].shape[2] == cfg.sliding_window
    from repro.models.model import input_specs as j_input_specs
    from repro_torch.configs.base import DECODE_32K, PREFILL_32K, TRAIN_4K
    from repro.configs import base as jb
    for shape, jshape in ((TRAIN_4K, jb.TRAIN_4K),
                          (PREFILL_32K, jb.PREFILL_32K),
                          (ShapeConfig("d", 64, 2, "decode"),
                           jb.ShapeConfig("d", 64, 2, "decode"))):
        got = model_mod.input_specs(cfg, shape)
        want = j_input_specs(jcfg, jshape)
        flat_g = module.flatten(got)
        flat_w = module.flatten(want)
        assert set(flat_g) == set(flat_w)
        for k in flat_w:
            assert tuple(flat_g[k].shape) == flat_w[k].shape, k
            assert str(flat_g[k].dtype).split(".")[-1] == \
                str(flat_w[k].dtype), k
    assert DECODE_32K.kind == "decode"


def test_streamed_load_is_bit_identical():
    """``load_model`` draws leaf by leaf into the parameters: Qwen's
    reduced weights from a seed equal the whole tree drawn first and
    loaded with ``params_from_numpy`` (the earlier loader), bit for bit;
    the first leaf also equals a truncated normal drawn by hand."""
    cfg = configs.get_reduced_config("qwen1.5-0.5b")
    got = serve_mod.load_model(cfg, seed=7, device="cpu")
    want = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(7)
    module.params_from_numpy(want, module.init_params(want.specs, gen,
                                                      "cpu"))
    pg, pw = dict(got.named_parameters()), dict(want.named_parameters())
    assert set(pg) == set(pw)
    assert all(torch.equal(pg[n], pw[n]) for n in pw)
    table = torch.empty(cfg.vocab, cfg.d_model)
    torch.nn.init.trunc_normal_(table, 0.0, 1.0, -2.0, 2.0,
                                generator=torch.Generator().manual_seed(7))
    assert torch.equal(pg["embed.table"], table * 0.02)


def test_streamed_load_fills_every_stack():
    """``init_params_into`` on deepseek reduced (``dense_blocks`` and
    ``blocks``): the same weights as the tree loaded whole."""
    cfg = configs.get_reduced_config("deepseek-v2-236b")
    got = serve_mod.load_model(cfg, seed=2, device="cpu")
    want = build_model(cfg, "cpu")
    module.params_from_numpy(want, module.init_params(
        want.specs, torch.Generator().manual_seed(2), "cpu"))
    pw = dict(want.named_parameters())
    assert any(n.startswith("dense_blocks.0.") for n in pw)
    assert all(torch.equal(p, pw[n]) for n, p in got.named_parameters())


# ------------------------------------------------------------- whole model
@pytest.mark.parametrize("s", [40, 37])
def test_forward_matches_repro(pair, s, routes):
    """Logits of every token no near-tie choice affects within 0.1,
    ``lb_loss`` within ``lb_tol``, ``dropped`` within k per affected
    token (exact when none is)."""
    cfg = pair.cfg
    toks = mp.tokens(cfg, 2, s, seed=s)
    with routes.record():
        want, jaux = pair.j_forward(toks)
        got, taux = pair.tm.forward(mp.RUN, {"tokens": torch.as_tensor(toks)})
    hit = mp.affected(cfg, routes.j, routes.t).reshape(2, s)
    assert (~hit).mean() >= mp.MIN_CLEAR
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = np.abs(mp.np32(got) - want).max(-1)
    assert diff[~hit].max() <= mp.LOGIT_ATOL, diff[~hit].max()
    assert taux["dropped"].dtype == torch.int32
    n_hit = int(hit.sum())
    assert abs(int(taux["dropped"]) - int(jaux["dropped"])) <= \
        cfg.top_k * n_hit
    assert abs(float(taux["lb_loss"]) - float(jaux["lb_loss"])) <= \
        mp.lb_tol(cfg, 2 * s, n_hit)


def _teacher_forced(pair, routes, toks, steps, max_len):
    """Both stacks fed ``toks`` one token at a time (the prompt) and then
    ``steps`` of repro's greedy tokens; logits compared at every step on
    the rows no near-tie choice affects at that step.  Returns (rows
    checked at argmax, the port's cache)."""
    cfg = pair.cfg
    b, s = toks.shape
    jc = pair.jm.init_cache(b, max_len)
    tc = pair.tm.init_cache(b, max_len)
    n_clear = required = 0
    before = np.zeros(b, bool)
    tok = toks[:, :1]
    for i in range(s + steps):
        with routes.record():
            jl, jc = pair.j_decode(tok, jc)
            tl, tc = pair.tm.decode_step(mp.RUN, torch.as_tensor(tok), tc)
        ok = ~mp.affected(cfg, routes.j, routes.t, before)
        before |= ~ok
        n_clear += int(ok.sum())
        jl, tl = mp.np32(jl)[:, -1], mp.np32(tl)[:, -1]
        np.testing.assert_allclose(tl[ok], jl[ok], atol=mp.LOGIT_ATOL,
                                   rtol=0)
        clear = ok & (mp.margin(jl) > mp.LOGIT_ATOL)
        np.testing.assert_array_equal(np.argmax(tl, -1)[clear],
                                      np.argmax(jl, -1)[clear])
        required += int(clear.sum())
        assert int(tc["pos"]) == int(jc["pos"]) == i + 1
        tok = toks[:, i + 1:i + 2] if i + 1 < s else \
            np.argmax(jl, -1).astype(np.int32)[:, None]
    assert n_clear >= mp.MIN_CLEAR * b * (s + steps)
    return required, tc


@pytest.mark.parametrize("s,steps", [(24, 4), (30, 12)])
def test_decode_teacher_forced(pair, routes, s, steps):
    """decode_step against repro's, fed the same tokens (T = B routes a
    step: capacity ceil(B k / E * cf)); mixtral's rolling window-32 cache
    runs past pos >= t at (30, 12), deepseek's MLA cache (ckv / kr) and
    its dense layer's cache fill to 42 slots."""
    toks = mp.tokens(pair.cfg, 3, s, seed=s)
    required, tc = _teacher_forced(pair, routes, toks, steps, s + steps)
    assert required > 0
    if pair.cfg.sliding_window:
        assert tc["k"].shape[2] == min(s + steps, pair.cfg.sliding_window)


def test_serve_token_loop_matches_repro_launcher(pair, routes):
    """``launch.serve.serve`` on a model without ``prefill``: the prompt
    fed token by token (``repro``'s launcher loop), the phases in order,
    no kernel launched, ``prefill_logits`` the last prompt step's, and the
    generated tokens repro's greedy tokens on unaffected rows wherever
    repro's margin is clear (repro fed the port's tokens)."""
    cfg = pair.cfg
    prompts = serve_mod.make_prompts(cfg, 3, 12, seed=1, device="cpu")
    seen = []
    before = dict(_build.LAUNCHES)
    with routes.record():
        res = serve_mod.serve(pair.tm, prompts, 6,
                              on_phase=lambda p, e: seen.append((p, e)))
    tcalls = list(routes.t)
    assert seen == [("prefill", "start"), ("prefill", "end"),
                    ("decode", "start"), ("decode", "end")]
    assert dict(_build.LAUNCHES) == before
    assert res.tokens.shape == (3, 6) and res.tokens.dtype == torch.int32
    assert torch.equal(res.tokens[:, 0],
                       res.prefill_logits.argmax(-1).to(torch.int32))
    # repro's launcher loop over the prompt, then the port's tokens.
    feed = np.concatenate([prompts.numpy(), res.tokens.numpy()], axis=1)
    jc = pair.jm.init_cache(3, 18)
    n_moe = len(pair.tm.blocks)
    n_clear = 0
    before = np.zeros(3, bool)
    for i in range(feed.shape[1] - 1):
        with routes.record():
            jl, jc = pair.j_decode(feed[:, i:i + 1], jc)
        ok = ~mp.affected(cfg, routes.j, tcalls[i * n_moe:(i + 1) * n_moe],
                          before)
        before |= ~ok
        n_clear += int(ok.sum())
        jl = mp.np32(jl)[:, -1]
        if i == 11:
            np.testing.assert_allclose(mp.np32(res.prefill_logits)[ok],
                                       jl[ok], atol=mp.LOGIT_ATOL, rtol=0)
        if i >= 11:
            clear = ok & (mp.margin(jl) > mp.LOGIT_ATOL)
            np.testing.assert_array_equal(
                res.tokens.numpy()[clear, i - 11], np.argmax(jl, -1)[clear])
    assert n_clear >= mp.MIN_CLEAR * 3 * (feed.shape[1] - 1)


def test_serve_launcher_runs_moe_on_the_cpu():
    """``python -m repro_torch.launch.serve --arch mixtral-8x7b --reduced
    --device cpu`` runs (the token-loop prefill)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mixtral-8x7b", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--gen", "4"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[serve] mixtral-8x7b-reduced: prefill 2x8" in r.stdout


def test_flash_routing_by_window(monkeypatch):
    """Mixtral's sliding window: a forward with S <= window launches
    ``ops.flash_attn`` once per layer, S > window never reaches it, and
    at S = window ``self_attn`` equals ``blockwise_attn`` with the window
    within the bf16 bound."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attn
    monkeypatch.setattr(ops, "flash_attn",
                        lambda *a, **kw: calls.append(a[0].shape) or
                        real(*a, **kw))
    cfg = configs.get_reduced_config("mixtral-8x7b")
    tm = serve_mod.load_model(cfg, seed=0, device="cpu")
    w = cfg.sliding_window
    for s, want in ((w, cfg.n_layers), (w - 5, cfg.n_layers), (w + 1, 0)):
        calls.clear()
        toks = torch.as_tensor(mp.tokens(cfg, 1, s, seed=s))
        with torch.no_grad():
            tm.forward(mp.RUN, {"tokens": toks})
        assert len(calls) == want, (s, calls)
    # At S <= window the window masks no key: the route's function is
    # blockwise_attn's with the window.
    rng = np.random.default_rng(6)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, w, h, cfg.hd)).astype(
        np.float32)).to(torch.bfloat16) for h in (4, 2, 2))
    kw = dict(causal=True, window=w, chunk_q=16, chunk_kv=16)
    monkeypatch.setattr(ops, "flash_attn", real)
    got = attention.self_attn(q, attention.repeat_kv(k, 4),
                              attention.repeat_kv(v, 4), **kw)
    want = attention.blockwise_attn(q, k, v, **kw)
    np.testing.assert_allclose(mp.np32(got), mp.np32(want), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


# ----------------------------------------------------------------- training
@pytest.fixture(scope="module")
def train_pair():
    return {arch: mp.Pair(arch) for arch in ARCHS}


def _batch(cfg, b=4, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())})


@pytest.mark.parametrize("microbatch", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_repro(train_pair, arch, microbatch):
    """One ``make_train_step`` against repro's jitted one on the same
    weights and batch: the metrics' keys (``lb_loss`` and ``dropped``
    among them), loss / ce / lb_loss within 5e-3, the grad norm within 5e-3
    relative, lr equal; at microbatch 2 too."""
    pair = train_pair[arch]
    knobs = dict(remat="none", microbatch=microbatch, **TRAIN_KNOBS)
    jrun = mp.JRunConfig(**knobs)
    run = RunConfig(**knobs)
    jb, tb = _batch(pair.cfg)
    _, jopt, jm = jax.jit(j_steps.make_train_step(pair.jm, jrun))(
        pair.jp, j_adamw.init(pair.jp), jb)
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    _, opt, m = steps.make_train_step(tm, run)(params, adamw.init(params),
                                               tb)
    assert set(m) == set(jm) == {"loss", "ce", "lb_loss", "dropped",
                                 "grad_norm", "lr"}
    assert int(opt.step) == int(jopt.step) == 1
    for key in ("loss", "ce", "lb_loss"):
        assert abs(float(m[key]) - float(jm[key])) <= LOSS_ATOL, key
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        GNORM_RTOL * float(jm["grad_norm"])
    assert m["dropped"].dtype == torch.float32 and float(m["dropped"]) > 0
    assert float(m["lr"]) == float(jm["lr"])


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_is_bit_equal(train_pair, remat):
    """remat dots / full recompute the MoE layers (routing, dispatch)
    identically: gradients and metrics bit-equal to remat none."""
    pair = train_pair["mixtral-8x7b"]
    _, tb = _batch(pair.cfg, seed=3)
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    out = [steps.make_grad_fn(tm, RunConfig(remat=r, **TRAIN_KNOBS))(
        params, tb) for r in ("none", remat)]
    (g0, m0), (g1, m1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert float(g0["blocks.1.moe.w_gate"].abs().max()) > 0
    assert float(g0["blocks.0.moe.router.w"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_moe(arch, tmp_path):
    """``launch.train`` takes the MoE archs: ``setup`` + ``train_loop``
    over ``make_train_step`` on the CPU, two steps, the loss finite and
    ``lb_loss`` / ``dropped`` reported."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime import driver
    cfg = configs.get_reduced_config(arch)
    model, params, opt = train_mod.setup(cfg, seed=0, device="cpu")
    run = train_mod.run_config(arch, 2, 32)
    src = SyntheticLM(cfg=cfg, batch=2, seq=32, seed=0, device="cpu")
    seen = []

    def step(params, opt, batch):
        params, opt, m = steps.make_train_step(model, run)(params, opt, batch)
        seen.append({k: float(v) for k, v in m.items()})
        return params, opt, m
    dcfg = driver.DriverConfig(total_steps=2, ckpt_every=2,
                               ckpt_dir=str(tmp_path), log_every=100)
    _, _, hist = driver.train_loop(step, params, opt, src, dcfg,
                                   log=lambda *_: None)
    assert hist["steps_run"] == 2 and len(seen) == 2
    assert all(np.isfinite(s["loss"]) and "lb_loss" in s and "dropped" in s
               for s in seen)


def test_train_cli_takes_moe(tmp_path):
    """``python -m repro_torch.launch.train --arch mixtral-8x7b --reduced
    --device cpu`` trains two steps and writes its checkpoints."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mixtral-8x7b", "--reduced", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[train] done: loss" in r.stdout and "2 steps" in r.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000000",
                                            "step_00000002"]


# --------------------------------------------------------------- checkpoints
def _repro_state(params, opt):
    """The port's state as repro's tree: every stack stacked, OptState."""
    def nest(flat):
        out = {}
        for name, t in flat.items():
            parts = name.split(".")
            stacked = parts[0] in ("blocks", "dense_blocks")
            if stacked:
                parts = [parts[0]] + parts[2:]
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            a = t.detach().numpy()
            if stacked:
                d.setdefault(parts[-1], []).append(a)
            else:
                d[parts[-1]] = jnp.asarray(a)
        return jax.tree.map(lambda ts: jnp.asarray(np.stack(ts)), out,
                            is_leaf=lambda x: isinstance(x, list))
    return {"params": nest(params),
            "opt": j_adamw.OptState(jnp.int32(int(opt.step)), nest(opt.m),
                                    nest(opt.v))}


def _stateful(arch, seed):
    cfg = configs.get_reduced_config(arch)
    model, params, opt = train_mod.setup(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k in params:
            opt.m[k].normal_(generator=gen)
            opt.v[k].uniform_(generator=gen)
        opt.step.fill_(3)
    return params, opt


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_both_ways(arch, tmp_path):
    """The MoE tree (``blocks.moe.w_gate`` [L, E, D, F], ``dense_blocks``)
    and its AdamW state: saved by the port, restored by repro into its
    tree equal; saved by repro, restored into the port's live tensors
    equal; the same npz keys and arrays either way."""
    params, opt = _stateful(arch, 0)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        3, {"params": params, "opt": opt})
    want = _repro_state(params, opt)
    jm = j_build_model(j_configs.get_reduced_config(arch))
    like = jax.tree.map(jnp.zeros_like, want)
    back = JManager(str(tmp_path / "port")).restore(3, like)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    assert np.asarray(back["params"]["blocks"]["moe"]["w_gate"]).shape == \
        jm.specs["blocks"]["moe"]["w_gate"].shape
    JManager(str(tmp_path / "repro"), async_save=False).save(3, want)
    p2, o2 = _stateful(arch, 1)
    CheckpointManager(str(tmp_path / "repro")).restore(
        3, {"params": p2, "opt": o2})
    for k in params:
        assert torch.equal(p2[k], params[k]), k
        assert torch.equal(o2.m[k], opt.m[k]) and torch.equal(
            o2.v[k], opt.v[k]), k
    with np.load(tmp_path / "port" / "step_00000003" / "arrays.npz") as a, \
            np.load(tmp_path / "repro" / "step_00000003" / "arrays.npz") as b:
        assert set(a.files) == set(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in b.files)
        assert ("params/dense_blocks/attn/wq/w" in a.files) == (
            arch == "deepseek-v2-236b")
