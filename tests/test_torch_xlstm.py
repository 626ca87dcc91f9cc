"""The port's xlstm family (``XLSTMModel``: the chunked mLSTM and its
recurrent step, the sequential sLSTM) against the JAX package's, on the
same numpy inputs, ``repro``'s weights carried across by
``params_from_numpy`` (``tests/ssm_pair.py``: ``repro`` evaluated op by
op where the comparison needs it, and why; the tolerances are
``tests/xattn_pair.py``'s).

Size: the reduced config, 4 layers in 2 groups (``slstm_every`` 2: one
mLSTM and one sLSTM a group), d 64, 4 heads of 16; and the same at
``slstm_every`` 0 (a flat stack of 4 mLSTMs).

One behaviour of ``repro`` is mirrored and pinned, not repaired: the
model's ``init_cache`` zeroes the stabilizers m (``jax.tree.map`` of
zeros over ``*_init_state``, which start them at -inf), so the sLSTM's
first decode steps differ from the forward's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssm_pair as sp
import xattn_pair as xp
from repro import configs as j_configs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import xlstm as j_xlstm
from repro.models.model import build_model as j_build_model
from repro.models.model import input_specs as j_input_specs
from repro.models.module import init_params as j_init_params
from repro.models.module import param_count as j_param_count
from repro.optim import adamw as j_adamw
from repro.runtime import steps as j_steps
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import _build
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import model as model_mod
from repro_torch.models import module, xlstm
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import driver, steps

ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def pair():
    return sp.Pair(ARCH)


@pytest.fixture(scope="module")
def flat():
    return sp.Pair(ARCH, slstm_every=0)


def _cfgs(**kw):
    kw = dict(dict(name="t", family="xlstm", n_layers=1, d_model=32,
                   n_heads=4, n_kv_heads=4, d_ff=0, vocab=10), **kw)
    return JModelConfig(**kw), ModelConfig(**kw)


def _block(spec_fn, seed=0):
    """One block's params at repro's init in both packages."""
    jcfg, cfg = _cfgs()
    jt = jax.tree.map(np.array, j_init_params(spec_fn(jcfg),
                                              jax.random.key(seed)))
    return jcfg, cfg, jax.tree.map(jnp.asarray, jt), module.tree_map(
        torch.as_tensor, jt)


def _x(shape, seed, dtype, scale=1.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * scale
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)


def _check(got, want, dtype):
    """f32: BLOCK_F32_TOL; bf16: two ulps (BF16_RTOL) + BF16_ATOL."""
    if dtype == "f32":
        np.testing.assert_allclose(xp.np32(got), xp.np32(want),
                                   atol=xp.BLOCK_F32_TOL,
                                   rtol=xp.BLOCK_F32_TOL)
    else:
        xp.close_bf16(got, want, atol=xp.BF16_ATOL)


# ------------------------------------------------------- params and builds
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("every", [None, 0])
def test_param_tree_follows_repro(reduced, every):
    """On the meta device (full width too): repro's tree with
    ``groups.mlstms`` split along both stacked axes and ``groups.slstm``
    along one (or a flat ``blocks`` stack at slstm_every 0); the counts
    agree (1.21e9 at full width: 6 groups of 7 mLSTMs and an sLSTM)."""
    get = "get_reduced_config" if reduced else "get_config"
    change = {} if every is None else {"slstm_every": every}
    cfg = dataclasses.replace(getattr(configs, get)(ARCH), **change)
    jm = j_build_model(dataclasses.replace(getattr(j_configs, get)(ARCH),
                                           **change))
    tm = build_model(cfg, "meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == sp.split_names(jm.abstract_params())
    assert tm.param_count() == j_param_count(jm.specs)
    if every is None:
        g, k = cfg.n_layers // cfg.slstm_every, cfg.slstm_every
        assert tm.n_groups == g
        assert f"groups.{g - 1}.mlstms.{k - 2}.wq.w" in got
        assert f"groups.{g - 1}.slstm.rz" in got
    else:
        assert f"blocks.{cfg.n_layers - 1}.wo_gate.w" in got
    assert not hasattr(tm, "prefill")
    if not reduced and every is None:
        assert tm.n_groups == 6
        assert 1.15e9 < tm.param_count() < 1.25e9


def test_serving_dtypes_by_use():
    """Serving build: the dense ``w`` / ``b`` of the blocks bf16, the
    sLSTM's recurrent ``r*`` and the norms f32 (repro reads them in
    f32), the head f32; the training build all f32."""
    tm = build_model(configs.get_config(ARCH), "meta")
    recurrent = 0
    for name, p in tm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        head = name.split(".")[0] in ("embed", "final_norm", "unembed")
        want = torch.bfloat16 if leaf in ("w", "b") and not head \
            else torch.float32
        recurrent += leaf in ("rz", "ri", "rf", "ro")
        assert p.dtype == want, name
    assert recurrent == 4 * 6
    assert all(p.dtype == torch.float32 for p in build_model(
        configs.get_reduced_config(ARCH), "meta",
        trainable=True).parameters())


def test_params_from_numpy_splits_every_stack(pair):
    params = dict(pair.tm.named_parameters())
    tree = pair.jp
    for g in range(2):
        assert torch.equal(params[f"groups.{g}.slstm.ri"],
                           torch.tensor(tree["groups"]["slstm"]["ri"][g]))
        assert torch.equal(params[f"groups.{g}.mlstms.0.wi.b"], torch.tensor(
            tree["groups"]["mlstms"]["wi"]["b"][g, 0]).to(torch.bfloat16))
    missing = dict(tree, groups=dict(tree["groups"],
                                     slstm=dict(tree["groups"]["slstm"])))
    del missing["groups"]["slstm"]["ro"]
    with pytest.raises(KeyError, match="missing"):
        module.params_from_numpy(build_model(pair.cfg, "cpu"), missing)


def test_streamed_load_fills_every_stack():
    cfg = configs.get_reduced_config(ARCH)
    got = serve_mod.load_model(cfg, seed=3, device="cpu")
    want = build_model(cfg, "cpu")
    module.params_from_numpy(want, module.init_params(
        want.specs, torch.Generator().manual_seed(3), "cpu"))
    pw = dict(want.named_parameters())
    assert all(torch.equal(p, pw[n]) for n, p in got.named_parameters())
    assert float(pw["groups.1.slstm.rf"].abs().max()) > 0


@pytest.mark.parametrize("every", [None, 0])
def test_cache_and_input_specs_follow_repro(every):
    """``cache_specs`` ("m": {C, n, m} [G, k-1, B, ...] or [L, B, ...];
    "s": {c, n, h, m} [G, B, h, dh]; f32; "pos" i32) and ``input_specs``
    against repro's, on the meta device at full width."""
    change = {} if every is None else {"slstm_every": every}
    cfg = dataclasses.replace(configs.get_config(ARCH), **change)
    jcfg = dataclasses.replace(j_configs.get_config(ARCH), **change)
    jm, tm = j_build_model(jcfg), build_model(cfg, "meta")
    tc = tm.cache_specs(4, 8192)
    sp.same_specs(tc, jm.cache_specs(4, 8192))
    if every is None:
        assert tc["m"]["C"].shape == (6, 7, 4, 4, 512, 512)
        assert tc["s"]["m"].shape == (6, 4, 4, 512)
    else:
        assert tc["m"]["C"].shape == (48, 4, 4, 512, 512) and "s" not in tc
    from repro.configs import base as jb
    from repro_torch.configs.base import TRAIN_4K
    for shape, jshape in ((TRAIN_4K, jb.TRAIN_4K),
                          (ShapeConfig("d", 64, 2, "decode"),
                           jb.ShapeConfig("d", 64, 2, "decode"))):
        sp.same_specs(model_mod.input_specs(cfg, shape),
                      j_input_specs(jcfg, jshape))


# ------------------------------------------------------------------ mLSTM
@pytest.mark.parametrize("chunk", [4, 8, 24])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlstm_matches_repro(chunk, dtype):
    """The chunked mLSTM against repro's, op by op: f32 within
    BLOCK_F32_TOL, bf16 within two ulps."""
    jcfg, cfg, jt, tt = _block(j_xlstm.mlstm_spec)
    jx, tx = _x((2, 24, 32), 3, dtype)
    with jax.disable_jit():
        want = j_xlstm.mlstm(jt, jcfg, jx, chunk=chunk)
    got = xlstm.mlstm(tt, cfg, tx, chunk=chunk)
    assert got.dtype == tx.dtype
    _check(got, want, dtype)


def test_mlstm_key_scale_is_a_bf16_division():
    """k / sqrt(dk) divides by sqrt(dk) rounded to bf16 (repro's weakly
    typed scalar): at dk 512, 22.625, not 22.627."""
    jcfg, cfg = _cfgs(d_model=1024, n_heads=2)
    jt = jax.tree.map(np.array, j_init_params(j_xlstm.mlstm_spec(jcfg),
                                              jax.random.key(0)))
    tt = module.tree_map(torch.as_tensor, jt)
    jx, tx = _x((1, 3, 1024), 0, "bf16")
    want = j_xlstm._mlstm_qkvif(jax.tree.map(jnp.asarray, jt), jcfg, jx)[1]
    got = xlstm._mlstm_qkvif(tt, cfg, tx)[1]
    np.testing.assert_array_equal(xp.np32(got), xp.np32(want))
    raw = tx @ tt["wk"]["w"].to(torch.bfloat16)
    assert torch.equal(got.reshape(raw.shape), raw / 22.625)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlstm_step_matches_repro(dtype):
    """24 recurrent steps from ``mlstm_init_state`` (m = -inf) against
    repro's: the outputs and the f32 states (C, n, m) within the block
    tolerance."""
    jcfg, cfg, jt, tt = _block(j_xlstm.mlstm_spec, 1)
    jx, tx = _x((2, 24, 32), 4, dtype)
    jst = j_xlstm.mlstm_init_state(jcfg, 2)
    tst = xlstm.mlstm_init_state(cfg, 2)
    assert float(tst["m"].max()) == float("-inf")
    for t in range(24):
        with jax.disable_jit():
            jy, jst = j_xlstm.mlstm_step(jt, jcfg, jx[:, t:t + 1], jst)
        ty, tst = xlstm.mlstm_step(tt, cfg, tx[:, t:t + 1], tst)
        _check(ty, jy, dtype)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(xp.np32(tst[k]), xp.np32(jst[k]),
                                   atol=xp.BLOCK_F32_TOL,
                                   rtol=xp.BLOCK_F32_TOL)


def test_mlstm_chunked_equals_recurrent():
    """The port's chunked mLSTM equals its own recurrent step over the
    same 24 tokens (tests/test_models.py's oracle and its 5e-4)."""
    _, cfg, _, tt = _block(j_xlstm.mlstm_spec)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(2, 24, 32)).astype(np.float32) * 0.5)
    y = xlstm.mlstm(tt, cfg, x, chunk=8)
    st = xlstm.mlstm_init_state(cfg, 2)
    ys = []
    for t in range(24):
        yt, st = xlstm.mlstm_step(tt, cfg, x[:, t:t + 1], st)
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.cat(ys, 1).numpy(),
                               atol=5e-4)


def test_mlstm_refuses_a_ragged_chunk():
    _, cfg, _, tt = _block(j_xlstm.mlstm_spec)
    with pytest.raises(ValueError, match="no multiple of the chunk"):
        xlstm.mlstm(tt, cfg, torch.zeros(1, 10, 32), chunk=4)


# ------------------------------------------------------------------ sLSTM
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_matches_repro(dtype):
    """The sequential sLSTM over 24 positions against repro's scan:
    f32 within BLOCK_F32_TOL, bf16 within two ulps."""
    jcfg, cfg, jt, tt = _block(j_xlstm.slstm_spec, 2)
    jx, tx = _x((2, 24, 32), 5, dtype)
    want = j_xlstm.slstm(jt, jcfg, jx)
    got = xlstm.slstm(tt, cfg, tx)
    assert got.dtype == tx.dtype
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_step_matches_repro_and_the_scan(dtype):
    """24 ``slstm_step``s from ``slstm_init_state`` (m = -inf) against
    repro's steps (outputs and states within the block tolerance), and
    equal to the port's own sequential ``slstm`` over the same tokens."""
    jcfg, cfg, jt, tt = _block(j_xlstm.slstm_spec, 3)
    jx, tx = _x((2, 24, 32), 6, dtype)
    jst = j_xlstm.slstm_init_state(jcfg, 2)
    tst = xlstm.slstm_init_state(cfg, 2)
    ys = []
    for t in range(24):
        with jax.disable_jit():
            jy, jst = j_xlstm.slstm_step(jt, jcfg, jx[:, t:t + 1], jst)
        ty, tst = xlstm.slstm_step(tt, cfg, tx[:, t:t + 1], tst)
        _check(ty, jy, dtype)
        ys.append(ty)
    for k in ("c", "n", "h", "m"):
        np.testing.assert_allclose(xp.np32(tst[k]), xp.np32(jst[k]),
                                   atol=xp.BLOCK_F32_TOL,
                                   rtol=xp.BLOCK_F32_TOL)
    _check(torch.cat(ys, 1), xlstm.slstm(tt, cfg, tx), dtype)


def test_slstm_gradients_are_finite_from_minus_inf():
    """m starts at -inf: no NaN in the forward or the gradient (-inf only
    meets finite numbers), and |n| = 1 at the first step (a tie of the
    normalizer's max, split as JAX splits it)."""
    jcfg, cfg, jt, tt = _block(j_xlstm.slstm_spec, 4)
    tt = {k: (v.requires_grad_() if not isinstance(v, dict) else
              {kk: vv.requires_grad_() for kk, vv in v.items()})
          for k, v in tt.items()}
    jx, tx = _x((2, 12, 32), 7, "f32")
    tx.requires_grad_()
    xlstm.slstm(tt, cfg, tx).square().sum().backward()
    assert bool(torch.isfinite(tx.grad).all())
    want = jax.grad(lambda p, x: jnp.sum(jnp.square(j_xlstm.slstm(
        p, jcfg, x))), argnums=(0, 1))(jt, jx)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[1]),
                               atol=xp.BLOCK_F32_TOL, rtol=1e-4)
    np.testing.assert_allclose(tt["rf"].grad.numpy(),
                               np.asarray(want[0]["rf"]),
                               atol=xp.BLOCK_F32_TOL, rtol=1e-4)


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("which", ["groups", "flat"])
def test_forward_matches_repro(pair, flat, which):
    """Logits within LOGIT_ATOL of repro's, op by op (no attention: the
    port runs no kernel here), with sLSTMs (groups) and without (flat)."""
    p = pair if which == "groups" else flat
    batch = sp.tokens(p.cfg, 2, 16, seed=1)
    want = p.j_forward(batch)
    got = p.t_forward(batch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=xp.LOGIT_ATOL,
                               rtol=0)


def test_forward_launches_no_kernel(monkeypatch, pair):
    fc = xp.FlashCalls(monkeypatch)
    before = dict(_build.LAUNCHES)
    steps.make_prefill_step(pair.tm, sp.RUN)(xp.torch_batch(
        sp.tokens(pair.cfg, 2, 16)))
    assert fc.calls == [] and dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("which", ["groups", "flat"])
def test_decode_teacher_forced_matches_repro(pair, flat, which):
    """``init_cache`` equals repro's in shapes, dtypes and values (zeros,
    the stabilizers too); ``decode_step`` over 8 prompt tokens and 4 of
    repro's greedy ones within LOGIT_ATOL of repro's (op by op) at every
    step, argmax equal where repro's margin is clear; the states at the
    end within BLOCK_F32_TOL."""
    p = pair if which == "groups" else flat
    toks = sp.tokens(p.cfg, 2, 8, seed=3)["tokens"]
    tc0, jc0 = p.tm.init_cache(2, 12), p.jm.init_cache(2, 12)
    sp.same_specs(tc0, jc0)
    assert all(not t.any() for t in module.flatten(tc0).values())
    jc, tc, required = sp.teacher_forced(p, toks, 4, 12)
    assert required > 0
    for key, t in module.flatten({k: v for k, v in tc.items()
                                  if k != "pos"}).items():
        want = module.flatten({k: v for k, v in jc.items()
                               if k != "pos"})[key]
        np.testing.assert_allclose(xp.np32(t), xp.np32(want),
                                   atol=xp.BLOCK_F32_TOL,
                                   rtol=xp.BLOCK_F32_TOL)


def test_zeroed_stabilizers_move_the_first_decode_steps(pair):
    """Pinned (repro ``model.py:490-503``): ``init_cache`` starts m at 0,
    the one-layer ``*_init_state`` at -inf.  From 0 the sLSTM's first
    step normalizes by max(|n|, 1) with n < 1, and decode's first logits
    depart from a teacher-forced forward by more than LOGIT_ATOL, in
    repro as in the port; from -inf they agree with it at every step
    (LOGIT_ATOL).  Decode equals repro's decode either way."""
    cfg = pair.cfg
    batch = sp.tokens(cfg, 2, 8, seed=4)
    toks = torch.as_tensor(batch["tokens"])
    fwd = pair.t_forward(batch).numpy()
    jfwd = pair.j_forward(batch)
    for minus_inf in (False, True):
        cache = pair.tm.init_cache(2, 8)
        jc = pair.jm.init_cache(2, 8)
        if minus_inf:
            for k in ("m", "s"):
                with torch.inference_mode():
                    cache[k]["m"].fill_(float("-inf"))
                jc = dict(jc, **{k: dict(jc[k], m=jnp.full_like(
                    jc[k]["m"], -jnp.inf))})
        dec, jdec = [], []
        for i in range(8):
            lg, cache = pair.tm.decode_step(sp.RUN, toks[:, i:i + 1], cache)
            jl, jc = pair.j_decode(batch["tokens"][:, i:i + 1], jc)
            dec.append(lg[:, -1].numpy())
            jdec.append(xp.np32(jl)[:, -1])
        dec, jdec = np.stack(dec, 1), np.stack(jdec, 1)
        np.testing.assert_allclose(dec, jdec, atol=xp.LOGIT_ATOL, rtol=0)
        first = np.abs(dec[:, 0] - fwd[:, 0]).max()
        jfirst = np.abs(jdec[:, 0] - jfwd[:, 0]).max()
        if minus_inf:
            np.testing.assert_allclose(dec, fwd, atol=xp.LOGIT_ATOL, rtol=0)
        else:
            assert first > xp.LOGIT_ATOL and jfirst > xp.LOGIT_ATOL


def test_serve_token_loop_matches_repro_decode(pair):
    """``launch.serve.serve`` (the prompt fed token by token): no kernel
    launched, the first token the last prompt step's argmax, every token
    repro's decode choice (fed the same tokens) where its margin is
    clear."""
    cfg = pair.cfg
    prompts = serve_mod.make_prompts(cfg, 2, 6, seed=1, device="cpu")
    before = dict(_build.LAUNCHES)
    res = serve_mod.serve(pair.tm, prompts, 4)
    assert dict(_build.LAUNCHES) == before
    assert torch.equal(res.tokens[:, 0],
                       res.prefill_logits.argmax(-1).to(torch.int32))
    feed = np.concatenate([prompts.numpy(), res.tokens.numpy()], axis=1)
    jc = pair.jm.init_cache(2, 10)
    for i in range(feed.shape[1] - 1):
        jl, jc = pair.j_decode(feed[:, i:i + 1], jc)
        jl = xp.np32(jl)[:, -1]
        if i >= 5:
            clear = xp.margin(jl) > xp.LOGIT_ATOL
            np.testing.assert_array_equal(res.tokens.numpy()[clear, i - 5],
                                          np.argmax(jl, -1)[clear])


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("which", ["groups", "flat"])
def test_train_step_matches_repro(pair, flat, which):
    """One ``make_train_step`` against repro's jitted one
    (tests/test_train_all_families.py's step) on the same weights and
    batch: loss / ce within LOSS_ATOL, the grad norm within GNORM_RTOL,
    lr equal; every gradient finite (m from -inf in both cells), the
    sLSTM's recurrent matrices' non-zero."""
    p = pair if which == "groups" else flat
    knobs = dict(remat="none", **sp.TRAIN_KNOBS)
    batch = sp.tokens(p.cfg, 4, 16, seed=8)
    _, jopt, jm = jax.jit(j_steps.make_train_step(
        p.jm, xp.JRunConfig(**knobs)))(
        p.jpd, j_adamw.init(p.jpd), xp.jax_batch(batch, labels=True))
    tm = p.model(trainable=True)
    params = dict(tm.named_parameters())
    run = RunConfig(**knobs)
    grads, _ = steps.make_grad_fn(tm, run)(params, xp.torch_batch(
        batch, labels=True))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    if which == "groups":
        assert float(grads["groups.1.slstm.rz"].abs().max()) > 0
    _, opt, m = steps.make_train_step(tm, run)(
        params, adamw.init(params), xp.torch_batch(batch, labels=True))
    assert int(opt.step) == int(jopt.step) == 1
    for key in ("loss", "ce"):
        assert abs(float(m[key]) - float(jm[key])) <= xp.LOSS_ATOL, key
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        xp.GNORM_RTOL * float(jm["grad_norm"])
    assert float(m["lr"]) == float(jm["lr"])


def test_remat_is_bit_equal(pair):
    """remat "full" recomputes each mLSTM block (not the sLSTM, as in
    repro): gradients and metrics bit-equal to remat "none"."""
    batch = xp.torch_batch(sp.tokens(pair.cfg, 2, 16, seed=2), labels=True)
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    (g0, m0), (g1, m1) = (steps.make_grad_fn(tm, RunConfig(
        remat=r, **sp.TRAIN_KNOBS))(params, batch) for r in ("none", "full"))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_train_launcher_runs_xlstm(tmp_path):
    cfg = configs.get_reduced_config(ARCH)
    model, params, opt = train_mod.setup(cfg, seed=0, device="cpu")
    run = train_mod.run_config(ARCH, 2, 16)
    src = SyntheticLM(cfg=cfg, batch=2, seq=16, seed=0, device="cpu")
    seen = []

    def step(params, opt, batch):
        params, opt, m = steps.make_train_step(model, run)(params, opt,
                                                           batch)
        seen.append(float(m["loss"]))
        return params, opt, m
    dcfg = driver.DriverConfig(total_steps=2, ckpt_every=2,
                               ckpt_dir=str(tmp_path), log_every=100)
    _, _, hist = driver.train_loop(step, params, opt, src, dcfg,
                                   log=lambda *_: None)
    assert hist["steps_run"] == 2 and all(np.isfinite(seen))


def test_checkpoints_cross_both_ways(pair, tmp_path):
    """``params/groups/mlstms/wq/w`` [G, k-1, ...] and
    ``params/groups/slstm/rz`` [G, h, dh, dh] in repro's format, both
    ways, values equal."""
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        1, {"params": params})
    JManager(str(tmp_path / "repro"), async_save=False).save(
        1, {"params": pair.jpd})
    with np.load(tmp_path / "port" / "step_00000001" / "arrays.npz") as a, \
            np.load(tmp_path / "repro" / "step_00000001" / "arrays.npz") as b:
        assert set(a.files) == set(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k
        assert a["params/groups/slstm/rz"].shape == (2, 4, 16, 16)
    back = JManager(str(tmp_path / "port")).restore(
        1, {"params": jax.tree.map(jnp.zeros_like, pair.jpd)})
    for x, y in zip(jax.tree.leaves(back["params"]),
                    jax.tree.leaves(pair.jpd)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    fresh = build_model(pair.cfg, "cpu", trainable=True)
    live = dict(fresh.named_parameters())
    CheckpointManager(str(tmp_path / "repro")).restore(1, {"params": live})
    for name, p in params.items():
        assert torch.equal(live[name], p), name
