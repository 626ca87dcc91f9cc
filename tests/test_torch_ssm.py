"""The port's ssm_hybrid family (zamba2: ``SSMHybridModel``, Mamba2's
chunked SSD scan and recurrent step, the shared attention block with a
LoRA on q per group) against the JAX package's, on the same numpy inputs,
``repro``'s weights carried across by ``params_from_numpy``
(``tests/ssm_pair.py``: ``repro`` evaluated op by op, and why; the
tolerances are ``tests/xattn_pair.py``'s).

Size: the reduced config, 5 layers (2 groups of k 2 Mamba2 blocks and a
tail of 1), d 64, 4 heads of 16, ssm_state 16, ssm head dim 16.
"""
import os
import subprocess
import sys

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
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
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
from repro_torch.models import module, ssm
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import driver, steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def pair():
    return sp.Pair(ARCH)


def _one_mamba(seed=0):
    """A lone Mamba2 block (d 32, 4 heads of 8 inside di 64, state 16) in
    both packages, a_log / dt_bias live."""
    kw = dict(name="t", family="ssm_hybrid", n_layers=1, d_model=32,
              n_heads=4, n_kv_heads=4, d_ff=0, vocab=10, ssm_state=16,
              ssm_head_dim=8)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jt = sp.live_leaves(jax.tree.map(np.array, j_init_params(
        j_ssm.mamba2_spec(jcfg), jax.random.key(seed))))
    return jcfg, cfg, jax.tree.map(jnp.asarray, jt), module.tree_map(
        torch.as_tensor, jt)


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
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
def test_param_tree_follows_repro(reduced):
    """On the meta device (full width too): repro's tree with
    ``groups.mambas`` split along both stacked axes, ``groups.lora`` and
    ``tail`` along one, ``shared`` whole; the counts agree (1.17e9 at
    full width: 6 groups of 6 and a tail of 2)."""
    get = "get_reduced_config" if reduced else "get_config"
    cfg = getattr(configs, get)(ARCH)
    jm = j_build_model(getattr(j_configs, get)(ARCH))
    tm = build_model(cfg, "meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == sp.split_names(jm.abstract_params())
    assert tm.param_count() == j_param_count(jm.specs)
    g, tail = divmod(cfg.n_layers, cfg.shared_attn_every)
    assert (tm.n_groups, tm.n_tail) == (g, tail) and tail > 0
    assert f"groups.{g - 1}.mambas.{cfg.shared_attn_every - 1}.conv_w" in got
    assert f"groups.{g - 1}.lora.b_q" in got and "shared.attn.wq.w" in got
    assert f"tail.{tail - 1}.in_proj.w" in got
    assert not hasattr(tm, "prefill")
    assert jax.tree_util.tree_structure(jm.abstract_params()) == \
        jax.tree_util.tree_structure(module.tree_map(
            lambda t: 0, tm.abstract_params()))
    if not reduced:
        assert (g, tail) == (6, 2)
        assert 1.1e9 < tm.param_count() < 1.25e9


def test_serving_dtypes_by_use():
    """Serving build: the dense ``w`` / ``b`` of the blocks bf16; the f32
    leaves repro casts per call (``conv_w``, ``conv_b``, ``a_log``,
    ``d_skip``, ``dt_bias``, the LoRA's ``a_q`` / ``b_q``) and the norms
    f32, the head f32; the training build all f32."""
    tm = build_model(configs.get_config(ARCH), "meta")
    f32_leaves = ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "a_q",
                  "b_q", "scale")
    seen = set()
    for name, p in tm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        head = name.split(".")[0] in ("embed", "final_norm", "unembed")
        want = torch.bfloat16 if leaf in ("w", "b") and not head \
            else torch.float32
        if leaf in f32_leaves:
            seen.add(leaf)
            want = torch.float32
        assert p.dtype == want, name
    assert seen == set(f32_leaves)
    assert all(p.dtype == torch.float32 for p in build_model(
        configs.get_reduced_config(ARCH), "meta",
        trainable=True).parameters())


def test_params_from_numpy_splits_every_stack(pair):
    """Every parameter holds repro's value at its (group, layer) index;
    a missing nested leaf is refused."""
    params = dict(pair.tm.named_parameters())
    tree = pair.jp
    mambas = tree["groups"]["mambas"]
    g, k = mambas["conv_w"].shape[:2]
    for gi in range(g):
        for j in range(k):
            assert torch.equal(params[f"groups.{gi}.mambas.{j}.conv_w"],
                               torch.tensor(mambas["conv_w"][gi, j]))
        assert torch.equal(params[f"groups.{gi}.lora.b_q"],
                           torch.tensor(tree["groups"]["lora"]["b_q"][gi]))
    assert torch.equal(params["tail.0.a_log"],
                       torch.tensor(tree["tail"]["a_log"][0]))
    assert torch.equal(params["shared.attn.wq.w"], torch.tensor(
        tree["shared"]["attn"]["wq"]["w"]).to(torch.bfloat16))
    missing = dict(tree, shared=dict(tree["shared"]))
    del missing["shared"]["ffn_norm"]
    with pytest.raises(KeyError, match="missing"):
        module.params_from_numpy(build_model(pair.cfg, "cpu"), missing)


def test_streamed_load_fills_every_stack():
    """``load_model`` draws leaf by leaf: the same weights as the whole
    tree drawn and loaded."""
    cfg = configs.get_reduced_config(ARCH)
    got = serve_mod.load_model(cfg, seed=3, device="cpu")
    want = build_model(cfg, "cpu")
    module.params_from_numpy(want, module.init_params(
        want.specs, torch.Generator().manual_seed(3), "cpu"))
    pw = dict(want.named_parameters())
    assert all(torch.equal(p, pw[n]) for n, p in got.named_parameters())
    assert float(pw["tail.0.in_proj.w"].float().abs().max()) > 0


def test_cache_and_input_specs_follow_repro():
    """``cache_specs`` ({S, conv} stacked [G, k, ...] and [tail, ...], both
    f32 at init; attn_k / attn_v [G, B, T, KH, hd] bf16) and
    ``input_specs`` against repro's, on the meta device at full width."""
    cfg, jcfg = configs.get_config(ARCH), j_configs.get_config(ARCH)
    jm, tm = j_build_model(jcfg), build_model(cfg, "meta")
    tc = tm.cache_specs(4, 8192)
    sp.same_specs(tc, jm.cache_specs(4, 8192))
    assert tc["ssm"]["S"].device.type == "meta"
    assert tc["ssm"]["S"].shape == (6, 6, 4, 64, 64, 64)
    assert tc["ssm"]["conv"].shape == (6, 6, 4, 3, 4096 + 128)
    assert tc["tail_ssm"]["conv"].dtype == torch.float32
    assert tc["attn_k"].shape == (6, 4, 8192, 32, 64)
    from repro.configs import base as jb
    from repro_torch.configs.base import PREFILL_32K, TRAIN_4K
    for shape, jshape in ((TRAIN_4K, jb.TRAIN_4K),
                          (PREFILL_32K, jb.PREFILL_32K),
                          (ShapeConfig("d", 64, 2, "decode"),
                           jb.ShapeConfig("d", 64, 2, "decode"))):
        sp.same_specs(model_mod.input_specs(cfg, shape),
                      j_input_specs(jcfg, jshape))


# --------------------------------------------------------------- Mamba2
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_matches_repro(with_state, dtype):
    """The depthwise causal conv (taps summed one at a time in x's
    dtype, tap 0 the oldest) and its new state: bit for bit."""
    jx, tx = _x((2, 9, 24), 0, dtype)
    jw, tw = _x((24, 4), 1, "f32")
    jb, tb = _x((24,), 2, "f32")
    jst = tst = None
    if with_state:
        jst, tst = _x((2, 3, 24), 3, dtype)
    jy, jnew = j_ssm._causal_conv(jx, jw, jb, jst)
    ty, tnew = ssm._causal_conv(tx, tw, tb, tst)
    assert ty.dtype == tx.dtype and tnew.shape == (2, 3, 24)
    np.testing.assert_array_equal(xp.np32(ty), xp.np32(jy))
    np.testing.assert_array_equal(xp.np32(tnew), xp.np32(jnew))


@pytest.mark.parametrize("chunk", [4, 8, 24])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_matches_repro(chunk, dtype):
    """The chunked scan (chunks of 4, 8 and the whole 24) against repro's
    run op by op: f32 within BLOCK_F32_TOL, bf16 within two ulps (both
    bit-equal here)."""
    jcfg, cfg, jt, tt = _one_mamba()
    jx, tx = _x((2, 24, 32), 4, dtype)
    with jax.disable_jit():
        want = j_ssm.mamba2(jt, jcfg, jx, chunk=chunk)
    got = ssm.mamba2(tt, cfg, tx, chunk=chunk)
    assert got.dtype == tx.dtype
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_step_matches_repro(dtype):
    """24 recurrent steps from ``mamba2_init_state`` against repro's: the
    outputs and the f32 state S within the block tolerance, the conv
    state (x's dtype after a step, f32 at init) too (bit for bit in
    bf16)."""
    jcfg, cfg, jt, tt = _one_mamba(1)
    jx, tx = _x((2, 24, 32), 5, dtype)
    jst = j_ssm.mamba2_init_state(jcfg, 2, 32)
    tst = ssm.mamba2_init_state(cfg, 2, 32)
    assert tst["conv"].dtype == torch.float32
    for t in range(24):
        with jax.disable_jit():
            jy, jst = j_ssm.mamba2_step(jt, jcfg, jx[:, t:t + 1], jst)
        ty, tst = ssm.mamba2_step(tt, cfg, tx[:, t:t + 1], tst)
        _check(ty, jy, dtype)
    assert tst["conv"].dtype == tx.dtype
    _check(tst["conv"], jst["conv"], dtype)
    if dtype == "bf16":
        np.testing.assert_array_equal(xp.np32(tst["conv"]),
                                      xp.np32(jst["conv"]))
    np.testing.assert_allclose(xp.np32(tst["S"]), xp.np32(jst["S"]),
                               atol=xp.BLOCK_F32_TOL, rtol=xp.BLOCK_F32_TOL)


def test_mamba2_chunked_equals_recurrent():
    """The port's chunked scan equals its own recurrent step over the
    same 24 tokens (tests/test_models.py's oracle and its 5e-4)."""
    _, cfg, _, tt = _one_mamba()
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(2, 24, 32)).astype(np.float32) * 0.5)
    y = ssm.mamba2(tt, cfg, x, chunk=8)
    st = ssm.mamba2_init_state(cfg, 2, 32)
    ys = []
    for t in range(24):
        yt, st = ssm.mamba2_step(tt, cfg, x[:, t:t + 1], st)
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.cat(ys, 1).numpy(),
                               atol=5e-4)


def test_mamba2_refuses_a_ragged_chunk():
    """S % chunk != 0 raises (repro asserts), for chunk < S only."""
    _, cfg, _, tt = _one_mamba()
    x = torch.zeros(1, 10, 32)
    with pytest.raises(ValueError, match="no multiple of the chunk"):
        ssm.mamba2(tt, cfg, x, chunk=4)
    assert ssm.mamba2(tt, cfg, x, chunk=16).shape == (1, 10, 32)


def test_long_chunk_stays_finite():
    """At a chunk of 256 (RunConfig's default) with the decay at its
    init (a_log 0, dt_bias 0: 0.69 a step), repro's intra-chunk exp
    overflows above the diagonal and inf * 0 makes NaN; the port masks
    the exponent, so its output is finite and equals its recurrent step
    (5e-4, as above)."""
    kw = dict(name="t", family="ssm_hybrid", n_layers=1, d_model=32,
              n_heads=4, n_kv_heads=4, d_ff=0, vocab=10, ssm_state=16,
              ssm_head_dim=8)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jt = jax.tree.map(np.array, j_init_params(j_ssm.mamba2_spec(jcfg),
                                              jax.random.key(0)))
    tt = module.tree_map(torch.as_tensor, jt)
    x = np.random.default_rng(2).normal(size=(1, 256, 32)).astype(
        np.float32) * 0.02
    want = j_ssm.mamba2(jax.tree.map(jnp.asarray, jt), jcfg, jnp.asarray(x),
                        chunk=256)
    assert not np.isfinite(np.asarray(want)).all()
    got = ssm.mamba2(tt, cfg, torch.as_tensor(x), chunk=256)
    assert bool(torch.isfinite(got).all())
    st = ssm.mamba2_init_state(cfg, 1, 32)
    ys = []
    for t in range(256):
        yt, st = ssm.mamba2_step(tt, cfg, torch.as_tensor(x[:, t:t + 1]), st)
        ys.append(yt)
    np.testing.assert_allclose(got.numpy(), torch.cat(ys, 1).numpy(),
                               atol=5e-4)


# ---------------------------------------------------------- shared block
def _shared_params(cfg, seed):
    """The shared block and one LoRA at repro's init (fan-in weights),
    ``b_q`` and the norm scales then drawn live."""
    rng = np.random.default_rng(seed)
    spec = {"shared": j_tf.shared_attn_spec(cfg),
            "lora": j_tf.shared_lora_spec(cfg)}
    tree = sp.live_leaves(jax.tree.map(np.array, j_init_params(
        spec, jax.random.key(seed))), seed)
    for name in ("norm", "ffn_norm"):
        tree["shared"][name]["scale"] = (1 + rng.normal(
            size=cfg.d_model) / 8).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), module.tree_map(
        torch.as_tensor, tree)


@pytest.mark.parametrize("s", [12, 17])
def test_shared_attn_matches_repro(pair, s):
    """``_shared_attn`` over s positions (LoRA live): the port's (the
    flash twin) against repro's (``blockwise_attn``, chunks of 16) within
    a residual block's bf16 bound (two ulps + BLOCK_BF16_ATOL), and bit
    for bit with the port's attention on ``blockwise_attn``; both round
    each LoRA product to bf16."""
    cfg = pair.cfg
    jt, tt = _shared_params(cfg, 4)
    jx, tx = _x((2, s, cfg.d_model), 6, "bf16")
    pos = np.arange(s, dtype=np.int32)
    want = j_tf._shared_attn(jt["shared"], jt["lora"], cfg, sp.J_RUN, jx,
                             jnp.asarray(pos))
    got = tf._shared_attn(tt["shared"], tt["lora"], cfg, sp.RUN, tx,
                          torch.as_tensor(pos))
    assert got.dtype == torch.bfloat16
    xp.close_bf16(got, want, atol=xp.BLOCK_BF16_ATOL)
    with sp.blockwise_self_attn(), jax.disable_jit():
        want = j_tf._shared_attn(jt["shared"], jt["lora"], cfg, sp.J_RUN,
                                 jx, jnp.asarray(pos))
        got = tf._shared_attn(tt["shared"], tt["lora"], cfg, sp.RUN, tx,
                              torch.as_tensor(pos))
    np.testing.assert_array_equal(xp.np32(got), xp.np32(want))


def test_shared_attn_decode_matches_repro(pair):
    """``_shared_attn_decode`` over 12 tokens and past the cache's end
    (slot min(pos, T-1)): outputs and caches bit for bit with repro's."""
    cfg = pair.cfg
    jt, tt = _shared_params(cfg, 5)
    jx, tx = _x((2, 14, cfg.d_model), 7, "bf16")
    shape = (2, 12, cfg.n_kv_heads, cfg.hd)
    jk = jv = jnp.zeros(shape, jnp.bfloat16)
    tk, tv = torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(
        shape, dtype=torch.bfloat16)
    for t in range(14):
        with jax.disable_jit():
            jy, jk, jv = j_tf._shared_attn_decode(
                jt["shared"], jt["lora"], cfg, jx[:, t:t + 1], jk, jv,
                jnp.asarray(t, jnp.int32))
        ty, tk, tv = tf._shared_attn_decode(
            tt["shared"], tt["lora"], cfg, tx[:, t:t + 1], tk, tv,
            torch.tensor(t, dtype=torch.int32))
        np.testing.assert_array_equal(xp.np32(ty), xp.np32(jy))
    np.testing.assert_array_equal(xp.np32(tk), xp.np32(jk))
    np.testing.assert_array_equal(xp.np32(tv), xp.np32(jv))


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("n_layers", [5, 4])
def test_forward_matches_repro(n_layers):
    """Logits within LOGIT_ATOL of repro's, op by op, with the port's
    self-attention on ``blockwise_attn`` as repro's (ssm_pair's doc): with
    a tail (5 layers: 2 groups + 1) and without (4: 2 groups); the
    port's own path (the flash twin) gives finite logits of that shape."""
    pair = sp.Pair(ARCH, n_layers=n_layers)
    assert pair.tm.n_tail == n_layers % 2
    batch = sp.tokens(pair.cfg, 2, 16, seed=n_layers)
    want = pair.j_forward(batch)
    with sp.blockwise_self_attn():
        got = pair.t_forward(batch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=xp.LOGIT_ATOL,
                               rtol=0)
    own = pair.t_forward(batch)
    assert own.shape == want.shape and bool(torch.isfinite(own).all())


def test_flash_launches_once_a_group(monkeypatch, pair):
    """A forward (and ``make_prefill_step``) reaches ``ops.flash_attn``
    once a group (the shared block: causal, [B, S, H, hd]) and nowhere
    else."""
    fc = xp.FlashCalls(monkeypatch)
    cfg = pair.cfg
    batch = sp.tokens(cfg, 2, 16)
    pair.t_forward(batch)
    assert fc.calls == [(True, (2, 16, cfg.n_heads, cfg.hd))] * \
        pair.tm.n_groups
    fc.calls.clear()
    steps.make_prefill_step(pair.tm, sp.RUN)(xp.torch_batch(batch))
    assert len(fc.calls) == pair.tm.n_groups == 2


def test_decode_teacher_forced_matches_repro(pair):
    """``init_cache`` equals repro's in shapes and dtypes; ``decode_step``
    over 8 prompt tokens and 4 of repro's greedy ones within LOGIT_ATOL
    of repro's (op by op) at every step, argmax equal where repro's
    margin is clear; the caches at the end: ``attn_k`` / ``attn_v``
    within CACHE_ATOL + two ulps, S within BLOCK_F32_TOL, the conv states
    equal (the port's f32, repro's bf16 after a step)."""
    toks = sp.tokens(pair.cfg, 2, 8, seed=3)["tokens"]
    sp.same_specs(pair.tm.init_cache(2, 12), pair.jm.init_cache(2, 12))
    jc, tc, required = sp.teacher_forced(pair, toks, 4, 12)
    assert required > 0
    for key in ("attn_k", "attn_v"):
        xp.close_bf16(tc[key], jc[key], atol=xp.CACHE_ATOL)
    for name in ("ssm", "tail_ssm"):
        np.testing.assert_allclose(
            xp.np32(tc[name]["S"]), xp.np32(jc[name]["S"]),
            atol=xp.BLOCK_F32_TOL, rtol=xp.BLOCK_F32_TOL)
        assert tc[name]["conv"].dtype == torch.float32
        assert jc[name]["conv"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(xp.np32(tc[name]["conv"]),
                                      xp.np32(jc[name]["conv"]))


def test_decode_equals_the_forward_per_block(pair):
    """Each Mamba2 block's and the shared block's decode steps, fed the
    forward's inputs to that block, give the forward's outputs within
    two bf16 ulps of the block's output scale (BF16_RTOL of its largest
    magnitude; through ``decode_step``'s caches)."""
    cfg = pair.cfg
    toks = torch.as_tensor(sp.tokens(cfg, 2, 16, seed=5)["tokens"])
    seen = []

    def rec(fn, xi):
        def wrap(*a, **kw):
            out = fn(*a, **kw)
            seen.append((a[xi], out))
            return out
        return wrap
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssm, "mamba2", rec(ssm.mamba2, 2))
        mp.setattr(tf, "_shared_attn", rec(tf._shared_attn, 4))
        pair.tm.forward(sp.RUN, {"tokens": toks})
    calls, t = [0], [0]

    def sub(fn, xi):
        def wrap(*a, **kw):
            x_in, y_fwd = seen[calls[0]]
            calls[0] += 1
            a = list(a)
            a[xi] = x_in[:, t[0]:t[0] + 1]
            out = fn(*a, **kw)
            want = y_fwd[:, t[0]:t[0] + 1].float()
            tol = xp.BF16_RTOL * float(want.abs().max())
            assert float((out[0].float() - want).abs().max()) <= tol
            return out
        return wrap
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssm, "mamba2_step", sub(ssm.mamba2_step, 2))
        mp.setattr(tf, "_shared_attn_decode", sub(tf._shared_attn_decode, 3))
        cache = pair.tm.init_cache(2, 16)
        for t[0] in range(16):
            calls[0] = 0
            _, cache = pair.tm.decode_step(sp.RUN, toks[:, t[0]:t[0] + 1],
                                           cache)
            assert calls[0] == len(seen) == cfg.n_layers + pair.tm.n_groups


def test_serve_token_loop_matches_repro_decode(pair):
    """``launch.serve.serve`` (no ``prefill``: the prompt fed token by
    token): no kernel launched, the first token the last prompt step's
    argmax, every token repro's decode choice (op by op, fed the same
    tokens) wherever repro's margin is clear."""
    cfg = pair.cfg
    prompts = serve_mod.make_prompts(cfg, 2, 6, seed=1, device="cpu")
    before = dict(_build.LAUNCHES)
    res = serve_mod.serve(pair.tm, prompts, 4)
    assert dict(_build.LAUNCHES) == before
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
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


def test_serve_launcher_runs_zamba2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
         "6", "--gen", "3"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"[serve] {ARCH}-reduced: prefill 2x6" in r.stdout


# ----------------------------------------------------------------- training
def test_train_step_matches_repro(pair):
    """One ``make_train_step`` against repro's
    (tests/test_train_all_families.py's step, run op by op: jitted, its
    grad norm lies 0.8 % from its own op-by-op one here) on the same
    weights and batch: loss / ce within LOSS_ATOL, the grad norm within
    GNORM_RTOL, lr equal; every gradient finite, the LoRA's and the SSM
    leaves' non-zero."""
    knobs = dict(remat="none", **sp.TRAIN_KNOBS)
    batch = sp.tokens(pair.cfg, 4, 16, seed=8)
    with jax.disable_jit():
        _, jopt, jm = j_steps.make_train_step(
            pair.jm, xp.JRunConfig(**knobs))(
            pair.jpd, j_adamw.init(pair.jpd),
            xp.jax_batch(batch, labels=True))
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    run = RunConfig(**knobs)
    grads, _ = steps.make_grad_fn(tm, run)(params, xp.torch_batch(
        batch, labels=True))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    for name in ("groups.0.lora.a_q", "groups.1.mambas.0.a_log",
                 "tail.0.dt_bias", "groups.0.mambas.1.conv_w"):
        assert float(grads[name].abs().max()) > 0, name
    _, opt, m = steps.make_train_step(tm, run)(
        params, adamw.init(params), xp.torch_batch(batch, labels=True))
    assert int(opt.step) == int(jopt.step) == 1
    for key in ("loss", "ce"):
        assert abs(float(m[key]) - float(jm[key])) <= xp.LOSS_ATOL, key
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        xp.GNORM_RTOL * float(jm["grad_norm"])
    assert float(m["lr"]) == float(jm["lr"])


def test_remat_is_bit_equal(pair):
    """remat "full" recomputes each Mamba2 block (not the shared block,
    as in repro): gradients and metrics bit-equal to remat "none"."""
    batch = xp.torch_batch(sp.tokens(pair.cfg, 2, 16, seed=2), labels=True)
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    (g0, m0), (g1, m1) = (steps.make_grad_fn(tm, RunConfig(
        remat=r, **sp.TRAIN_KNOBS))(params, batch) for r in ("none", "full"))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_train_launcher_runs_zamba2(tmp_path):
    """``launch.train``'s ``setup`` and ``train_loop`` over
    ``make_train_step`` on the CPU: two steps, finite losses, the shared
    block's flash (the trainable twin) once a group a step."""
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
    """The nested stacks in repro's format: the port's save gives repro's
    npz keys (``params/groups/mambas/conv_w`` [G, k, ...],
    ``params/groups/lora/a_q`` [G, ...], ``params/tail/...``,
    ``params/shared/...``), shapes and values, and restores into repro's
    tree equal; repro's own checkpoint restores into the port's tensors
    equal."""
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
        assert a["params/groups/mambas/conv_w"].shape[:2] == (2, 2)
        assert a["params/tail/a_log"].shape == (1, 8)
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

