"""The port's encdec family (seamless-m4t: ``EncDecModel``, the encoder's
``dense_block_bidir``, ``enc_norm``, the decoder's cross-attention)
against the JAX package's, on the same numpy inputs, ``repro``'s weights
carried across by ``params_from_numpy`` (``tests/xattn_pair.py``: sizes,
and the tolerances, which are ``tests/test_torch_models.py``'s and
``tests/test_torch_train.py``'s).

Size: the reduced config, 2 encoder + 2 decoder layers, d 64, 4 heads
of 16, GELU.  The encoder's self-attention is the first path of the
port on flash's full (non-causal) route; here it runs the twin, where
``repro`` runs ``blockwise_attn(causal=False)``.

One behaviour of ``repro`` is mirrored and pinned, not repaired: decode
never fills ``cross_k`` / ``cross_v``, so its cross-attention adds
nothing and decode does not agree with a teacher-forced ``forward``
(it does with the cross-attention's ``wo`` zeroed).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xattn_pair as xp
from repro import configs as j_configs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models import transformer as j_tf
from repro.models.model import build_model as j_build_model
from repro.models.model import input_specs as j_input_specs
from repro.models.module import param_count as j_param_count
from repro.optim import adamw as j_adamw
from repro.runtime import steps as j_steps
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import _build
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import model as model_mod
from repro_torch.models import module
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import driver, steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def pair():
    return xp.Pair(ARCH)


# ------------------------------------------------------- params and builds
@pytest.mark.parametrize("reduced", [True, False])
def test_param_tree_follows_repro(reduced):
    """On the meta device (full width too): repro's tree with
    ``enc_blocks`` and ``dec_blocks`` split per layer and ``enc_norm`` a
    head leaf, shape for shape; the counts agree."""
    get = "get_reduced_config" if reduced else "get_config"
    cfg = getattr(configs, get)(ARCH)
    jm = j_build_model(getattr(j_configs, get)(ARCH))
    tm = build_model(cfg, "meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == xp.split_names(jm.abstract_params())
    assert got["enc_norm.scale"] == (cfg.d_model,)
    assert tm.param_count() == j_param_count(jm.specs)
    assert not hasattr(tm, "prefill")
    assert jax.tree_util.tree_structure(jm.abstract_params()) == \
        jax.tree_util.tree_structure(module.tree_map(
            lambda t: 0, tm.abstract_params()))
    if not reduced:
        assert 8.7e8 < tm.param_count() < 8.9e8


def test_serving_dtypes_by_use():
    tm = build_model(configs.get_config(ARCH), "meta")
    for name, p in tm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        want = torch.bfloat16 if "_blocks." in name and leaf in (
            "w", "b") else torch.float32
        assert p.dtype == want, name
    assert tm.enc_norm.scale.dtype == torch.float32


def test_cache_and_input_specs_follow_repro():
    """``cache_specs`` (k / v and cross_k / cross_v, [L, B, T, KH, hd])
    and ``input_specs`` (frames [B, S, d] bf16) against repro's, on the
    meta device at full width."""
    cfg, jcfg = configs.get_config(ARCH), j_configs.get_config(ARCH)
    jm, tm = j_build_model(jcfg), build_model(cfg, "meta")
    jc, tc = jm.cache_specs(4, 4096), tm.cache_specs(4, 4096)
    assert set(tc) == set(jc) == {"k", "v", "cross_k", "cross_v", "pos"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
    from repro.configs import base as jb
    from repro_torch.configs.base import PREFILL_32K, TRAIN_4K
    for shape, jshape in ((TRAIN_4K, jb.TRAIN_4K),
                          (PREFILL_32K, jb.PREFILL_32K),
                          (ShapeConfig("d", 64, 2, "decode"),
                           jb.ShapeConfig("d", 64, 2, "decode"))):
        got = module.flatten(model_mod.input_specs(cfg, shape))
        want = module.flatten(j_input_specs(jcfg, jshape))
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


def test_streamed_load_fills_every_stack():
    cfg = configs.get_reduced_config(ARCH)
    got = serve_mod.load_model(cfg, seed=2, device="cpu")
    want = build_model(cfg, "cpu")
    module.params_from_numpy(want, module.init_params(
        want.specs, torch.Generator().manual_seed(2), "cpu"))
    pw = dict(want.named_parameters())
    assert any(n.startswith("enc_blocks.1.") for n in pw)
    assert all(torch.equal(p, pw[n]) for n, p in got.named_parameters())


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("s,chunk", [(16, 16), (37, 8)])
def test_encoder_block_matches_repro(pair, s, chunk):
    """``dense_block_bidir`` (flash's full route: the twin here) against
    repro's (``blockwise_attn(causal=False)``) on the same bf16 inputs
    and weights, within two ulps plus two at the residual's unit scale
    (``xattn_pair.BLOCK_BF16_ATOL``)."""
    cfg = pair.cfg
    p = jax.tree.map(lambda a: a[1], pair.jp["enc_blocks"])
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    run = RunConfig(remat="none", attn_chunk_q=chunk, attn_chunk_kv=chunk)
    jrun = xp.JRunConfig(remat="none", attn_chunk_q=chunk,
                         attn_chunk_kv=chunk)
    pos = np.arange(s, dtype=np.int32)
    got = tf.dense_block_bidir(module.tree_map(torch.as_tensor, p), cfg, run,
                               torch.as_tensor(x), torch.as_tensor(pos))
    want = j_tf.dense_block_bidir(jax.tree.map(jnp.asarray, p), cfg, jrun,
                                  jnp.asarray(x), jnp.asarray(pos))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    xp.close_bf16(got, want, atol=xp.BLOCK_BF16_ATOL)
    # Non-causal: the first position reads the last.
    moved = x.copy()
    moved[:, -1] += 1.0
    again = tf.dense_block_bidir(module.tree_map(torch.as_tensor, p), cfg,
                                 run, torch.as_tensor(moved),
                                 torch.as_tensor(pos))
    assert not torch.equal(again[:, 0], got[:, 0])


# ------------------------------------------------------------- whole model
@pytest.mark.parametrize("s", [24, 37])
def test_forward_matches_repro(pair, s):
    """Logits within 0.1 of repro's; the frames path is live (other
    frames move the logits by far more than the tolerance)."""
    batch = xp.inputs(pair.cfg, 2, s, seed=s)
    want = pair.j_forward(batch)
    got = pair.t_forward(batch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=xp.LOGIT_ATOL,
                               rtol=0)
    other = dict(batch, frames=xp.inputs(pair.cfg, 2, s, seed=99)["frames"])
    moved = np.abs(pair.t_forward(other).numpy() - got.numpy()).max()
    assert moved > 5 * xp.LOGIT_ATOL


def test_frames_of_another_length(pair):
    """The encoder's length need not be the decoder's: 11 frames under
    20 tokens, within 0.1 of repro's logits."""
    batch = xp.inputs(pair.cfg, 2, 20, seed=4)
    batch["frames"] = np.ascontiguousarray(batch["frames"][:, :11])
    np.testing.assert_allclose(pair.t_forward(batch).numpy(),
                               pair.j_forward(batch), atol=xp.LOGIT_ATOL,
                               rtol=0)


def test_flash_launches_encoder_full_decoder_causal(monkeypatch, pair):
    """A forward reaches ``ops.flash_attn`` ``enc_layers`` times on the
    full route (the encoder, [B, S_enc, H, hd]) and then ``n_layers``
    times causal (the decoder's self-attention); the cross-attention
    never."""
    fc = xp.FlashCalls(monkeypatch)
    cfg = pair.cfg
    batch = xp.inputs(cfg, 2, 20)
    batch["frames"] = np.ascontiguousarray(batch["frames"][:, :13])
    steps.make_prefill_step(pair.tm, xp.RUN)(xp.torch_batch(batch))
    assert fc.calls == (
        [(False, (2, 13, cfg.n_heads, cfg.hd))] * cfg.enc_layers
        + [(True, (2, 20, cfg.n_heads, cfg.hd))] * cfg.n_layers)


@pytest.mark.parametrize("s,steps_", [(6, 6), (12, 3)])
def test_decode_teacher_forced_matches_repro(pair, s, steps_):
    """``init_cache`` equals repro's in shapes and dtypes;
    ``decode_step`` over the prompt and repro's greedy tokens within 0.1
    of repro's logits at every step, argmax equal where repro's margin is
    clear; the self caches within 0.0625 + 2 ulps of repro's."""
    cfg = pair.cfg
    toks = xp.inputs(cfg, 3, s, seed=s)["tokens"]
    jc0, tc0 = pair.jm.init_cache(3, s + steps_), pair.tm.init_cache(
        3, s + steps_)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tc0.items()} == {k: (v.shape, str(v.dtype))
                                         for k, v in jc0.items()}
    jc, tc, required = xp.teacher_forced(pair, toks, steps_, s + steps_)
    assert required > 0
    for key in ("k", "v"):
        xp.close_bf16(tc[key], jc[key], atol=xp.CACHE_ATOL)


def test_decode_leaves_cross_caches_zero(pair):
    """Pinned (repro ``model.py:347-348, :373-374``): ``cross_k`` /
    ``cross_v`` stay zero through decode in both packages, so decode's
    cross-attention adds nothing: decode agrees with a teacher-forced
    ``forward`` whose cross-attention ``wo`` is zeroed, and not with the
    forward as it is."""
    cfg = pair.cfg
    batch = xp.inputs(cfg, 2, 10, seed=3)
    toks = batch["tokens"]
    _, tc, _ = xp.teacher_forced(pair, toks, 0, 10)
    assert not tc["cross_k"].any() and not tc["cross_v"].any()
    jc = pair.jm.init_cache(2, 10)
    for i in range(10):
        _, jc = pair.j_decode(toks[:, i:i + 1], jc)
    assert not np.asarray(jc["cross_k"]).any()
    dec = []
    cache = pair.tm.init_cache(2, 10)
    for i in range(10):
        lg, cache = pair.tm.decode_step(xp.RUN, torch.from_numpy(
            toks[:, i:i + 1]), cache)
        dec.append(lg[:, -1].numpy())
    dec = np.stack(dec, 1)
    no_cross = pair.model()
    with torch.no_grad():
        for p in no_cross.dec_blocks:
            p.cross.wo.w.zero_()
    assert np.abs(dec - pair.t_forward(batch, no_cross).numpy()).max() \
        <= xp.LOGIT_ATOL
    assert np.abs(dec - pair.t_forward(batch).numpy()).max() > \
        xp.LOGIT_ATOL


# ------------------------------------------------------- steps and serving
def test_serve_token_loop_matches_repro_decode(pair):
    """``launch.serve.serve`` (the token loop): the phases in order, no
    kernel launched, the tokens repro's decode choices (fed the same
    tokens) wherever repro's margin is clear."""
    cfg = pair.cfg
    prompts = serve_mod.make_prompts(cfg, 2, 8, seed=1, device="cpu")
    seen = []
    before = dict(_build.LAUNCHES)
    res = serve_mod.serve(pair.tm, prompts, 5,
                          on_phase=lambda p, e: seen.append((p, e)))
    assert seen == [("prefill", "start"), ("prefill", "end"),
                    ("decode", "start"), ("decode", "end")]
    assert dict(_build.LAUNCHES) == before
    assert res.tokens.shape == (2, 5) and res.tokens.dtype == torch.int32
    feed = np.concatenate([prompts.numpy(), res.tokens.numpy()], axis=1)
    jc = pair.jm.init_cache(2, 13)
    for i in range(feed.shape[1] - 1):
        jl, jc = pair.j_decode(feed[:, i:i + 1], jc)
        jl = xp.np32(jl)[:, -1]
        if i == 7:
            np.testing.assert_allclose(xp.np32(res.prefill_logits), jl,
                                       atol=xp.LOGIT_ATOL, rtol=0)
        if i >= 7:
            clear = xp.margin(jl) > xp.LOGIT_ATOL
            np.testing.assert_array_equal(res.tokens.numpy()[clear, i - 7],
                                          np.argmax(jl, -1)[clear])


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_step_matches_repro(pair, microbatch):
    """One ``make_train_step`` against repro's jitted one: loss / ce
    within 5e-3, grad norm within 5e-3 relative, lr equal; the encoder's
    and the cross-attention's gradients non-zero."""
    knobs = dict(remat="none", microbatch=microbatch, **xp.TRAIN_KNOBS)
    batch = xp.inputs(pair.cfg, 4, 24, seed=8)
    _, jopt, jm = jax.jit(j_steps.make_train_step(
        pair.jm, xp.JRunConfig(**knobs)))(
        pair.jpd, j_adamw.init(pair.jpd), xp.jax_batch(batch, labels=True))
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    run = RunConfig(**knobs)
    grads, _ = steps.make_grad_fn(tm, run)(params, xp.torch_batch(
        batch, labels=True))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    for name in ("enc_blocks.0.attn.wq.w", "enc_norm.scale",
                 "dec_blocks.1.cross.wk.w"):
        assert float(grads[name].abs().max()) > 0, name
    _, opt, m = steps.make_train_step(tm, run)(
        params, adamw.init(params), xp.torch_batch(batch, labels=True))
    assert set(m) == set(jm) == {"loss", "ce", "grad_norm", "lr"}
    assert int(opt.step) == int(jopt.step) == 1
    for key in ("loss", "ce"):
        assert abs(float(m[key]) - float(jm[key])) <= xp.LOSS_ATOL, key
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        xp.GNORM_RTOL * float(jm["grad_norm"])
    assert float(m["lr"]) == float(jm["lr"])


def test_remat_is_bit_equal(pair):
    """remat "dots" over the encoder and decoder blocks: gradients and
    metrics bit-equal to remat "none"."""
    batch = xp.torch_batch(xp.inputs(pair.cfg, 2, 16, seed=2), labels=True)
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    (g0, m0), (g1, m1) = (steps.make_grad_fn(tm, RunConfig(
        remat=r, **xp.TRAIN_KNOBS))(params, batch) for r in ("none", "dots"))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_train_launcher_runs_encdec(tmp_path):
    """``launch.train``'s ``setup`` and ``train_loop`` on the CPU: the
    pipeline draws the frames stub, two steps, finite losses."""
    cfg = configs.get_reduced_config(ARCH)
    model, params, opt = train_mod.setup(cfg, seed=0, device="cpu")
    run = train_mod.run_config(ARCH, 2, 16)
    src = SyntheticLM(cfg=cfg, batch=2, seq=16, seed=0, device="cpu")
    assert src.batch_at(0)["frames"].shape == (2, 16, cfg.d_model)
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


def test_train_cli_takes_encdec(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[train] done: loss" in r.stdout and "2 steps" in r.stdout


def test_checkpoints_cross_both_ways(pair, tmp_path):
    """The port's trainable params and an AdamW state saved by the port
    give repro's npz keys (``params/enc_norm/scale``,
    ``params/enc_blocks/...`` [Le, ...]) and arrays; repro restores them
    equal, and repro's save restores into the port's live tensors."""
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    opt = adamw.init(params)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        2, {"params": params, "opt": opt})
    jstate = {"params": pair.jpd, "opt": j_adamw.init(pair.jpd)}
    JManager(str(tmp_path / "repro"), async_save=False).save(2, jstate)
    with np.load(tmp_path / "port" / "step_00000002" / "arrays.npz") as a, \
            np.load(tmp_path / "repro" / "step_00000002" / "arrays.npz") as b:
        assert set(a.files) == set(b.files)
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                   for k in b.files)
        assert a["params/enc_blocks/attn/wq/w"].shape[0] == \
            pair.cfg.enc_layers
        assert "params/enc_norm/scale" in a.files
    back = JManager(str(tmp_path / "port")).restore(
        2, jax.tree.map(jnp.zeros_like, jstate))
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path
    live = dict(xp.Pair(ARCH, seed=5).model(trainable=True)
                .named_parameters())
    CheckpointManager(str(tmp_path / "repro")).restore(
        2, {"params": live, "opt": adamw.init(live)})
    assert all(torch.equal(live[n], params[n]) for n in params)
