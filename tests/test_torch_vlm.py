"""The port's vlm family (llama-3.2-vision: ``VLMModel``, the gated cross
block, the nested ``groups`` stack) against the JAX package's, on the
same numpy inputs, ``repro``'s weights carried across by
``params_from_numpy`` with both gates non-zero (``tests/xattn_pair.py``:
sizes, and the tolerances, which are ``tests/test_torch_models.py``'s
and ``tests/test_torch_train.py``'s).

Size: the reduced config, 4 layers in 2 groups (k 2: one self block and
one cross block a group), d 64, 4 heads of 16 over 2 KV heads, 16 image
tokens of 48.

Two behaviours of ``repro`` are mirrored and pinned, not repaired:
decode never fills ``img_k`` / ``img_v`` (so its cross-attention adds
nothing, and decode agrees with a teacher-forced ``forward`` only with
the attention gate at 0), and both gates start at zero.
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
ARCH = "llama-3.2-vision-90b"


@pytest.fixture(scope="module")
def pair():
    return xp.Pair(ARCH)


# ------------------------------------------------------- params and builds
@pytest.mark.parametrize("reduced", [True, False])
def test_param_tree_follows_repro(reduced):
    """On the meta device (full width too: no memory): repro's tree with
    ``groups.selfs`` split along both of its stacked axes and
    ``groups.cross`` along one, shape for shape; the counts agree."""
    get = "get_reduced_config" if reduced else "get_config"
    cfg = getattr(configs, get)(ARCH)
    jm = j_build_model(getattr(j_configs, get)(ARCH))
    tm = build_model(cfg, "meta")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == xp.split_names(jm.abstract_params())
    assert tm.param_count() == j_param_count(jm.specs)
    g, k = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every
    assert f"groups.{g - 1}.selfs.{k - 2}.attn.wq.w" in got
    assert f"groups.{g - 1}.cross.gate" in got
    assert not hasattr(tm, "prefill")
    assert jax.tree_util.tree_structure(jm.abstract_params()) == \
        jax.tree_util.tree_structure(module.tree_map(
            lambda t: 0, tm.abstract_params()))
    if not reduced:
        assert 8.7e10 < tm.param_count() < 8.9e10


def test_serving_dtypes_keep_the_gates_f32():
    """Serving build: the gates and norms f32 (repro reads them in f32:
    ``tanh(gate)`` is cast after), the block dense weights bf16, the
    head f32; the training build all f32."""
    tm = build_model(configs.get_config(ARCH), "meta")
    gates = 0
    for name, p in tm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gate", "ffn_gate"):
            gates += 1
            want = torch.float32
        elif name.startswith("groups.") and leaf in ("w", "b"):
            want = torch.bfloat16
        else:
            want = torch.float32
        assert p.dtype == want, name
    assert gates == 2 * 20
    assert tm.groups[0]["cross"].ffn.w_gate.w.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in build_model(
        configs.get_reduced_config(ARCH), "meta",
        trainable=True).parameters())


def test_params_from_numpy_splits_nested_stacks(pair):
    """Every parameter holds repro's value at its (group, layer) index;
    a missing nested leaf or a wrong group count is refused."""
    params = dict(pair.tm.named_parameters())
    tree = pair.jp
    selfs = tree["groups"]["selfs"]
    for g in range(selfs["attn"]["wq"]["w"].shape[0]):
        for j in range(selfs["attn"]["wq"]["w"].shape[1]):
            want = torch.tensor(selfs["attn"]["wq"]["w"][g, j])
            assert torch.equal(params[f"groups.{g}.selfs.{j}.attn.wq.w"],
                               want.to(torch.bfloat16))
        assert torch.equal(params[f"groups.{g}.cross.gate"],
                           torch.tensor(tree["groups"]["cross"]["gate"][g]))
    missing = dict(tree, groups=dict(tree["groups"],
                                     cross=dict(tree["groups"]["cross"])))
    del missing["groups"]["cross"]["ffn_gate"]
    with pytest.raises(KeyError, match="missing"):
        module.params_from_numpy(build_model(pair.cfg, "cpu"), missing)
    short = jax.tree.map(lambda a: a[:1], tree["groups"])
    with pytest.raises(KeyError, match="missing"):
        module.params_from_numpy(build_model(pair.cfg, "cpu"),
                                 dict(tree, groups=short))


def test_streamed_load_fills_nested_stacks():
    """``load_model`` draws leaf by leaf into the nested parameters: the
    same weights as the whole tree drawn and loaded."""
    cfg = configs.get_reduced_config(ARCH)
    got = serve_mod.load_model(cfg, seed=3, device="cpu")
    want = build_model(cfg, "cpu")
    module.params_from_numpy(want, module.init_params(
        want.specs, torch.Generator().manual_seed(3), "cpu"))
    pw = dict(want.named_parameters())
    assert all(torch.equal(p, pw[n]) for n, p in got.named_parameters())
    assert float(pw["groups.1.selfs.0.attn.wq.w"].float().abs().max()) > 0
    # repro's init: both gates zero.
    assert not pw["groups.1.cross.gate"].any()
    assert not pw["groups.1.cross.ffn_gate"].any()


def test_cache_and_input_specs_follow_repro():
    """``cache_specs`` ([G, k-1, B, T, KH, hd] k / v, [G, B, n_img, KH,
    hd] img_k / img_v) and ``input_specs`` against repro's shapes and
    dtypes, on the meta device at full width."""
    cfg, jcfg = configs.get_config(ARCH), j_configs.get_config(ARCH)
    jm, tm = j_build_model(jcfg), build_model(cfg, "meta")
    jc, tc = jm.cache_specs(4, 8192), tm.cache_specs(4, 8192)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
        assert tc[k].device.type == "meta"
    assert tc["k"].shape == (20, 4, 4, 8192, 8, 128)
    assert tc["img_k"].shape == (20, 4, 1600, 8, 128)
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


# ------------------------------------------------------------------ blocks
def _cross_params(cfg, seed):
    rng = np.random.default_rng(seed)
    spec = j_tf.cross_block_spec(cfg)
    tree = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) / 4).astype(np.float32), spec,
        is_leaf=lambda x: hasattr(x, "init"))
    for name in ("gate", "ffn_gate"):
        tree[name] = rng.uniform(0.5, 1.5, (1,)).astype(np.float32)
    for name in ("norm", "ffn_norm"):
        tree[name]["scale"] = (1 + rng.normal(size=cfg.d_model) / 8).astype(
            np.float32)
    return tree, module.tree_map(torch.as_tensor, tree)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_blocks_match_repro(pair, dtype):
    """``cross_img_kv``, ``cross_block`` (blockwise over 16 image keys,
    chunks of 16 and 5) and ``cross_block_decode`` against non-zero image
    caches, on the same inputs and weights (gates 0.5-1.5)."""
    cfg = pair.cfg
    jt, tt = _cross_params(cfg, 4)
    assert sorted(module.flatten(tt)) == sorted(module.flatten(
        module.tree_map(lambda p: 0, tf.cross_block_spec(cfg))))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    img = rng.normal(size=(2, cfg.n_img_tokens, cfg.d_vision)).astype(
        np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jx, tx = jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)
    jimg, timg = jnp.asarray(img, jdt), torch.as_tensor(img).to(tdt)
    jtree = jax.tree.map(jnp.asarray, jt)

    def check(got, want, tol=xp.F32_ATOL, atol=0.0):
        if dtype == "f32":
            np.testing.assert_allclose(xp.np32(got), xp.np32(want),
                                       atol=tol, rtol=tol)
        else:
            xp.close_bf16(got, want, atol=atol)

    jkv = j_tf.cross_img_kv(jtree, cfg, jimg)
    tkv = tf.cross_img_kv(tt, cfg, timg)
    for a, b in zip(tkv, jkv):
        assert tuple(a.shape) == (2, cfg.n_img_tokens, cfg.n_kv_heads,
                                  cfg.hd)
        check(a, b)
    # The block casts x to bf16 (the activation dtype) as repro's does;
    # its image K / V come in the caller's dtype.
    for chunk in (16, 5):
        run = RunConfig(remat="none", attn_chunk_q=chunk,
                        attn_chunk_kv=chunk)
        jrun = xp.JRunConfig(remat="none", attn_chunk_q=chunk,
                             attn_chunk_kv=chunk)
        got = tf.cross_block(tt, cfg, run, tx, tkv)
        want = j_tf.cross_block(jtree, cfg, jrun, jx, jkv)
        assert got.dtype == torch.bfloat16
        xp.close_bf16(got, want, atol=xp.BF16_ATOL)
    ik = rng.normal(size=(2, cfg.n_img_tokens, cfg.n_kv_heads,
                          cfg.hd)).astype(np.float32)
    iv = rng.normal(size=ik.shape).astype(np.float32)
    x1 = x[:, :1]
    got = tf.cross_block_decode(
        tt, cfg, torch.as_tensor(x1).to(tdt), torch.as_tensor(ik).to(
            torch.bfloat16), torch.as_tensor(iv).to(torch.bfloat16))
    want = j_tf.cross_block_decode(jtree, cfg, jnp.asarray(x1, jdt),
                                   jnp.asarray(ik, jnp.bfloat16),
                                   jnp.asarray(iv, jnp.bfloat16))
    check(got, want, tol=xp.BLOCK_F32_TOL, atol=xp.BF16_ATOL)


def test_gate_is_tanh_cast_to_the_activations():
    """The gate multiplies as ``tanh(gate).to(x.dtype)``: a gate whose
    tanh rounds in bf16 scales the attention output by the rounded value;
    a zero gate drops the attention output and a zero ffn_gate the FFN."""
    cfg = configs.get_reduced_config(ARCH)
    _, tt = _cross_params(cfg, 6)
    x = torch.randn(1, 3, cfg.d_model, generator=torch.Generator(
        ).manual_seed(0)).to(torch.bfloat16)
    o = torch.randn(1, 3, cfg.d_model, generator=torch.Generator(
        ).manual_seed(1)).to(torch.bfloat16)
    zero = dict(tt, gate=torch.zeros(1), ffn_gate=torch.zeros(1))
    assert torch.equal(tf._gated(zero, cfg, x, o), x)
    only_attn = dict(zero, gate=torch.tensor([0.3]))
    want = x + torch.tanh(torch.tensor([0.3])).to(torch.bfloat16) * o
    assert torch.equal(tf._gated(only_attn, cfg, x, o), want)


# ------------------------------------------------------------- whole model
@pytest.mark.parametrize("s", [24, 37])
def test_forward_matches_repro(pair, s):
    """Logits within 0.1 of repro's (the port's self layers on the flash
    twin, repro's on ``blockwise_attn``); the image path is live: other
    image tokens move the logits by far more than the tolerance."""
    batch = xp.inputs(pair.cfg, 2, s, seed=s)
    want = pair.j_forward(batch)
    got = pair.t_forward(batch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=xp.LOGIT_ATOL,
                               rtol=0)
    other = dict(batch, img=xp.inputs(pair.cfg, 2, s, seed=99)["img"])
    moved = np.abs(pair.t_forward(other).numpy() - got.numpy()).max()
    assert moved > 5 * xp.LOGIT_ATOL


def test_flash_launches_per_group(monkeypatch, pair):
    """A forward reaches ``ops.flash_attn`` k-1 times a group (the self
    layers, causal, [B, S, H, hd]) and never for the cross blocks."""
    fc = xp.FlashCalls(monkeypatch)
    cfg = pair.cfg
    batch = xp.inputs(cfg, 2, 20)
    pair.t_forward(batch)
    g, k = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every
    assert fc.calls == [(True, (2, 20, cfg.n_heads, cfg.hd))] * (g * (k - 1))
    fc.calls.clear()
    steps.make_prefill_step(pair.tm, xp.RUN)(xp.torch_batch(batch))
    assert len(fc.calls) == g * (k - 1)


@pytest.mark.parametrize("s,steps_", [(6, 6), (12, 3)])
def test_decode_teacher_forced_matches_repro(pair, s, steps_):
    """``init_cache`` equals repro's in shapes and dtypes; ``decode_step``
    over the prompt and repro's greedy tokens within 0.1 of repro's
    logits at every step, argmax equal where repro's margin is clear; the
    self caches within 0.0625 + 2 ulps of repro's at the end."""
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


def test_decode_leaves_image_caches_zero(pair):
    """Pinned (repro ``model.py:262-263, :284-285``): decode only reads
    ``img_k`` / ``img_v``, which stay zero in both packages, so its
    cross-attention adds nothing.  With the attention gate at 0
    (``ffn_gate`` not: the cross block's FFN still runs) decode agrees
    with a teacher-forced ``forward``; with a non-zero gate the forward's
    image attention moves the logits and decode does not follow."""
    cfg = pair.cfg
    batch = xp.inputs(cfg, 2, 10, seed=3)
    toks = batch["tokens"]
    _, tc, _ = xp.teacher_forced(pair, toks, 0, 10)
    assert not tc["img_k"].any() and not tc["img_v"].any()
    jc = pair.jm.init_cache(2, 10)
    for i in range(10):
        _, jc = pair.j_decode(toks[:, i:i + 1], jc)
    assert not np.asarray(jc["img_k"]).any()
    gated = xp.Pair(ARCH, gate=0.0)
    assert all(float(g.cross.gate) == 0 and float(g.cross.ffn_gate) != 0
               for g in gated.tm.groups)
    for p, want_close in ((gated, True), (pair, False)):
        fwd = p.t_forward(batch).numpy()
        cache = p.tm.init_cache(2, 10)
        dec = []
        for i in range(10):
            lg, cache = p.tm.decode_step(xp.RUN, torch.from_numpy(
                toks[:, i:i + 1]), cache)
            dec.append(lg[:, -1].numpy())
        diff = np.abs(np.stack(dec, 1) - fwd).max()
        assert (diff <= xp.LOGIT_ATOL) == want_close, diff


# ------------------------------------------------------- steps and serving
def test_serve_token_loop_matches_repro_decode(pair):
    """``launch.serve.serve`` (no ``prefill``: the prompt fed token by
    token): the phases in order, no kernel launched, the first token the
    last prompt step's argmax, and every token repro's decode choice
    (fed the same tokens) wherever repro's margin is clear."""
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
    assert torch.equal(res.tokens[:, 0],
                       res.prefill_logits.argmax(-1).to(torch.int32))
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


def test_serve_launcher_runs_vlm_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
         "6", "--gen", "3"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"[serve] {ARCH}-reduced: prefill 2x6" in r.stdout


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_step_matches_repro(pair, microbatch):
    """One ``make_train_step`` against repro's jitted one on the same
    weights (gates non-zero) and batch: loss / ce within 5e-3, the grad
    norm within 5e-3 relative, lr equal; every gradient finite and the
    gates' non-zero (the image path trains)."""
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
    assert float(grads["groups.0.cross.gate"].abs().max()) > 0
    assert float(grads["groups.1.cross.attn.wk.w"].abs().max()) > 0
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
    """remat "full" recomputes the self layers (not the cross blocks, as
    in repro): gradients and metrics bit-equal to remat "none"."""
    batch = xp.torch_batch(xp.inputs(pair.cfg, 2, 16, seed=2), labels=True)
    tm = pair.model(trainable=True)
    params = dict(tm.named_parameters())
    (g0, m0), (g1, m1) = (steps.make_grad_fn(tm, RunConfig(
        remat=r, **xp.TRAIN_KNOBS))(params, batch) for r in ("none", "full"))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_train_launcher_runs_vlm(tmp_path):
    """``launch.train``'s ``setup`` and ``train_loop`` over
    ``make_train_step`` on the CPU: the pipeline draws the image stub,
    two steps run, the losses are finite."""
    cfg = configs.get_reduced_config(ARCH)
    model, params, opt = train_mod.setup(cfg, seed=0, device="cpu")
    run = train_mod.run_config(ARCH, 2, 16)
    src = SyntheticLM(cfg=cfg, batch=2, seq=16, seed=0, device="cpu")
    assert src.batch_at(0)["img"].shape == (2, cfg.n_img_tokens,
                                            cfg.d_vision)
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
    assert hist["steps_run"] == 2 and len(seen) == 2
    assert all(np.isfinite(seen))


def test_checkpoint_holds_repros_nested_keys(pair, tmp_path):
    """The nested stacks round trip: repro's tree loaded with
    ``params_from_numpy`` into the trainable model, saved by the port,
    gives repro's npz keys (``params/groups/selfs/attn/wq/w`` [G, k-1,
    ...], ``params/groups/cross/gate`` [G, 1]), shapes and values, and
    restores into repro's tree equal; repro's own checkpoint restores
    into the port's live tensors equal."""
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
        g, k = (pair.cfg.n_layers // pair.cfg.cross_attn_every,
                pair.cfg.cross_attn_every)
        assert a["params/groups/selfs/attn/wq/w"].shape[:2] == (g, k - 1)
        assert a["params/groups/cross/gate"].shape == (g, 1)
    back = JManager(str(tmp_path / "port")).restore(
        1, {"params": jax.tree.map(jnp.zeros_like, pair.jpd)})
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_flatten_with_path(back["params"])[0],
            jax.tree_util.tree_flatten_with_path(pair.jpd)[0]):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path
    other = xp.Pair(ARCH, seed=5).model(trainable=True)
    live = dict(other.named_parameters())
    CheckpointManager(str(tmp_path / "repro")).restore(1, {"params": live})
    assert all(torch.equal(live[n], params[n]) for n in params)
