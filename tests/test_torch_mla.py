"""The port's multi-head latent attention and DeepSeek-V2's own parts
(src/repro_torch/models/attention.py ``mla_*``, the dense first layer,
``dense_blocks``) against the JAX package's, on the same numpy inputs and
with ``repro``'s weights carried across.  The whole-model checks of both
MoE configs (forward, decode, serve, train, checkpoints) are in
tests/test_torch_moe.py.

Sizes: deepseek-v2-236b's reduced config (d 64, 4 heads, q_lora 48,
kv_lora 32, nope 16 / rope 8 / v 16, head dim 24).  Tolerances, as
stated per test:

* layers on equal bf16 inputs: two bf16 ulps plus 2^-8 (as
  tests/test_torch_models.py's layers: XLA and PyTorch round a bf16
  product in other places);
* MLA decode on equal inputs: f32 scores and products in both, the
  output (bf16) within the same bound and the written cache slots within
  one bf16 ulp;
* the absorbed decode against the expanded form of the port itself, at
  the last position: within 2^-5 (two bf16 roundings of different
  products, through ``wo``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moe_pair as mp
from repro import configs as j_configs
from repro.models import attention as j_attn
from repro.models.model import build_model as j_build_model
from repro.models.module import init_params as j_init_params
from repro_torch import configs
from repro_torch.kernels import flash_attn as flash_kernels
from repro_torch.models import attention, layers, module
from repro_torch.models.model import build_model

ARCH = "deepseek-v2-236b"
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 2.0 ** -8


@pytest.fixture(scope="module")
def tree():
    """repro's reduced deepseek params (numpy) and the config."""
    cfg = configs.get_reduced_config(ARCH)
    jm = j_build_model(j_configs.get_reduced_config(ARCH))
    jp = j_init_params(jm.specs, jax.random.key(0))
    return cfg, jm, jax.tree.map(np.array, jp)


def _layer(tree, i=0):
    """Block ``i``'s MLA params: repro's (jnp) and the port's serving
    layout (a ParamTree from the serving build, loaded from repro's)."""
    cfg, _, flat = tree
    jp = jax.tree.map(lambda a: jnp.asarray(a[i]), flat["blocks"]["attn"])
    tm = build_model(cfg, "cpu")
    module.params_from_numpy(tm, flat)
    return jp, tm.blocks[i]["attn"]


def _close(got, want, rtol=BF16_RTOL, atol=BF16_ATOL):
    np.testing.assert_allclose(mp.np32(got), mp.np32(want), rtol=rtol,
                               atol=atol)


def test_mla_spec_matches_repro(tree):
    cfg, _, _ = tree
    got = module.flatten(attention.mla_spec(cfg))
    want = module.flatten(j_attn.mla_spec(cfg))
    assert list(got) == list(want)
    assert all(got[k].shape == want[k].shape for k in want)


def test_dense_blocks_load_from_repro(tree):
    """``params_from_numpy`` splits ``dense_blocks`` (the dense first
    layer) as it splits ``blocks``: every parameter holds repro's value
    (bf16 ones rounded to nearest even)."""
    cfg, _, flat = tree
    tm = build_model(cfg, "cpu")
    module.params_from_numpy(tm, flat)
    params = dict(tm.named_parameters())
    n = 0
    for name, arr in module.flatten(flat).items():
        head, _, rest = name.partition(".")
        parts = [(f"{head}.{i}.{rest}", arr[i]) for i in range(arr.shape[0])] \
            if head in ("blocks", "dense_blocks") else [(name, arr)]
        for pname, a in parts:
            p = params[pname]
            assert torch.equal(p, torch.tensor(a).to(p.dtype)), pname
            n += 1
    assert n == len(params)
    assert "dense_blocks.0.attn.wq.w" in params
    assert params["blocks.0.attn.wuk.w"].dtype == torch.float32


@pytest.mark.parametrize("s", [16, 37])
def test_mla_qkr_and_self_attn_match_repro(tree, s):
    """``_mla_qkr`` (q_nope, q_rope with RoPE, the shared rope key) and the
    expanded ``mla_self_attn`` through ``blockwise_attn`` on equal bf16
    inputs."""
    cfg, _, _ = tree
    jp, tp = _layer(tree)
    x = np.random.default_rng(s).normal(size=(2, s, cfg.d_model))
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).to(
        torch.bfloat16)
    pos = np.arange(s, dtype=np.int32)
    got = attention._mla_qkr(tp, cfg, tx, torch.as_tensor(pos))
    want = j_attn._mla_qkr(jp, cfg, jx, jnp.asarray(pos))
    for g, w in zip(got[:3], want[:3]):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    got = attention.mla_self_attn(tp, cfg, tx, positions=torch.as_tensor(pos),
                                  chunk_q=16, chunk_kv=16)
    want = j_attn.mla_self_attn(jp, cfg, jx, positions=jnp.asarray(pos),
                                chunk_q=16, chunk_kv=16)
    assert got.dtype == torch.bfloat16
    _close(got, want)


def test_mla_decode_matches_repro(tree):
    """``mla_decode_self_attn`` step by step (f32 absorbed products over
    the ckv / kr cache, written in place) on equal bf16 inputs, 10 steps
    into a 12-slot cache: outputs and the cache against repro's."""
    cfg, _, _ = tree
    jp, tp = _layer(tree)
    rng = np.random.default_rng(9)
    b, t = 3, 12
    jckv = jnp.zeros((b, t, cfg.kv_lora), jnp.bfloat16)
    jkr = jnp.zeros((b, t, cfg.qk_rope_dim), jnp.bfloat16)
    tckv = torch.zeros((b, t, cfg.kv_lora), dtype=torch.bfloat16)
    tkr = torch.zeros((b, t, cfg.qk_rope_dim), dtype=torch.bfloat16)
    step = jax.jit(lambda x, c, k, p: j_attn.mla_decode_self_attn(
        jp, cfg, x, c, k, p))
    for i in range(10):
        x = rng.normal(size=(b, 1, cfg.d_model))
        jo, jckv, jkr = step(jnp.asarray(x, jnp.bfloat16), jckv, jkr,
                             jnp.int32(i))
        to, ckv, kr = attention.mla_decode_self_attn(
            tp, cfg, torch.as_tensor(x).to(torch.bfloat16), tckv, tkr,
            torch.tensor(i, dtype=torch.int32))
        assert ckv is tckv and kr is tkr               # in place
        _close(to, jo)
    _close(tckv, jckv, rtol=2.0 ** -7, atol=0)
    _close(tkr, jkr, rtol=2.0 ** -7, atol=0)
    assert not tckv[:, 10:].any()


def test_mla_decode_equals_the_expanded_form(tree):
    """The absorbed decode (``W_uk`` folded into the query, ``W_uv`` after
    the weighted sum) computes the expanded attention's last position."""
    cfg, _, _ = tree
    _, tp = _layer(tree)
    s = 9
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(2, s, cfg.d_model))).to(torch.bfloat16)
    full = attention.mla_self_attn(tp, cfg, x,
                                   positions=torch.arange(s, dtype=torch.int32),
                                   chunk_q=16, chunk_kv=16)
    ckv = torch.zeros((2, s, cfg.kv_lora), dtype=torch.bfloat16)
    kr = torch.zeros((2, s, cfg.qk_rope_dim), dtype=torch.bfloat16)
    for i in range(s):
        out, _, _ = attention.mla_decode_self_attn(
            tp, cfg, x[:, i:i + 1], ckv, kr,
            torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(mp.np32(out[:, 0]), mp.np32(full[:, i]),
                                   atol=2.0 ** -5, rtol=0)


def test_head_dim_192_never_reaches_flash(monkeypatch):
    """DeepSeek-V2's dense layer at its published head dim (192, beyond
    the kernels' 128): ``self_attn`` keeps ``blockwise_attn`` (no
    ``ops.flash_attn`` call) and computes it; ``padded_head_dim`` refuses
    192, so a launch could not take it."""
    from repro_torch.kernels import ops
    calls = []
    monkeypatch.setattr(ops, "flash_attn", lambda *a, **kw: calls.append(1))
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 20, 2, 192)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    kw = dict(causal=True, window=None, chunk_q=8, chunk_kv=8)
    assert not attention.flash_takes(20, 192, None)
    assert attention.flash_takes(20, 128, None)
    assert attention.flash_takes(20, 24, 32) and not attention.flash_takes(
        40, 24, 32)
    got = attention.self_attn(q, k, v, **kw)
    assert calls == []
    want = attention.blockwise_attn(q, k, v, causal=True, chunk_q=8,
                                    chunk_kv=8)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="192"):
        flash_kernels.padded_head_dim(192)
    # The full config's dense layer is that shape.
    cfg = configs.get_config(ARCH)
    assert cfg.hd == 192 and cfg.first_dense_layers == 1


def test_dense_layer_at_head_dim_192_matches_repro(monkeypatch):
    """A deepseek reduced copy at head dim 192 (the published dense
    layer's): the forward never calls ``ops.flash_attn`` and its logits
    match repro's as tests/test_torch_moe.py holds the reduced ones."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attn
    monkeypatch.setattr(ops, "flash_attn",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    routes = mp.Routes()
    routes.install()
    try:
        pair = mp.Pair(ARCH, head_dim=192)
        toks = mp.tokens(pair.cfg, 2, 20, seed=4)
        with routes.record():
            want, _ = pair.j_forward(toks)
            got, _ = pair.tm.forward(mp.RUN, {"tokens": torch.as_tensor(toks)})
        hit = mp.affected(pair.cfg, routes.j, routes.t).reshape(2, 20)
    finally:
        routes.uninstall()
    assert calls == []
    assert (~hit).mean() >= mp.MIN_CLEAR
    diff = np.abs(mp.np32(got) - want).max(-1)
    assert diff[~hit].max() <= mp.LOGIT_ATOL


def test_mla_cache_layout(tree):
    """``init_cache``: ``ckv`` [L-1, B, T, kv_lora], ``kr`` [L-1, B, T,
    rope], the dense layer's ``dense_k`` / ``dense_v`` at the full
    length, bf16, as repro's."""
    cfg, jm, _ = tree
    tm = build_model(cfg, "cpu")
    tc = tm.init_cache(3, 11)
    jc = jm.init_cache(3, 11)
    assert set(tc) == set(jc) == {"pos", "ckv", "kr", "dense_k", "dense_v"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
    assert tc["ckv"].dtype == torch.bfloat16 and tc["pos"].dtype == \
        torch.int32
    assert layers.ACT_DTYPE == torch.bfloat16
