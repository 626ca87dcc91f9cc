"""The port's dense LM stack (src/repro_torch/{configs,models,runtime,
launch}) against the JAX package's, on the same numpy inputs and with
``repro``'s weights carried across by ``params_from_numpy``.

Sizes: ``get_reduced_config`` for qwen1.5-0.5b (MHA, QKV bias) and yi-9b
(GQA 2:1), two layers, d 64.  Tolerances, as stated per test:

* ops on f32 inputs: 1e-6 absolute (the same f32 arithmetic);
* ops on bf16 inputs: two bf16 ulps (1 / 64 relative) — XLA and PyTorch
  round a bf16 product or activation in different places, one ulp apart
  at most on these cases;
* whole-model logits (f32, scale about 4): 0.1 absolute.  Those ulp
  differences carry through two layers, and the port's self-attention
  runs the flash twin where repro runs ``blockwise_attn`` (the one
  difference in the call graph); the worst seen on these seeds is 0.049;
* bf16 caches: 0.0625 absolute plus two ulps (the worst seen: one ulp at
  magnitudes up to 8, layer 0 bit-equal);
* decode is compared teacher-forced: both stacks are fed repro's greedy
  tokens, logits are compared at every step, and argmax equality is
  required only where repro's top-2 margin exceeds the logit tolerance
  (a near tie would flip on rounding, not on a defect).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs.base import RunConfig as JRunConfig
from repro.models import attention as j_attn
from repro.models import ffn as j_ffn
from repro.models import layers as j_layers
from repro.models.model import build_model as j_build_model
from repro.models.module import init_params as j_init_params
from repro.models.module import param_count as j_param_count
from repro.runtime import steps as j_steps
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import _build
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention, ffn, layers, module
from repro_torch.models.model import build_model
from repro_torch.runtime import steps

F32_ATOL = 1e-6
BF16_RTOL = 2.0 ** -6
LOGIT_ATOL = 0.1
CACHE_ATOL = 0.0625
ARCHS = ("qwen1.5-0.5b", "yi-9b")
RUN = RunConfig(remat="none", attn_chunk_q=16, attn_chunk_kv=16)
J_RUN = JRunConfig(remat="none", attn_chunk_q=16, attn_chunk_kv=16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_bf16(got, want, atol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                               atol=atol)


class Pair:
    """One config's repro model and params, and the port's model carrying
    the same weights (CPU)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.jm = j_build_model(cfg)
        self.jp = j_init_params(self.jm.specs, jax.random.key(0))
        self.tm = build_model(cfg, "cpu")
        module.params_from_numpy(
            self.tm, jax.tree.map(lambda a: np.array(a), self.jp))
        self._jit = {}

    def j(self, name, fn):
        if name not in self._jit:
            self._jit[name] = jax.jit(fn, static_argnums=(2,)) \
                if name == "prefill" else jax.jit(fn)
        return self._jit[name]

    def j_forward(self, toks):
        fn = self.j("forward", lambda p, t: self.jm.forward(
            p, J_RUN, {"tokens": t})[0])
        return np.asarray(fn(self.jp, jnp.asarray(toks)))

    def j_prefill(self, toks, max_len):
        fn = self.j("prefill", lambda p, t, n: self.jm.prefill(
            p, J_RUN, t, n))
        return fn(self.jp, jnp.asarray(toks), max_len)

    def j_decode(self, tok, cache):
        fn = self.j("decode", lambda p, t, c: self.jm.decode_step(
            p, J_RUN, t, c))
        return fn(self.jp, jnp.asarray(tok), cache)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(configs.get_reduced_config(request.param))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _margin(logits):
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def _teacher_forced(pair, toks, max_len, steps):
    """Prefill both stacks, then ``steps`` decode steps fed repro's greedy
    tokens; hold logits and caches as the module doc says.  Returns the
    number of (row, step) comparisons whose argmax was required equal."""
    jlast, jc = pair.j_prefill(toks, max_len)
    tlast, tc = pair.tm.prefill(RUN, torch.as_tensor(toks), max_len)
    np.testing.assert_allclose(_np(tlast), _np(jlast), atol=LOGIT_ATOL,
                               rtol=0)
    for key in ("k", "v"):
        _close_bf16(tc[key], jc[key], atol=CACHE_ATOL)
    assert int(tc["pos"]) == int(jc["pos"]) == toks.shape[1]
    logits, required = _np(jlast)[:, -1], 0
    for _ in range(steps):
        tok = np.argmax(logits, -1).astype(np.int32)[:, None]
        jl, jc = pair.j_decode(tok, jc)
        tl, tc = pair.tm.decode_step(RUN, torch.as_tensor(tok), tc)
        jl, tl = _np(jl)[:, -1], _np(tl)[:, -1]
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        clear = _margin(jl) > LOGIT_ATOL
        np.testing.assert_array_equal(np.argmax(tl, -1)[clear],
                                      np.argmax(jl, -1)[clear])
        required += int(clear.sum())
        assert int(tc["pos"]) == int(jc["pos"])
        logits = jl
    for key in ("k", "v"):
        _close_bf16(tc[key], jc[key], atol=CACHE_ATOL)
    return required


# ------------------------------------------------------------- configs
def test_configs_are_repro_copies():
    assert configs.ARCH_NAMES == j_configs.ARCH_NAMES
    for name in configs.ARCH_NAMES:
        for get in ("get_config", "get_reduced_config"):
            assert dataclasses.asdict(getattr(configs, get)(name)) == \
                dataclasses.asdict(getattr(j_configs, get)(name))
        assert [s.name for s in configs.shapes_for(configs.get_config(
            name))] == [s.name for s in j_configs.shapes_for(
                j_configs.get_config(name))]
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(
        JRunConfig())


# ------------------------------------------------------ params and module
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "yi-9b", "minicpm-2b",
                                  "nemotron-4-15b"])
@pytest.mark.parametrize("reduced", [True, False])
def test_param_tree_follows_repro(name, reduced):
    """Full width too, on the meta device (no memory): the port's
    parameters are repro's tree with the stacked blocks split per layer,
    shape for shape, and the counts agree (about 6.2e8 for qwen)."""
    get = "get_reduced_config" if reduced else "get_config"
    cfg = getattr(configs, get)(name)
    jm = j_build_model(getattr(j_configs, get)(name))
    tm = build_model(cfg, "meta")
    j_abs = jm.abstract_params()
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(j_abs)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                want[".".join(["blocks", str(i)] + keys[1:])] = leaf.shape[1:]
        else:
            want[".".join(keys)] = leaf.shape
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    assert tm.param_count() == j_param_count(jm.specs)
    assert module.param_count(tm.specs) == j_param_count(jm.specs)
    if name == "qwen1.5-0.5b" and not reduced:
        assert 6.1e8 < tm.param_count() < 6.3e8


def test_parameter_dtypes():
    """Block dense weights and biases are stored bf16 (cast once at
    load); norm scales, the embedding and the unembedding stay f32."""
    tm = build_model(configs.get_reduced_config("qwen1.5-0.5b"), "meta")
    for name, p in tm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        want = torch.bfloat16 if name.startswith("blocks.") and leaf in (
            "w", "b") else torch.float32
        assert p.dtype == want, name


def test_params_from_numpy_loads_repro_weights(pair):
    """Every parameter holds repro's value (bf16 ones rounded to nearest
    even, as repro's per-call cast rounds them)."""
    flat = module.flatten(jax.tree.map(np.asarray, pair.jp))
    params = dict(pair.tm.named_parameters())
    for name, arr in flat.items():
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(arr.shape[0]):
                p = params[f"blocks.{i}.{rest}"]
                want = torch.tensor(arr[i]).to(p.dtype)
                assert torch.equal(p, want), f"blocks.{i}.{rest}"
        else:
            assert torch.equal(params[name], torch.tensor(arr)), name


def test_params_from_numpy_checks_keys_and_shapes():
    cfg = configs.get_reduced_config("yi-9b")
    jm = j_build_model(cfg)
    tree = jax.tree.map(np.asarray, j_init_params(jm.specs,
                                                  jax.random.key(1)))
    tm = build_model(configs.get_reduced_config("yi-9b"), "cpu")
    missing = dict(tree, blocks=dict(tree["blocks"]))
    del missing["blocks"]["ffn_norm"]
    with pytest.raises(KeyError, match="missing"):
        module.params_from_numpy(tm, missing)
    extra = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        module.params_from_numpy(tm, extra)
    bad = dict(tree, final_norm={"scale": np.zeros(5, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        module.params_from_numpy(tm, bad)
    module.params_from_numpy(tm, tree)


def test_init_params_from_generator():
    """Truncated normals at two deviations, fan-in scaling, zeros and
    ones, reproducible from the generator's seed; meta stand-ins carry
    the shapes only."""
    spec = {"n": module.P((4000,), (None,), init="normal", scale=0.5),
            "f": module.P((400, 30), (None, None), init="fanin"),
            "z": module.P((3,), (None,), init="zeros"),
            "o": module.P((3,), (None,), init="ones")}
    spec = module.stack(spec, 2)
    a = module.init_params(spec, torch.Generator().manual_seed(3), "cpu")
    b = module.init_params(spec, torch.Generator().manual_seed(3), "cpu")
    for key in spec:
        assert torch.equal(a[key], b[key])
        assert a[key].shape == spec[key].shape
    assert float(a["n"].abs().max()) <= 2 * 0.5
    assert 0.3 < float(a["n"].std()) < 0.5      # N(0, 1) cut at 2: 0.88
    assert float(a["f"].abs().max()) <= 2 / np.sqrt(400)
    assert torch.equal(a["z"], torch.zeros(2, 3))
    assert torch.equal(a["o"], torch.ones(2, 3))
    meta = module.abstract_params(spec)
    assert meta["f"].device.type == "meta" and meta["f"].shape == (2, 400,
                                                                   30)


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layers_match_repro(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    w = (rng.normal(size=(64, 48)) / 8).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jx, tx = jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)

    def check(got, want):
        assert str(got.dtype).split(".")[-1] == \
            str(want.dtype).replace("bfloat16", "bfloat16")
        if dtype == "f32":
            np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL,
                                       rtol=1e-6)
        else:
            _close_bf16(got, want)

    j = {"scale": jnp.asarray(scale)}
    t = {"scale": torch.as_tensor(scale)}
    check(layers.rmsnorm(t, tx, 1e-5), j_layers.rmsnorm(j, jx, 1e-5))
    j["bias"], t["bias"] = jnp.asarray(bias), torch.as_tensor(bias)
    check(layers.layernorm(t, tx), j_layers.layernorm(j, jx))
    for bias_on in (False, True):
        jp = {"w": jnp.asarray(w)}
        tp = {"w": torch.as_tensor(w)}
        if bias_on:
            jp["b"], tp["b"] = jnp.asarray(b), torch.as_tensor(b)
        check(layers.dense(tp, tx), j_layers.dense(jp, jx))
    pos = np.arange(24)
    for theta in (1e4, 5e6):
        js, jc = j_layers.rope_tables(jnp.asarray(pos), 16, theta)
        ts, tc = layers.rope_tables(torch.as_tensor(pos), 16, theta)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=F32_ATOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=F32_ATOL)
    xh = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    js, jc = j_layers.rope_tables(jnp.asarray(pos), 16, 1e4)
    ts, tc = layers.rope_tables(torch.as_tensor(pos), 16, 1e4)
    check(layers.apply_rope(torch.as_tensor(xh).to(tdt), ts, tc),
          j_layers.apply_rope(jnp.asarray(xh, jdt), js, jc))
    bpos = np.stack([pos, pos + 5])                      # [B, S] tables
    js, jc = j_layers.rope_tables(jnp.asarray(bpos), 16, 1e4)
    ts, tc = layers.rope_tables(torch.as_tensor(bpos), 16, 1e4)
    check(layers.apply_rope(torch.as_tensor(xh).to(tdt), ts, tc),
          j_layers.apply_rope(jnp.asarray(xh, jdt), js, jc))


def test_embed_unembed_match_repro():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 9))
    got = layers.embed({"table": torch.as_tensor(table)},
                       torch.as_tensor(toks))
    want = j_layers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks))
    assert got.dtype == layers.ACT_DTYPE
    np.testing.assert_array_equal(_np(got), _np(want))     # same bits
    w = rng.normal(size=(16, 50)).astype(np.float32)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    got = layers.unembed({"w": torch.as_tensor(w)},
                         torch.as_tensor(x).to(torch.bfloat16))
    want = j_layers.unembed({"w": jnp.asarray(w)},
                            jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_ATOL * 10)


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ffn_matches_repro(act, dtype):
    rng = np.random.default_rng(2)
    spec = ffn.ffn_spec(32, 88, act)
    tree = module.tree_map(lambda p: (rng.normal(size=p.shape) / 6).astype(
        np.float32), spec)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    got = ffn.ffn(module.tree_map(torch.as_tensor, tree),
                  torch.as_tensor(x).to(tdt), act)
    want = j_ffn.ffn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x, jdt),
                     act)
    assert sorted(module.flatten(spec)) == sorted(module.flatten(
        j_ffn.ffn_spec(32, 88, act)))
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5,
                                   rtol=1e-5)
    else:
        _close_bf16(got, want, atol=2.0 ** -8)


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,t,kh,causal,window,q_offset,chunk", [
    (32, 32, 4, True, None, 0, 16),
    (37, 37, 2, True, None, 0, 16),       # ragged chunks, GQA 2:1
    (40, 40, 4, True, 8, 0, 16),          # sliding window
    (40, 40, 1, False, None, 0, 12),      # full attention, MQA
    (8, 40, 4, True, None, 32, 16),       # query offset (chunked prefill)
    (8, 40, 2, True, 12, 32, 8),          # offset + window
])
def test_blockwise_attn_matches_repro(s, t, kh, causal, window, q_offset,
                                      chunk, dtype):
    rng = np.random.default_rng(s + t + kh)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, t, kh, 16)).astype(np.float32)
    v = rng.normal(size=(2, t, kh, 16)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    kw = dict(causal=causal, window=window, chunk_q=chunk, chunk_kv=chunk,
              q_offset=q_offset)
    got = attention.blockwise_attn(*(torch.as_tensor(a).to(tdt)
                                     for a in (q, k, v)), **kw)
    want = j_attn.blockwise_attn(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                 **kw)
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)
    else:
        _close_bf16(got, want, atol=2.0 ** -8)


@pytest.mark.parametrize("kh", [4, 2, 1])
@pytest.mark.parametrize("mode", ["scalar", "per_row", "cache_pos"])
def test_decode_attn_matches_repro(kh, mode):
    rng = np.random.default_rng(kh)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 20, kh, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 20, kh, 16)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc))
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, kc, vc))
    if mode == "scalar":
        got = attention.decode_attn(tq, tk, tv, torch.tensor(13))
        want = j_attn.decode_attn(jq, jk, jv, jnp.asarray(13))
    elif mode == "per_row":
        vl = np.array([1, 20, 7])
        got = attention.decode_attn(tq, tk, tv, torch.as_tensor(vl))
        want = j_attn.decode_attn(jq, jk, jv, jnp.asarray(vl))
    else:
        cp = rng.integers(-1, 30, (3, 20))
        cp[:, 0] = 3                        # every row has a valid slot
        got = attention.decode_attn(tq, tk, tv, None,
                                    cache_pos=torch.as_tensor(cp))
        want = j_attn.decode_attn(jq, jk, jv, None,
                                  cache_pos=jnp.asarray(cp))
    _close_bf16(got, want, atol=2.0 ** -8)


def test_repeat_kv_and_projection_match_repro(pair):
    cfg = pair.cfg
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12)
    js, jc = j_layers.rope_tables(jnp.asarray(pos), cfg.hd, cfg.rope_theta)
    ts, tc = layers.rope_tables(torch.as_tensor(pos), cfg.hd,
                                cfg.rope_theta)
    jp = jax.tree.map(lambda a: a[0], pair.jp["blocks"])["attn"]
    got = attention.gqa_project_qkv(pair.tm.blocks[0]["attn"], cfg,
                                    torch.as_tensor(x).to(torch.bfloat16),
                                    rope=(ts, tc))
    want = j_attn.gqa_project_qkv(jp, cfg, jnp.asarray(x, jnp.bfloat16),
                                  rope=(js, jc))
    for g, w in zip(got, want):
        _close_bf16(g, w)
        _close_bf16(attention.repeat_kv(g, cfg.n_heads),
                    j_attn.repeat_kv(w, cfg.n_heads))


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("s", [48, 37])
def test_forward_logits_match_repro(pair, s):
    toks = _tokens(pair.cfg, 2, s)
    got, aux = pair.tm.forward(RUN, {"tokens": torch.as_tensor(toks)})
    assert aux == {} and got.dtype == torch.float32
    assert got.shape == (2, s, pair.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), pair.j_forward(toks),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("s", [48, 37])
def test_prefill_and_decode_match_repro(pair, s):
    """Prefill's last logits and caches, then six decode steps fed
    repro's tokens (teacher-forced)."""
    toks = _tokens(pair.cfg, 2, s, seed=s)
    assert _teacher_forced(pair, toks, s + 6, 6) > 0


def test_full_cache_clamps_past_its_end():
    """A full cache of t slots: once pos >= t every step writes slot
    t - 1 (repro's clamp), and the port does the same."""
    pair = Pair(configs.get_reduced_config("qwen1.5-0.5b"))
    toks = _tokens(pair.cfg, 2, 10, seed=3)
    _teacher_forced(pair, toks, 12, 5)          # pos 10 .. 14 on t = 12


@pytest.mark.parametrize("s,steps", [(40, 6), (10, 12)])
def test_sliding_window_matches_repro(s, steps):
    """A sliding-window variant of the reduced qwen (window 16): prefill
    through blockwise_attn with the window (not the flash kernel), then
    the rolling cache, past pos >= t."""
    cfg = dataclasses.replace(configs.get_reduced_config("qwen1.5-0.5b"),
                              sliding_window=16)
    pair = Pair(cfg)
    toks = _tokens(cfg, 2, s, seed=s)
    _teacher_forced(pair, toks, s + steps, steps)
    got = pair.tm.forward(RUN, {"tokens": torch.as_tensor(toks)})[0]
    np.testing.assert_allclose(got.numpy(), pair.j_forward(toks),
                               atol=LOGIT_ATOL, rtol=0)


def test_window_prefill_skips_the_flash_kernel(monkeypatch):
    """With a sliding window no call reaches ``ops.flash_attn``; without
    one, each layer's attention does, once per forward / prefill."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attn
    monkeypatch.setattr(ops, "flash_attn",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = configs.get_reduced_config("qwen1.5-0.5b")
    toks = torch.as_tensor(_tokens(cfg, 1, 20))
    for window, want in ((16, 0), (None, cfg.n_layers)):
        m = build_model(dataclasses.replace(cfg, sliding_window=window),
                        "cpu")
        module.params_from_numpy(m, module.init_params(
            m.specs, torch.Generator().manual_seed(0), "cpu"))
        calls.clear()
        m.prefill(RUN, toks, 24)
        assert len(calls) == want
        calls.clear()
        m.forward(RUN, {"tokens": toks})
        assert len(calls) == want


def test_unknown_family_raises():
    """``build_model`` takes every family of the configs and raises
    ValueError for any other."""
    for name in configs.ARCH_NAMES:
        build_model(configs.get_reduced_config(name), "meta")
    cfg = dataclasses.replace(configs.get_reduced_config("qwen1.5-0.5b"),
                              family="rnn")
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(cfg, "meta")


# ------------------------------------------------------- steps and serving
def test_steps_match_repro(pair):
    toks = _tokens(pair.cfg, 2, 24, seed=9)
    got = steps.make_prefill_step(pair.tm, RUN)(
        {"tokens": torch.as_tensor(toks)})
    want = jax.jit(j_steps.make_prefill_step(pair.jm, J_RUN))(
        pair.jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    jlast, jc = pair.j_prefill(toks, 30)
    _, tc = pair.tm.prefill(RUN, torch.as_tensor(toks), 30)
    tok = np.argmax(np.asarray(jlast)[:, -1], -1).astype(np.int32)[:, None]
    jn, jc = jax.jit(j_steps.make_serve_step(pair.jm, J_RUN))(
        pair.jp, jnp.asarray(tok), jc)
    tn, tc = steps.make_serve_step(pair.tm, RUN)(torch.as_tensor(tok), tc)
    jl, _ = pair.j_decode(tok, pair.j_prefill(toks, 30)[1])
    clear = _margin(np.asarray(jl)[:, -1]) > LOGIT_ATOL
    assert tn.dtype == torch.int32 and tn.shape == (2, 1)
    np.testing.assert_array_equal(tn.numpy()[clear], np.asarray(jn)[clear])
    assert int(tc["pos"]) == 25


def test_serve_generates_greedily(pair):
    """``launch.serve.serve`` on the CPU: the phases in order, no kernel
    launched, the first token the prefill's argmax, the rest repro's
    greedy tokens wherever repro's margin is clear (teacher-forced)."""
    cfg = pair.cfg
    prompts = serve_mod.make_prompts(cfg, 2, 24, seed=0, device="cpu")
    seen = []
    before = dict(_build.LAUNCHES)
    res = serve_mod.serve(pair.tm, prompts, 5,
                          on_phase=lambda p, e: seen.append((p, e)))
    assert seen == [("prefill", "start"), ("prefill", "end"),
                    ("decode", "start"), ("decode", "end")]
    assert dict(_build.LAUNCHES) == before
    assert res.tokens.shape == (2, 5) and res.tokens.dtype == torch.int32
    assert res.peak_bytes is None and res.prompt_len == 24
    assert torch.equal(res.tokens[:, 0],
                       res.prefill_logits.argmax(-1).to(torch.int32))
    np.testing.assert_array_equal(
        prompts.numpy(), np.random.default_rng(0).integers(
            0, cfg.vocab, (2, 24)))
    toks = np.concatenate([prompts.numpy(), res.tokens.numpy()], axis=1)
    jl = pair.j_forward(toks.astype(np.int32))[:, 23:-1]
    clear = _margin(jl) > LOGIT_ATOL
    np.testing.assert_array_equal(res.tokens.numpy()[clear],
                                  np.argmax(jl, -1)[clear])


def test_load_model_is_seeded():
    cfg = configs.get_reduced_config("yi-9b")
    a = serve_mod.load_model(cfg, seed=4, device="cpu")
    b = serve_mod.load_model(cfg, seed=4, device="cpu")
    c = serve_mod.load_model(cfg, seed=5, device="cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert not torch.equal(pa["blocks.0.attn.wq.w"], pc["blocks.0.attn.wq.w"])
    assert torch.equal(pa["final_norm.scale"], torch.ones(cfg.d_model))
