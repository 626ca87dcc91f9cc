"""The port's training path (src/repro_torch/{optim,runtime,launch/train.py}
and the trainable flash attention) against the JAX package's, on the
same numpy inputs and with ``repro``'s weights carried across by
``params_from_numpy``.  ``repro`` runs with its plain attention
(``blockwise_attn``) and, for the trainable flash, the Pallas kernel in
interpret mode.

Sizes: qwen1.5-0.5b's reduced config (2 layers, d 64, vocab 512), a
batch of 4 x 64 tokens.  Tolerances, as stated per test:

* AdamW's ``update`` and ``schedule`` on equal inputs: 4 f32 ulps (the
  same arithmetic; XLA's and PyTorch's ``pow`` / ``cos`` / ``exp`` and
  the norm's summation order may differ in the last bit, and the clip
  scale carries that into every leaf), an ulp of the largest term where
  the update subtracts (``p - lr * u`` with p near ``lr * u``);
* ``cross_entropy`` on equal f32 logits: 1e-5 absolute (a log-sum-exp
  and a mean in another order);
* the trainable flash: gradients bit-equal to autograd through the
  port's ``blockwise_attn`` (the backward is that program); within 1e-5
  of ``repro``'s ``make_flash_attn_trainable`` at f32 (summation order);
* one train step: loss and ``ce`` within 5e-3 absolute (seen: 7.5e-4),
  the grad norm within 5e-3 relative (seen: 6e-4), each gradient within
  5 % normwise, ``|got - want| / |want|`` (seen: 2.7 % at most).  Both
  packages round activations and the weights' gradients to bf16 (the
  blocks cast ``w`` to bf16 per call), in other places, and the port's
  forward runs the flash twin where ``repro`` runs ``blockwise_attn``;
  a gradient that lost a term (attention's, say) is off by far more;
* the embedding gradient is pinned, not copied (ROADMAP §3): ``repro``
  casts the table to bf16 and then gathers, so its gradient is a bf16
  scatter-add; the port gathers and then casts, so its gradient is the
  f32 sum of the cotangents.  Rows of tokens that occur once in the
  batch are held to the step's 5 %; every row to an f64 oracle of the
  same cotangents (1e-6 of the row's absolute sum); 1,000 repeats of one
  token with cotangent 1.0 give 256.0 in ``repro`` and 1000.0 here.

Updated parameters are not compared element by element after a step:
Adam's first step moves each by about ``lr * sign(g)``, so a near-zero
gradient that differs in its last bits flips its update.  The gradients
are held, and ``update`` is held on equal gradients.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs.base import RunConfig as JRunConfig
from repro.kernels.flash_attn import \
    make_flash_attn_trainable as j_make_trainable
from repro.models import layers as j_layers
from repro.models.model import build_model as j_build_model
from repro.models.module import init_params as j_init_params
from repro.optim import adamw as j_adamw
from repro.runtime import steps as j_steps
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_attn as flash_kernels
from repro_torch.launch import train as train_mod
from repro_torch.models import attention, layers, module
from repro_torch.models import model as model_mod
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import driver, steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen1.5-0.5b"
B, S = 4, 64
ULPS = 4
LOSS_ATOL, GNORM_RTOL, GRAD_NORMWISE = 5e-3, 5e-3, 0.05
KNOBS = dict(attn_chunk_q=16, attn_chunk_kv=16, learning_rate=1e-3,
             warmup_steps=2, total_steps=100)
RUN = RunConfig(remat="none", **KNOBS)
J_RUN = JRunConfig(remat="none", **KNOBS)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _flat(tree, pre=()):
    """{"a/b/c": leaf} of a nested dict (repro's path keys)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + (k,)))
        else:
            out["/".join(pre + (k,))] = v
    return out


def _repro_leaf(flat, name):
    """repro's leaf for the port's dotted parameter ``name`` (the blocks
    stacked [L, ...] in repro)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return np.asarray(flat["/".join(["blocks"] + parts[2:])])[
            int(parts[1])]
    return np.asarray(flat["/".join(parts)])


def _normwise(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


class Pair:
    """repro's reduced qwen and its params; the port's trainable model
    carrying the same weights (CPU); one batch from numpy."""

    def __init__(self):
        self.cfg = configs.get_reduced_config(ARCH)
        self.jm = j_build_model(j_configs.get_reduced_config(ARCH))
        self.jp = j_init_params(self.jm.specs, jax.random.key(0))
        toks = np.random.default_rng(0).integers(
            0, self.cfg.vocab, (B, S + 1)).astype(np.int32)
        self.jb = {"tokens": jnp.asarray(toks[:, :-1]),
                   "labels": jnp.asarray(toks[:, 1:])}
        self.tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                   "labels": torch.from_numpy(toks[:, 1:].copy())}

    def model(self):
        tm = build_model(self.cfg, "cpu", trainable=True)
        module.params_from_numpy(tm, jax.tree.map(np.array, self.jp))
        return tm

    def j_grads(self, run):
        fn = jax.jit(jax.value_and_grad(j_steps.make_loss_fn(self.jm, run),
                                        has_aux=True))
        (_, metrics), grads = fn(self.jp, self.jb)
        return metrics, _flat(grads)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def port_grads(pair):
    """The port's gradients and metrics at RUN (remat none)."""
    tm = pair.model()
    params = dict(tm.named_parameters())
    grads, metrics = steps.make_grad_fn(tm, RUN)(params, pair.tb)
    return grads, metrics


@pytest.fixture(scope="module")
def repro_grads(pair):
    return pair.j_grads(J_RUN)


# ------------------------------------------------------------- AdamW
def _tree(seed, scale, positive=False):
    """A flat {path: f32 array} shaped like the reduced qwen's params,
    keys sorted (repro's leaf order)."""
    rng = np.random.default_rng(seed)
    specs = _flat(j_build_model(j_configs.get_reduced_config(ARCH)).specs)
    out = {}
    for k in sorted(specs):
        a = rng.normal(size=specs[k].shape) * scale
        out[k] = np.abs(a).astype(np.float32) if positive \
            else a.astype(np.float32)
    return out


def _assert_ulps(got, want, what, *terms):
    """|got - want| within ULPS f32 ulps of the largest of |want| and the
    ``terms`` the value was summed from, element by element."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.abs(want)
    for t in terms:
        mag = np.maximum(mag, np.abs(np.asarray(t, np.float32)))
    tol = ULPS * np.spacing(mag.astype(np.float32))
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (what, got[bad][:4], want[bad][:4])


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
@pytest.mark.parametrize("start", [0, 499], ids=["step1", "step500"])
def test_adamw_update_matches_repro(clip, start):
    """One update from step ``start`` (moments zero at 0, random at 499)
    on equal params and grads (global norm ~ 10, so the clip bites):
    params, moments, step and grad norm within ULPS of repro's."""
    run = RunConfig(grad_clip=clip, weight_decay=0.1)
    jrun = JRunConfig(grad_clip=clip, weight_decay=0.1)
    p, g = _tree(1, 0.05), _tree(2, 0.02)
    m = _tree(3, 1e-3) if start else {k: np.zeros_like(a)
                                       for k, a in p.items()}
    v = _tree(4, 1e-5, positive=True) if start else {
        k: np.zeros_like(a) for k, a in p.items()}
    lr = np.float32(3e-4)
    jp, jst, jn = j_adamw.update(
        {k: jnp.asarray(a) for k, a in g.items()},
        j_adamw.OptState(jnp.int32(start),
                         {k: jnp.asarray(a) for k, a in m.items()},
                         {k: jnp.asarray(a) for k, a in v.items()}),
        {k: jnp.asarray(a) for k, a in p.items()}, jrun, jnp.float32(lr))
    tp = {k: torch.tensor(a) for k, a in p.items()}
    st = adamw.OptState(torch.tensor(start, dtype=torch.int32),
                        {k: torch.tensor(a) for k, a in m.items()},
                        {k: torch.tensor(a) for k, a in v.items()})
    out, st2, gn = adamw.update({k: torch.tensor(a) for k, a in g.items()},
                                st, tp, run, torch.tensor(lr))
    assert out is tp and st2.m is st.m          # in place
    assert st2.step.dtype == torch.int32 and int(st2.step) == start + 1
    _assert_ulps(float(gn), float(jn), "grad norm")
    if clip:
        assert float(jn) > clip
    for k in p:
        _assert_ulps(out[k].numpy(), jp[k], k, p[k])
        _assert_ulps(st2.m[k].numpy(), jst.m[k], k, m[k], g[k])
        _assert_ulps(st2.v[k].numpy(), jst.v[k], k, v[k], g[k] ** 2)


@pytest.mark.parametrize("sched", ["cosine", "wsd", "const"])
def test_schedule_matches_repro(sched):
    run = RunConfig(schedule=sched, warmup_steps=100, total_steps=10000)
    jrun = JRunConfig(schedule=sched, warmup_steps=100, total_steps=10000)
    for step in (0, 1, 50, 99, 100, 500, 5000, 7999, 8000, 9000, 9999,
                 10000, 12000):
        got = adamw.schedule(run, torch.tensor(step, dtype=torch.int32))
        want = j_adamw.schedule(jrun, jnp.int32(step))
        assert got.dtype == torch.float32 and got.shape == ()
        _assert_ulps(float(got), float(want), f"{sched} step {step}")


def test_adamw_init_and_global_norm():
    p = {k: torch.tensor(a) for k, a in _tree(5, 1.0).items()}
    st = adamw.init(p)
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    assert all(torch.equal(st.m[k], torch.zeros_like(p[k])) and
               st.m[k] is not st.v[k] for k in p)
    want = j_adamw.global_norm({k: jnp.asarray(a.numpy())
                                for k, a in p.items()})
    _assert_ulps(float(adamw.global_norm(p)), float(want), "norm")


# ---------------------------------------------------------------- loss
@pytest.mark.parametrize("z", [0.0, 1e-4, 1e-2])
def test_cross_entropy_matches_repro(z):
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(3, 17, 101)) * 4).astype(np.float32)
    labels = rng.integers(0, 101, (3, 17)).astype(np.int32)
    got = steps.cross_entropy(torch.tensor(logits), torch.tensor(labels), z)
    want = j_steps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 z)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5, rtol=0)


# ------------------------------------------------- the trainable flash
def _qkv(dtype, seed=3):
    """tests/test_flash_attn.py:39's shapes: q [1, 64, 4, 16], k / v
    [1, 64, 2, 16] (GQA 2:1), and a cotangent like q."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16), (1, 64, 4, 16))]
    return arrs, [torch.tensor(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trainable_flash_grads_are_blockwise(dtype):
    """Forward equal to the flash twin (``flash_attn``), gradients bit-equal
    to autograd through ``blockwise_attn`` on the KV heads repeated."""
    _, (q, k, v, g) = _qkv(dtype)
    f = flash_kernels.make_flash_attn_trainable(causal=True, bq=32, bk=32,
                                                chunk=32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = f(q, k, v)
    with torch.no_grad():
        assert torch.equal(out, flash_kernels.flash_attn(q, k, v))
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = attention.blockwise_attn(q, attention.repeat_kv(k, 4),
                                   attention.repeat_kv(v, 4), causal=True,
                                   chunk_q=32, chunk_kv=32)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


def test_trainable_flash_matches_repro():
    """Against repro's custom_vjp (Pallas forward in interpret mode), f32:
    the output and the three gradients within 1e-5."""
    (qn, kn, vn, gn), (q, k, v, g) = _qkv(torch.float32)
    jf = j_make_trainable(causal=True, bq=32, bk=32, interpret=True,
                          chunk=32)
    jout, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (qn, kn, vn)))
    jgrads = vjp(jnp.asarray(gn))
    f = flash_kernels.make_flash_attn_trainable(causal=True, chunk=32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = f(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), g)
    for a, b in zip((out,) + grads, (jout,) + tuple(jgrads)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5, rtol=0)


def test_flash_kernel_refuses_autograd():
    """The kernel's launch is invisible to autograd: ``flash_attn_bhsd``
    and ``ops.flash_attn`` raise when grad is enabled and an input
    requires grad (on the CPU too), rather than drop the gradients."""
    from repro_torch.kernels import ops
    _, (q, k, v, _g) = _qkv(torch.float32)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="make_flash_attn_trainable"):
        ops.flash_attn(q, k, v)
    bhsd = torch.zeros(2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        flash_kernels.flash_attn_bhsd(bhsd, bhsd, bhsd)
    with torch.no_grad():
        flash_kernels.flash_attn_bhsd(bhsd, bhsd, bhsd)
        ops.flash_attn(q, k, v)


def test_self_attn_takes_the_trainable_path_under_grad(pair):
    """Under grad the model's attention goes through the trainable flash
    (its backward node) and wq gets attention's gradient; without grad
    it goes through ``ops.flash_attn`` and builds no graph."""
    _, (q, k, v, _g) = _qkv(torch.float32)
    kw = dict(causal=True, window=None, chunk_q=16, chunk_kv=16)
    out = attention.self_attn(q.requires_grad_(), attention.repeat_kv(k, 4),
                              attention.repeat_kv(v, 4), **kw)
    assert type(out.grad_fn).__name__ == "_TrainableFlashBackward"
    with torch.no_grad():
        assert attention.self_attn(q, k, v, **kw).grad_fn is None
    tm = pair.model()
    logits, _ = tm(RUN, pair.tb)
    g = torch.autograd.grad(logits.square().mean(),
                            [tm.blocks[1].attn.wq.w])[0]
    assert float(g.abs().max()) > 0


# ------------------------------------------------------ one train step
def test_train_step_grads_match_repro(pair, port_grads, repro_grads):
    """Loss, ce and every gradient against repro's (the embedding table on
    the rows of tokens that occur once: see the module doc)."""
    grads, metrics = port_grads
    jmetrics, jgrads = repro_grads
    for key in ("loss", "ce"):
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= LOSS_ATOL
    gn = float(adamw.global_norm(grads))
    jn = float(j_adamw.global_norm(jgrads))
    assert abs(gn - jn) <= GNORM_RTOL * jn
    toks = pair.tb["tokens"].numpy().ravel()
    once = np.flatnonzero(np.bincount(toks, minlength=pair.cfg.vocab) == 1)
    assert len(once) > 50
    for name, g in grads.items():
        got, want = _np(g), _repro_leaf(jgrads, name)
        if name == "embed.table":
            got, want = got[once], want[once]
        assert got.dtype == np.float32 and got.shape == want.shape
        assert _normwise(got, want) <= GRAD_NORMWISE, name


def test_train_step_metrics_match_repro(pair):
    """The port's step against repro's jitted ``make_train_step`` on the
    same weights and batch: loss, ce, grad norm and lr."""
    jstep = jax.jit(j_steps.make_train_step(pair.jm, J_RUN))
    _, jopt, jm = jstep(pair.jp, j_adamw.init(pair.jp), pair.jb)
    tm = pair.model()
    params = dict(tm.named_parameters())
    _, opt, m = steps.make_train_step(tm, RUN)(params, adamw.init(params),
                                               pair.tb)
    assert int(opt.step) == int(jopt.step) == 1
    assert set(m) == set(jm) == {"loss", "ce", "grad_norm", "lr"}
    for key in ("loss", "ce"):
        assert abs(float(m[key]) - float(jm[key])) <= LOSS_ATOL
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
        <= GNORM_RTOL * float(jm["grad_norm"])
    assert float(m["lr"]) == float(jm["lr"]) == 0.0     # warmup from 0


def test_embedding_grad_is_the_f32_sum(pair, monkeypatch):
    """Every row of the port's embedding gradient against an f64 oracle:
    the sum of the embedding output's cotangents over the row's tokens."""
    cots = []

    def embed(params, tokens):
        x = layers.embed(params, tokens)
        x.register_hook(cots.append)
        return x
    monkeypatch.setattr(model_mod, "embed", embed)
    tm = pair.model()
    params = dict(tm.named_parameters())
    grads, _ = steps.make_grad_fn(tm, RUN)(params, pair.tb)
    (cot,) = cots
    toks = pair.tb["tokens"].numpy().ravel()
    cot = cot.double().numpy().reshape(len(toks), -1)
    oracle = np.zeros((pair.cfg.vocab, cot.shape[1]))
    np.add.at(oracle, toks, cot)
    scale = np.zeros_like(oracle)
    np.add.at(scale, toks, np.abs(cot))
    got = grads["embed.table"].double().numpy()
    assert np.all(np.abs(got - oracle) <= 1e-6 * scale)
    assert np.count_nonzero(np.bincount(toks) > 1) > 20


def test_embedding_repeats_are_not_rounded_to_bf16():
    """1,000 repeats of one token, cotangent 1.0: repro's bf16 scatter-add
    stops at 256.0; the port's f32 sum gives 1000.0."""
    table = np.random.default_rng(8).normal(size=(16, 8)).astype(np.float32)
    tokens = np.full((1, 1000), 3, np.int32)
    _, vjp = jax.vjp(lambda t: j_layers.embed({"table": t},
                                              jnp.asarray(tokens)),
                     jnp.asarray(table))
    (jg,) = vjp(jnp.ones((1, 1000, 8), jnp.bfloat16))
    t = torch.tensor(table, requires_grad=True)
    x = layers.embed({"table": t}, torch.tensor(tokens))
    (tg,) = torch.autograd.grad(x, t, torch.ones_like(x))
    assert np.all(np.asarray(jg)[3] == 256.0)
    assert torch.all(tg[3] == 1000.0)
    assert float(tg.abs().sum()) == 8000.0


def test_microbatch_matches_repro(pair):
    """microbatch=2: the gradients (f32 sums of g / 2) and metrics against
    repro's scan at the step's tolerances."""
    run = RunConfig(remat="none", microbatch=2, **KNOBS)
    jrun = JRunConfig(remat="none", microbatch=2, **KNOBS)
    jstep = jax.jit(j_steps.make_train_step(pair.jm, jrun))
    _, _, jm = jstep(pair.jp, j_adamw.init(pair.jp), pair.jb)
    tm = pair.model()
    params = dict(tm.named_parameters())
    grads, m = steps.make_grad_fn(tm, run)(params, pair.tb)
    for key in ("loss", "ce"):
        assert abs(float(m[key]) - float(jm[key])) <= LOSS_ATOL
    gn = float(adamw.global_norm(grads))
    assert abs(gn - float(jm["grad_norm"])) <= GNORM_RTOL * gn
    # The accumulation itself: the mean of the two halves' gradients.
    halves = [steps.make_grad_fn(tm, RUN)(params, {
        k: x[i * B // 2:(i + 1) * B // 2] for k, x in pair.tb.items()})
        for i in range(2)]
    for name, g in grads.items():
        want = (torch.zeros_like(g) + halves[0][0][name] / 2) \
            + halves[1][0][name] / 2
        assert torch.equal(g, want), name


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_is_bit_equal(pair, port_grads, remat):
    """remat dots / full recompute the same ops: gradients and metrics
    bit-equal to remat none."""
    tm = pair.model()
    params = dict(tm.named_parameters())
    run = RunConfig(remat=remat, **KNOBS)
    grads, metrics = steps.make_grad_fn(tm, run)(params, pair.tb)
    want_g, want_m = port_grads
    assert all(torch.equal(metrics[k], want_m[k]) for k in want_m)
    assert all(torch.equal(grads[k], want_g[k]) for k in want_g)


def test_forward_without_grad_keeps_serving_numbers(pair):
    """A trainable model's forward under no_grad equals its forward under
    grad (remat full), and the serving build still stores bf16 blocks
    with no gradient."""
    tm = pair.model()
    with torch.no_grad():
        a, _ = tm(RunConfig(remat="full"), pair.tb)
    b, _ = tm(RunConfig(remat="full"), pair.tb)
    assert torch.equal(a, b.detach()) and b.requires_grad
    serving = build_model(pair.cfg, "meta")
    assert not any(p.requires_grad for p in serving.parameters())
    assert serving.blocks[0].attn.wq.w.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in build_model(pair.cfg, "meta",
                                    trainable=True).parameters())


# -------------------------------------------------------------- driver
def _setup():
    cfg = configs.get_reduced_config(ARCH)
    return train_mod.setup(cfg, seed=0, device="cpu")


def test_restart_is_bitwise_identical(tmp_path):
    """Crash at step 7, restart from the step-5 checkpoint: parameters and
    optimizer state bit-identical to a run without the fault."""
    cfg = configs.get_reduced_config(ARCH)
    src = SyntheticLM(cfg=cfg, batch=2, seq=32, seed=3, device="cpu")
    run = RunConfig(remat="none", attn_chunk_q=32, attn_chunk_kv=32,
                    learning_rate=1e-3, warmup_steps=2, total_steps=100)
    out = []
    for name, fail in (("a", None), ("b", {7})):
        model, params, opt = _setup()
        dcfg = driver.DriverConfig(total_steps=10, ckpt_every=5,
                                   ckpt_dir=str(tmp_path / name),
                                   log_every=100)
        out.append(driver.train_loop(steps.make_train_step(model, run),
                                     params, opt, src, dcfg, fail_at=fail,
                                     log=lambda *_: None))
    (p1, o1, h1), (p2, o2, h2) = out
    assert h1["restarts"] == 0 and h2["restarts"] == 1
    assert h2["steps_run"] == 12 and len(h1["loss"]) == 10
    assert h1["loss"][-1] < h1["loss"][0]
    assert int(o1.step) == int(o2.step) == 10
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(o1.m[k], o2.m[k]) and torch.equal(o1.v[k],
                                                             o2.v[k]), k


class _Source:
    def batch_at(self, step):
        return {"step": step}


def _fake(step_fn):
    params = {"w": torch.zeros(3)}
    return step_fn, params, adamw.init(params)


def test_max_restarts_bounds_a_crash_loop(tmp_path):
    calls = []

    def step(params, opt, batch):
        calls.append(batch["step"])
        raise RuntimeError("flaky host")
    fn, params, opt = _fake(step)
    dcfg = driver.DriverConfig(total_steps=4, ckpt_dir=str(tmp_path),
                               max_restarts=2)
    with pytest.raises(RuntimeError, match="flaky host"):
        driver.train_loop(fn, params, opt, _Source(), dcfg,
                          log=lambda *_: None)
    assert calls == [0, 0, 0]


def test_straggler_hook_fires(tmp_path):
    seen = []

    def step(params, opt, batch):
        # Every step takes 5 ms at least: a step of microseconds makes the
        # running median so small that the host's jitter after step 7's
        # sleep reads as a straggler too.
        time.sleep(0.25 if batch["step"] == 7 else 0.005)
        return params, opt, {"loss": torch.tensor(1.0),
                             "lr": torch.tensor(0.0)}
    fn, params, opt = _fake(step)
    dcfg = driver.DriverConfig(total_steps=9, ckpt_every=100,
                               ckpt_dir=str(tmp_path))
    _, _, hist = driver.train_loop(
        fn, params, opt, _Source(), dcfg,
        on_straggler=lambda s, r: seen.append((s, r)), log=lambda *_: None)
    assert [s for s, _ in seen] == [7] and seen[0][1] > 3.0
    assert hist["stragglers"] == 1 and hist["steps_run"] == 9


# ------------------------------------------------------------ launcher
def _launch(*extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--steps", "3", "--batch", "2", "--seq", "32",
         *extra], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=240)


@pytest.mark.parametrize("geo", [False, True], ids=["plain", "geo"])
def test_train_launcher_runs_on_the_cpu_when_asked(tmp_path, geo):
    """``--device cpu`` runs the reduced model three steps (with the geo
    stage when asked) and writes checkpoints 0 and 3; without a card the
    default ``--device cuda`` fails rather than fall back."""
    args = ["--ckpt-dir", str(tmp_path)] + (["--geo-enrich"] if geo else [])
    r = _launch("--device", "cpu", *args)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[train] done: loss" in r.stdout and "3 steps" in r.stdout
    assert ("geo enrichment on" in r.stdout) == geo
    assert sorted(os.listdir(tmp_path)) == ["step_00000000",
                                            "step_00000003"]
    if not geo and not torch.cuda.is_available():
        r = _launch("--ckpt-dir", str(tmp_path / "cuda"))
        assert r.returncode != 0 and "[train] done" not in r.stdout
