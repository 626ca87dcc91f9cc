"""The model half of the port's mesh path (``repro_torch.sharding.rules``,
``launch.mesh``'s collectives, ``moe_ffn(mesh=)``, the steps,
``adamw.global_norm`` and ``CheckpointManager`` under a mesh,
``train_loop(shardings=)``, ``launch/train.py``'s data mesh) against the
JAX package's, on the CPU.

* In process: every parameter's spec, the batch and input specs and the
  cache specs of all ten configs at full width on
  ``make_production_mesh``'s shapes, equal to ``repro``'s (a stub mesh;
  exact); ``act_spec``; a one-rank mesh, which needs no process group
  (the train step there is the one-device step on bf16-rounded weights,
  bit for bit); placement and refusals.
* Multi-rank: ``repro`` on 8 fake devices in one child interpreter,
  jitted, on a (2, 4) ("data", "model") mesh, beside the port on one
  spawn of 8 gloo CPU ranks, then a spawn of 4 for a (1, 4) restore
  and the per-block gathers on (2, 2) (one reduced cell of each family,
  the steps from the rank's blocks bit for bit equal to the steps on the
  whole compute tree, no rank holding two blocks' gathered leaves):
  each rank's blocks; ``moe_ffn`` with experts split over "model" (E 8),
  with virtual experts (E 2) and with a batch replicated over "data";
  one train step of reduced qwen and mixtral; AdamW alone on equal
  inputs; a checkpoint saved on (2, 4) and restored on (1, 4), in
  process and by ``repro``.  A second JAX child beside it: qwen's
  ``make_prefill_step`` and ``decode_step`` / ``make_serve_step``;
  mixtral's train step on the (8,) ("data",) mesh and with 2
  microbatches; ``train_loop(shardings=)`` with a failure.  On the (8,)
  data mesh, where each rank runs the experts on its slice of one global
  capacity plan's slots, Mixtral's prefill and decode steps and
  DeepSeek-V2's prefill against one process over the whole batch, bit
  for bit (``pair.DATA_MOE_ARCHS``).  Mixtral's
  routing can flip at near ties between the packages (bf16 rounding,
  ``tests/moe_pair.py``), so its mesh prefill, decode and data-mesh
  gradients are held against one process of the port routed as it
  routed (the data mesh bit for bit, its gradients to 2 %; the
  tensor-parallel (2, 4) mesh to LOGIT_ATOL, its layer-0 partials bit
  for bit), which ``tests/test_torch_moe.py`` holds against ``repro``;
  its (2, 4) train step is routed as ``repro`` routed (the JAX child
  hands its routing over, ``pair.jax_routes``) and its own choices may
  differ only at near ties; against ``repro`` the other steps are held
  to the bounds a flip stays within.  The tensor-parallel layout on the
  ranks: each tree's "model" blocks, the vocab-parallel
  ``cross_entropy`` (1e-6 of the whole vocab's) and embedding (bit for
  bit), the kv-head blocks of the cache.  ``launch/train.py`` under 4
  gloo ranks.
* The dry-run (``launch.dryrun``) on (2, 4): its counting mesh against
  the gloo ranks stepping the same cells (collective bytes and calls by
  kind, FLOPs, argument bytes: exact, first and last rank), and against
  ``repro``'s ``run_cell`` on the reduced configs (in the JAX children):
  ``params`` / ``param_bytes`` exact for all ten archs, the train and
  prefill arguments of the dense and MoE families exact, decode's
  arguments exact or apart by the pinned ``DECODE_ARGUMENT_GAPS``,
  FLOPs within 1 % or apart by the named ``FLOP_GAPS``, exactly.

Tolerances:

* specs, blocks, ``dropped``, restored checkpoints, the mesh against one
  process routed alike: exact;
* qwen's prefill and decode logits: 0.1 absolute
  (``tests/test_torch_models.py``'s; seen: 0.035); served tokens equal
  where ``repro``'s top-2 margin is over 0.2;
* ``moe_ffn``'s output: one bf16 ulp of its largest value (2^-7
  relative; the bf16 psum over "model" adds the partial outputs in
  another order than XLA; seen: 0 for E 8, one ulp at E 2); ``lb_loss``
  1e-3 absolute (seen: 6e-8);
* gradients: 2 % normwise, ``|got - want| / |want|``, for ``moe_ffn``
  (seen: 0.54 % at most: bf16 products in another order), and 5 % for
  a train step, ``tests/test_torch_train.py``'s bound (seen: 3.2 %, a
  bias of a reduced qwen); loss and ce 5e-3 absolute, the grad norm
  5e-3 relative, ``lb_loss`` 1e-3;
* a step's updated values within twice Adam's largest move of
  ``repro``'s, elementwise (``_adam_ratio``: a first update moves a
  value by ``lr * sign(g)`` times a ratio of the bias corrections, so a
  gradient near zero may flip it; over a loop, the moves add up),
  its moments ``m`` 5 % and ``v`` 10 % normwise; AdamW alone on equal
  inputs: 4 f32 ulps of the largest of the value, its parameter and the
  step between them (``tests/test_torch_train.py``'s rule; seen: 3.5),
  the norm 1e-6 relative (seen: equal);
* the learning rate: 4 f32 ulps (XLA's and PyTorch's ``cos``).

``repro``'s ``moe_ffn`` gradient is held as the derivative of its own
forward: its ``shard_map`` under ``check_vma=False``
(``mesh_model_pair.vma_unchecked``, a patch in the child; the forward is
the same).  With a batch split over "data" ``repro`` runs
``check_vma=True`` (``src/repro/models/moe.py:189-192``), and on jax
0.9.0 its gradient through the router (the top-k weights) is then not
that derivative; the expert weights' gradients are.  Pinned by
``test_repro_moe_gradient_under_check_vma_is_pinned`` (ROADMAP §3, F9).
The multi-rank fixture runs once per module (~50 s); the JAX child and
each spawn have their own time limits, so a rank stuck in a collective
fails the fixture instead of hanging.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import mesh_model_pair as pair
from moe_pair import ROUTE_GAP
from repro import configs as j_configs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import ShapeConfig as JShape
from repro.models import layers as j_layers
from repro.models.model import build_model as j_build_model
from repro.models.model import input_specs as j_input_specs
from repro.sharding import rules as j_rules
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (AbstractMesh, Mesh, gather_fwd,
                                     make_production_mesh, psum_bwd,
                                     psum_fwd)
from repro_torch.models import layers, module
from repro_torch.models import moe as t_moe
from repro_torch.models.model import build_model, input_specs
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.sharding import rules
from subproc import REPO_ROOT

JAX_TIMEOUT_S = 600
SPAWN_TIMEOUT_S = {8: 420, 4: 240}
OUT_ATOL_ULPS = 2.0 ** -7
LB_ATOL = 1e-3
MOE_GRAD_NORMWISE = 0.02
LOSS_ATOL, GNORM_RTOL, GRAD_NORMWISE = 5e-3, 5e-3, 0.05
LOGIT_ATOL = 0.1
M_NORMWISE, V_NORMWISE = 0.05, 0.10
ULPS = 4
PROD_MESHES = {"single": (16, 16), "multi": (2, 16, 16)}
BATCHES = (1, 2, 3, 8, 16, 32, 64, 256, 512)


class StubMesh:
    """``axis_names`` and a name -> size ``shape``: what both packages'
    rules read."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _prod(kind):
    m = make_production_mesh(multi_pod=kind == "multi")
    return m, StubMesh(tuple(m.shape.values()), m.axis_names)


def _nw(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------- specs, in process
def test_production_mesh_shapes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert isinstance(single, AbstractMesh)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512


@pytest.mark.parametrize("kind", sorted(PROD_MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_match_repro(arch, kind):
    """spec_pspec of every leaf of the full-width spec tree equals
    ``repro``'s; ``model_shardings`` gives each per-layer parameter its
    stacked leaf's spec less the stacked dimensions."""
    mesh, stub = _prod(kind)
    jspecs = pair.flat(j_build_model(j_configs.get_config(arch)).specs)
    model = build_model(configs.get_config(arch), "meta")
    tspecs = module.flatten(model.specs)
    assert set(jspecs) == set(k.replace(".", "/") for k in tspecs)
    for name, p in tspecs.items():
        got = rules.spec_pspec(p, mesh)
        assert tuple(got) == tuple(j_rules.spec_pspec(
            jspecs[name.replace(".", "/")], stub)), name
    sh = rules.model_shardings(model, mesh)
    assert set(sh) == set(dict(model.named_parameters()))
    for pname, s in sh.items():
        assert s.mesh is mesh
        stacked = rules.spec_pspec(tspecs[_stacked_name(model, pname)],
                                   mesh)
        assert tuple(s.spec) == tuple(stacked[len(stacked) - len(s.spec):])


def _stacked_name(model, pname):
    """The spec-tree leaf a per-layer parameter name comes from."""
    return ".".join(s for s in pname.split(".") if not s.isdigit())


@pytest.mark.parametrize("kind", sorted(PROD_MESHES))
def test_batch_and_input_specs_match_repro(kind):
    mesh, stub = _prod(kind)
    for b in BATCHES:
        for ndim in (1, 2, 3):
            assert tuple(rules.batch_pspec(mesh, b, ndim)) == tuple(
                j_rules.batch_pspec(stub, b, ndim)), (b, ndim)
        assert rules.batch_axes(mesh, b) == tuple(
            a for p in j_rules.batch_pspec(stub, b, 1) if p
            for a in ((p,) if isinstance(p, str) else p))
    jmesh = jax.sharding.AbstractMesh(tuple(mesh.shape.values()),
                                      mesh.axis_names)
    for arch in configs.ARCH_NAMES:
        for kind_, b in (("train", 256), ("prefill", 32)):
            shape = ShapeConfig(kind_, 4096, b, kind_)
            got = rules.input_shardings(mesh, input_specs(
                configs.get_config(arch), shape))
            want = j_rules.input_shardings(jmesh, j_input_specs(
                j_configs.get_config(arch), JShape(kind_, 4096, b, kind_)))
            assert set(got) == set(want)
            for k in got:
                assert tuple(got[k].spec) == tuple(want[k].spec), (arch, k)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cache_specs_match_repro(arch):
    """``cache_shardings`` over the port's cache tree at full width equals
    ``repro``'s over its own, at a batch the data axis divides and one it
    does not."""
    mesh, _ = _prod("single")
    jmesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    tmodel = build_model(configs.get_config(arch), "meta")
    jmodel = j_build_model(j_configs.get_config(arch))
    for b in (32, 3):
        got = pair.flat(rules.cache_shardings(
            mesh, tmodel.cache_specs(b, 1024), b))
        want = pair.flat(j_rules.cache_shardings(
            jmesh, jmodel.cache_specs(b, 1024), b))
        assert set(got) == set(want)
        for k in got:
            assert tuple(got[k].spec) == tuple(want[k].spec), (arch, b, k)


def test_act_spec_matches_repro():
    for kind in sorted(PROD_MESHES):
        mesh, stub = _prod(kind)
        for shape, parts in (((256, 4096, 32, 128),
                              (("pod", "data"), None, "model", None)),
                             ((3, 4096, 8, 128),
                              (("pod", "data"), None, "model", None)),
                             ((32, 4096, 152064), ("data", None, "model")),
                             ((32, 7), (None, "model"))):
            assert tuple(layers.act_spec(shape, parts, mesh)) == tuple(
                j_layers.act_spec(shape, parts, stub))
    x = torch.ones(2, 3)
    assert layers.shard_act(x, "data", None) is x


# ------------------------------------------------- placement, in process
class CoordMesh(StubMesh):
    def __init__(self, shape, axes, rank):
        super().__init__(shape, axes)
        self.coords = dict(zip(axes, (int(c) for c in np.unravel_index(
            rank, shape))))


def test_local_shards_tile_the_tensor():
    """The blocks of every rank of a (2, 4) mesh tile the tensor, each
    the row-major block of its coordinates (a dimension over ("data",
    "model") splits data-major)."""
    x = torch.arange(8 * 16 * 3, dtype=torch.float32).reshape(8, 16, 3)
    for spec in (rules.PartitionSpec("data", "model"),
                 rules.PartitionSpec(("data", "model")),
                 rules.PartitionSpec(None, ("data", "model"), None),
                 rules.PartitionSpec()):
        seen = torch.zeros_like(x)
        for r in range(8):
            mesh = CoordMesh((2, 4), ("data", "model"), r)
            blk = rules.local_shard(x, spec, mesh)
            sl = rules.shard_slices(x.shape, spec, mesh)
            assert torch.equal(blk, x[sl])
            seen[sl] += 1
        assert torch.all(seen == (1 if any(spec) else 8)), spec
    with pytest.raises(ValueError, match="does not split"):
        rules.shard_slices((6,), rules.PartitionSpec("model"),
                           CoordMesh((2, 4), ("data", "model"), 0))


def test_one_rank_mesh_needs_no_group():
    mesh = Mesh((1, 1), ("data", "model"))
    x = torch.randn(4, 6, requires_grad=True)
    assert mesh.all_gather(x, ("data", "model"), 1) is x
    assert mesh.psum_scatter(x, "model", 0) is x
    for fn in (lambda t: gather_fwd(t, mesh, "data", 0),
               lambda t: psum_fwd(t, mesh, "model"),
               lambda t: psum_bwd(t, mesh, ("data", "model"))):
        assert fn(x) is x
    assert mesh.any(True) and not mesh.any(False)
    view = mesh.with_batch(("data",))
    assert view.batch_axes == ("data",) and mesh.batch_axes == ()
    assert view.routes is mesh.routes and mesh.route == "direct"
    assert set(mesh.routes) == {"all_reduce", "all_gather",
                                "reduce_scatter"}


def test_one_rank_mesh_step_is_the_cast_step():
    """A train step on a (1, 1) mesh (no process group) is the one-device
    step on the same weights rounded to bf16 (``cast_params``), bit for
    bit: loss, metrics and every gradient but the embedding table's
    (the mesh gathers the bf16 table, so its gradient is a bf16
    scatter-add; one device gathers f32 rows: ROADMAP §3)."""
    cfg = configs.get_reduced_config("mixtral-8x7b")
    run = RunConfig(remat="full", attn_chunk_q=16, attn_chunk_kv=16)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 33))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    _one_rank_step_is_the_cast_step(cfg, run, batch)


def _one_rank_step_is_the_cast_step(cfg, run, batch):
    """The (1, 1) mesh's gradients and metrics against the one-device
    step's on bf16-rounded weights (random, the vlm's gates drawn from
    U(0.5, 1.5)): equal bit for bit but the embedding table's."""
    full = build_model(cfg, "cpu", trainable=True)
    module.init_params_into(full, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in full.named_parameters():
            if name.endswith(("cross.gate", "cross.ffn_gate")):
                p.uniform_(0.5, 1.5)
            elif p.dim() >= 2:
                p.copy_(p.to(torch.bfloat16))
    params = dict(full.named_parameters())
    g1, m1 = steps.make_grad_fn(full, run)(params, batch)
    mesh = Mesh((1, 1), ("data", "model"))
    tmpl = build_model(cfg, "meta", trainable=True)
    local = {k: p.detach().clone().requires_grad_(True)
             for k, p in params.items()}
    g2, m2 = steps.make_grad_fn(tmpl, run, mesh)(local, batch)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    for k in g1:
        if k != "embed.table":
            # The cast's backward rounds a matrix's gradient to bf16.
            want = g1[k].to(torch.bfloat16) if g1[k].dim() >= 2 else g1[k]
            assert torch.equal(want.float(), g2[k].float()), k
    assert all(p.device.type == "meta" for p in tmpl.parameters())


@pytest.mark.parametrize("arch", pair.XATTN_ARCHS)
def test_one_rank_mesh_xattn_step_is_the_cast_step(arch):
    """The cross-attention families on a (1, 1) mesh (no "model" extent,
    nothing tensor-parallel), remat "full", gates non-zero: the step of
    ``test_one_rank_mesh_step_is_the_cast_step``, bit for bit."""
    cfg = configs.get_reduced_config(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    if cfg.family == "vlm":
        batch["img"] = torch.from_numpy(rng.normal(size=(
            2, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32))
    else:
        batch["frames"] = torch.from_numpy(rng.normal(size=(
            2, 12, cfg.d_model)).astype(np.float32))
    _one_rank_step_is_the_cast_step(cfg, RunConfig(**pair.XATTN_KNOBS),
                                    batch)


def test_one_rank_mesh_moe_is_the_local_path():
    """On a (1, 1) mesh ``moe_ffn``'s mesh path (any E: one model rank
    holds them all) gives the one-rank path's output and aux, bit for
    bit (the refusals: ``tests/test_torch_moe.py``)."""
    cfg = dataclasses.replace(configs.get_reduced_config("mixtral-8x7b"),
                              n_experts=3, capacity_factor=0.5)
    params = module.init_params(t_moe.moe_spec(cfg),
                                torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    mesh = Mesh((1, 1), ("data", "model")).with_batch(("data",))
    y, aux = t_moe.moe_ffn(params, cfg, x, mesh)
    y0, aux0 = t_moe.moe_ffn(params, cfg, x)
    assert torch.equal(y, y0) and int(aux0["dropped"]) > 0
    assert int(aux["dropped"]) == int(aux0["dropped"])
    assert float(aux["lb_loss"]) == float(aux0["lb_loss"])


def test_checkpoint_shardings_must_match_the_tree(tmp_path):
    mesh = Mesh((1, 1), ("data", "model"))
    sh = rules.NamedSharding(mesh, rules.PartitionSpec("data"))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"a": torch.ones(4)}, shardings={"a": sh})
    with pytest.raises(KeyError, match="shardings tree"):
        mgr.save(2, {"a": torch.ones(4)}, shardings={"b": sh})
    with pytest.raises(ValueError, match="checkpoint shape"):
        mgr.restore(1, {"a": torch.zeros(2)}, {"a": sh})
    got = mgr.restore(1, {"a": torch.zeros(4)}, {"a": sh})
    assert torch.equal(got["a"], torch.ones(4))


# ------------------------------------------------------- multi-rank runs
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": repro's outputs, 8: the (2, 4) ranks', 4: the (1, 4)
    restore's, "ckpt": the checkpoint directory}."""
    tmp = tmp_path_factory.mktemp("mesh_model")
    inputs, jout = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    ckpt = str(tmp / "ckpt")
    pair.make_inputs(inputs)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        ["src", "tests"]), "XLA_FLAGS": pair.XLA_FLAGS,
        "JAX_PLATFORMS": "cpu"}
    jsteps = str(tmp / "jax_steps.npz")
    children = [subprocess.Popen(
        [sys.executable, "-c", f"import mesh_model_pair as m; m.{call}"],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for call in (
            f"jax_reference({inputs!r}, {jout!r})",
            f"jax_reference_steps({inputs!r}, {jsteps!r}, {str(tmp)!r})")]
    try:
        pair.spawn_ranks(8, (str(tmp / "init8"), inputs, ckpt, str(tmp)),
                         SPAWN_TIMEOUT_S[8])
        pair.spawn_ranks(4, (str(tmp / "init4"), inputs, ckpt, str(tmp)),
                         SPAWN_TIMEOUT_S[4])
        for child in children:
            out, err = child.communicate(timeout=JAX_TIMEOUT_S)
            assert child.returncode == 0 and "jax reference done" in out, \
                err[-4000:]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.communicate()
    load = lambda p: dict(np.load(p))     # noqa: E731
    jax_out = load(jout)
    jax_out.update(load(jsteps))
    return {"jax": jax_out, 8: load(str(tmp / "world8.npz")),
            4: load(str(tmp / "world4.npz")), "ckpt": ckpt,
            "inputs": load(inputs)}


def _repro_leaf(flat, arch, tag, name):
    key, i = pair._repro_key(name)
    a = flat[f"{arch}/{tag}/{key}"]
    return a if i is None else a[i]


def test_gathers_are_contiguous(runs):
    """``Mesh.all_gather`` / ``psum_scatter`` along every dim return
    contiguous tensors: a product on the permuted view took another
    cuBLAS kernel than one process's and rounded differently (F11)."""
    for dim in range(3):
        assert runs[8][f"contiguous/{dim}"].tolist() == [True, True], dim


def test_routes_are_direct_on_gloo_cpu(runs):
    for world in (8, 4):
        assert dict(runs[world]["routes"].tolist()) == {
            "all_gather": "direct", "all_reduce": "direct",
            "reduce_scatter": "direct"}


@pytest.mark.parametrize("arch", pair.TRAIN_ARCHS)
def test_blocks_are_repro_device_blocks(runs, arch):
    """Each rank's block of every leaf is the slice ``repro``'s
    ``NamedSharding.devices_indices_map`` gives its device."""
    j, t = runs["jax"], runs[8]
    keys = [k for k in j if k.startswith(f"{arch}/blocks/")]
    assert keys
    for k in keys:
        for r in range(8):
            assert np.array_equal(t[f"{k}/rank{r}"], j[k][r]), (k, r)


@pytest.mark.parametrize("case", sorted(pair.MOE_CASES))
def test_moe_ffn_matches_repro(runs, case):
    j, t = runs["jax"], runs[8]
    y, jy = t[f"moe_{case}/y"], j[f"moe_{case}/y"]
    assert y.shape == jy.shape
    assert np.abs(y - jy).max() <= OUT_ATOL_ULPS * np.abs(jy).max()
    assert int(t[f"moe_{case}/dropped"]) == int(j[f"moe_{case}/dropped"])
    assert int(j[f"moe_{case}/dropped"]) > 0      # capacity drops
    assert abs(float(t[f"moe_{case}/lb"]) - float(j[f"moe_{case}/lb"])) \
        <= LB_ATOL


@pytest.mark.parametrize("case", sorted(pair.MOE_CASES))
def test_moe_ffn_grads_match_repro(runs, case):
    """The gradients of sum(y * cot) + 0.01 lb_loss with respect to x and
    every weight, against ``repro``'s derivative of its forward."""
    j, t = runs["jax"], runs[8]
    for k in ("x", "router/w", "w_gate", "w_up", "w_down"):
        got, want = t[f"moe_{case}/g/{k}"], j[f"moe_{case}/g/{k}"]
        assert got.shape == want.shape
        assert _nw(got, want) <= MOE_GRAD_NORMWISE, k


def test_repro_moe_gradient_under_check_vma_is_pinned(runs):
    """F9 (ROADMAP §3): with the batch split over "data", ``repro``'s
    ``moe_ffn`` gradient (``check_vma=True``) is off its forward's
    derivative on the router's path (x and the router weight, far beyond
    rounding), while the expert weights' agree; with the batch
    replicated (``check_vma=False`` in ``repro`` too) all agree.  The
    port gives the derivative."""
    j = runs["jax"]
    for case in ("ep", "virtual"):
        for k in ("x", "router/w"):
            assert _nw(j[f"moe_{case}/g_vma/{k}"],
                       j[f"moe_{case}/g/{k}"]) > 0.2, (case, k)
        for k in ("w_gate", "w_up", "w_down"):
            assert np.array_equal(j[f"moe_{case}/g_vma/{k}"],
                                  j[f"moe_{case}/g/{k}"]), (case, k)
    for k in ("x", "router/w", "w_gate", "w_up", "w_down"):
        assert np.array_equal(j[f"moe_replicated/g_vma/{k}"],
                              j[f"moe_replicated/g/{k}"]), k


@pytest.mark.parametrize("arch", pair.TRAIN_ARCHS)
def test_train_step_metrics_match_repro(runs, arch):
    """One train step's metrics on (2, 4) against ``repro``'s under the
    mesh.  Mixtral's step is routed as ``repro`` routed (its routing
    handed over by the JAX child, ``pair.jax_routes``): the port's own
    choices, recorded before the forcing, may differ from ``repro``'s only
    at near ties (a gap under ``ROUTE_GAP``), where bf16 rounding in
    another place decides them; ``dropped`` is then equal."""
    j, t = runs["jax"], runs[8]
    n_moe = sum(1 for k in j if k.startswith(f"{arch}/routes/ids"))
    for i in range(n_moe):
        ids, gap = j[f"{arch}/routes/ids{i}"], j[f"{arch}/routes/gap{i}"]
        # One rank of each data shard, in row order.
        own = np.concatenate([t[f"{arch}/own_ids{i}/rank{r}"]
                              for r in (0, 4)])
        assert own.shape == ids.shape
        flip = (np.sort(own, -1) != np.sort(ids, -1)).any(-1)
        assert not (flip & (gap >= ROUTE_GAP)).any(), (i, gap[flip])
    assert n_moe == (2 if arch == "mixtral-8x7b" else 0)
    for tag in ("metrics", "step"):
        keys = {k for k in j if k.startswith(f"{arch}/{tag}/")}
        assert keys == {k for k in t if k.startswith(f"{arch}/{tag}/")}
    for key in ("loss", "ce"):
        for tag in ("metrics", "step"):
            k = f"{arch}/{tag}/{key}"
            assert abs(float(t[k]) - float(j[k])) <= LOSS_ATOL, k
    k = f"{arch}/step/grad_norm"
    assert abs(float(t[k]) - float(j[k])) <= GNORM_RTOL * float(j[k])
    lr, jlr = np.float32(t[f"{arch}/step/lr"]), np.float32(
        j[f"{arch}/step/lr"])
    assert jlr > 0 and abs(lr - jlr) <= ULPS * np.spacing(jlr)
    if f"{arch}/step/lb_loss" in j:
        assert abs(float(t[f"{arch}/step/lb_loss"])
                   - float(j[f"{arch}/step/lb_loss"])) <= LB_ATOL
        assert float(t[f"{arch}/step/dropped"]) == float(
            j[f"{arch}/step/dropped"])


@pytest.mark.parametrize("arch", pair.TRAIN_ARCHS)
def test_train_step_grads_match_repro(runs, arch):
    """Every parameter's gradient (gathered from the blocks) against
    ``repro``'s under the mesh."""
    j, t = runs["jax"], runs[8]
    names = [k[len(f"{arch}/g/"):] for k in t if k.startswith(f"{arch}/g/")]
    assert len(names) == len(dict(build_model(
        configs.get_reduced_config(arch), "meta").named_parameters()))
    for name in names:
        got = t[f"{arch}/g/{name}"]
        want = _repro_leaf(j, arch, "g", name)
        assert got.shape == want.shape
        assert _nw(got, want) <= GRAD_NORMWISE, name


def _adam_ratio(step, n_grads=1):
    """The largest |m_hat / sqrt(v_hat)| AdamW can reach at ``step`` from
    moments that summed ``n_grads`` gradients since zero (Cauchy-Schwarz
    over the decayed sums; 1 gradient: its exact value)."""
    run = RunConfig()
    bc1, bc2 = 1 - run.beta1 ** step, 1 - run.beta2 ** step
    q = run.beta1 ** 2 / run.beta2
    return ((1 - run.beta1) / bc1) / np.sqrt((1 - run.beta2) / bc2) \
        * np.sqrt(sum(q ** i for i in range(n_grads)))


@pytest.mark.parametrize("arch", pair.TRAIN_ARCHS)
def test_train_step_updates_match_repro(runs, arch):
    j, t = runs["jax"], runs[8]
    lr = float(j[f"{arch}/step/lr"])
    bound = 2 * lr * _adam_ratio(pair.OPT_STEP0 + 1)
    for name in [k[len(f"{arch}/p2/"):] for k in t
                 if k.startswith(f"{arch}/p2/")]:
        got, want = t[f"{arch}/p2/{name}"], _repro_leaf(j, arch, "p2", name)
        tol = bound + ULPS * np.spacing(np.abs(want).astype(np.float32))
        assert np.all(np.abs(got - want) <= tol), name
        assert _nw(t[f"{arch}/m2/{name}"],
                   _repro_leaf(j, arch, "m2", name)) <= M_NORMWISE, name
        assert _nw(t[f"{arch}/v2/{name}"],
                   _repro_leaf(j, arch, "v2", name)) <= V_NORMWISE, name


@pytest.mark.parametrize("arch", pair.TRAIN_ARCHS)
def test_sharded_adamw_matches_repro_on_equal_inputs(runs, arch):
    """AdamW on the blocks (the norm summed over each leaf's own axes)
    against ``repro``'s jitted ``update`` under the mesh, fed the same
    gradients."""
    j, t, inp = runs["jax"], runs[8], runs["inputs"]
    gn, jgn = float(t[f"{arch}/upd/grad_norm"]), float(
        j[f"{arch}/upd/grad_norm"])
    assert abs(gn - jgn) <= 1e-6 * jgn
    for name in [k[len(f"{arch}/upd/"):] for k in t
                 if k.startswith(f"{arch}/upd/") and k != f"{arch}/upd/"
                 "grad_norm"]:
        got, want = t[f"{arch}/upd/{name}"], _repro_leaf(j, arch, "upd",
                                                          name)
        p0 = _repro_leaf({f"{arch}/w/{k[len(f'w/{arch}/'):]}": v
                          for k, v in inp.items()
                          if k.startswith(f"w/{arch}/")}, arch, "w", name)
        mag = np.maximum(np.maximum(np.abs(want), np.abs(p0)),
                         np.abs(p0 - want)).astype(np.float32)
        assert np.all(np.abs(got - want) <= ULPS * np.spacing(mag)), name


def test_prefill_and_serve_steps_match_repro(runs):
    """qwen's ``make_prefill_step`` last logits and DECODE_STEPS of
    ``decode_step`` logits on (2, 4) within LOGIT_ATOL of ``repro``'s
    under the mesh; ``make_serve_step``'s tokens equal wherever
    ``repro``'s top-2 margin is clear of twice that."""
    _prefill_and_serve_match(runs, pair.TRAIN_ARCHS[0])


def _prefill_and_serve_match(runs, arch):
    """``arch``'s prefill and decode logits within LOGIT_ATOL of
    ``repro``'s, its served tokens equal where ``repro``'s top-2 margin is
    clear of twice that (at least half of them)."""
    j, t = runs["jax"], runs[8]
    vocab = configs.get_reduced_config(arch).vocab
    assert t[f"{arch}/prefill"].shape == (pair.TRAIN_B, vocab)
    assert np.abs(t[f"{arch}/prefill"] - j[f"{arch}/prefill"]).max() \
        <= LOGIT_ATOL
    clear = 0
    for s in range(pair.DECODE_STEPS):
        want = j[f"{arch}/decode{s}"]
        assert np.abs(t[f"{arch}/decode{s}"] - want).max() <= LOGIT_ATOL, s
        top = np.sort(want, -1)[:, -2:]
        ok = top[:, 1] - top[:, 0] > 2 * LOGIT_ATOL
        clear += int(ok.sum())
        assert np.array_equal(t[f"{arch}/serve{s}"][ok, 0],
                              j[f"{arch}/serve{s}"][ok, 0])
    assert clear >= pair.DECODE_STEPS * pair.TRAIN_B // 2


@pytest.mark.parametrize("arch", pair.TRAIN_ARCHS)
def test_mesh_prefill_and_decode_are_one_process_routed_alike(runs, arch):
    """The (2, 4) mesh's prefill, decode and serve steps against one
    process's forward and decode of each data shard's rows (the MoE's
    capacity is per shard), routed as that process routed.  The mesh is
    tensor-parallel over "model", so its bf16 partials are summed in
    gloo's order and the logits are no longer one process's bits: each
    rank's layer-0 partials (attention's ``wo``, the FFN's ``w_down``)
    are bit-equal to one process's product of the same slices, and the
    logits are within LOGIT_ATOL of one process's; the served tokens
    equal its argmax wherever its top-2 margin is clear of twice that.
    With ``tests/test_torch_moe.py`` holding one process against
    ``repro``, this holds mixtral's mesh path, whose routing can flip at
    near ties between the packages."""
    t = runs[8]
    tags = ("wo", "w_down") if arch == pair.TRAIN_ARCHS[0] else ("wo",)
    for tag in tags:
        for r in range(8):
            assert t[f"{arch}/partial_{tag}/rank{r}"].tolist() == \
                [True, True, True], (tag, r)
    assert np.abs(t[f"{arch}/prefill"] - t[f"{arch}/prefill_one"]).max() \
        <= LOGIT_ATOL
    for s in range(pair.DECODE_STEPS):
        want = t[f"{arch}/decode_one{s}"]
        assert np.abs(t[f"{arch}/decode{s}"] - want).max() <= LOGIT_ATOL
        top = np.sort(want, -1)[:, -2:]
        ok = top[:, 1] - top[:, 0] > 2 * LOGIT_ATOL
        assert np.array_equal(t[f"{arch}/serve{s}"][ok, 0],
                              want.argmax(-1)[ok])


def test_data_mesh_prefill_is_one_process(runs):
    """qwen's prefill on the (8,) ("data",) mesh, where "model" has extent
    1 and nothing is tensor-parallel: one process's forward of each row,
    bit for bit."""
    t = runs[8]
    assert np.array_equal(t["data_mesh/prefill"], t["data_mesh/prefill_one"])


@pytest.mark.parametrize("tag", ["serve", "train"])
@pytest.mark.parametrize("arch", sorted(pair.TREE_CASES))
def test_tp_trees_hold_model_blocks(runs, arch, tag):
    """Each rank's compute tree on (2, 4) (the serving tree of
    ``compute_params`` and the training tree): the tensor-parallel leaves
    hold their "model" block, 1/4 of their elements, where the rules
    split whole heads and the vocab, and the re-blocked ones their piece
    (MLA's wuq 1/4, Mamba2's in_proj 98 of 296 columns); the leaf whole
    where they do not (mixtral's 2 kv heads, MiniCPM's 6 q heads, a vocab
    of 513); every other leaf whole but the experts (their blocks as
    placed)."""
    t = runs[8]
    cfg = dataclasses.replace(configs.get_reduced_config(arch),
                              **pair.TREE_CASES[arch])
    pre = f"tree/{arch}/{tag}/"
    got = {k[len(pre):]: float(v) for k, v in t.items()
           if k.startswith(pre)}
    model = build_model(cfg, "meta")
    assert set(got) == set(dict(model.named_parameters()))
    split = {"qwen1.5-0.5b": ("attn.wq", "attn.wk", "attn.wv", "attn.wo",
                              "ffn.", "embed.table", "unembed.w"),
             # The dense layer's GQA and FFN, MLA's wuk / wuv / wo and its
             # re-blocked wuq (its head columns), the shared experts.
             "deepseek-v2-236b": ("attn.wq.", "attn.wk.", "attn.wv.",
                                  "attn.wo.", "ffn.", "attn.wuq.",
                                  "attn.wuk.", "attn.wuv.", "moe.shared.",
                                  "embed.table", "unembed.w"),
             # The shared block's attention, FFN and LoRA b_q, out_proj.
             "zamba2-1.2b": ("attn.w", "ffn.", "lora.b_q", "out_proj",
                             "embed.table", "unembed.w"),
             # The sLSTM's wo (its o gate's columns and its output's rows)
             # whole, its gates' wz / wi / wf blocks.
             "xlstm-1.3b": ("wq.", "wk.", "wv.", "wo_gate.", "mlstms.0.wo.",
                            "slstm.wz", "slstm.wi", "slstm.wf", "embed.table",
                            "unembed.w"),
             "mixtral-8x7b": ("attn.wq", "attn.wo", "embed.table",
                              "unembed.w"),
             "minicpm-2b": ("ffn.",),
             # Self and cross blocks alike; the 2 kv heads whole.
             "llama-3.2-vision-90b": ("attn.wq", "attn.wo", "ffn.",
                                      "embed.table", "unembed.w"),
             # Encoder, decoder self and cross; the vocab of 513 whole.
             "seamless-m4t-medium": ("attn.w", "self.w", "cross.w",
                                     "ffn.")}[arch]
    # Mamba2's in_proj: its 2 heads' z / x / dt columns and B / C whole.
    di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    h = di // cfg.ssm_head_dim
    in_proj = (2 * di / 4 + 2 * n + h / 4) / (2 * di + 2 * n + h) if h \
        else None
    for name, share in got.items():
        if ".moe.w_" in name:
            continue
        want = in_proj if name.endswith("in_proj.w") else \
            0.25 if any(k in name for k in split) else 1.0
        assert share == want, (name, share)


def test_vocab_parallel_cross_entropy_matches_whole_vocab(runs):
    """``cross_entropy`` over each rank's vocab block (512 over 4 ranks,
    its data shard's rows, z-loss on) and its gradient equal the whole
    vocab's on the same rows to 1e-6."""
    t = runs[8]
    for r in range(8):
        dl, dce, dg, loss = t[f"vocab_ce/rank{r}"]
        assert dl <= 1e-6 and dce <= 1e-6 and dg <= 1e-6, (r, dl, dce, dg)
        assert np.isfinite(loss) and loss > 1.0


def test_vocab_split_embedding_is_one_process(runs):
    """The vocab-split embedding (each rank's rows in its range, zeros
    elsewhere, summed over "model") is one process's gather-then-cast bit
    for bit, from an f32 table and from a bf16 one."""
    for r in range(8):
        assert runs[8][f"vocab_embed/rank{r}"].tolist() == [True, True], r


@pytest.mark.parametrize("arch", pair.TRAIN_ARCHS)
def test_mesh_cache_holds_kv_head_blocks(runs, arch):
    """``local_cache`` on (2, 4): this rank's 4 of 8 rows and, where
    ``cache_shardings`` splits them (qwen's 4 kv heads), 1 kv head of 4;
    mixtral's 2 kv heads stay whole on every rank."""
    cfg = configs.get_reduced_config(arch)
    kv = cfg.n_kv_heads // 4 if cfg.n_kv_heads % 4 == 0 else cfg.n_kv_heads
    t_len = min(pair.DECODE_LEN, cfg.sliding_window or pair.DECODE_LEN)
    for r in range(8):
        assert runs[8][f"{arch}/cache_k/rank{r}"].tolist() == [
            cfg.n_layers, pair.TRAIN_B // 2, t_len, kv, cfg.hd], r


@pytest.mark.parametrize("arch", pair.XATTN_ARCHS)
def test_xattn_prefill_and_serve_steps_match_repro(runs, arch):
    """The cross-attention families' ``make_prefill_step`` last logits
    and DECODE_STEPS of ``decode_step`` logits on (2, 4),
    tensor-parallel over "model" (the vlm's gates non-zero), within
    LOGIT_ATOL of ``repro``'s under the mesh; ``make_serve_step``'s tokens
    equal wherever ``repro``'s top-2 margin is clear of twice that."""
    _prefill_and_serve_match(runs, arch)


@pytest.mark.parametrize("arch", pair.XATTN_ARCHS)
def test_xattn_train_step_matches_repro(runs, arch):
    """One train step of the cross-attention families on (2, 4),
    tensor-parallel over "model", remat "full", against ``repro``'s under
    the mesh: loss and ce within LOSS_ATOL (the loss function's and the
    step's), the grad norm within GNORM_RTOL, the lr within ULPS, every
    gradient (gathered from the blocks) within GRAD_NORMWISE.

    A one-element gradient (a vlm gate's: ``tanh``'s derivative times the
    sum, over every activation of the batch, of the gated output times
    its cotangent, whose terms cancel) has no normwise bound from
    rounding: its relative error is the summed terms' rounding over a
    small sum.  ``repro``'s own gradients on the mesh and on one device
    differ by more than GRAD_NORMWISE at such a leaf (pinned below; 23.6 %
    at the first group's ``ffn_gate`` on these inputs).  So a
    one-element gradient is held within GRAD_NORMWISE of ``repro``'s
    under the mesh or within that spread of ``repro``'s two layouts,
    whichever is larger; every other gradient at GRAD_NORMWISE."""
    j, t = runs["jax"], runs[8]
    for tag in ("metrics", "step"):
        keys = {k for k in j if k.startswith(f"{arch}/{tag}/")}
        assert keys and keys == {k for k in t
                                 if k.startswith(f"{arch}/{tag}/")}
        for key in ("loss", "ce"):
            k = f"{arch}/{tag}/{key}"
            assert abs(float(t[k]) - float(j[k])) <= LOSS_ATOL, k
    k = f"{arch}/step/grad_norm"
    assert abs(float(t[k]) - float(j[k])) <= GNORM_RTOL * float(j[k])
    lr, jlr = np.float32(t[f"{arch}/step/lr"]), np.float32(
        j[f"{arch}/step/lr"])
    assert jlr > 0 and abs(lr - jlr) <= ULPS * np.spacing(jlr)
    names = [k[len(f"{arch}/g/"):] for k in t if k.startswith(f"{arch}/g/")]
    assert len(names) == len(dict(build_model(
        configs.get_reduced_config(arch), "meta").named_parameters()))
    spreads = []
    for name in names:
        got = t[f"{arch}/g/{name}"]
        want = _repro_leaf(j, arch, "g", name)
        assert got.shape == want.shape
        if want.size > 1:
            assert _nw(got, want) <= GRAD_NORMWISE, name
            continue
        spread = float(np.abs(_repro_leaf(j, arch, "g_one", name)
                              - want).max())
        spreads.append(spread / float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= max(
            GRAD_NORMWISE * float(np.abs(want).max()), spread), name
    cfg = configs.get_reduced_config(arch)
    if cfg.family == "vlm":
        # Both gates of every cross block, and repro's spread over
        # GRAD_NORMWISE at one of them.
        assert len(spreads) == 2 * cfg.n_layers // cfg.cross_attn_every
        assert max(spreads) > GRAD_NORMWISE
    else:
        assert not spreads


@pytest.mark.parametrize("arch", pair.XATTN_ARCHS)
def test_xattn_cache_holds_kv_head_blocks(runs, arch):
    """``local_cache`` of the cross-attention families on (2, 4): this
    rank's 4 of 8 rows and, where the kv heads split (the encdec's 4),
    1 kv head of 4 in every kv leaf, the vlm's image caches and the
    encdec's cross caches too; the vlm's 2 kv heads stay whole."""
    cfg = configs.get_reduced_config(arch)
    kv = cfg.n_kv_heads // 4 if cfg.n_kv_heads % 4 == 0 else cfg.n_kv_heads
    rows, hd = pair.TRAIN_B // 2, cfg.hd
    if cfg.family == "vlm":
        g, k = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every
        want = {"k": [g, k - 1, rows, pair.DECODE_LEN, kv, hd],
                "img_k": [g, rows, cfg.n_img_tokens, kv, hd]}
        want["v"], want["img_v"] = want["k"], want["img_k"]
    else:
        want = {k: [cfg.n_layers, rows, pair.DECODE_LEN, kv, hd]
                for k in ("k", "v", "cross_k", "cross_v")}
    for r in range(8):
        got = {k[len(f"{arch}/cache_"):-len(f"/rank{r}")]: v.tolist()
               for k, v in runs[8].items()
               if k.startswith(f"{arch}/cache_") and k.endswith(f"/rank{r}")}
        assert got == want, r


@pytest.mark.parametrize("arch", pair.XATTN_ARCHS)
def test_xattn_data_mesh_prefill_is_one_process(runs, arch):
    """The cross-attention families' prefill on the (8,) ("data",) mesh,
    where "model" has extent 1 and nothing is tensor-parallel: one
    process's forward of each row, bit for bit."""
    t = runs[8]
    assert np.array_equal(t[f"{arch}/data_mesh/prefill"],
                          t[f"{arch}/data_mesh/prefill_one"])


@pytest.mark.parametrize("arch", pair.LAST_LOGITS)
def test_last_prefill_and_serve_steps_match_repro(runs, arch):
    """DeepSeek-V2 (MLA, routed as ``repro`` routed each call) and the
    xLSTM on (2, 4), tensor-parallel over "model": ``make_prefill_step``'s
    last logits and DECODE_STEPS of ``decode_step``'s within LOGIT_ATOL of
    ``repro``'s under the mesh; ``make_serve_step``'s tokens equal wherever
    ``repro``'s top-2 margin is clear of twice that."""
    j, t = runs["jax"], runs[8]
    vocab = configs.get_reduced_config(arch).vocab
    assert t[f"{arch}/prefill"].shape == (pair.TRAIN_B, vocab)
    assert np.abs(t[f"{arch}/prefill"] - j[f"{arch}/prefill"]).max() \
        <= LOGIT_ATOL
    clear = 0
    for s in range(pair.DECODE_STEPS):
        want = j[f"{arch}/decode{s}"]
        assert np.abs(t[f"{arch}/decode{s}"] - want).max() <= LOGIT_ATOL, s
        top = np.sort(want, -1)[:, -2:]
        ok = top[:, 1] - top[:, 0] > 2 * LOGIT_ATOL
        clear += int(ok.sum())
        assert np.array_equal(t[f"{arch}/serve{s}"][ok, 0],
                              want.argmax(-1)[ok])
    assert clear >= pair.DECODE_STEPS * pair.TRAIN_B // 4


def test_zamba2_steps_run_tensor_parallel(runs):
    """Zamba2's prefill and serve steps on (2, 4): finite logits of the
    whole vocab, and every served token the argmax of the same step's
    decode logits (its values are held block by block, LAST_BLOCKS: see
    ``pair.LAST_LOGITS``)."""
    t = runs[8]
    arch = "zamba2-1.2b"
    vocab = configs.get_reduced_config(arch).vocab
    assert t[f"{arch}/prefill"].shape == (pair.TRAIN_B, vocab)
    assert np.isfinite(t[f"{arch}/prefill"]).all()
    for s in range(pair.DECODE_STEPS):
        logits = t[f"{arch}/decode{s}"]
        assert logits.shape == (pair.TRAIN_B, vocab)
        assert np.array_equal(t[f"{arch}/serve{s}"][:, 0], logits.argmax(-1))


@pytest.mark.parametrize("arch", pair.LAST_ARCHS)
def test_last_train_step_matches_repro(runs, arch):
    """One train step of the last three families on (2, 4),
    tensor-parallel over "model", against ``repro``'s under the mesh: the
    step's loss and ce within LOSS_ATOL of ``repro``'s loss function's
    and its lr within ULPS of ``repro``'s schedule; for DeepSeek-V2
    (routed as ``repro`` routed: the port's own choices differ only at
    near ties) also the grad norm within GNORM_RTOL of the global norm of
    ``repro``'s gradients, ``lb_loss`` within LB_ATOL, ``dropped`` equal
    and every gradient within GRAD_NORMWISE.  The recurrent families'
    gradients are held block by block (``test_last_blocks_match_one_
    process``; ``pair.LAST_LOGITS`` says why)."""
    j, t = runs["jax"], runs[8]
    for key in ("loss", "ce"):
        k = f"{arch}/step/{key}"
        assert abs(float(t[k]) - float(j[f"{arch}/metrics/{key}"])) \
            <= LOSS_ATOL, k
    lr, jlr = np.float32(t[f"{arch}/step/lr"]), np.float32(j[f"{arch}/lr"])
    assert jlr > 0 and abs(lr - jlr) <= ULPS * np.spacing(jlr)
    assert np.isfinite(float(t[f"{arch}/step/grad_norm"]))
    if arch not in pair.LAST_GRADS:
        assert not any(k.startswith(f"{arch}/g/") for k in t)
        return
    cfg = configs.get_reduced_config(arch)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    for i in range(n_moe):
        ids, gap = j[f"{arch}/train/ids{i}"], j[f"{arch}/train/gap{i}"]
        own = np.concatenate([t[f"{arch}/own_ids{i}/rank{r}"]
                              for r in (0, 4)])
        flip = (np.sort(own, -1) != np.sort(ids, -1)).any(-1)
        assert not (flip & (gap >= ROUTE_GAP)).any(), (i, gap[flip])
    assert abs(float(t[f"{arch}/step/lb_loss"])
               - float(j[f"{arch}/metrics/lb_loss"])) <= LB_ATOL
    assert float(t[f"{arch}/step/dropped"]) == float(
        j[f"{arch}/metrics/dropped"])
    names = [k[len(f"{arch}/g/"):] for k in t if k.startswith(f"{arch}/g/")]
    # repro's grad norm: the global norm of its gradients (its step's
    # adamw.update computes the same before clipping).
    jn = float(np.sqrt(sum(float(np.sum(np.square(v.astype(np.float64))))
                           for k, v in j.items()
                           if k.startswith(f"{arch}/g/"))))
    assert abs(float(t[f"{arch}/step/grad_norm"]) - jn) <= GNORM_RTOL * jn
    assert len(names) == len(dict(build_model(cfg, "meta")
                                  .named_parameters()))
    for name in names:
        got, want = t[f"{arch}/g/{name}"], _repro_leaf(j, arch, "g", name)
        assert got.shape == want.shape
        assert _nw(got, want) <= GRAD_NORMWISE, name


@pytest.mark.parametrize("case", pair.LAST_BLOCKS,
                         ids=[f"{a}-{k}" for a, _, k in pair.LAST_BLOCKS])
def test_last_blocks_match_one_process(runs, case):
    """Each LAST_BLOCKS block on every (2, 4) rank, in f32, its leaves
    entering as the train step's tree gives them (the re-blocked wuq /
    in_proj gathered and cut, the whole leaves read in part through
    ``psum_bwd``, the split norms' sums over "model"), against one
    process's block on the whole batch: the output's rows within
    BLOCK_F32_TOL of one process's scale (zamba2's shared block casts to
    bf16 itself: two bf16 ulps, BF16_RTOL), and each rank's own block of
    every leaf's gradient within GRAD_NORMWISE normwise.  One leaf has no
    normwise bound: the sLSTM's input-gate bias, whose gradient is a sum
    over positions that cancels (the stabilized cell is nearly invariant
    to a shift of log i shared by every position: its norm is under 1e-3
    of the block's largest); it is held within GRAD_NORMWISE of that
    largest norm.  The recurrent blocks' decode step from a random state:
    its output rows and each state leaf's block (this rank's heads; the
    conv's x channels and the B / C ones) within BLOCK_F32_TOL (bf16 for
    the shared block's).  A gather of a re-blocked leaf that slices its
    gradient instead of reduce-scattering it, or a norm sum through
    ``psum_fwd`` alone, fails this test."""
    from xattn_pair import BF16_RTOL, BLOCK_F32_TOL
    arch, prefixes, kind = case
    t = runs[8]
    tag = f"block/{configs.get_reduced_config(arch).name}/{kind}"
    tol = BF16_RTOL if kind == "shared_attn" else BLOCK_F32_TOL
    leaves, cancelled = set(), set()
    for r in range(8):
        assert float(t[f"{tag}/y/rank{r}"]) <= tol, r
        for k, v in t.items():
            if not (k.startswith(f"{tag}/g/") and k.endswith(f"/rank{r}")):
                continue
            name = k[len(f"{tag}/g/"):-len(f"/rank{r}")]
            leaves.add(name)
            nw, err, norm, top = (float(x) for x in v)
            if norm < 1e-3 * top:
                cancelled.add(name)
                assert err <= GRAD_NORMWISE * top, (name, r)
            else:
                assert nw <= GRAD_NORMWISE, (name, r, nw)
        for k, v in t.items():
            if k.startswith(f"{tag}/step_") and k.endswith(f"/rank{r}"):
                assert float(v) <= tol, (k, r)
    model = build_model(configs.get_reduced_config(arch), "meta")
    assert leaves == {k for k in dict(model.named_parameters())
                      if any(k.startswith(p + ".") for p in prefixes)}
    assert cancelled == ({"groups.1.slstm.wi.b"} if kind == "slstm"
                         else set())
    steps_ = {k[len(f"{tag}/step_"):-len("/rank0")] for k in t
              if k.startswith(f"{tag}/step_") and k.endswith("/rank0")}
    assert steps_ == {"mla": set(), "shared_ffn": set(),
                      "mamba2": {"y", "S", "conv"},
                      "shared_attn": {"y", "k", "v"},
                      "mlstm": {"y", "C", "n", "m"},
                      "slstm": {"y", "c", "n", "h", "m"}}[kind]


def test_scatter_fwd_is_the_psum_block(runs):
    """``scatter_fwd`` on every (2, 4) rank: its forward is this rank's
    sequence block of ``psum`` over "model" (contiguous), its backward
    ``all_gather`` of the gradient; ``block_fwd``'s forward is the rank's
    block of its input, its backward the same all-gather (bit for
    bit)."""
    for tag in ("scatter", "block"):
        for r in range(8):
            assert runs[8][f"sp/{tag}/rank{r}"].tolist() == \
                [True, True, True], (tag, r)


@pytest.mark.parametrize("case", pair.SP_BLOCKS,
                         ids=[f"{a}-{k}" for a, k, _ in pair.SP_BLOCKS])
def test_sp_blocks_hold_sequence_blocks(runs, case):
    """Each SP_BLOCKS block on every (2, 4) rank at S = 32 holds the
    residual as its sequence block [B_loc, S / 4, D] (zamba2's shared
    block inside itself; MLA's output), equal to the rank's block of the
    same block with the residual whole: bit for bit where only the
    collectives changed (SP_BIT_EQUAL), within LOGIT_ATOL where k / v,
    the latents, the LoRA or undivided heads run on the rank's own rows
    (seen on this CPU: bit-equal but MiniCPM's 6 heads, blockwise where
    the whole residual takes flash's twin, 0.016, and MLA in f32,
    2.4e-7); and within LOGIT_ATOL of one process on the rank's rows.
    At S = 30, which the 4-way axis does not divide, the residual stays
    whole and the block is the whole-residual block, bit for bit."""
    arch, kind, _ = case
    cfg = configs.get_reduced_config(arch)
    t = runs[8]
    pre = f"sp/{arch}/{kind}"
    b = pair.TRAIN_B // pair.MESH[0]
    for r in range(8):
        for s, n in ((pair.TRAIN_S, pair.TRAIN_S // pair.MESH[1]),
                     (pair.SP_ODD_S, pair.SP_ODD_S)):
            assert t[f"{pre}/{s}/shape/rank{r}"].tolist() == \
                [b, n, cfg.d_model], (s, r)
            err, same = t[f"{pre}/{s}/vs_whole/rank{r}"]
            if s == pair.SP_ODD_S or (arch, kind) in pair.SP_BIT_EQUAL:
                assert same, (s, r, err)
            assert err <= LOGIT_ATOL, (s, r)
            assert float(t[f"{pre}/{s}/vs_one/rank{r}"]) <= LOGIT_ATOL, \
                (s, r)


@pytest.mark.parametrize("case", pair.SP_GRADS,
                         ids=[f"{a}-{k}" for a, k, _ in pair.SP_GRADS])
def test_sp_block_grads_match_one_process(runs, case):
    """Each SP_GRADS block in f32 on every (2, 4) rank, fed its sequence
    block: the rank's block of every leaf's gradient (the norms' scales,
    the gates, the kv-gathered ``wk`` / ``wv``, MLA's down projections
    and every leaf of undivided heads through ``sp_tree``; the gathers'
    reduce-scattered gradients) within BLOCK_F32_TOL normwise of one
    process's on the whole batch (seen: 9.2e-7), a leaf whose gradient
    cancels (norm under 1e-3 of the block's largest) within that of the
    largest.  A scale or gate read on the rank's tokens without its sum
    over "model" is a quarter of the whole and fails."""
    from xattn_pair import BLOCK_F32_TOL
    arch, kind, prefixes = case
    t = runs[8]
    pre = f"sp/{arch}/{kind}/g/"
    leaves = set()
    for r in range(8):
        for k, v in t.items():
            if not (k.startswith(pre) and k.endswith(f"/rank{r}")):
                continue
            name = k[len(pre):-len(f"/rank{r}")]
            leaves.add(name)
            nw, err, norm, top = (float(x) for x in v)
            if norm < 1e-3 * top:
                assert err <= BLOCK_F32_TOL * top, (name, r)
            else:
                assert nw <= BLOCK_F32_TOL, (name, r, nw)
    model = build_model(configs.get_reduced_config(arch), "meta")
    assert leaves == {k for k in dict(model.named_parameters())
                      if any(k.startswith(p + ".") for p in prefixes)}


@pytest.mark.parametrize("arch", pair.LAST_ARCHS)
def test_last_cache_holds_head_blocks(runs, arch):
    """``local_cache`` of the last three families on (2, 4): this rank's 4
    of 8 rows and its heads of every state leaf (Mamba2's S at 2 of 8
    heads, its conv at its 32 x channels and the 32 B / C ones, the
    shared block's k / v at 1 of 4 kv heads; the mLSTM's C / n / m and the
    sLSTM's c / n / h / m at 1 of 4 heads); DeepSeek-V2's ckv / kr whole
    over "model", its dense layer's k / v at 1 of 4 kv heads."""
    cfg = configs.get_reduced_config(arch)
    rows, t_len = pair.TRAIN_B // 2, pair.DECODE_LEN
    if arch == "deepseek-v2-236b":
        want = {"ckv": [2, rows, t_len, cfg.kv_lora],
                "kr": [2, rows, t_len, cfg.qk_rope_dim],
                "dense_k": [1, rows, t_len, 1, cfg.hd]}
        want["dense_v"] = want["dense_k"]
    elif arch == "zamba2-1.2b":
        s = [rows, 2, cfg.ssm_state, cfg.ssm_head_dim]
        conv = [rows, cfg.ssm_conv - 1, 32 + 2 * cfg.ssm_state]
        want = {"ssm/S": [2, 2] + s, "ssm/conv": [2, 2] + conv,
                "tail_ssm/S": [1] + s, "tail_ssm/conv": [1] + conv,
                "attn_k": [2, rows, t_len, 1, cfg.hd]}
        want["attn_v"] = want["attn_k"]
    else:
        dk = cfg.d_model // cfg.n_heads
        want = {"m/C": [2, 1, rows, 1, dk, dk], "m/n": [2, 1, rows, 1, dk],
                "m/m": [2, 1, rows, 1],
                **{f"s/{k}": [2, rows, 1, dk] for k in "cnhm"}}
    for r in range(8):
        got = {k[len(f"{arch}/cache_"):-len(f"/rank{r}")]: v.tolist()
               for k, v in runs[8].items()
               if k.startswith(f"{arch}/cache_") and k.endswith(f"/rank{r}")}
        assert got == want, r


def test_data_mesh_moe_is_one_process_routed_alike(runs):
    """Mixtral on the (8,) ("data",) mesh (``repro``'s MoE takes its
    one-rank path over the whole batch there): metrics equal to one
    process's (1,) mesh, routed as it routed, and every gradient within
    MOE_GRAD_NORMWISE (the bf16 gradients of 8 shares summed in another
    order; seen: 1.1 %)."""
    t = runs[8]
    for k in ("loss", "ce", "lb_loss", "dropped"):
        assert t[f"data_mesh/metrics/{k}"] == t[f"data_one/metrics/{k}"], k
    names = [k[len("data_mesh/g/"):] for k in t
             if k.startswith("data_mesh/g/")]
    assert names
    for name in names:
        assert _nw(t[f"data_mesh/g/{name}"],
                   t[f"data_one/g/{name}"]) <= MOE_GRAD_NORMWISE, name


DATA_MOE_CALLS = [(arch, call) for arch, decode in pair.DATA_MOE_ARCHS.items()
                  for call in ("prefill", "decode")[:1 + decode]]


@pytest.mark.parametrize("arch,call", DATA_MOE_CALLS)
def test_data_mesh_moe_steps_are_one_process(runs, arch, call):
    """Mixtral and DeepSeek-V2 (MLA, shared experts) on the (8,) data
    mesh, each rank's experts on its slice of one global capacity plan's
    slots, against one process over the whole batch, bit for bit: the
    prefill step's (or each decode step's) last-position logits, and
    every MoE call's routes, output rows, dropped pairs and load-balance
    loss.  A decode step is the padded case: its capacity is below the
    number of ranks, so some ranks hold only empty slots."""
    t = runs[8]
    cfg = configs.get_reduced_config(arch)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    one, mesh = f"data_moe/{arch}/one", f"data_moe/{arch}/mesh"
    prefill_ids = n_moe * pair.TRAIN_B * pair.TRAIN_S
    if call == "prefill":
        logits, calls = ["logits0"], range(n_moe)
        ids = slice(0, prefill_ids)
    else:
        assert t_moe.capacity_of(cfg, pair.TRAIN_B) < pair.DATA_MESH[0]
        logits = [f"logits{j}" for j in range(1, 1 + pair.DECODE_STEPS)]
        calls = range(n_moe, n_moe * (1 + pair.DECODE_STEPS))
        ids = slice(prefill_ids, None)
    assert len(t[f"{mesh}/dropped"]) == len(t[f"{one}/dropped"]) == \
        n_moe * (1 + pair.DECODE_STEPS * pair.DATA_MOE_ARCHS[arch])
    for key in logits + [f"y{i}" for i in calls]:
        assert np.array_equal(t[f"{mesh}/{key}"], t[f"{one}/{key}"]), key
    assert t[f"{one}/ids"][ids].size > 0
    assert np.array_equal(t[f"{mesh}/ids"][ids], t[f"{one}/ids"][ids])
    for key in ("dropped", "lb_loss"):
        assert np.array_equal(t[f"{mesh}/{key}"][list(calls)],
                              t[f"{one}/{key}"][list(calls)]), key


@pytest.mark.parametrize("tag", ["data_mesh", "microbatch"])
def test_mixtral_step_variants_match_repro(runs, tag):
    """Mixtral's train step on the (8,) data mesh and with 2 microbatches
    on (2, 4) against ``repro``'s: the bounds of a step that a routing
    flip at a near tie stays within (loss, ce 5e-3; lb_loss 1e-3; the
    grad norm 5e-3 relative)."""
    j, t = runs["jax"], runs[8]
    for key in ("loss", "ce"):
        assert abs(float(t[f"{tag}/step/{key}"])
                   - float(j[f"{tag}/step/{key}"])) <= LOSS_ATOL
    assert abs(float(t[f"{tag}/step/lb_loss"])
               - float(j[f"{tag}/step/lb_loss"])) <= LB_ATOL
    gn = float(j[f"{tag}/step/grad_norm"])
    assert abs(float(t[f"{tag}/step/grad_norm"]) - gn) <= GNORM_RTOL * gn


def test_train_loop_matches_repro(runs):
    """``train_loop(shardings=)`` on (2, 4), a failure injected at step
    LOOP_FAIL: one restart, the losses of the steps it ends with within
    5e-3 of ``repro``'s loop under the mesh, the final parameters within
    Adam's moves of ``repro``'s, and bit for bit a clean run's."""
    j, t = runs["jax"], runs[8]
    assert int(t["loop/restarts"]) == int(j["loop/restarts"]) == 1
    got, want = t["loop/loss"], j["loop/loss"][-pair.LOOP_STEPS:]
    assert len(got) == pair.LOOP_STEPS
    assert np.all(np.abs(got - want) <= LOSS_ATOL)
    assert np.array_equal(got, t["loop_clean/loss"])
    run = RunConfig(**pair.RUN_KNOBS)
    bound = 2 * sum(float(adamw.schedule(run, torch.tensor(s)))
                    * _adam_ratio(s + 1, s + 1)
                    for s in range(pair.LOOP_STEPS))
    names = [k[len("loop/p/"):] for k in t if k.startswith("loop/p/")]
    assert names
    for name in names:
        p = t[f"loop/p/{name}"]
        assert np.array_equal(p, t[f"loop_clean/p/{name}"]), name
        want = _repro_leaf({f"x/p/{k[len('loop/p/'):]}": v
                            for k, v in j.items() if k.startswith("loop/p/")},
                           "x", "p", name)
        assert np.all(np.abs(p - want) <= bound + ULPS * np.spacing(
            np.abs(want).astype(np.float32))), name


PER_BLOCK_KINDS = ("prefill", "serve") + tuple(
    f"train_{r}" for r in pair.PER_BLOCK_REMATS)


@pytest.mark.parametrize("kind", PER_BLOCK_KINDS)
@pytest.mark.parametrize("arch", pair.PER_BLOCK_ARCHS)
def test_per_block_steps_are_the_whole_tree(runs, arch, kind):
    """On every (2, 2) rank, the steps gathering each stacked block just
    before it runs equal, bit for bit, the same steps on the whole
    compute tree gathered before the forward: the prefill's last logits,
    each serve step's logits and the cache after them, a train step's
    loss, ce (``lb_loss``, ``dropped``) and every leaf's gradient under
    remat "full", "dots" and "none"."""
    got = runs[4]
    tag = f"per_block/{arch}"
    if kind.startswith("train_"):
        remat = kind[len("train_"):]
        names = [k for k in got if k.startswith(f"{tag}/{remat}/")]
        assert len(names) >= 4 * 3, names
    elif kind == "serve":
        names = [k for k in got if k.startswith(f"{tag}/serve")
                 or k.startswith(f"{tag}/cache/")]
        assert len(names) == 4 * (pair.DECODE_STEPS + 1), names
    else:
        names = [k for k in got if k.startswith(f"{tag}/prefill/")]
        assert len(names) == 4, names
    for k in names:
        assert got[k][0] == 1, (k, got[k].tolist())


@pytest.mark.parametrize("arch", pair.PER_BLOCK_ARCHS)
def test_per_block_steps_hold_one_block_at_once(runs, arch):
    """No (2, 2) rank ever held the gathered leaves of two stacked blocks
    at once (weakrefs on every gathered leaf, checked at each gather:
    the forward's, a remat recompute's and those of the saved-tensor
    hook of a block that is not rematerialized), in any of the steps."""
    for r in range(4):
        most, calls = runs[4][f"per_block/{arch}/held/rank{r}"]
        assert most == 1 and calls > 0, (r, most, calls)


def test_checkpoint_restores_on_other_meshes(runs, tmp_path):
    """qwen's state after its step, saved from (2, 4): restored on (1, 4)
    (each rank reading its blocks), in one process and by ``repro``, bit
    for bit the state that was saved."""
    t4, t8 = runs[4], runs[8]
    arch = pair.TRAIN_ARCHS[0]
    assert int(t4["restored/step"]) == pair.OPT_STEP0 + 1
    for tag, src in (("p", "p2"), ("m", "m2"), ("v", "v2")):
        names = [k[len(f"{arch}/{src}/"):] for k in t8
                 if k.startswith(f"{arch}/{src}/")]
        for name in names:
            assert np.array_equal(t4[f"restored/{tag}/{name}"],
                                  t8[f"{arch}/{src}/{name}"]), name
    model = build_model(configs.get_reduced_config(arch), "cpu",
                        trainable=True)
    params = dict(model.named_parameters())
    opt = adamw.init(params)
    CheckpointManager(runs["ckpt"]).restore(1, {"params": params,
                                                "opt": opt})
    for name, p in params.items():
        assert np.array_equal(p.detach().numpy(), t8[f"{arch}/p2/{name}"])
        assert np.array_equal(opt.v[name].numpy(), t8[f"{arch}/v2/{name}"])
    jm = j_build_model(j_configs.get_reduced_config(arch))
    like = {"params": jax.tree.map(np.zeros_like, jm.abstract_params())}
    from repro.optim import adamw as j_adamw
    like["opt"] = j_adamw.init(like["params"])
    got = JManager(runs["ckpt"]).restore(1, like)
    assert int(got["opt"].step) == pair.OPT_STEP0 + 1
    jflat = pair.flat(jax.tree.map(np.asarray, got["params"]))
    for name in params:
        key, i = pair._repro_key(name)
        a = jflat[key] if i is None else jflat[key][i]
        assert np.array_equal(a, t8[f"{arch}/p2/{name}"]), name


def test_train_launcher_on_a_data_mesh(tmp_path):
    """``launch/train.py`` under 4 gloo ranks (torchrun's environment) on
    its (4,) ("data",) mesh: the losses of a one-process run within
    5e-3 (the mesh casts the matrices to bf16 before the forward, one
    device does not), one checkpoint directory in ``repro``'s format, and
    a second run resuming from it."""
    def run(world, ck, steps_=3):
        env = {**os.environ, "PYTHONPATH": "src", "WORLD_SIZE": str(world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
               "OMP_NUM_THREADS": "1"}
        args = [sys.executable, "-m", "repro_torch.launch.train",
                "--reduced", "--device", "cpu", "--steps", str(steps_),
                "--batch", "8", "--seq", "32", "--ckpt-every", "2",
                "--ckpt-dir", ck]
        procs = [subprocess.Popen(args, cwd=REPO_ROOT, env={
            **env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=180))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert all(p.returncode == 0 for p in procs), outs[0][1][-3000:]
        return outs[0][0]

    def losses(text):
        line = [ln for ln in text.splitlines() if "done: loss" in ln][0]
        return [float(v) for v in line.split("loss ")[1].split(",")[0]
                .split(" -> ")]
    one = losses(run(1, str(tmp_path / "one")))
    out4 = run(4, str(tmp_path / "four"))
    assert "mesh {'data': 4}" in out4
    four = losses(out4)
    assert max(abs(a - b) for a, b in zip(one, four)) <= LOSS_ATOL
    assert sorted(os.listdir(tmp_path / "four")) == [
        "step_00000000", "step_00000002", "step_00000003"]
    resumed = run(4, str(tmp_path / "four"), steps_=4)
    assert "resumed from checkpoint step 3" in resumed


# -------------------------------------------------------------- dry-run
# The port's per-rank FLOPs above repro's where the gap passes 1 %, by
# (arch, kind): exact, from this mesh's reduced cells (PERF.md §6 names
# each).  Prefill and train hold the residual sequence-parallel where
# repro pins it (ROADMAP item 7d), so the pinned blocks' products match;
# what remains:
#   * decode (one token; repro pins nothing and the port keeps the
#     residual whole): the K / V projections of 2 kv heads on the 4-way
#     axis (yi, mixtral, the vlm's self attention), the whole attention of
#     6 heads (nemotron, minicpm), MLA's down projections (deepseek), the
#     shared block's and Mamba2's in_proj B / C columns (zamba2), each
#     computed whole on every model rank;
#   * the vlm's image-side cross K / V (+589,824): its 2 kv heads whole on
#     every rank, where GSPMD's propagation splits them beyond any pin;
#   * zamba2's prefill: Mamba2's in_proj B / C / dt columns (+1,966,080)
#     and its SSD chunk products (+655,360, 131,072 a layer), both in the
#     Mamba2 layers, which repro does not pin;
#   * the xLSTM's prefill: two mLSTM chunk products (+131,072, +8,192);
#   * yi's train step: the attention's score and value products (+262,144:
#     the flash forward's twin and its blockwise recompute against repro's
#     blockwise forward and backward; qwen's and mixtral's train steps
#     carry the same, inside 1 % there).
FLOP_GAPS = {
    ("yi-9b", "train"): 262144, ("yi-9b", "decode"): 49152,
    ("nemotron-4-15b", "decode"): 368640,
    ("minicpm-2b", "decode"): 285696,
    ("llama-3.2-vision-90b", "prefill"): 589824,
    ("llama-3.2-vision-90b", "decode"): 49152,
    ("zamba2-1.2b", "prefill"): 2621440, ("zamba2-1.2b", "decode"): 67584,
    ("xlstm-1.3b", "prefill"): 139264,
    ("deepseek-v2-236b", "decode"): 67584,
    ("mixtral-8x7b", "decode"): 49152,
}
FLOP_RTOL = 0.01
# The port's decode arguments above repro's, by design: the recurrent
# state blocks of local_cache (ROADMAP §3: zamba2's conv state holds the
# rank's x channels and B / C whole; the xLSTM's n / m and the sLSTM's
# state split by heads, where repro keeps them whole), and the weights
# repro's jit drops as unused (keep_unused=False: the vlm's image-side
# k / v projections and the encdec's encoder, which decode never reads).
DECODE_ARGUMENT_GAPS = {"llama-3.2-vision-90b": 3072,
                        "seamless-m4t-medium": 58624, "zamba2-1.2b": 5760,
                        "xlstm-1.3b": -7776}
@pytest.fixture(scope="module")
def port_dryrun():
    """``record(arch, kind, rank=0)``: the port's dry-run record of a
    reduced cell on (2, 4) at ``rank``, each made once."""
    made = {}

    def record(arch, kind, rank=0):
        if (arch, kind, rank) not in made:
            made[arch, kind, rank] = dryrun.cell_record(
                configs.get_reduced_config(arch),
                pair.dryrun_shape(kind, ShapeConfig),
                dryrun.CountingMesh(pair.MESH, pair.AXES, rank),
                RunConfig(**pair.RUN_KNOBS))
        return made[arch, kind, rank]
    return record


@pytest.mark.parametrize("kind", pair.DRYRUN_KINDS)
@pytest.mark.parametrize("arch", pair.DRYRUN_GLOO_ARCHS)
def test_counting_mesh_counts_the_gloo_ranks(runs, port_dryrun, arch, kind):
    """The dry-run's counting mesh against the gloo ranks stepping the
    same cell (first and last rank): equal collective bytes and calls by
    kind, FlopCounterMode totals and argument bytes."""
    last = pair.MESH[0] * pair.MESH[1] - 1
    for rank in (0, last):
        rec = port_dryrun(arch, kind, rank)
        pre = f"dryrun/{arch}/{kind}/rank{rank}/"
        got = runs[8]
        assert rec["collective_bytes_per_device"] == {
            c: int(got[pre + f"bytes/{c}"]) for c in pair.COLLECTIVE_KINDS}
        assert rec["collective_counts"] == {
            c: int(got[pre + f"calls/{c}"]) for c in pair.COLLECTIVE_KINDS}
        assert rec["flops_per_device"] == int(got[pre + "flops"])
        assert rec["memory"]["argument_size"] == int(
            got[pre + "argument_size"])


@pytest.mark.parametrize("arch", pair.DRYRUN_ARCHS)
def test_dryrun_params_match_repro(runs, port_dryrun, arch):
    rec, j = port_dryrun(arch, "prefill"), runs["jax"]
    assert rec["params"] == int(j[f"dryrun/{arch}/prefill/params"])
    assert rec["param_bytes"] == int(j[f"dryrun/{arch}/prefill/param_bytes"])


@pytest.mark.parametrize("kind", ("train", "prefill"))
@pytest.mark.parametrize("arch", pair.DRYRUN_TRAIN_ARCHS)
def test_dryrun_arguments_match_repro(runs, port_dryrun, arch, kind):
    """A rank's blocks, AdamW state and batch rows: the bytes repro's
    compiled step takes on a device."""
    assert port_dryrun(arch, kind)["memory"]["argument_size"] == int(
        runs["jax"][f"dryrun/{arch}/{kind}/argument_size"])


@pytest.mark.parametrize("arch", pair.DRYRUN_ARCHS)
def test_dryrun_decode_arguments_match_repro(runs, port_dryrun, arch):
    got = port_dryrun(arch, "decode")["memory"]["argument_size"]
    want = int(runs["jax"][f"dryrun/{arch}/decode/argument_size"])
    assert got - want == DECODE_ARGUMENT_GAPS.get(arch, 0)


@pytest.mark.parametrize("cell", [(a, "train") for a in
                                  pair.DRYRUN_TRAIN_ARCHS]
                         + [(a, k) for a in pair.DRYRUN_ARCHS
                            for k in ("prefill", "decode")])
def test_dryrun_flops_match_repro(runs, port_dryrun, cell):
    """Per-rank FLOPs within FLOP_RTOL of repro's, or above them by
    exactly the named FLOP_GAPS."""
    arch, kind = cell
    got = port_dryrun(arch, kind)["flops_per_device"]
    want = int(runs["jax"][f"dryrun/{arch}/{kind}/flops_per_device"])
    if cell in FLOP_GAPS:
        assert got - want == FLOP_GAPS[cell]
    else:
        assert abs(got - want) <= FLOP_RTOL * want, (got, want)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
