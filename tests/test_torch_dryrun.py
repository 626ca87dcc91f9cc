"""The port's dry-run (``repro_torch.launch.dryrun``) in one process, on
the meta device:

* the counting rules on hand-counted probes: ``StepTally``'s bytes
  (``repro``'s rule: 2 x the result bytes of an op whose result is at
  least 1 MiB; a view 0, an in-place write its bytes) and its peak of
  live storages along a matmul chain; ``CountingMesh``'s collectives
  (result shapes, bytes and calls by kind, autograd backwards included);
  ``counted_collectives`` on a ``Mesh`` whose gather runs through
  ``psum`` (gloo's route for a CUDA buffer) counting it once;
* the record of the last rank of a (2, 4) mesh equal to rank 0's for
  every reduced config's train and decode cells, and every tensor the
  step makes on meta;
* ``tree_bytes``, the most compute-tree bytes a step holds at once (the
  leaves outside the stacks and the largest stacked block's, gathered
  block by block), and ``whole_tree_bytes``, the whole tree's, on one
  reduced cell of each family; ``temp_size`` below the whole-tree
  step's (every leaf gathered before the forward and bound, as the
  steps did before they gathered block by block) by at least their
  difference less one block, FLOPs equal;
* the reduced Mixtral's expert ``bmm`` FLOPs a rank on (8,) ("data",)
  exactly ceil(C / 8) / C of one rank's (each rank its slice of the
  global plan's slots), for a train and a decode cell;
* ``main()``: a failing cell recorded with ``ok: false`` and its error,
  exit 1; the CLI at full width (Qwen1.5-0.5B's ``train_4k`` on the
  single-pod mesh) exits 0 and records the published config's
  ``param_count``.

The multi-rank checks (the counting mesh against gloo ranks, and the
records against ``repro``'s ``run_cell``) run in the spawns of
``tests/test_torch_mesh_model.py``.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, gather_fwd, psum_bwd, psum_fwd
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.models.module import param_count
from subproc import REPO_ROOT

MIB = 1 << 20
CLI_TIMEOUT_S = 300
KNOBS = dict(remat="none", attn_chunk_q=16, attn_chunk_kv=16)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_bytes_rule_and_peak_on_a_matmul_chain():
    """[512, 512] f32 is 1 MiB: two fresh products (2 x 1 MiB each), a
    view (0), an in-place add (2 x 1 MiB), a [4, 512] product (8 KiB,
    under the threshold: 0 bytes, but live); the peak is the two live
    products, freed ones no longer counted."""
    x, w = _meta(512, 512), _meta(512, 512)
    tally = dryrun.StepTally()
    with tally:
        y = x @ w
        z = y @ w
        del y
        u = z[:, :256]
        z.add_(1.0)
        s = x[:4] @ w
        h = _meta(256, 512)
    assert tally.bytes == 6 * MIB
    assert tally.peak == 2 * MIB
    assert tally.live == MIB + 4 * 512 * 4 + 256 * 512 * 4
    del z, u, s, h
    assert tally.live == 0


def test_counting_mesh_collectives():
    mesh = dryrun.CountingMesh((2, 4), ("data", "model"), rank=6)
    assert mesh.coords == {"data": 1, "model": 2}
    assert mesh.index(("data", "model")) == 6
    assert mesh.axis_size("model") == 4
    x = _meta(8, 6, dtype=torch.bfloat16)
    assert mesh.psum(x, "model").shape == (8, 6)
    assert mesh.pmax(x, ("data",)).shape == (8, 6)
    assert mesh.all_gather(x, ("data", "model"), 1).shape == (8, 48)
    assert mesh.psum_scatter(x, "data", 0).shape == (4, 6)
    assert mesh.psum(x, ()) is x
    view = mesh.with_batch(("data",))
    view.all_gather(x, "model", 0)
    assert mesh.tally.counts == {"all-reduce": 2, "all-gather": 2,
                                 "reduce-scatter": 1}
    assert mesh.tally.bytes == {"all-reduce": 192, "all-gather": 768 + 384,
                                "reduce-scatter": 48}
    with pytest.raises(ValueError, match="psum_scatter"):
        mesh.psum_scatter(_meta(3, 2), "model")


def test_counting_mesh_counts_backward_collectives():
    """``gather_fwd``'s backward reduce-scatters (or slices, no
    collective), ``psum_bwd``'s all-reduces, ``psum_fwd``'s passes the
    gradient on."""
    mesh = dryrun.CountingMesh((2, 4), ("data", "model"))
    x = _meta(4, 8).requires_grad_(True)
    y = gather_fwd(x, mesh, "data", 0) * 2
    y = y + gather_fwd(x, mesh, "model", 0, reduce=False).sum(
        0, keepdim=True)
    z = psum_fwd(psum_bwd(y, mesh, "model"), mesh, "data")
    assert mesh.tally.counts == {"all-reduce": 1, "all-gather": 2,
                                 "reduce-scatter": 0}
    torch.autograd.grad(z.sum(), x)
    assert mesh.tally.counts == {"all-reduce": 2, "all-gather": 2,
                                 "reduce-scatter": 1}
    assert mesh.tally.bytes["reduce-scatter"] == 4 * 8 * 4


def _psum_route_mesh():
    """A (1, 4) ``Mesh`` without a process group whose ``all_reduce``
    "runs" (a clone) and whose gathers take gloo's route for a CUDA
    buffer: through ``psum``."""
    mesh = Mesh.__new__(Mesh)
    mesh.axis_names, mesh.shape, mesh.size = ("data", "model"), {
        "data": 1, "model": 4}, 4
    mesh.rank, mesh.coords, mesh.batch_axes = 1, {"data": 0, "model": 1}, ()
    mesh.routes = {"all_reduce": "direct", "all_gather": "psum",
                   "reduce_scatter": "psum"}
    mesh._groups = {("model",): None}
    mesh._direct = lambda name, x, group, call: name == "all_reduce"
    return mesh


def test_counted_collectives_count_the_outer_call():
    mesh = _psum_route_mesh()
    x = torch.ones(2, 3)
    with dryrun.counted_collectives() as tally:
        g = mesh.all_gather(x, "model", 0)
        s = mesh.psum_scatter(g, "model", 0)
        mesh.psum(x, "model")
        mesh.psum(x, "data")                # extent 1: no collective
    assert g.shape == (8, 3) and s.shape == (2, 3)
    assert tally.counts == {"all-reduce": 1, "all-gather": 1,
                            "reduce-scatter": 1}
    assert tally.bytes == {"all-reduce": 24, "all-gather": 96,
                           "reduce-scatter": 24}
    assert Mesh.all_gather is Mesh.__dict__["all_gather"]
    with dryrun.counted_collectives() as again:
        pass
    assert sum(again.counts.values()) == 0


class _OffMeta(TorchDispatchMode):
    """Records every op whose tensor results leave the meta device."""

    def __init__(self):
        super().__init__()
        self.off = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.off.append((str(func), tuple(t.shape), t.device))
        return out


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_last_rank_record_is_rank_zero_and_all_on_meta(arch):
    """Every rank's blocks have one shape, so the last rank's record is
    rank 0's (but its ``rank``); every result the step makes is a meta
    tensor.  The train step runs the forward, its backward and AdamW;
    decode the cache blocks (the CLI test runs remat "full")."""
    cfg = configs.get_reduced_config(arch)
    run = RunConfig(**KNOBS)
    for kind in ("train", "decode"):
        shape = ShapeConfig(f"reduced_{kind}", 32, 8, kind)
        spy = _OffMeta()
        with spy:
            first = dryrun.cell_record(cfg, shape, dryrun.CountingMesh(
                (2, 4), ("data", "model")), run)
        assert spy.off == [], spy.off[:5]
        last = dryrun.cell_record(cfg, shape, dryrun.CountingMesh(
            (2, 4), ("data", "model"), rank=7), run)
        assert (first["rank"], last["rank"]) == (0, 7)
        for rec in (first, last):
            del rec["rank"], rec["trace_s"]
        assert last == first, kind
        assert first["route"] == "ref" and first["flops_per_device"] > 0


# One reduced cell of each family for the per-block tree bytes.
FAMILY_ARCHS = ("qwen1.5-0.5b", "deepseek-v2-236b", "llama-3.2-vision-90b",
                "seamless-m4t-medium", "zamba2-1.2b", "xlstm-1.3b")


def _whole_tree_steps(monkeypatch):
    """The steps as they were before they gathered block by block: the
    whole compute tree (``_compute_tree``) bound before the forward
    (``PerBlock.step_tree``), each block reading it as bound."""
    from repro_torch.runtime import steps

    def whole(self):
        p = steps.cast_params(self.params) if self.cast else self.params
        return steps._compute_tree(p, self.shardings, self.axes, self.keep,
                                   self.pieces)
    monkeypatch.setattr(steps.PerBlock, "step_tree", whole)
    monkeypatch.setattr(steps.PerBlock, "__call__", lambda self, b: b)


@pytest.mark.parametrize("kind", ("train", "prefill"))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_tree_bytes_are_one_block_at_a_time(monkeypatch, arch, kind):
    from repro_torch.runtime import steps
    from repro_torch.sharding import rules
    cfg = configs.get_reduced_config(arch)
    run = RunConfig(**dict(KNOBS, remat="full"))
    shape = ShapeConfig(f"reduced_{kind}", 8, 8, kind)
    mesh = dryrun.CountingMesh((2, 4), ("data", "model"))
    rec = dryrun.cell_record(cfg, shape, mesh, run)
    # The tree leaf by leaf, as the steps gather it.
    model = build_model(cfg, "meta", trainable=True)
    params = dryrun.rank_inputs(model, shape, mesh)["params"]
    with torch.no_grad():
        p = {k: v.detach() for k, v in params.items()}
        if kind == "train":
            p = steps.cast_params(p)
        tree = steps._compute_tree(
            p, rules.model_shardings(model, mesh),
            rules.batch_axes(mesh, 8) if kind == "train" else (),
            rules.tp_leaves(model, mesh), rules.tp_pieces(model, mesh))
    size = {k: dryrun.nbytes(t) for k, t in tree.items()}
    blocks = [sum(size[f"{pre}.{rel}"] for rel, _ in b.named_parameters())
              for pre, b in model.stacked_blocks().items()]
    whole = sum(size.values())
    assert rec["whole_tree_bytes"] == whole
    assert rec["tree_bytes"] == whole - sum(blocks) + max(blocks)
    assert rec["tree_bytes"] < whole
    _whole_tree_steps(monkeypatch)
    before = dryrun.cell_record(cfg, shape, mesh, run)
    assert before["flops_per_device"] == rec["flops_per_device"]
    fall = before["memory"]["temp_size"] - rec["memory"]["temp_size"]
    assert fall >= whole - rec["tree_bytes"] - max(blocks), (fall, whole)


class _ExpertFlops(TorchDispatchMode):
    """The FLOPs of every ``bmm`` with an operand of width ``f`` (the
    experts' hidden width, which no other product of the reduced Mixtral
    has), backward included."""

    def __init__(self, f):
        super().__init__()
        self.f, self.total, self.calls = f, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default and \
                self.f in args[0].shape + args[1].shape:
            (b, m, k), n = args[0].shape, args[1].shape[2]
            self.total += 2 * b * m * k * n
            self.calls += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ("train", "decode"))
def test_data_mesh_experts_are_a_slot_slice(kind):
    """The reduced Mixtral's expert ``bmm`` FLOPs a rank on (8,)
    ("data",) are exactly ceil(C / 8) / C of one rank's on (1,): C = 160
    slots an expert for a train step's 8 x 32 tokens, 20 a rank; C = 5
    for a decode step's 8, 1 a rank (the padded slice)."""
    cfg = configs.get_reduced_config("mixtral-8x7b")
    run = RunConfig(**KNOBS)
    shape = ShapeConfig(f"reduced_{kind}", 32, 8, kind)
    tokens = 8 * (32 if kind == "train" else 1)
    cap = moe.capacity_of(cfg, tokens)
    flops = {}
    for n in (1, 8):
        count = _ExpertFlops(cfg.d_ff_expert)
        with count:
            dryrun.cell_record(cfg, shape, dryrun.CountingMesh(
                (n,), ("data",)), run)
        assert count.calls == cfg.n_layers * (3 if kind == "decode" else 9)
        flops[n] = count.total
    assert flops[8] * cap == flops[1] * -(-cap // 8)
    assert flops[8] < flops[1]


def test_main_records_a_failing_cell(monkeypatch, tmp_path):
    out = tmp_path / "cells.json"

    def fail(arch, shape, mesh, run, verbose=True):
        raise RuntimeError(f"no {shape.name}")
    monkeypatch.setattr(dryrun, "run_cell", fail)
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
        "--multi-pod-only", "--out", str(out)])
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 1
    (rec,) = json.loads(out.read_text())
    assert rec == {"arch": "qwen1.5-0.5b", "shape": "decode_32k",
                   "mesh_name": "multi_pod", "ok": False,
                   "error": "RuntimeError('no decode_32k')"}


def test_cli_at_full_width(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on Qwen1.5-0.5B's train
    cell at its published widths on the (16, 16) mesh, with no card."""
    out = tmp_path / "qwen.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "train_4k", "--single-pod-only",
         "--out", str(out)], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S, env={**os.environ, "PYTHONPATH": "src",
                                    "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    (rec,) = json.loads(out.read_text())
    cfg = configs.get_config("qwen1.5-0.5b")
    assert rec["ok"] and rec["mesh_name"] == "single_pod"
    assert rec["params"] == param_count(build_model(cfg, "meta").specs)
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["n_devices"] == 256 and rec["rank"] == 0
    assert rec["flops_per_device"] > 0 and all(
        v > 0 for v in rec["collective_counts"].values())
