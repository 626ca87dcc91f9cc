"""CPU tests of the benchmark harness (``bench/``), at tiny sizes.

The harness runs here on the CPU through ``harness.run_cell(...,
device="cpu")``: the program then takes its plain twins, so these tests
show the harness's control flow, its files found by name, its check and
its faults, never a time.  The cell on the card is ``test_cell_on_card``,
which skips without one.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import generate, harness, trace as trace_mod, work
from bench.reference import census as census_mod
from bench.reference.crossing import CrossingReference

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 11                    # past 32 signed bits
TINY = dict(l1_polygons=2, l2_per_l1=2, l3_per_l2=4, batch_points=4096,
            sample_rows=4096, sample_sets=3, trace_batches=2)
MIXES = ("inblock", "land", "roads", "extent")


def _tiny_root(dest: Path) -> Path:
    """A checkout-like tree: BENCHMARK.json and bench/'s data and readers,
    every configuration cut to TINY."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("traffic", "layer_metrics", "end_to_end"):
        shutil.copytree(ROOT / "bench" / sub, dest / "bench" / sub)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY)
        (dest / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (dest / c["file"]).write_text(json.dumps(cfg))
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return _tiny_root(tmp_path_factory.mktemp("bench_root"))


def _run(root, cell, trace=False, seed=SEED, hook=None):
    return harness.run_cell(root, cell, seed, 0.3, trace, "cpu",
                            time.perf_counter(), engine_hook=hook)


def _tiny_census(seed=3):
    return census_mod.build_census(seed, 2, 2, 4)


# -- the frozen copies equal their sources ---------------------------------

@pytest.mark.parametrize("seed,sizes", [(0, (2, 2, 4)), (5, (3, 2, 3))])
def test_census_equals_the_programs_generator(seed, sizes):
    from repro_torch.core import synth
    got = census_mod.build_census(seed, *sizes)
    want = synth.build_synth_census(seed=seed, n_states=sizes[0],
                                    counties_per_state=sizes[1],
                                    blocks_per_county=sizes[2])
    for lvl in census_mod.LEVELS:
        soup = getattr(want.census, lvl)
        for f in census_mod.SOUP_FIELDS:
            a, b = got.levels[lvl][f], getattr(soup, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (lvl, f)
    assert got.extent == want.census.extent
    assert np.array_equal(got.block_rects, want.block_rects)
    assert got.sagitta == want.sagitta
    for f in census_mod.WARP_FIELDS:
        assert np.array_equal(getattr(got.warp, f), getattr(want.warp, f))


@pytest.mark.parametrize("margin", [0.0, 0.05, 0.25])
def test_sampler_equals_the_programs_sampler(margin):
    from repro_torch.core import synth
    want_map = synth.build_synth_census(seed=1, n_states=2,
                                        counties_per_state=2,
                                        blocks_per_county=4)
    got = census_mod.sample_points(census_mod.build_census(1, 2, 2, 4),
                                   np.random.default_rng(9), 500, margin)
    want = want_map.sample_points(np.random.default_rng(9), 500, margin)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def _work_calls(name):
    """One small CPU call of kernel entry ``name``: (args, kw, outs), and
    the fast index for the cascade."""
    from repro_torch.core.artifact import GeoIndexSet
    from repro_torch.kernels import (bbox, cascade, gather_pip, ops, pip,
                                     segment)
    from repro_torch.core.geometry import CensusMap, PolygonSoup
    g = torch.Generator().manual_seed(4)
    c = _tiny_census()
    cmap = CensusMap(**{lvl: PolygonSoup(**c.levels[lvl])
                        for lvl in census_mod.LEVELS}, extent=c.extent)
    pts = torch.as_tensor(census_mod.sample_points(
        c, np.random.default_rng(2), 300, 0.0)[0])
    edges = torch.as_tensor(ops.edges_from_soup_np(
        c.levels["blocks"]["verts"]))
    boxes = torch.as_tensor(c.levels["blocks"]["bbox"])
    index = None
    if name == "crossings_gathered":
        pid = torch.randint(0, edges.shape[0], (300,), generator=g)
        args, kw, fn = (pts, edges[pid].contiguous()), {}, \
            pip.crossings_gathered
    elif name == "crossings_one":
        args, kw, fn = (pts, edges[3].contiguous()), {}, pip.crossings_one
    elif name == "bbox_mask":
        args, kw, fn = (pts, boxes), {}, bbox.bbox_mask
    elif name == "bbox_count_select":
        sel = torch.randint(0, boxes.shape[0], (300, 5), generator=g)
        args, kw, fn = (pts, boxes[sel].contiguous()), {}, \
            bbox.bbox_count_select
    elif name == "crossings_candidates":
        pool = ops.build_edge_pool(edges.numpy(), be=16, device="cpu")
        pid = torch.randint(-1, edges.shape[0], (300,), generator=g).int()
        args = (pid, pts, pool.first, pool.count, pool.live, pool.blocks)
        kw, fn = {"max_blocks": pool.max_blocks}, \
            gather_pip.crossings_candidates
    elif name == "segment_reduce_sorted":
        ids = torch.sort(torch.randint(0, 16, (300,), generator=g,
                                       dtype=torch.int32))[0]
        args, kw, fn = (ids, torch.rand(300, generator=g), 16), {}, \
            segment.segment_reduce_sorted
    else:
        idx = GeoIndexSet.build(cmap, components=("fast",), pools=("fast",),
                                device="cpu")
        index, pool = idx.fast, idx.fast.edge_pool
        args = (pts, index.quant, index.cell_lo, index.cell_hi,
                index.cell_val, index.top_start, index.cand,
                index.block_bbox, pool.first, pool.count, pool.blocks)
        kw = dict(max_level=index.max_level, gbits=index.gbits,
                  search_iters=index.search_iters)
        fn = cascade.assign_cascade
    out = fn(*args, **kw)
    return (args, kw, out if isinstance(out, tuple) else (out,)), index


@pytest.mark.parametrize("name", ["crossings_gathered", "crossings_one",
                                  "bbox_mask", "bbox_count_select",
                                  "crossings_candidates",
                                  "segment_reduce_sorted", "assign_cascade"])
def test_work_counts_equal_chip_smokes(name):
    import chip_smoke
    from repro_torch.core import fast as fast_mod
    call, index = _work_calls(name)
    got = work.bound_ms(name, [call, call], index, fast_mod)
    want = chip_smoke.bound_ms(name, [call, call], index, fast_mod)
    assert got == want
    assert (work.HBM_BYTES_PER_S, work.FP32_OPS_PER_S) == \
        (chip_smoke.HBM_BYTES_PER_S, chip_smoke.FP32_OPS_PER_S)


def test_counted_launches_wraps_every_kernel_entry():
    from repro_torch.kernels import _build, pip
    from repro_torch.core import fast as fast_mod
    names = sorted(n for _, n in harness._kernel_entries())
    assert names == sorted(_build.LAUNCHES)
    call, _ = _work_calls("crossings_gathered")
    launches = []
    with harness.counted_launches(launches, None, fast_mod):
        pip.crossings_gathered(*call[0])
    assert pip.crossings_gathered.__name__ == "crossings_gathered"
    assert launches == [("crossings_gathered",
                         *work.launch_work("crossings_gathered", *call))]


# -- the generator ------------------------------------------------------------

@pytest.mark.parametrize("mix", MIXES)
def test_generator_is_deterministic_by_seed(mix):
    c = _tiny_census()
    m = json.loads((ROOT / "bench" / "traffic" / f"{mix}.json").read_text())
    a = generate.make_pool(c, m, SEED, 1000, "cpu")
    b = generate.make_pool(c, m, SEED, 1000, "cpu")
    d = generate.make_pool(c, m, SEED + 1, 1000, "cpu")
    assert len(a) == m["pool_batches"]
    for x, y, z in zip(a, b, d):
        assert x.shape == (1000, 2) and x.dtype == torch.float32
        assert torch.isfinite(x).all()
        assert torch.equal(x, y) and not torch.equal(x, z)
    assert not torch.equal(a[0], a[1])


def _inblock_hits(margin, band, n=4000):
    c = _tiny_census()
    mix = {"pool_batches": 1, "kind": "inblock", "margin": margin,
           "band": band}
    pts = generate.make_pool(c, mix, SEED, n, "cpu")[0]
    return CrossingReference(c, "cpu").ids(pts)[1]


@pytest.mark.parametrize("margin", [0.0, 0.25])
def test_inblock_points_lie_inside_one_block(margin):
    assert bool((_inblock_hits(margin, 3.0) == 1).all())


def test_without_the_band_some_points_fall_off_the_map():
    """The band keeps points off block sides: without it, at the map's
    outer border, a point can lie between the warped border and its
    polygon's chord, on no block."""
    n_hits = _inblock_hits(0.0, 0.0, 20000)
    assert int((n_hits == 0).sum()) > 0


@pytest.mark.parametrize("mix", [{"pool_batches": 1},
                                 {"pool_batches": 1, "kind": "ring"},
                                 {"pool_batches": 1, "kind": "inblock",
                                  "margin": 0.0},
                                 {"pool_batches": 0, "kind": "extent"}])
def test_a_mix_the_generator_cannot_read_is_refused(mix):
    with pytest.raises(ValueError):
        generate.check_mix(mix)


# -- the reference and the control ---------------------------------------------

def _brute_force(c, pts: np.ndarray) -> np.ndarray:
    """Lowest-numbered block whose ring holds each point (float64 crossing
    number over every block), -1 for none."""
    blocks = c.levels["blocks"]
    out = np.full(len(pts), -1, np.int64)
    px, py = pts[:, 0:1].astype(np.float64), pts[:, 1:2].astype(np.float64)
    for b in range(len(blocks["verts"]) - 1, -1, -1):
        ring = blocks["verts"][b, :blocks["n_verts"][b]].astype(np.float64)
        x1, y1 = ring[:, 0], ring[:, 1]
        x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
        straddle = (y1 > py) != (y2 > py)
        cross = straddle & (((px - x1) * (y2 - y1) < (py - y1) * (x2 - x1))
                            == (y2 > y1))
        out[cross.sum(axis=1) % 2 == 1] = b
    return out


def test_reference_equals_brute_force_loop():
    c = _tiny_census()
    mixes = [{"kind": "inblock", "margin": 0.0, "band": 0.0},
             {"kind": "extent"}, {"kind": "edge", "sigma": 0.02}]
    pts = torch.cat([generate.make_pool(c, dict(m, pool_batches=1), SEED,
                                        1000, "cpu")[0] for m in mixes])
    ids, _ = CrossingReference(c, "cpu").ids(pts)
    want = _brute_force(c, pts.numpy())
    assert np.array_equal(ids[:, 2].numpy(), want)
    cp = c.levels["blocks"]["parent"]
    sp = c.levels["counties"]["parent"]
    on = want >= 0
    assert np.array_equal(ids[on, 1].numpy(), cp[want[on]])
    assert np.array_equal(ids[on, 0].numpy(), sp[cp[want[on]]])
    assert bool((ids[~on] == -1).all())


def test_reference_equals_the_samplers_truth_and_the_control_fails():
    """The lower reading and the control at a test's size: the float32
    reference gives the sampler's ids; the same reference in bfloat16
    (the control) gets some wrong, which the limit of 0 fails."""
    c = _tiny_census()
    xy, bid, cid, sid = census_mod.sample_points(
        c, np.random.default_rng(5), 3000, 0.0)
    truth = np.stack([sid, cid, bid], axis=1)
    pts = torch.as_tensor(xy)
    ids, _ = CrossingReference(c, "cpu").ids(pts)
    assert np.array_equal(ids.numpy(), truth)
    low, _ = CrossingReference(c, "cpu", dtype=torch.bfloat16).ids(pts)
    assert int((low.numpy() != truth).any(axis=1).sum()) > 0


def test_control_script_reads_both_sides(tiny_root, capsys):
    """bench/control.py at a test's size: each control is a whole run with
    the timed path replaced; the bfloat16 one reads not correct."""
    from bench import control
    assert control.main(["--workload", "synth3k_fast.inblock", "--seeds",
                         "1", "2", "--seconds", "0.3", "--device", "cpu",
                         "--root", str(tiny_root)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["seed"], x["side"]) for x in lines] == [
        (s, side) for s in (1, 2)
        for side in ("control_bf16", "control_approx")]
    for x in lines:
        assert x["rows_checked"] >= 4096 and x["mismatched_ids"] >= 0
        if x["side"] == "control_bf16":
            assert x["correct"] is False and x["mismatched_ids"] > 0


@pytest.mark.parametrize("cell", ["synth3k_fast.inblock",
                                  "paper221k_simple.inblock"])
def test_the_bf16_reference_in_the_programs_place_is_not_correct(
        tiny_root, cell):
    """The control of every cell: the plain reference in bfloat16, run as
    the timed path, fails the harness's own check."""
    from bench import control
    spec = harness.Spec(tiny_root)
    cfg = spec.config(spec.workload(cell)["config"])
    art_dir, _ = harness.ensure_artifact(spec.root, cfg)
    low = CrossingReference(harness.load_census(art_dir), "cpu",
                            dtype=torch.bfloat16)
    line = _run(tiny_root, cell, hook=control.bf16_hook(low))
    assert line["correct"] is False
    assert line["checks"]["mismatched_ids"]["value"] > 0


# -- runs on the CPU -----------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["synth3k_fast.inblock",
                                  "paper221k_simple.inblock"])
def test_result_line_has_the_contracts_keys(tiny_root, cell, trace):
    spec = harness.Spec(tiny_root)
    line = _run(tiny_root, cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in spec.data[kind]}
    assert set(line["metrics"]) <= set(spec.metrics(kind, cell))
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and np.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"need_share", "pip_per_pt",
                "host_ms_per_batch"} <= set(line["metrics"])
    else:
        assert "setup_s" in line["metrics"] and "pts_per_s" in line["metrics"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit", "rule"}
    json.dumps(line)


def _fault(kind):
    """An engine hook that breaks the timed path's answers."""
    def hook(engine):
        real = engine.assign
        last = {}

        def assign(points):
            res = real(points)
            n = points.shape[0]
            if kind == "half_batch":
                keep = torch.arange(n) < n // 2
                res.state, res.county, res.block = (
                    torch.where(keep, t, -1)
                    for t in (res.state, res.county, res.block))
            elif kind == "altered_answer":
                res.block = res.block.clone()
                res.block[n // 3] = (res.block[n // 3] + 1) % 16
            else:                       # "stale": the previous batch's ids
                res, last["res"] = last.get("res", res), res
            return res
        engine.assign = assign
        return engine
    return hook


@pytest.mark.parametrize("kind", ["half_batch", "altered_answer", "stale"])
def test_a_broken_timed_path_is_not_correct(tiny_root, kind):
    line = _run(tiny_root, "synth3k_fast.inblock", hook=_fault(kind))
    assert line["correct"] is False
    assert line["checks"]["mismatched_ids"]["value"] > 0


@pytest.mark.parametrize("what", ["config", "mix", "metric"])
def test_new_files_are_found_by_name(tmp_path, what):
    """A configuration, a traffic mix or a per-layer metric is a new file
    plus a new entry in BENCHMARK.json; no other file changes."""
    root = _tiny_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = {"name": "new.cell", "config": "synth3k_fast",
            "traffic": "inblock", "chips": 1, "why": "test"}
    if what == "config":
        cfg = json.loads((root / "bench/configs/synth3k_fast.json")
                         .read_text())
        cfg.update(name="tiny_new", l3_per_l2=3, batch_points=1000)
        (root / "bench/configs/tiny_new.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": "tiny_new", "source": "test",
                                "file": "bench/configs/tiny_new.json",
                                "reduced": [], "why": "test"})
        cell["config"] = "tiny_new"
    elif what == "mix":
        (root / "bench/traffic/homes.json").write_text(json.dumps(
            {"pool_batches": 2, "kind": "inblock", "margin": 0.3,
             "band": 0.0}))
        cell["traffic"] = "homes"
    else:
        (root / "bench/layer_metrics/batches_seen.py").write_text(
            "def read(run):\n    return run.batches\n")
        spec["per_layer"].append({"name": "batches_seen", "unit": "batches",
                                  "better": "higher",
                                  "source": "host_clock", "layer": "engine",
                                  "moves": "pts_per_s"})
    spec["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    line = _run(root, "new.cell", trace=(what == "metric"))
    assert line["correct"] is True
    if what == "config":
        assert line["attempted"] % 1000 == 0
        assert any(p.name.startswith("tiny_new-")
                   for p in (root / "bench/cache").iterdir())
    if what == "metric":
        assert line["metrics"]["batches_seen"]["value"] >= 1


# -- what a run loads ------------------------------------------------------------

def _python(code: str, cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = (
        "import sys, time, json\n"
        "from bench import harness\n"
        f"harness.run_cell({str(tiny_root)!r}, 'synth3k_fast.inblock', 7, "
        "0.2, True, 'cpu', time.perf_counter())\n"
        "import bench.run\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = _python(code, tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "bench" in top
    assert not top & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, json\n"
        "import bench.reference.census, bench.reference.crossing\n"
        "import bench.generate, bench.work, bench.trace\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_without_a_card_run_py_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "synth3k_fast.inblock",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_with_only_the_benchmarks_files_run_py_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "synth3k_fast.inblock",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# -- the trace readers -------------------------------------------------------------

def _synthetic_trace():
    host = {"pid": 1, "tid": 1}
    ev = [dict(ph="X", cat="user_annotation", name=trace_mod.STRETCH,
               ts=0, dur=100, **host),
          dict(ph="X", cat="user_annotation", name="assign", ts=0, dur=40,
               **host),
          dict(ph="X", cat="cpu_op", name="aten::index", ts=0, dur=20,
               **host),
          dict(ph="X", cat="user_annotation", name="wait", ts=40, dur=60,
               **host),
          dict(ph="X", cat="kernel", name="crossings_gathered_kernel("
               "float const*, float4 const*, int*, long, int)", ts=10,
               dur=20, pid=0, tid=7),
          dict(ph="X", cat="kernel", name="void at::native::index_kernel"
               "<float>(int)", ts=25, dur=25, pid=0, tid=7),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoD", ts=70,
               dur=10, pid=0, tid=7),
          dict(ph="X", cat="kernel", name="outside", ts=200, dur=5,
               pid=0, tid=7)]
    return trace_mod.Trace(ev, {"crossings_gathered_kernel"})


def test_trace_reading_and_the_readers():
    tr = _synthetic_trace()
    assert tr.window_us == 100
    assert tr.device_us() == 55 and tr.device_us(hand=True) == 20
    assert tr.busy_us() == 50                    # [10, 50) and [70, 80)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["wait", 20e-6] and ["assign/aten::index", 10e-6] \
        in gaps and len(gaps) == 3
    assert tr.top_ops()[0][0].startswith("void at::native::index_kernel")
    run = harness.Run(batch=1, batches=1, window_s=1.0, latencies_s=[1.0],
                      issue_s=[0.5], setup_s=1.0, peak_bytes=0, trace=tr,
                      launches=[("crossings_gathered", 3.35e6, 0)])
    spec = harness.Spec(ROOT)
    read = {n: spec.reader("per_layer", n).read(run)
            for n in ("glue_share", "idle_share", "kernel_roofline",
                      "host_ms_per_batch")}
    assert read["glue_share"] == pytest.approx(100 * 35 / 55)
    assert read["idle_share"] == pytest.approx(50.0)
    assert read["kernel_roofline"] == pytest.approx(100 * 1e-6 / 20e-6)
    assert read["host_ms_per_batch"] == pytest.approx(500.0)


def test_hand_kernel_names_come_from_the_cuda_sources():
    from repro_torch.kernels import _build
    names = trace_mod.global_names(_build.CSRC)
    assert {"crossings_gathered_kernel", "bbox_count_select_kernel",
            "assign_cascade_kernel", "crossings_candidates_kernel",
            "bbox_mask_flat_kernel"} <= names


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (bench/run.py runs the cells there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cell_on_card(cuda_device):
    """The fast cell at its own size for two seconds on the card, traced:
    correct, with every per-layer metric read."""
    spec = harness.Spec(ROOT)
    line = harness.run_cell(ROOT, "synth3k_fast.inblock", SEED, 2.0, True,
                            cuda_device, time.perf_counter())
    assert line["correct"] is True
    assert set(line["metrics"]) == set(spec.metrics("per_layer",
                                                    "synth3k_fast.inblock"))
