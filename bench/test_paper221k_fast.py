"""The paper's national map on the fast approach
(``paper221k_fast.inblock``): the cell through ``harness.run_cell`` on
the CPU, cut to a test's size, and at its own size on the card.

On the CPU the program takes its plain twins, so these tests show the
cell's files found by name, its check and its two per-layer readers,
never a time.  ``test_national_fast_cell_on_card`` skips without a card.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness

ROOT = Path(__file__).resolve().parents[1]
CELL = "paper221k_fast.inblock"
SEED = 2**31 + 29                    # past 32 signed bits
# The harness tests' cut: 2 x 2 x 4 blocks, 4,096-point batches.
TINY = dict(l1_polygons=2, l2_per_l1=2, l3_per_l2=4, batch_points=4096,
            sample_rows=4096, sample_sets=3, trace_batches=2)
READERS = ("boundary_share", "pip_per_boundary_pt")


def _cut_root(dest: Path, sizes: dict) -> Path:
    """BENCHMARK.json and bench/'s data and readers, the cell's
    configuration cut to ``sizes``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("traffic", "layer_metrics", "end_to_end"):
        shutil.copytree(ROOT / "bench" / sub, dest / "bench" / sub)
    spec = harness.Spec(ROOT)
    file = next(c["file"] for c in spec.data["configs"]
                if c["name"] == spec.workload(CELL)["config"])
    cfg = json.loads((ROOT / file).read_text())
    cfg.update(sizes)
    (dest / file).parent.mkdir(parents=True)
    (dest / file).write_text(json.dumps(cfg))
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return _cut_root(tmp_path_factory.mktemp("bench_root"), TINY)


def test_the_cell_is_the_papers_map_on_the_planners_path():
    spec = harness.Spec(ROOT)
    wl = spec.workload(CELL)
    cfg = spec.config(wl["config"])
    assert (wl["traffic"], wl["chips"]) == ("inblock", 1)
    sizes = (cfg["l1_polygons"], cfg["l2_per_l1"], cfg["l3_per_l2"])
    assert int(np.prod(sizes)) == cfg["blocks_total"] == 220_864
    assert (cfg["strategy"], cfg["mode"], cfg["artifact"]) == \
        ("auto", "exact", ["covering"])
    assert cfg["reduced"] == [] and "max_level" not in cfg
    assert spec.metrics("per_layer", CELL) == list(READERS)


def _run(root, trace):
    return harness.run_cell(root, CELL, SEED, 0.3, trace, "cpu",
                            time.perf_counter())


def _check_line(root, line, trace):
    spec = harness.Spec(root)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["mismatched_ids"]["value"] == 0
    assert line["checks"]["rows_checked"]["value"] >= 4096
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in spec.data[kind]}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and np.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        # On the CPU nothing is allocated on a card: no peak to read.
        assert set(line["metrics"]) == {"pts_per_s", "setup_s"}
    json.dumps(line)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_correct_with_its_metrics(tiny_root, trace):
    """At the harness tests' cut the sampler's band keeps every point off
    the boundary cells (a leaf is under 1 % of a block's side): the share
    reads 0 and there is no boundary point to divide by."""
    line = _run(tiny_root, trace)
    _check_line(tiny_root, line, trace)
    if trace:
        assert line["metrics"]["boundary_share"]["value"] == 0.0
        assert set(line["metrics"]) == {"boundary_share"}


def test_one_state_cut_reads_both_metrics(tmp_path):
    """At one state's share (3,944 blocks, level 9: about 66 leaf cells a
    block, as the national map's 76 at level 12) points land in boundary
    cells, and both readers read them."""
    root = _cut_root(tmp_path, dict(TINY, l1_polygons=1, l2_per_l1=58,
                                    l3_per_l2=68, batch_points=1 << 14))
    line = _run(root, True)
    _check_line(root, line, True)
    got = {k: m["value"] for k, m in line["metrics"].items()}
    assert set(got) == set(READERS)
    assert 10.0 < got["boundary_share"] < 35.0
    assert 1.0 <= got["pip_per_boundary_pt"] < 2.0


def test_readers_read_the_counters_and_nothing_without_them():
    spec = harness.Spec(ROOT)
    run = harness.Run(batch=4, batches=25, window_s=1.0, latencies_s=[],
                      issue_s=[], setup_s=1.0, peak_bytes=0,
                      counters={"n_need": 20, "n_pip": 30, "overflow": 0,
                                "points": 100})
    got = {n: spec.reader("per_layer", n).read(run) for n in READERS}
    assert got == {"boundary_share": 20.0, "pip_per_boundary_pt": 1.5}
    run.counters = {}
    assert all(spec.reader("per_layer", n).read(run) is None
               for n in READERS)


@pytest.mark.cuda
def test_national_fast_cell_on_card():
    """The cell at its own size for two seconds on the card, traced: the
    planner's ``fast`` at covering level 12 over all 220,864 blocks,
    correct, both readers read, and no point of the traffic pool past
    the compaction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (bench/run.py runs the cells there)")
    from bench import generate
    from repro_torch.core.artifact import GeoIndexSet
    from repro_torch.core.engine import EngineConfig, GeoEngine
    dev = torch.device("cuda")
    line = harness.run_cell(ROOT, CELL, SEED, 2.0, True, dev,
                            time.perf_counter())
    assert line["correct"] is True
    assert set(line["metrics"]) == set(READERS)
    spec = harness.Spec(ROOT)
    cfg = spec.config("paper221k_fast")
    art, _ = harness.ensure_artifact(ROOT, cfg)
    eng = GeoEngine.from_index_set(
        GeoIndexSet.load(str(art / "artifact"), device=dev), "auto",
        EngineConfig(mode="exact"))
    facts = eng.explain()["covering"]
    assert eng.strategy == "fast" and facts["covering_level"] == 12
    assert eng.fast_index.block_parent.shape[0] == 220_864
    pool = generate.make_pool(harness.load_census(art), spec.mix("inblock"),
                              SEED, cfg["batch_points"], dev)
    for pts in pool:
        stats = eng.assign(pts).stats
        assert int(stats.overflow) == 0 and int(stats.n_need) > 0
