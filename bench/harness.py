"""One run of one benchmark cell, driven by ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* the configuration: the ``file`` of its entry (the map's sizes and seed,
  the guarantee (``mode``) and strategy it runs, the batch, the reference
  that judges it; everything else is the program's default);
* the traffic mix: ``bench/traffic/<traffic>.json``, read by
  ``bench/generate.py``;
* an end-to-end metric: ``bench/end_to_end/<name>.py``, a per-layer one
  ``bench/layer_metrics/<name>.py``; each has ``read(run)`` that returns
  a number, or None where the run holds nothing to read.

A run: the artifact (census and, where the configuration asks for it, the
covering) is built once per checkout into ``bench/cache/`` and loaded by
the program's ``GeoIndexSet.load``; the engine is
``GeoEngine.from_index_set``; the traffic pool is made on the device from
the seed; a few warm batches; then a closed loop of ``engine.assign`` for
``seconds``, one batch in flight, each batch waited for, a sample of each
batch's ids (rows drawn from the seed) kept.  With ``trace`` the loop also
sums the program's ``GeoStats`` counters, and after it a short stretch of
batches runs under torch.profiler with the kernel entry points wrapped to
count each launch's work.  Then the program is freed and the reference
works out the kept rows' ids again; one id that differs makes the run
incorrect.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import importlib.util
import inspect
import json
import os
import pkgutil
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench import generate, trace as trace_mod, work
from bench.reference import census as census_mod

BENCH = "bench"
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_BATCHES = 3


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.data = load_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        mix = load_json(self.root / BENCH / "traffic" / f"{name}.json")
        generate.check_mix(mix)
        return mix

    def metrics(self, kind: str, cell: str) -> list:
        """Names of the ``kind`` ("end_to_end" | "per_layer") metrics that
        cell ``cell`` reports."""
        return [m["name"] for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, kind: str, name: str):
        folder = {"end_to_end": "end_to_end",
                  "per_layer": "layer_metrics"}[kind]
        path = self.root / BENCH / folder / f"{name}.py"
        mod_name = "bench_reader_" + re.sub(r"\W", "_", f"{kind}_{name}")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclasses.dataclass
class Run:
    """What the readers read (see ``bench/end_to_end``,
    ``bench/layer_metrics``)."""

    batch: int                 # points a batch
    batches: int               # batches completed in the window
    window_s: float            # first dispatch to last ids ready
    latencies_s: list          # each batch: dispatch to ids ready
    issue_s: list              # each batch: the host's time in assign
    setup_s: float
    peak_bytes: int            # max allocated over the window
    counters: dict = dataclasses.field(default_factory=dict)
    trace: object = None       # trace_mod.Trace of the traced stretch
    launches: list = dataclasses.field(default_factory=list)
    #                            (kernel, bytes, ops) of each traced launch


# -- the artifact ----------------------------------------------------------

def _tree_hash(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(str(p.name).encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def program_sources() -> list:
    import repro_torch
    pkg = Path(repro_torch.__file__).resolve().parent
    return sorted(pkg.rglob("*.py"))


def program_census(census):
    """The frozen census as the program's ``CensusMap``."""
    from repro_torch.core.geometry import CensusMap, PolygonSoup
    soups = {lvl: PolygonSoup(**census.levels[lvl])
             for lvl in census_mod.LEVELS}
    return CensusMap(states=soups["states"], counties=soups["counties"],
                     blocks=soups["blocks"], extent=census.extent)


def build_map(cfg: dict):
    return census_mod.build_census(
        seed=cfg["map_seed"], n_states=cfg["l1_polygons"],
        counties_per_state=cfg["l2_per_l1"],
        blocks_per_county=cfg["l3_per_l2"])


def ensure_artifact(root: Path, cfg: dict):
    """(directory, seconds it took to build or None if it was there).

    The directory holds ``census.npz`` (the frozen generator's arrays)
    and ``artifact/`` (the program's ``GeoIndexSet.save`` of that census
    with ``cfg["artifact"]`` built).  It is keyed by the configuration,
    the frozen generator and the program's Python sources."""
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    h.update(_tree_hash([Path(census_mod.__file__)]).encode())
    h.update(_tree_hash(program_sources()).encode())
    cache = root / BENCH / "cache"
    final = cache / f"{cfg['name']}-{h.hexdigest()[:16]}"
    if (final / "done").exists():
        return final, None
    from repro_torch.core.artifact import GeoIndexSet
    t0 = time.perf_counter()
    for old in cache.glob(f"{cfg['name']}-*"):
        if re.fullmatch(re.escape(cfg["name"]) + r"-[0-9a-f]{16}", old.name):
            shutil.rmtree(old, ignore_errors=True)
    tmp = cache / f".{final.name}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    census = build_map(cfg)
    np.savez(tmp / "census.npz", **census.to_arrays())
    idx = GeoIndexSet.build(program_census(census),
                            components=tuple(cfg["artifact"]), device="cpu")
    idx.save(str(tmp / "artifact"))
    (tmp / "done").write_text("")
    os.replace(tmp, final)
    return final, time.perf_counter() - t0


def load_census(art_dir: Path):
    with np.load(art_dir / "census.npz") as z:
        return census_mod.Census.from_arrays({k: z[k] for k in z.files})


# -- the timed path ----------------------------------------------------------

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _keep(res, rows):
    return torch.stack((res.state[rows], res.county[rows], res.block[rows]))


def sample_rows(cfg: dict, seed: int, dev) -> list:
    """``cfg["sample_sets"]`` sets of ``cfg["sample_rows"]`` distinct rows
    of a batch, drawn from the seed: batch b keeps the ids of set b mod
    their number for the check."""
    batch = int(cfg["batch_points"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(generate.sub_seed(seed, "sample"))
    k = min(int(cfg["sample_rows"]), batch)
    return [torch.randperm(batch, generator=gen, device=dev)[:k]
            for _ in range(int(cfg["sample_sets"]))]


class Window:
    """The closed loop and what it keeps for the check."""

    def __init__(self, engine, pool, row_sets, dev):
        self.engine, self.pool, self.row_sets, self.dev = (engine, pool,
                                                           row_sets, dev)
        self.kept = []           # [3, k] ids of batch b, in order
        self.counters = None

    def rows(self, b):
        return self.row_sets[b % len(self.row_sets)]

    def one(self, b):
        res = self.engine.assign(self.pool[b % len(self.pool)])
        self.kept.append(_keep(res, self.rows(b)))
        return res

    def run(self, seconds: float, count: bool):
        lat, issue = [], []
        b = len(self.kept)
        _sync(self.dev)
        t_begin = time.perf_counter()
        t_stop = t_begin + seconds
        while True:
            pts = self.pool[b % len(self.pool)]
            t0 = time.perf_counter()
            res = self.engine.assign(pts)
            t1 = time.perf_counter()
            self.kept.append(_keep(res, self.rows(b)))
            if count:
                self._count(res)
            _sync(self.dev)
            t2 = time.perf_counter()
            lat.append(t2 - t0)
            issue.append(t1 - t0)
            b += 1
            if t2 >= t_stop:
                return lat, issue, t2 - t_begin

    def _count(self, res):
        st = res.stats
        now = {"n_need": torch.as_tensor(st.n_need).long(),
               "n_pip": torch.as_tensor(st.n_pip).long(),
               "overflow": torch.as_tensor(st.overflow).long()}
        if self.counters is None:
            self.counters = now
        else:
            self.counters = {k: self.counters[k] + now[k] for k in now}


def _kernel_entries():
    """(module, name) of every kernel entry point of the program: a
    function named in ``_build.LAUNCHES`` defined in a kernels module
    that checks launches."""
    import repro_torch.kernels as kpkg
    from repro_torch.kernels import _build
    out = []
    for info in pkgutil.iter_modules(kpkg.__path__):
        mod = importlib.import_module(f"{kpkg.__name__}.{info.name}")
        if "_build.check(" not in inspect.getsource(mod):
            continue
        for name in _build.LAUNCHES:
            fn = getattr(mod, name, None)
            if callable(fn) and getattr(fn, "__module__", "") == mod.__name__:
                out.append((mod, name))
    return out


@contextlib.contextmanager
def counted_launches(launches: list, index, fast_mod):
    """Wrap every kernel entry point: each call's work goes to
    ``launches`` as (name, bytes, ops); counts that read the data are
    made after the block, so nothing waits for the device inside it."""
    later = []
    saved = []

    def wrap(name, real):
        def counted(*args, **kw):
            out = real(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            if name in work.READS_DATA:
                later.append((name, args, kw, outs))
            else:
                w = work.launch_work(name, args, kw, outs)
                if w is not None:
                    launches.append((name, *w))
            return out
        return counted

    for mod, name in _kernel_entries():
        real = getattr(mod, name)
        saved.append((mod, name, real))
        setattr(mod, name, wrap(name, real))
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    for name, args, kw, outs in later:
        w = work.launch_work(name, args, kw, outs, index, fast_mod)
        if w is not None:
            launches.append((name, *w))


def traced_stretch(window: Window, n: int, dev, index, fast_mod):
    """``n`` batches under torch.profiler, after one batch that the
    profiler sees start but the stretch leaves out: (Trace, launches)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import _build
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    launches = []
    with profile(activities=acts) as prof:
        window.one(len(window.kept))
        _sync(dev)
        with counted_launches(launches, index, fast_mod), \
                record_function(trace_mod.STRETCH):
            for _ in range(n):
                b = len(window.kept)
                with record_function("traffic"):
                    pts = window.pool[b % len(window.pool)]
                    rows = window.rows(b)
                with record_function("assign"):
                    res = window.engine.assign(pts)
                with record_function("wait"):
                    window.kept.append(_keep(res, rows))
                    _sync(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        tr = trace_mod.Trace.from_file(
            path, trace_mod.global_names(_build.CSRC))
    return tr, launches


# -- the check ---------------------------------------------------------------

def reference_class(cfg: dict):
    """The configuration's plain reference: ``Reference`` of
    ``bench/reference/<cfg["reference"]>.py``."""
    return importlib.import_module(
        f"bench.reference.{cfg['reference']}").Reference


def check_ids(ref, window: Window) -> dict:
    """The kept ids against the reference on the same points: each number
    compared with its limit."""
    pts = torch.cat([window.pool[b % len(window.pool)][window.rows(b)]
                     for b in range(len(window.kept))])
    got = torch.cat([k.t() for k in window.kept]).int()
    want, n_hits = ref.ids(pts)
    bad = (got != want).any(dim=1)
    print(f"reference: {int((n_hits > 1).sum())} of {pts.shape[0]} checked "
          f"points lie in more than one block, {int((n_hits == 0).sum())} "
          f"in none", file=sys.stderr)
    return {"mismatched_ids": {"value": int(bad.sum()), "limit": 0,
                               "rule": "<="},
            "rows_checked": {"value": int(got.shape[0]), "limit": 1,
                             "rule": ">="}}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["rule"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- one run -------------------------------------------------------------------

def run_cell(root, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, engine_hook=None) -> dict:
    """One run of ``cell``; returns the result line (a dict).
    ``engine_hook(engine)`` may replace the engine (the fault tests)."""
    from repro_torch.core import fast as fast_mod
    from repro_torch.core.artifact import GeoIndexSet
    from repro_torch.core.engine import EngineConfig, GeoEngine
    spec = Spec(root)
    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    mix = spec.mix(wl["traffic"])
    dev = torch.device(device)

    art_dir, built_s = ensure_artifact(spec.root, cfg)
    if built_s is not None:
        print(f"built {cfg['name']}'s census and artifact in "
              f"{built_s:.3f} s (first run in this checkout)",
              file=sys.stderr)
    idx = GeoIndexSet.load(str(art_dir / "artifact"), device=dev)
    engine = GeoEngine.from_index_set(idx, strategy=cfg["strategy"],
                                      cfg=EngineConfig(mode=cfg["mode"]))
    if engine_hook is not None:
        engine = engine_hook(engine)
    census = load_census(art_dir)
    batch = int(cfg["batch_points"])
    pool = generate.make_pool(census, mix, seed, batch, dev)
    window = Window(engine, pool, sample_rows(cfg, seed, dev), dev)
    for b in range(WARM_BATCHES):
        window.one(b)
    _sync(dev)
    window.kept.clear()
    setup_s = time.perf_counter() - t_start
    setup_peak = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    lat, issue, window_s = window.run(seconds, count=trace)
    _sync(dev)
    run = Run(batch=batch, batches=len(lat), window_s=window_s,
              latencies_s=lat, issue_s=issue, setup_s=setup_s,
              peak_bytes=_peak(dev))
    if trace:
        c = window.counters
        run.counters = {k: int(v) for k, v in c.items()}
        run.counters["points"] = run.batches * batch
        run.trace, run.launches = traced_stretch(
            window, int(cfg["trace_batches"]), dev, engine.fast_index,
            fast_mod)
    memory_peak = max(setup_peak, _peak(dev))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak)}

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    units = {m["name"]: m["unit"] for m in spec.data[kind]}
    for name in spec.metrics(kind, cell):
        value = spec.reader(kind, name).read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_us() / 1e6
        device_info["window_s"] = run.trace.window_us / 1e6

    # The program is freed before the reference runs.
    del engine, idx, window.engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check_ids(reference_class(cfg)(census, dev), window)
    line = {"correct": passes(checks), "attempted": run.batches * batch,
            "failed": checks["mismatched_ids"]["value"],
            "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.top_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = checks
    return line


def _peak(dev) -> int:
    if dev.type == "cuda":
        return int(torch.cuda.max_memory_allocated(dev))
    return 0
