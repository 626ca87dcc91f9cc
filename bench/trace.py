"""Reading a torch.profiler trace of the benchmark's traced stretch.

The stretch is one host range (``STRETCH``) around a few batches, each
split into the benchmark's own ranges: ``traffic`` (taking the batch from
the pool), ``assign`` (the program's call) and ``wait`` (until the ids are
ready).  From the Chrome trace the profiler exports, ``Trace`` keeps the
device operations (kernels, copies, fills), those ranges and the host
operators of the thread that ran them, and answers what the per-layer
readers ask: device time by kind, the union of busy intervals, the idle
gaps named by what the host was doing, the top operations.

A hand kernel is a device kernel whose name holds one of the
``__global__`` function names of the program's CUDA sources.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

STRETCH = "bench.stretch"
HOST_RANGES = ("traffic", "assign", "wait")
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}
_GLOBAL = re.compile(r"__global__\s+void\s+(\w+)\s*\(")
_BOUNDS = re.compile(r"__launch_bounds__\s*\([^)]*\)")
_WORD = re.compile(r"[A-Za-z_]\w*")


def global_names(csrc_dir) -> set:
    """Names of the ``__global__`` functions in a directory of CUDA
    sources."""
    names = set()
    for path in sorted(Path(csrc_dir).glob("*.cu*")):
        text = _BOUNDS.sub(" ", path.read_text())
        names.update(_GLOBAL.findall(text))
    return names


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Trace:
    def __init__(self, events: list, hand_names: set):
        stretch = [e for e in events if e.get("ph") == "X"
                   and e.get("name") == STRETCH
                   and not str(e.get("cat", "")).startswith("gpu")]
        if not stretch:
            raise ValueError(f"the trace holds no {STRETCH!r} range")
        s = stretch[0]
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.tid = (s.get("pid"), s.get("tid"))
        self.hand_names = set(hand_names)
        self.device = []      # (name, kind, start, end) within the stretch
        self.ranges = []      # (name, start, end): the benchmark's ranges
        self.host_ops = []    # (name, start, end): that thread's operators
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if te <= self.t0 or ts >= self.t1:
                continue
            cat = str(e.get("cat", "")).lower()
            if cat in DEVICE_CATS:
                self.device.append((e["name"], DEVICE_CATS[cat], ts, te))
            elif (e.get("pid"), e.get("tid")) == self.tid:
                if e.get("name") in HOST_RANGES:
                    self.ranges.append((e["name"], ts, te))
                elif cat == "cpu_op":
                    self.host_ops.append((e["name"], ts, te))

    @classmethod
    def from_file(cls, path, hand_names: set) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, hand_names)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def is_hand(self, name: str) -> bool:
        return any(w in self.hand_names for w in _WORD.findall(name))

    def device_us(self, hand=None) -> float:
        """Summed device time (clipped to the stretch); ``hand`` True /
        False keeps only hand kernels / everything else."""
        return sum(min(te, self.t1) - max(ts, self.t0)
                   for name, kind, ts, te in self.device
                   if hand is None
                   or (kind == "kernel" and self.is_hand(name)) == hand)

    def busy_us(self) -> float:
        return union_us([(ts, te) for _, _, ts, te in self.device],
                        self.t0, self.t1)

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...]: device operations by summed time."""
        by = {}
        for name, _, ts, te in self.device:
            by[name] = by.get(name, 0.0) + (min(te, self.t1)
                                            - max(ts, self.t0))
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], us / 1e6] for name, us in top]

    def _host_at(self, t: float) -> str:
        rng = next((name for name, ts, te in self.ranges if ts <= t < te),
                   "between")
        inner = [(te - ts, name) for name, ts, te in self.host_ops
                 if ts <= t < te]
        return f"{rng}/{min(inner)[1]}" if inner else rng

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds], ...]: the longest spans of
        the stretch in which no device operation ran, each named by the
        benchmark's range and the innermost host operator at its middle."""
        gaps, edge = [], self.t0
        for _, _, ts, te in sorted(self.device, key=lambda d: d[2]):
            if ts > edge:
                gaps.append((edge, ts))
            edge = max(edge, te)
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return [[self._host_at((s + e) / 2)[:120], (e - s) / 1e6]
                for s, e in gaps]
