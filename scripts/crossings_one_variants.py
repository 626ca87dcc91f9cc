#!/usr/bin/env python3
"""``crossings_one`` at several points per thread, on the card.

    python3 scripts/crossings_one_variants.py [--points 1 2 4 8]

Builds ``src/repro_torch/kernels/csrc/pip.cu`` once per value of its
``kOnePoints`` (a copy with the constant replaced, the port's nvcc flags)
into a library under ``build/``, and for each: the registers and shared
memory ``-Xptxas -v`` reports, the kernel's SASS instruction mix
(``cuobjdump -sass``: the function's instructions, and those of its
innermost loop by opcode, with the tests an iteration runs counted as
half its FADDs, two subtractions a test), and its time (CUDA events,
mean of 5 launches after a warm one) on 2^24 points against a 142-row
table with ~20 % y1 == y2 rows, the shape of the smoke's ``pip_one``
calls, each output bit-equal to ``ref.crossings_one``.  Prints the
card's name and power limit first.  Needs a CUDA device.
"""
import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

N, E, PAD, REPS = 1 << 24, 142, 0.2, 5


def table(rng):
    """A star polygon of E edges with a share PAD of zero rows."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, E + 1))
    r = rng.uniform(0.5, 1.0, E + 1)
    v = np.stack([r * np.cos(ang), r * np.sin(ang)], 1).astype(np.float32)
    v[-1] = v[0]
    edges = np.concatenate([v[:-1], v[1:]], 1)
    edges[rng.random(E) < PAD] = 0.0
    return edges


def build(build_mod, points: int, out_dir: str):
    """(library path, ptxas lines, SASS text) of pip.cu at ``points``."""
    src = (build_mod.CSRC / "pip.cu").read_text()
    line = "constexpr int kOnePoints = 4;"
    assert src.count(line) == 1, "pip.cu: kOnePoints not where expected"
    cu = os.path.join(out_dir, f"pip_{points}.cu")
    with open(cu, "w") as f:
        f.write(src.replace(line, f"constexpr int kOnePoints = {points};"))
    lib = os.path.join(out_dir, f"libpip_{points}.so")
    log = subprocess.run(
        [build_mod.nvcc_path(), *build_mod.NVCC_FLAGS, "-I",
         str(build_mod.CSRC), "-shared", "-o", lib, cu],
        capture_output=True, text=True, check=True)
    lines = (log.stdout + log.stderr).splitlines()
    at = next(i for i, ln in enumerate(lines)
              if "Compiling" in ln and "crossings_one" in ln)
    ptx = next(ln.split(":", 1)[1].strip() for ln in lines[at:]
               if "Used" in ln)
    cuobjdump = os.path.join(os.path.dirname(build_mod.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    return lib, ptx, sass


def sass_mix(sass: str):
    """(opcodes of the crossings_one function, those of its innermost
    loop): the loop is the span from a branch target to the last
    backward branch that returns to it."""
    body = sass.split("Function : ")
    fn = next(b for b in body if "crossings_one_kernel" in b.split("\n")[0])
    ins = []
    for ln in fn.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*?);", ln)
        if m:
            ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
    total = collections.Counter(op.split(".")[0] for _, op, _ in ins)
    loops = []
    for addr, op, rest in ins:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            loops.append((int(t.group(1), 16), addr))
    inner = min(loops, key=lambda ab: ab[1] - ab[0]) if loops else None
    loop = collections.Counter(
        op.split(".")[0] for a, op, _ in ins
        if inner and inner[0] <= a <= inner[1])
    return total, loop


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-1.2, 1.2, (N, 2)).astype(np.float32),
                          device="cuda")
    edges = torch.as_tensor(table(rng), device="cuda")
    staged = int((edges[:, 1] != edges[:, 3]).sum())
    want = torch.cat([ref.crossings_one(pts[i:i + (1 << 20)], edges)
                      for i in range(0, N, 1 << 20)])
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        for points in args.points:
            lib_path, ptx, sass = build(_build, points, tmp)
            fn = ctypes.CDLL(lib_path).repro_crossings_one
            fn.argtypes = _build._SIGNATURES["repro_crossings_one"]
            fn.restype = ctypes.c_int
            out = torch.empty(N, dtype=torch.int32, device="cuda")

            def run():
                status = fn(_build.ptr(pts), _build.ptr(edges),
                            _build.ptr(out), N, E, _build.stream_of(pts))
                assert status == 0, f"launch failed ({status})"

            run()
            torch.cuda.synchronize()
            assert torch.equal(out, want), f"{points} points: != twin"
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(10_000_000)
            start.record()
            for _ in range(REPS):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / REPS
            total, loop = sass_mix(sass)
            # Two subtractions a test (px - x1, py - y1): the tests an
            # iteration of the loop runs.
            tests = max(loop["FADD"] // 2, 1)
            per_test = sum(loop.values()) / tests
            print(f"kOnePoints {points}: {ms:.4f} ms for {N} points x "
                  f"{staged} staged of {E} edges = "
                  f"{N * staged / ms * 1e3:.4g} tests/s; == twin; {ptx}")
            print(f"  SASS: {sum(total.values())} instructions; innermost "
                  f"loop {sum(loop.values())} instructions for {tests} "
                  f"tests = {per_test:.3g} a test; by opcode "
                  f"{dict(loop.most_common())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
