"""The synthetic census map and its ground-truth sampler, frozen.

A copy of the generator the program ships (a hierarchical BSP partition of
a CONUS-like chart, every level's rings subdivided on one global grid step
and pushed through a smooth sinusoidal warp), kept here so that the map the
benchmark hands both sides cannot move with the program.  Everything is
host numpy; nothing of the program is imported.  ``build_census`` gives
the same arrays as the program's ``build_synth_census`` for the same
arguments (a test holds the two equal).

``Census`` keeps each level as a dict of arrays (``verts``, ``n_verts``,
``bbox``, ``parent``, ``fips``: the closed, padded ring layout), the
chart-space rectangles that give ground truth, the warp and the sagitta
bound that the samplers keep their distance from.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# CONUS-like extent in chart space (degrees).
EXTENT = (-125.0, -66.0, 24.0, 49.0)
LEVELS = ("states", "counties", "blocks")
SOUP_FIELDS = ("verts", "n_verts", "bbox", "parent", "fips")
WARP_FIELDS = ("ax", "ay", "kx", "ky", "px", "py")


@dataclasses.dataclass(frozen=True)
class Warp:
    """Multi-octave sinusoidal displacement field (a homeomorphism)."""

    ax: np.ndarray
    ay: np.ndarray
    kx: np.ndarray
    ky: np.ndarray
    px: np.ndarray
    py: np.ndarray

    def __call__(self, xy: np.ndarray) -> np.ndarray:
        x, y = xy[..., 0], xy[..., 1]
        dx = np.zeros_like(x)
        dy = np.zeros_like(y)
        for i in range(len(self.ax)):
            dx = dx + self.ax[i] * np.sin(self.ky[i] * y + self.px[i])
            dy = dy + self.ay[i] * np.sin(self.kx[i] * x + self.py[i])
        return np.stack([x + dx, y + dy], axis=-1)


def make_warp(rng: np.random.Generator, octaves: int, grad: float,
              k_finest: float) -> Warp:
    ax, ay, kx, ky, px, py = [], [], [], [], [], []
    for o in range(octaves):
        frq = k_finest / (4.0 ** o)
        amp = grad / frq
        ax.append(amp * rng.uniform(0.6, 1.0))
        ay.append(amp * rng.uniform(0.6, 1.0))
        kx.append(frq * rng.uniform(0.8, 1.2))
        ky.append(frq * rng.uniform(0.8, 1.2))
        px.append(rng.uniform(0, 2 * np.pi))
        py.append(rng.uniform(0, 2 * np.pi))
    return Warp(*(np.array(v) for v in (ax, ay, kx, ky, px, py)))


def _snap(c: float, lo: float, hi: float, step: float) -> float:
    """A cut snapped to the global grid, strictly inside (lo, hi), so
    every corner is a shared subdivision vertex and the partition stays
    exact after the warp."""
    t = np.round(c / step) * step
    if t <= lo + step * 0.5 or t >= hi - step * 0.5:
        return c
    return float(t)


def _bsp(rng: np.random.Generator, rect: tuple, n: int,
         step: float) -> list:
    rects = [rect]
    while len(rects) < n:
        areas = [(r[1] - r[0]) * (r[3] - r[2]) for r in rects]
        i = int(np.argmax(areas))
        x0, x1, y0, y1 = rects.pop(i)
        if (x1 - x0) >= (y1 - y0):
            c = _snap(x0 + (x1 - x0) * rng.uniform(0.35, 0.65), x0, x1, step)
            rects += [(x0, c, y0, y1), (c, x1, y0, y1)]
        else:
            c = _snap(y0 + (y1 - y0) * rng.uniform(0.35, 0.65), y0, y1, step)
            rects += [(x0, x1, y0, c), (x0, x1, c, y1)]
    return rects


def _rect_ring(rect: tuple, step: float) -> np.ndarray:
    """Open CCW ring of a rectangle, subdivided at global multiples of
    ``step`` so that neighbours share identical vertices."""
    x0, x1, y0, y1 = rect

    def seg(lo, hi, axis_fixed, fixed, ascending):
        eps = step * 1e-9
        ticks = np.arange(np.ceil((lo - eps) / step) * step, hi, step)
        ticks = ticks[(ticks > lo + eps) & (ticks < hi - eps)]
        if not ascending:
            ticks = ticks[::-1]
        return [(t, fixed) if axis_fixed == "y" else (fixed, t)
                for t in ticks]

    ring = [(x0, y0)]
    ring += seg(x0, x1, "y", y0, True)
    ring += [(x1, y0)]
    ring += seg(y0, y1, "x", x1, True)
    ring += [(x1, y1)]
    ring += seg(x0, x1, "y", y1, False)
    ring += [(x0, y1)]
    ring += seg(y0, y1, "x", x0, False)
    return np.array(ring, dtype=np.float64)


def pack_rings(rings: list, parent: np.ndarray, fips: np.ndarray) -> dict:
    """Open rings -> closed rings padded with their first vertex, f32."""
    n = len(rings)
    nv = np.array([len(r) for r in rings], dtype=np.int32)
    max_v = int(nv.max())
    verts = np.zeros((n, max_v + 1, 2), dtype=np.float32)
    bbox = np.zeros((n, 4), dtype=np.float32)
    for i, r in enumerate(rings):
        r = np.asarray(r, dtype=np.float32)
        k = len(r)
        verts[i, :k] = r
        verts[i, k:] = r[0]
        bbox[i] = (r[:, 0].min(), r[:, 0].max(), r[:, 1].min(),
                   r[:, 1].max())
    return {"verts": verts, "n_verts": nv, "bbox": bbox,
            "parent": np.asarray(parent, np.int32),
            "fips": np.asarray(fips, np.int64)}


@dataclasses.dataclass(frozen=True)
class Census:
    levels: dict          # {"states" | "counties" | "blocks": soup dict}
    extent: tuple         # warped map extent (xmin, xmax, ymin, ymax)
    warp: Warp
    block_rects: np.ndarray   # [n_block, 4] chart-space (x0, x1, y0, y1)
    sagitta: float

    def to_arrays(self) -> dict:
        """Flat arrays for ``np.savez`` (``from_arrays`` inverts it)."""
        out = {f"{lvl}_{f}": self.levels[lvl][f]
               for lvl in LEVELS for f in SOUP_FIELDS}
        out.update({f"warp_{f}": getattr(self.warp, f) for f in WARP_FIELDS})
        out["extent"] = np.asarray(self.extent, np.float64)
        out["block_rects"] = self.block_rects
        out["sagitta"] = np.float64(self.sagitta)
        return out

    @classmethod
    def from_arrays(cls, arrays) -> "Census":
        return cls(
            levels={lvl: {f: np.asarray(arrays[f"{lvl}_{f}"])
                          for f in SOUP_FIELDS} for lvl in LEVELS},
            extent=tuple(float(v) for v in arrays["extent"]),
            warp=Warp(*(np.asarray(arrays[f"warp_{f}"])
                        for f in WARP_FIELDS)),
            block_rects=np.asarray(arrays["block_rects"]),
            sagitta=float(arrays["sagitta"]))


def build_census(seed: int, n_states: int, counties_per_state: int,
                 blocks_per_county: int, grad: float = 0.2,
                 extent: tuple = EXTENT) -> Census:
    """The map: ``n_states`` x ``counties_per_state`` x
    ``blocks_per_county`` nested polygons, the grid step half the
    typical block edge, the finest warp octave pinned to it."""
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = extent
    n_total_blocks = n_states * counties_per_state * blocks_per_county
    typ = np.sqrt((x1 - x0) * (y1 - y0) / n_total_blocks)
    grid_step = typ / 2.0
    k_finest = np.pi / (4.0 * grid_step)
    k_coarsest = 2.0 * np.pi / max(x1 - x0, y1 - y0)
    octaves = max(2, int(np.ceil(np.log(k_finest / k_coarsest)
                                 / np.log(4.0))))
    warp = make_warp(rng, octaves=octaves, grad=grad, k_finest=k_finest)

    state_rects = _bsp(rng, (x0, x1, y0, y1), n_states, grid_step)
    county_rects, county_parent = [], []
    for si, sr in enumerate(state_rects):
        for cr in _bsp(rng, sr, counties_per_state, grid_step):
            county_rects.append(cr)
            county_parent.append(si)
    block_rects, block_parent = [], []
    for ci, cr in enumerate(county_rects):
        for br in _bsp(rng, cr, blocks_per_county, grid_step):
            block_rects.append(br)
            block_parent.append(ci)

    def level(rects, parent, fips_base):
        rings = [warp(_rect_ring(r, grid_step)) for r in rects]
        return pack_rings(rings, parent,
                          fips_base + np.arange(len(rects), dtype=np.int64))

    levels = {"states": level(state_rects, [-1] * len(state_rects), 1_000),
              "counties": level(county_rects, county_parent, 10_000),
              "blocks": level(block_rects, block_parent, 100_000_000)}
    boxes = [levels[lvl]["bbox"] for lvl in LEVELS]
    ext = (min(float(b[:, 0].min()) for b in boxes),
           max(float(b[:, 1].max()) for b in boxes),
           min(float(b[:, 2].min()) for b in boxes),
           max(float(b[:, 3].max()) for b in boxes))
    # Chord-sagitta bound of a warped boundary segment, summed over the
    # octaves: amp * (k * step / 2)^2 / 2.
    sag = float(max(sum(a * (k * grid_step / 2) ** 2 / 2
                        for a, k in zip(amps, ks))
                    for amps, ks in ((warp.ax, warp.ky), (warp.ay, warp.kx))))
    return Census(levels=levels, extent=ext, warp=warp,
                  block_rects=np.array(block_rects), sagitta=sag)


def sample_points(census: Census, rng: np.random.Generator, n: int,
                  margin: float = 0.05):
    """The map's ground-truth sampler: an area-weighted block, a uniform
    point of its chart rectangle outside a band of max(margin x side,
    3 x sagitta) (at most 0.45 of the side), warped.  Returns (xy [n, 2]
    f32, block, county, state ids)."""
    br = census.block_rects
    areas = (br[:, 1] - br[:, 0]) * (br[:, 3] - br[:, 2])
    bid = rng.choice(len(br), size=n, p=areas / areas.sum()).astype(np.int32)
    r = br[bid]
    w, h = r[:, 1] - r[:, 0], r[:, 3] - r[:, 2]
    mx = np.minimum(np.maximum(w * margin, 3 * census.sagitta), 0.45 * w)
    my = np.minimum(np.maximum(h * margin, 3 * census.sagitta), 0.45 * h)
    x = rng.uniform(r[:, 0] + mx, r[:, 1] - mx)
    y = rng.uniform(r[:, 2] + my, r[:, 3] - my)
    xy = census.warp(np.stack([x, y], axis=-1)).astype(np.float32)
    cid = census.levels["blocks"]["parent"][bid]
    sid = census.levels["counties"]["parent"][cid]
    return xy, bid, cid.astype(np.int32), sid.astype(np.int32)
