"""Synthetic hierarchical census map + location streams (host, numpy).

Real census shapefiles are not available offline, so we generate a map with
the same *structure* the paper exploits:

  * a strict 3-level hierarchy (state -> county -> block group) that exactly
    partitions a CONUS-like extent,
  * highly irregular, non-convex polygon boundaries with 10s..1000s of
    vertices,
  * bounding boxes that overlap between neighbours so that a tunable ~20 % of
    query points fall in >1 bbox (the paper's measured PIP fraction).

Construction: recursive BSP (guillotine) cuts in a rectilinear "chart" space
give an exact nested partition of rectangles.  Every rectangle edge is
subdivided on a *global* grid step (so neighbours share identical boundary
vertices), then all vertices are pushed through a smooth, multi-octave
sinusoidal warp.  The warp is a homeomorphism (displacement gradients < 1),
so the warped polygons still partition the map exactly, but edges become
curvy, polygons non-convex, and bboxes bleed across neighbours.

Ground truth is free: a query point is generated in chart space (where its
BSP cell is known by construction) and warped with the same map.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.geometry import CensusMap, pack_rings

# CONUS-like extent in chart space (degrees).
EXTENT = (-125.0, -66.0, 24.0, 49.0)


@dataclasses.dataclass(frozen=True)
class Warp:
    """Multi-octave sinusoidal displacement field (a homeomorphism)."""

    ax: np.ndarray   # [octaves] x-displacement amplitudes
    ay: np.ndarray   # [octaves]
    kx: np.ndarray   # [octaves] frequencies (rad / degree)
    ky: np.ndarray
    px: np.ndarray   # [octaves] phases
    py: np.ndarray

    def __call__(self, xy: np.ndarray) -> np.ndarray:
        x, y = xy[..., 0], xy[..., 1]
        dx = np.zeros_like(x)
        dy = np.zeros_like(y)
        for i in range(len(self.ax)):
            dx = dx + self.ax[i] * np.sin(self.ky[i] * y + self.px[i])
            dy = dy + self.ay[i] * np.sin(self.kx[i] * x + self.py[i])
        return np.stack([x + dx, y + dy], axis=-1)


def make_warp(rng: np.random.Generator, octaves: int = 3,
              grad: float = 0.2, k_finest: float = 2.4) -> Warp:
    """Octave frequencies descend 4x from ``k_finest`` with amplitude =
    grad / freq, so the displacement *gradient* stays ~``grad`` per octave and
    the total well below 1 -> invertible warp, with irregularity at every
    hierarchy scale.  ``k_finest`` is pinned to the boundary subdivision step
    (k*step = pi/4) so the chord-sagitta error between subdivision vertices
    stays << the point-sampling margin.  ``grad`` is tuned so ~20 % of uniform
    points land in >1 sibling bbox, matching the paper's measured PIP
    fraction (~0.2 evals/point)."""
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
    """Snap a cut coordinate to the global grid, staying strictly inside.

    Snapping all cuts to grid ticks guarantees every rectangle corner (incl.
    T-junction contact points between neighbours) is a shared subdivision
    vertex, so the partition stays *exact* after the nonlinear warp.
    """
    t = np.round(c / step) * step
    if t <= lo + step * 0.5 or t >= hi - step * 0.5:
        # No interior tick available; keep unsnapped midpoint cut (rare, and
        # only possible for cells ~2 ticks wide where warp curvature over a
        # single step is negligible).
        return c
    return float(t)


def _bsp(rng: np.random.Generator, rect: tuple, n: int,
         step: float) -> list[tuple]:
    """Split rect into n rectangles with jittered, grid-snapped cuts."""
    rects = [rect]
    while len(rects) < n:
        # Split the rectangle with the largest area.
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
    """Open CCW ring for a rectangle, subdivided on the global grid step.

    Subdivision points lie at global multiples of ``step`` so neighbouring
    rectangles produce *identical* vertices along shared edges: the partition
    stays exact after warping.
    """
    x0, x1, y0, y1 = rect

    def seg(lo, hi, axis_fixed, fixed, ascending):
        # Global tick multiples strictly inside (lo, hi); ``ascending`` only
        # controls traversal order.  Epsilon is relative to the step so
        # grid-snapped endpoints are reliably excluded.
        eps = step * 1e-9
        ticks = np.arange(np.ceil((lo - eps) / step) * step, hi, step)
        ticks = ticks[(ticks > lo + eps) & (ticks < hi - eps)]
        if not ascending:
            ticks = ticks[::-1]
        pts = [(t, fixed) if axis_fixed == "y" else (fixed, t) for t in ticks]
        return pts

    ring = [(x0, y0)]
    ring += seg(x0, x1, "y", y0, True)
    ring += [(x1, y0)]
    ring += seg(y0, y1, "x", x1, True)
    ring += [(x1, y1)]
    ring += seg(x0, x1, "y", y1, False)
    ring += [(x0, y1)]
    ring += seg(y0, y1, "x", x0, False)
    return np.array(ring, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class SynthCensus:
    census: CensusMap
    warp: Warp
    # Chart-space rectangles per level, for ground-truth assignment.
    state_rects: np.ndarray    # [n_state, 4]
    county_rects: np.ndarray   # [n_county, 4]
    block_rects: np.ndarray    # [n_block, 4]
    # Upper bound on the chord-sagitta error of warped boundary segments:
    # the warped *image* of a chart boundary can bulge past the straight
    # polygon edge by at most this much.  Ground-truth points keep >= 3x this
    # distance from chart boundaries.
    sagitta: float = 0.0

    def sample_points(self, rng: np.random.Generator, n: int,
                      margin: float = 0.05):
        """Sample n points with known ground truth.

        Points are drawn uniformly inside chart-space *block* rectangles with
        a margin from the boundary (relative, floored at 3x the warp sagitta
        bound so fp32 on-device tests are unambiguous), then warped.  Returns
        (xy [n,2] f32, block_id [n] i32, county_id [n] i32, state_id [n] i32).
        """
        br = self.block_rects
        # Area-weighted block choice approximates uniform spatial sampling.
        areas = (br[:, 1] - br[:, 0]) * (br[:, 3] - br[:, 2])
        p = areas / areas.sum()
        bid = rng.choice(len(br), size=n, p=p).astype(np.int32)
        r = br[bid]
        w, h = r[:, 1] - r[:, 0], r[:, 3] - r[:, 2]
        mx = np.minimum(np.maximum(w * margin, 3 * self.sagitta), 0.45 * w)
        my = np.minimum(np.maximum(h * margin, 3 * self.sagitta), 0.45 * h)
        x = rng.uniform(r[:, 0] + mx, r[:, 1] - mx)
        y = rng.uniform(r[:, 2] + my, r[:, 3] - my)
        xy = self.warp(np.stack([x, y], axis=-1)).astype(np.float32)
        cid = self.census.blocks.parent[bid]
        sid = self.census.counties.parent[cid]
        return xy, bid, cid.astype(np.int32), sid.astype(np.int32)


def build_synth_census(seed: int = 0, n_states: int = 8,
                       counties_per_state: int = 4,
                       blocks_per_county: int = 16,
                       octaves: int = None, grad: float = 0.2,
                       extent: tuple = EXTENT,
                       grid_step: float = None) -> SynthCensus:
    """Build a synthetic census map.

    Defaults are test-sized; the paper-scale config is
    (56, ~58, ~68) -> 56 states / 3,248 counties / 220,864 blocks.
    ``grid_step`` controls boundary vertex density (default: half the typical
    block edge length, giving blocks ~8-40 vertices and states 100s-1000s).
    """
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = extent
    rect0 = (x0, x1, y0, y1)

    n_total_blocks = n_states * counties_per_state * blocks_per_county
    if grid_step is None:
        # Typical block edge length / 2 -> blocks get >= ~8 boundary vertices.
        typ = np.sqrt((x1 - x0) * (y1 - y0) / n_total_blocks)
        grid_step = typ / 2.0
    # Finest octave: k * grid_step = pi/4 (wavelength = 8 grid steps), coarsest
    # ~ the state scale, so bbox bleed is significant at every level.
    k_finest = np.pi / (4.0 * grid_step)
    k_coarsest = 2.0 * np.pi / max(x1 - x0, y1 - y0)
    if octaves is None:
        octaves = max(2, int(np.ceil(np.log(k_finest / k_coarsest)
                                     / np.log(4.0))))
    warp = make_warp(rng, octaves=octaves, grad=grad, k_finest=k_finest)

    state_rects = _bsp(rng, rect0, n_states, grid_step)
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

    def build_level(rects, parent, fips_base):
        rings = [warp(_rect_ring(r, grid_step)) for r in rects]
        parent = np.asarray(parent, dtype=np.int32)
        fips = fips_base + np.arange(len(rects), dtype=np.int64)
        return pack_rings(rings, parent=parent, fips=fips)

    states = build_level(state_rects, [-1] * len(state_rects), 1_000)
    counties = build_level(county_rects, county_parent, 10_000)
    blocks = build_level(block_rects, block_parent, 100_000_000)

    # Warped map extent (warp can push vertices slightly outside the chart box).
    allv = [states.bbox, counties.bbox, blocks.bbox]
    xmin = min(float(b[:, 0].min()) for b in allv)
    xmax = max(float(b[:, 1].max()) for b in allv)
    ymin = min(float(b[:, 2].min()) for b in allv)
    ymax = max(float(b[:, 3].max()) for b in allv)
    census = CensusMap(states=states, counties=counties, blocks=blocks,
                       extent=(xmin, xmax, ymin, ymax))
    # Sum of per-octave sagitta bounds: amp_o * (k_o*step/2)^2 / 2, a
    # geometric series dominated by the finest octave (k*step = pi/4).
    # x- and y-displacement bounds are equal by construction; keep the max.
    sag = float(max(sum(a * (k * grid_step / 2) ** 2 / 2
                        for a, k in zip(amps, ks))
                    for amps, ks in ((warp.ax, warp.ky), (warp.ay, warp.kx))))
    return SynthCensus(census=census, warp=warp,
                       state_rects=np.array(state_rects),
                       county_rects=np.array(county_rects),
                       block_rects=np.array(block_rects),
                       sagitta=sag)
