"""Plain crossing-number reference: which block holds each point.

The reference works every id out again from the block polygons alone.
Each point is tested, by the half-open crossing-number rule, against every
block whose ring's bounding box holds it (found through a uniform grid
over the map); the county and the state are the block's parents in the
census's own arrays.  Plain PyTorch in blocks of rows, on whatever device
the points are; nothing of the program is imported or read.

``dtype`` is the precision of the crossing arithmetic: the configuration's
float32 for the reference, bfloat16 for the control (the candidate search
stays in float32, so only the arithmetic changes).
"""
from __future__ import annotations

import numpy as np
import torch

ROWS = 1 << 15            # points per block of the PIP arithmetic


class CrossingReference:
    def __init__(self, census, device, dtype=torch.float32):
        blocks = census.levels["blocks"]
        verts = np.asarray(blocks["verts"], np.float32)
        self.device = torch.device(device)
        self.dtype = dtype
        v = torch.as_tensor(verts, device=self.device)
        self.edges = torch.cat([v[:, :-1], v[:, 1:]], dim=-1)  # [P, V, 4]
        self.block_parent = torch.as_tensor(
            np.asarray(blocks["parent"], np.int64), device=self.device)
        self.county_parent = torch.as_tensor(
            np.asarray(census.levels["counties"]["parent"], np.int64),
            device=self.device)
        self._grid(verts)

    def _grid(self, verts: np.ndarray) -> None:
        """Blocks by grid cell: about one cell per block, each block
        listed in every cell its ring's box touches."""
        n = verts.shape[0]
        lo = verts.min(axis=1).astype(np.float64)       # [P, 2]
        hi = verts.max(axis=1).astype(np.float64)
        g0, g1 = lo.min(axis=0), hi.max(axis=0)
        side = max(1, int(np.ceil(np.sqrt(n))))
        size = np.maximum((g1 - g0) / side, 1e-12)
        c0 = np.clip(np.floor((lo - g0) / size), 0, side - 1).astype(np.int64)
        c1 = np.clip(np.floor((hi - g0) / size), 0, side - 1).astype(np.int64)
        span = c1 - c0 + 1
        cells, ids = [], []
        for dx in range(int(span[:, 0].max())):
            for dy in range(int(span[:, 1].max())):
                ok = (dx < span[:, 0]) & (dy < span[:, 1])
                cells.append((c0[ok, 0] + dx) * side + c0[ok, 1] + dy)
                ids.append(np.nonzero(ok)[0])
        cells, ids = np.concatenate(cells), np.concatenate(ids)
        order = np.lexsort((ids, cells))
        cells, ids = cells[order], ids[order]
        count = np.bincount(cells, minlength=side * side)
        start = np.concatenate([[0], np.cumsum(count)[:-1]])
        table = np.full((side * side, int(count.max())), -1, np.int64)
        table[cells, np.arange(len(cells)) - start[cells]] = ids
        self.side = side
        self.origin = torch.tensor(g0, device=self.device)
        self.size = torch.tensor(size, device=self.device)
        self.table = torch.as_tensor(table, device=self.device)

    def _candidates(self, pts: torch.Tensor) -> torch.Tensor:
        c = torch.floor((pts.double() - self.origin) / self.size)
        inside = ((c >= 0) & (c < self.side)).all(dim=1)
        c = c.clamp(0, self.side - 1).long()
        cand = self.table[c[:, 0] * self.side + c[:, 1]]
        return torch.where(inside[:, None], cand, -1)

    def _inside(self, pts: torch.Tensor, pid: torch.Tensor) -> torch.Tensor:
        """Crossing-number parity of each point against its own block."""
        e = self.edges[pid.clamp(min=0)].to(self.dtype)        # [R, V, 4]
        p = pts.to(self.dtype)
        px, py = p[:, 0:1], p[:, 1:2]
        x1, y1, x2, y2 = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
        straddle = (y1 > py) != (y2 > py)
        lhs = (px - x1) * (y2 - y1)
        rhs = (py - y1) * (x2 - x1)
        cross = straddle & ((lhs < rhs) == (y2 > y1))
        return ((cross.sum(dim=1) % 2) == 1) & (pid >= 0)

    def hits(self, pts: torch.Tensor):
        """(block [n] i64 = the lowest-numbered block holding the point,
        -1 for none; n_hits [n]: how many blocks hold it)."""
        block = torch.full((pts.shape[0],), -1, dtype=torch.int64,
                           device=pts.device)
        n_hits = torch.zeros(pts.shape[0], dtype=torch.int64,
                             device=pts.device)
        for lo in range(0, pts.shape[0], ROWS):
            p = pts[lo:lo + ROWS]
            cand = self._candidates(p)
            best = torch.full((p.shape[0],), -1, dtype=torch.int64,
                              device=p.device)
            count = torch.zeros_like(best)
            for j in range(cand.shape[1]):
                hit = self._inside(p, cand[:, j])
                count += hit.long()
                take = hit & ((best < 0) | (cand[:, j] < best))
                best = torch.where(take, cand[:, j], best)
            block[lo:lo + ROWS] = best
            n_hits[lo:lo + ROWS] = count
        return block, n_hits

    def ids(self, pts: torch.Tensor):
        """([n, 3] i32 (state, county, block), -1 where no block holds the
        point; n_hits [n])."""
        block, n_hits = self.hits(pts)
        county = torch.where(block >= 0,
                             self.block_parent[block.clamp(min=0)], -1)
        state = torch.where(county >= 0,
                            self.county_parent[county.clamp(min=0)], -1)
        return torch.stack([state, county, block], dim=1).int(), n_hits


# The name the harness looks up (a configuration's ``reference`` key names
# the module).
Reference = CrossingReference
