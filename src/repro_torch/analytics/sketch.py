"""Distinct-count sketches for the analytics layer (copy of
src/repro/analytics/sketch.py, numpy only; DESIGN.md §16).

``DistinctSketch`` is a vectorized per-segment **linear counting**
sketch (Whang et al. '90): one ``bits``-wide bitmap per block, a
64-bit avalanche hash of the source id picks the bit, and the distinct
estimate is ``-m * ln(z / m)`` from the count of still-zero bits
``z``.  Linear counting beats HyperLogLog at the small cardinalities
per block a k-anonymity threshold cares about (it is near-exact until
the bitmap loads up — relative error ~ sqrt(m)*(e^t - t - 1)^0.5 / n
at load t = n/m), and its state is a plain bitmap: **mergeable by
bitwise OR**, exactly associative/commutative, which is what lets
sliding windows compose from tumbling panes (window.py) and replicas
feed one aggregator in any order.

Privacy angle (the mContain-style workload): per-block *source*
cardinality gates publication — blocks with fewer than k distinct
sources in a window are suppressed (window.py applies the threshold).
The sketch only ever holds hashed presence bits, never source ids.
Collisions can only under-estimate, so an estimate-based threshold is
conservative: it never publishes a block the exact count would have
suppressed.
"""
from __future__ import annotations

import numpy as np

DEF_BITS = 2048


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 finalizer: uint64 -> well-mixed uint64.
    Deterministic across runs/platforms (pure integer arithmetic), which
    keeps sketch-based tests and snapshots reproducible."""
    x = np.asarray(x).astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


class DistinctSketch:
    """Per-segment linear-counting bitmaps: [n_segments, bits/8] uint8.

    ``observe`` is vectorized over (segment id, source id) pairs;
    invalid segment ids (< 0 or >= n_segments) are ignored.  ``merge``
    returns a NEW sketch (bitwise OR — the GeoStats.merge discipline:
    non-mutating, associative, commutative)."""

    __slots__ = ("n_segments", "bits", "bitmap")

    def __init__(self, n_segments: int, bits: int = DEF_BITS,
                 bitmap: np.ndarray | None = None):
        if bits % 8 != 0 or bits <= 0:
            raise ValueError(f"bits must be a positive multiple of 8, "
                             f"got {bits}")
        self.n_segments = int(n_segments)
        self.bits = int(bits)
        if bitmap is None:
            bitmap = np.zeros((self.n_segments, self.bits // 8), np.uint8)
        assert bitmap.shape == (self.n_segments, self.bits // 8)
        self.bitmap = bitmap

    def observe(self, seg_ids, source_ids) -> None:
        seg = np.asarray(seg_ids).astype(np.int64).ravel()
        src = np.asarray(source_ids).astype(np.uint64).ravel()
        assert seg.shape == src.shape, (seg.shape, src.shape)
        ok = (seg >= 0) & (seg < self.n_segments)
        seg, src = seg[ok], src[ok]
        if not seg.size:
            return
        pos = (splitmix64(src) % np.uint64(self.bits)).astype(np.int64)
        np.bitwise_or.at(self.bitmap, (seg, pos >> 3),
                         (np.uint8(1) << (pos & 7).astype(np.uint8)))

    def merge(self, other: "DistinctSketch") -> "DistinctSketch":
        assert (self.n_segments, self.bits) == (other.n_segments,
                                                other.bits)
        return DistinctSketch(self.n_segments, self.bits,
                              np.bitwise_or(self.bitmap, other.bitmap))

    def estimate(self) -> np.ndarray:
        """[n_segments] float64 distinct-count estimates.  A saturated
        bitmap (zero empty bits) clamps at the sketch's resolution limit
        ``m * ln(m)`` — size ``bits`` ~10x the expected per-block
        cardinality to stay out of that regime."""
        set_bits = np.unpackbits(self.bitmap, axis=1).sum(axis=1)
        m = float(self.bits)
        z = (m - set_bits).astype(np.float64)
        with np.errstate(divide="ignore"):
            est = -m * np.log(np.maximum(z, 1.0) / m)
        return np.where(z > 0, est, m * np.log(m))

    def estimate_round(self) -> np.ndarray:
        """[n_segments] int64 rounded estimates (what thresholds use)."""
        return np.rint(self.estimate()).astype(np.int64)
