"""The one traffic generator: a mix file's parameters -> a pool of batches.

A mix (``bench/traffic/<name>.json``) names ``pool_batches``, the number
of distinct batches the window cycles through, and the ``kind`` of point
every batch holds, with that kind's parameters:

* ``inblock`` (``margin``, ``band``): the map's own ground-truth sampler.
  An area-weighted block, a uniform point of its chart rectangle outside
  a band of max(margin x side, band x the warp's sagitta bound), warped.
* ``edge`` (``sigma``): a point on a block's chart boundary (the block
  weighted by perimeter, the point uniform along it), moved along the
  side's normal by N(0, (sigma x the mean block side)^2), warped: pings
  on the streets that bound blocks.
* ``extent`` : uniform over the map's bounding box, the sea and the
  land beyond the border included.

Points are made on the device from the seed with a ``torch.Generator``
there, in float64, and handed over as float32.  The same seed gives the
same pool.
"""
from __future__ import annotations

import hashlib

import torch

def sub_seed(seed: int, what: str) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _warp(census, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    w = census.warp
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(y)
    for i in range(len(w.ax)):
        dx = dx + float(w.ax[i]) * torch.sin(float(w.ky[i]) * y
                                             + float(w.px[i]))
        dy = dy + float(w.ay[i]) * torch.sin(float(w.kx[i]) * x
                                             + float(w.py[i]))
    return torch.stack([x + dx, y + dy], dim=1)


def _pick(weights: torch.Tensor, n: int, gen) -> torch.Tensor:
    cdf = torch.cumsum(weights, 0)
    u = torch.rand(n, dtype=torch.float64, device=weights.device,
                   generator=gen) * cdf[-1]
    return torch.searchsorted(cdf, u).clamp(max=weights.shape[0] - 1)


def _inblock(census, rects, n, gen, margin: float, band: float):
    w, h = rects[:, 1] - rects[:, 0], rects[:, 3] - rects[:, 2]
    r = rects[_pick(w * h, n, gen)]
    w, h = r[:, 1] - r[:, 0], r[:, 3] - r[:, 2]
    band = band * census.sagitta
    mx = torch.minimum(torch.clamp(w * margin, min=band), 0.45 * w)
    my = torch.minimum(torch.clamp(h * margin, min=band), 0.45 * h)
    u = torch.rand((n, 2), dtype=torch.float64, device=rects.device,
                   generator=gen)
    x = r[:, 0] + mx + (w - 2 * mx) * u[:, 0]
    y = r[:, 2] + my + (h - 2 * my) * u[:, 1]
    return _warp(census, x, y)


def _edge(census, rects, n, gen, sigma: float):
    w, h = rects[:, 1] - rects[:, 0], rects[:, 3] - rects[:, 2]
    spread = sigma * float(((w + h) / 2).mean())
    r = rects[_pick(2 * (w + h), n, gen)]
    w, h = r[:, 1] - r[:, 0], r[:, 3] - r[:, 2]
    u = torch.rand(n, dtype=torch.float64, device=rects.device,
                   generator=gen) * 2 * (w + h)
    off = torch.randn(n, dtype=torch.float64, device=rects.device,
                      generator=gen) * spread
    # Walk the perimeter: bottom, right, top, left.
    bottom, right, top = u < w, (u >= w) & (u < w + h), \
        (u >= w + h) & (u < 2 * w + h)
    x = torch.where(bottom, r[:, 0] + u,
                    torch.where(right, r[:, 1] + off,
                                torch.where(top, r[:, 1] - (u - w - h),
                                            r[:, 0] - off)))
    y = torch.where(bottom, r[:, 2] - off,
                    torch.where(right, r[:, 2] + (u - w),
                                torch.where(top, r[:, 3] + off,
                                            r[:, 3] - (u - 2 * w - h))))
    return _warp(census, x, y)


def _extent(census, rects, n, gen):
    x0, x1, y0, y1 = census.extent
    u = torch.rand((n, 2), dtype=torch.float64, device=rects.device,
                   generator=gen)
    return torch.stack([x0 + (x1 - x0) * u[:, 0],
                        y0 + (y1 - y0) * u[:, 1]], dim=1)


PARAMS = {"inblock": ("margin", "band"), "edge": ("sigma",), "extent": ()}


def check_mix(mix: dict) -> None:
    """Raise on a mix file the generator cannot read."""
    kind = mix.get("kind")
    if kind not in PARAMS or int(mix.get("pool_batches", 0)) < 1:
        raise ValueError(f"a mix needs a kind of {tuple(PARAMS)} and "
                         f"pool_batches >= 1")
    missing = [k for k in PARAMS[kind] if k not in mix]
    if missing:
        raise ValueError(f"a {kind} mix needs {missing}")


def make_batch(census, mix: dict, n: int, gen, rects) -> torch.Tensor:
    """One [n, 2] float32 batch of the mix."""
    kind = mix["kind"]
    if kind == "inblock":
        xy = _inblock(census, rects, n, gen, float(mix["margin"]),
                      float(mix["band"]))
    elif kind == "edge":
        xy = _edge(census, rects, n, gen, float(mix["sigma"]))
    else:
        xy = _extent(census, rects, n, gen)
    return xy.float().contiguous()


def make_pool(census, mix: dict, seed: int, batch: int, device) -> list:
    """``mix["pool_batches"]`` distinct [batch, 2] float32 batches on
    ``device``, drawn from ``seed``."""
    check_mix(mix)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "traffic"))
    rects = torch.as_tensor(census.block_rects, dtype=torch.float64,
                            device=device)
    return [make_batch(census, mix, batch, gen, rects)
            for _ in range(int(mix["pool_batches"]))]
