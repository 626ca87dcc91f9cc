"""The cascade's county and block bbox step in one op
(``ops.bbox_select_children``) against the composition it replaced in
``core/simple.py::_level_pass``: the parent's children gathered
(``children_table[...]``), their boxes gathered (``bbox_table[...]``),
``bbox_count_select`` and the pick, and for the candidates the gathered
mask and ``first_k_candidates``.  Tolerance: exact equality (counts and
ids are integers).

The cases marked ``cuda`` hold the kernel against its twin on the card
at the paper's widths (58 counties a state, 68 blocks a county) and
count its launches in one cascade; they skip here.  This file imports
no JAX, so it runs on the card as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_select_children.py -m cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.core import simple as t_simple
from repro_torch.core.resolve import first_k_candidates
from repro_torch.core.synth import build_synth_census
from repro_torch.kernels import _build, bbox, ops, ref

NEEDS_CUDA = "needs a CUDA device; chip_smoke.py checks it"
WIDTHS = (1, 8, 32, 33, 58, 68)
FAR = 1.0e30


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CUDA)
    return torch.device("cuda")


def composed(points, parent, children_table, bbox_table, k):
    """The county / block bbox step as ``_level_pass`` composed it before
    the kernel, written out op for op."""
    n_parents = children_table.shape[0] - 1
    parent_ix = torch.where(parent >= 0, parent, n_parents)
    cand = children_table[parent_ix.long()]                      # [N, C]
    cand_ix = torch.where(cand >= 0, cand, bbox_table.shape[0] - 1)
    boxes = bbox_table[cand_ix.long()]                           # [N, C, 4]
    cnt, sel = ops.bbox_count_select(points, boxes)
    picked = torch.gather(cand, 1, sel.clamp(min=0).long()[:, None])[:, 0]
    pick = torch.where(sel >= 0, picked, -1)
    slots = first_k_candidates(ops.bbox_mask_gathered(points, boxes), k)
    first = torch.where(slots >= 0,
                        torch.gather(cand, 1, slots.clamp(min=0).long()), -1)
    return cnt, pick, first


def _tables(rng, c, n_parents=9):
    """Children [P+1, C] (rows of consecutive ids, -1 padded to random
    lengths, row 0 full, row 3 all -1, the sentinel row last) and boxes [M+1, 4]:
    large overlapping boxes so points sit in several, a few empty ones,
    the empty sentinel box last."""
    rows, nxt = [], 0
    for p in range(n_parents):
        n = {0: c, 3: 0}.get(p, int(rng.integers(max(1, c - 3), c + 1)))
        rows.append(np.concatenate([np.arange(nxt, nxt + n),
                                    np.full(c - n, -1)]))
        nxt += n
    children = np.stack(rows + [np.full(c, -1)]).astype(np.int32)
    lo = rng.uniform(-1.0, 0.5, size=(nxt, 2))
    size = rng.uniform(0.3, 1.5, size=(nxt, 2))
    boxes = np.stack([lo[:, 0], lo[:, 0] + size[:, 0],
                      lo[:, 1], lo[:, 1] + size[:, 1]], 1)
    boxes[rng.random(nxt) < 0.05] = (1.0, 0.0, 1.0, 0.0)         # empty
    boxes = np.concatenate([boxes, [(1.0, 0.0, 1.0, 0.0)]])
    return (torch.from_numpy(children),
            torch.from_numpy(boxes.astype(np.float32)))


def _points(rng, n, n_parents):
    """n points in [-1, 1.5]^2 with NaN, infinite and FAR rows, and their
    parents with about one in eight -1."""
    pts = rng.uniform(-1.0, 1.5, size=(n, 2)).astype(np.float32)
    odd = [(np.nan, 0.1), (0.1, np.nan), (FAR, FAR), (-FAR, 0.2),
           (np.inf, 0.3), (0.2, -np.inf)]
    pts[:len(odd)] = odd
    parent = rng.integers(0, n_parents, size=n).astype(np.int32)
    parent[rng.random(n) < 0.125] = -1
    return torch.from_numpy(pts), torch.from_numpy(parent)


@pytest.mark.parametrize("k", ["1", "4", "C+1"])
@pytest.mark.parametrize("c", WIDTHS)
def test_twin_equals_the_composition(c, k):
    """Count, pick and first k for C of one box, the county width of the
    small maps, one and two ballot steps, and the paper's 58 and 68;
    k = 1, 4 and past C; lost parents, padded and empty rows, NaN /
    infinite / FAR points and rows in more than k boxes."""
    k = c + 1 if k == "C+1" else int(k)
    rng = np.random.default_rng(100 * c + k)
    children, boxes = _tables(rng, c)
    pts, parent = _points(rng, 2000, children.shape[0] - 1)
    want = composed(pts, parent, children, boxes, k)
    for got in (ops.bbox_select_children(pts, parent, children, boxes, k),
                bbox.bbox_select_children(pts, parent, children, boxes, k),
                ref.bbox_select_children(pts, parent, children, boxes, k)):
        assert [g.dtype for g in got] == [torch.int32] * 3
        assert got[2].shape == (2000, min(k, c))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    cnt, pick, first = want
    assert (cnt[:6] == 0).all() and (pick[:6] == -1).all()
    assert (cnt[parent < 0] == 0).all() and (cnt[parent == 3] == 0).all()
    assert (children == -1).any(dim=1)[:-1].any()      # padded rows
    assert int(cnt.max()) > min(k, c) or k > c or c == 1
    if c >= 33:            # a pick in the second ballot step: slot >= 32
        row0 = children[torch.where(parent >= 0, parent, -1).long(), 0]
        assert ((pick >= 0) & (pick - row0 >= 32)).any()
    hit = cnt > 0
    assert (first[hit, 0] >= 0).all() and (first[~hit] == -1).all()


def test_cascade_takes_no_box_gather(synth_small, points_small, monkeypatch):
    """The county and block levels go through ``bbox_select_children``
    (twice a cascade) and never through ``bbox_count_select``, the
    gathered mask or ``topk`` of their candidates."""
    index = t_simple.SimpleIndex.from_census(synth_small.census,
                                             device="cpu")
    calls = {"select": 0}
    real = ops.bbox_select_children

    def select(*args, **kw):
        calls["select"] += 1
        return real(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("a box gather path was taken")
    monkeypatch.setattr(ops, "bbox_select_children", select)
    monkeypatch.setattr(ops, "bbox_count_select", refuse)
    monkeypatch.setattr(ops, "bbox_mask_gathered", refuse)
    sid, cid, bid, _ = t_simple.cascade_assign(
        index, torch.from_numpy(points_small[0]), t_simple.SimpleConfig())
    assert calls["select"] == 2
    assert (bid >= 0).float().mean() > 0.99


# ------------------------------------------------------------- on the card
@pytest.fixture(scope="module")
def paper_widths():
    """A two-state map at the paper's fan-out (58 counties a state, 68
    blocks a county) and one of 8 counties a state."""
    return {8: build_synth_census(seed=3, n_states=2, counties_per_state=8,
                                  blocks_per_county=24),
            68: build_synth_census(seed=0, n_states=2, counties_per_state=58,
                                   blocks_per_county=68)}


@pytest.mark.cuda
@pytest.mark.parametrize("level,c", [("county", 8), ("county", 58),
                                     ("block", 68)])
def test_cuda_kernel_equals_twin(cuda_device, paper_widths, level, c):
    """The kernel bit-equal to its twin on 2^20 points of the map's
    sampler, one in sixteen parents -1 and one in sixteen another
    parent's id, at k = 4 and k = 1; a second launch bit-equal."""
    sc = paper_widths[8 if c == 8 else 68]
    index = t_simple.SimpleIndex.from_census(sc.census, device=cuda_device)
    rng = np.random.default_rng(c)
    xy, _, cid, sid = sc.sample_points(rng, 1 << 20)
    parent = (sid if level == "county" else cid).copy()
    n_parents = sc.census.states.n_poly if level == "county" \
        else sc.census.counties.n_poly
    u = rng.random(parent.shape[0])
    parent[u < 1 / 16] = -1
    wrong = (u >= 1 / 16) & (u < 1 / 8)
    parent[wrong] = rng.integers(0, n_parents, int(wrong.sum()))
    children = getattr(index, f"{level}_children")
    boxes = getattr(index, f"{level}_bbox")
    assert children.shape[1] == c
    pts = torch.from_numpy(xy).to(cuda_device)
    par = torch.from_numpy(parent.astype(np.int32)).to(cuda_device)
    for k in (4, 1):
        _build.reset_launches()
        got = bbox.bbox_select_children(pts, par, children, boxes, k)
        assert _build.LAUNCHES["bbox_select_children"] == 1
        again = bbox.bbox_select_children(pts, par, children, boxes, k)
        want = ref.bbox_select_children(pts, par, children, boxes, k)
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(a, w)
        assert int(got[0].max()) > 1 and (got[1] >= 0).float().mean() > 0.8


@pytest.mark.cuda
def test_cuda_cascade_launches(cuda_device, paper_widths):
    """One ``cascade_assign`` on the card launches the new kernel twice,
    ``bbox_count_select`` never and ``bbox_mask`` once, and its ids and
    stats equal the CPU cascade's (the twins)."""
    sc = paper_widths[68]
    xy = sc.sample_points(np.random.default_rng(5), 1 << 16)[0]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        index = t_simple.SimpleIndex.from_census(sc.census, device=dev)
        _build.reset_launches()
        out[dev.type] = t_simple.cascade_assign(
            index, torch.from_numpy(xy).to(dev), t_simple.SimpleConfig())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
    assert launches["bbox_select_children"] == 2
    assert launches["bbox_count_select"] == 0
    assert launches["bbox_mask"] == 1
    for a, b in zip(out["cuda"][:3], out["cpu"][:3]):
        assert torch.equal(a.cpu(), b)
    for lvl, st in out["cuda"][3].items():
        assert {k: int(v) for k, v in st.items()} == \
            {k: int(v) for k, v in out["cpu"][3][lvl].items()}
