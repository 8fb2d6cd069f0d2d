"""The sizing of K3's and K5's split over row tiles (`cvmm.dw_split`),
checked on the CPU against a Python mirror of the item map that
csrc/dw_gemm.cuh builds on the device. The kernels themselves are held
against their plain versions in tests/test_torch_cuda.py."""
import numpy as np
import pytest

from repro_torch.kernels import cvmm as K


def _split_items(te, n_experts, chunk):
    """csrc/dw_gemm.cuh's find_item for every item q of the grid that
    dw_split sizes: (q, expert, first tile, end tile, chunk k of count,
    partial slot) for each item with work; an empty expert's zeros have
    first tile == end tile."""
    n_items, _ = K.dw_split(len(te), n_experts, chunk)
    nb = -(-len(te) // chunk)
    items = []
    for q in range(n_items):
        e = te[q * chunk] if q < nb else q - nb
        lo, hi = sum(t < e for t in te), sum(t <= e for t in te)
        if q < nb:
            t0, t1 = q * chunk, min(hi, q * chunk + chunk)
        elif lo == hi:
            items.append((q, e, 0, 0, 0, 1, None))
            continue
        elif lo % chunk == 0:
            continue
        else:
            t0, t1 = lo, min(hi, (lo // chunk + 1) * chunk)
        items.append((q, e, t0, t1, t0 // chunk - lo // chunk,
                      (hi - 1) // chunk - lo // chunk + 1,
                      2 * (t0 // chunk) + (t0 % chunk != 0)))
    return items


def _random_layout(seed):
    rng = np.random.default_rng(seed)
    e = int(rng.integers(2, 41))
    counts = rng.integers(0, 12, size=e) * (rng.random(e) > 0.3)  # some empty
    counts[-1] += 1 + int(rng.integers(0, 4))   # trailing slack tiles go to the last
    return np.repeat(np.arange(e), counts).tolist(), e


SPLIT_LAYOUTS = {
    "random_0": _random_layout(0), "random_1": _random_layout(1),
    "random_2": _random_layout(2), "random_3": _random_layout(3),
    "all_tiles_on_one_expert": ([0] * 37, 1),
    "all_tiles_on_one_expert_of_many": ([5] * 23, 9),
    "every_expert_one_tile": (list(range(40)), 40),
    "empty_experts": ([1, 1, 1, 1, 1, 4, 4, 6, 6, 6, 6, 6, 6, 6, 6, 6], 8),
}


@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("layout", SPLIT_LAYOUTS)
def test_dw_split_sizes_a_grid_that_covers_every_tile(layout, chunk):
    te, n_experts = SPLIT_LAYOUTS[layout]
    n_items, n_slots = K.dw_split(len(te), n_experts, chunk)
    tiles = np.bincount(te, minlength=n_experts)
    assert n_items >= sum(-(-int(t) // chunk) for t in tiles)
    items = _split_items(te, n_experts, chunk)
    covered = [0] * len(te)
    chunks, zeros = {}, []
    for q, e, t0, t1, k, count, slot in items:
        assert 0 <= q < n_items and 0 <= e < n_experts
        if t0 == t1:
            zeros.append(e)
            continue
        assert t1 - t0 <= chunk and all(te[t] == e for t in range(t0, t1))
        for t in range(t0, t1):
            covered[t] += 1
        chunks.setdefault(e, []).append((k, count, slot))
    assert covered == [1] * len(te)                      # every tile exactly once
    assert sorted(zeros) == [e for e in range(n_experts) if tiles[e] == 0]
    slots = []
    for e, cs in chunks.items():
        assert sorted(k for k, _, _ in cs) == list(range(len(cs)))
        assert {count for _, count, _ in cs} == {len(cs)}
        if len(cs) > 1:                                  # partials in scratch
            slots += [slot for _, _, slot in cs]
    assert len(set(slots)) == len(slots) and all(0 <= s < n_slots for s in slots)
