"""The port's kernel-contract analyzer: clean on the tree with its sweeps
wide, and each seeded fault in a plan, a schedule's shared memory or a
work partition flagged."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import check, run_passes
from repro_torch.analysis.plans import verify_plan
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import cvmm as K

# facts each pass verifies on the tree today, less a margin: a sweep that
# shrinks below these no longer proves what it did
CHECK_FLOORS = {"plans": 200, "smem": 6000, "schedules": 600}


def test_analysis_cli_clean_on_the_tree(tmp_path):
    out = tmp_path / "report.json"
    assert check.main(["--all", "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and report["n_findings"] == 0
    for name, floor in CHECK_FLOORS.items():
        assert report["checks"][name] >= floor, (name, report["checks"])


def _plan():
    rng = np.random.RandomState(3)
    idx = torch.from_numpy(rng.randint(0, 5, size=(150, 2)))
    gates = torch.from_numpy(rng.rand(150, 2).astype(np.float32))
    return ops.make_moe_plan(idx, 5, gates), 150


def _corrupt_row_src():
    plan, n = _plan()
    rs = plan.row_src.clone()
    slack = int(np.setdiff1d(np.arange(plan.m_pad), plan.new_pos.numpy())[0])
    rs[slack] = 0                                # a slack slot reads row 0
    return verify_plan(dataclasses.replace(plan, row_src=rs), n)


def _duplicate_slot():
    plan, n = _plan()
    new_pos = plan.new_pos.clone()
    new_pos[1] = new_pos[0]
    return verify_plan(dataclasses.replace(plan, new_pos=new_pos), n)


def _wrong_tile_expert():
    plan, n = _plan()
    te = plan.tile_expert.clone()
    last0 = int(torch.nonzero(te == 0).max())    # expert 0's last tile, now expert 1's:
    te[last0] = 1                                # still sorted, no longer pure
    return verify_plan(dataclasses.replace(plan, tile_expert=te), n)


def _over_budget_candidate(monkeypatch):
    # a budget below K4's 256-wide items, and a tuner that no longer prunes
    # by shared memory: it offers a candidate that cannot launch
    budget = autotune.smem_bytes("row_gemm", {"kernel": "cvmm", "glu": 0, "save": 0},
                                 {"bn": 128})
    monkeypatch.setattr(autotune, "default_smem_budget", lambda hw=None: budget)
    monkeypatch.setattr(autotune, "smem_bytes", lambda family, shape, tiles: 0)
    return run_passes(["smem"]).findings


def _walk_drops_an_item(monkeypatch):
    walk = K.row_gemm_block_items

    def dropping(block, n_pad, schedule):
        items = walk(block, n_pad, schedule)
        return items[:-1] if block == 0 and len(items) > 1 else items

    monkeypatch.setattr(K, "row_gemm_block_items", dropping)
    return run_passes(["schedules"]).findings


@pytest.mark.parametrize("mutant,want", [
    (_corrupt_row_src, {"sentinel"}),
    (_duplicate_slot, {"slots-injective"}),
    (_wrong_tile_expert, {"tile-purity"}),
    (_over_budget_candidate, {"candidate-budget"}),
    (_walk_drops_an_item, {"coverage"}),
], ids=["row_src", "slot", "tile_expert", "over_budget", "dropped_item"])
def test_seeded_mutants_flagged(mutant, want, monkeypatch):
    args = (monkeypatch,) if mutant in (_over_budget_candidate, _walk_drops_an_item) else ()
    findings = mutant(*args)
    assert want <= {f.check for f in findings}, [str(f) for f in findings[:5]]
