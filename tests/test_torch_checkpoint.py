"""Fault tolerance on the port, on the CPU: the checkpoint manager's
guarantees (only committed checkpoints count, keep-N, bf16 leaves bit for
bit, an async save that snapshots before it returns), the straggler monitor
against the reference's, and an in-process port of the reference's
``tests/test_fault_tolerance.py::test_preemption_resume_bit_exact``: a run
that fails at step 6 and resumes from its step-6 checkpoint ends bit for
bit where the uninterrupted run ends."""
import os
import threading

import numpy as np
import pytest
import torch

from repro.runtime import monitor as jmonitor
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.common import map_leaves, tree_leaves
from repro_torch.launch import train as train_cli
from repro_torch.runtime import monitor


def _bits(t):
    """A tensor's bits as an integer tensor (== would equate -0.0 and 0.0
    and fail on NaN)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float64: torch.int64}
    return t.detach().view(ints[t.dtype]) if t.dtype in ints else t.detach()


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 5, generator=g),
                       "layers": [{"b": torch.randn(4, generator=g)} for _ in range(2)]},
            "step": 7}


def test_only_committed_checkpoints_count(tmp_path, monkeypatch):
    """A stale ``tmp.*`` directory and a ``step_*`` one without COMMITTED
    (a crash mid-save) are neither listed nor restored; an async write that
    fails commits nothing, and ``wait()`` raises its error."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    assert mgr.restore(_tree()) == (None, None)
    mgr.save(3, _tree(3), blocking=True)
    save_pytree(str(tmp_path / "tmp.9.12345"), _tree(9))
    save_pytree(str(tmp_path / "step_8"), _tree(8))          # no COMMITTED
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_8", "tmp.9.12345"]
    assert mgr.all_steps() == [3] and mgr.latest_step() == 3
    got, extra = mgr.restore(_tree())
    assert extra == {"step": 3}
    for a, b in zip(tree_leaves(got), tree_leaves(_tree(3))):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)

    def full_disk(*args):
        raise OSError("no space left on device")
    monkeypatch.setattr(manager_mod, "_save_host", full_disk)
    mgr.save(10, _tree(10))
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr.wait()                                          # the error is raised once
    assert mgr.latest_step() == 3


def test_keep_n_collects_older_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 6):
        mgr.save(step, _tree(step), extra={"data": {"step": step}})
    mgr.wait()
    assert mgr.all_steps() == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    _, extra = mgr.restore(_tree(), step=4)
    assert extra == {"data": {"step": 4}, "step": 4}


def test_leaves_round_trip_bit_for_bit(tmp_path):
    """bf16 (saved as its uint16 bits), float32 with -0.0, NaN and
    subnormals, integer tensors, a generator's byte state, numpy arrays and
    Python numbers come back with their dtype, bits and requires_grad."""
    g = torch.Generator().manual_seed(1)
    special = torch.tensor([-0.0, float("nan"), 1e-40, float("inf"), 3.0])
    tree = {"bf16": (torch.randn(6, 7, generator=g) * 100).to(torch.bfloat16),
            "bf16_special": special.to(torch.bfloat16),
            "f32": torch.cat([special, torch.randn(9, generator=g)]).requires_grad_(),
            "i64": torch.arange(-3, 9), "rng": g.get_state(),
            "np": np.arange(5, dtype=np.int16), "step": 12, "lr": 0.5}
    save_pytree(str(tmp_path / "ck"), tree, extra={"data": {"step": 2}})
    like = map_leaves(tree, lambda path, a: (torch.zeros_like(a) if isinstance(a, torch.Tensor)
                                             else a * 0))
    like["f32"].requires_grad_()
    got, extra = load_pytree(str(tmp_path / "ck"), like)
    assert extra == {"data": {"step": 2}}
    for key in ("bf16", "bf16_special", "f32", "i64", "rng"):
        assert got[key].dtype == tree[key].dtype, key
        assert torch.equal(_bits(got[key]), _bits(tree[key])), key
    assert got["f32"].requires_grad and not got["bf16"].requires_grad
    np.testing.assert_array_equal(got["np"], tree["np"])
    assert got["np"].dtype == np.int16
    assert (got["step"], got["lr"]) == (12, 0.5) and type(got["step"]) is int
    with pytest.raises(KeyError, match="missing leaf"):
        load_pytree(str(tmp_path / "ck"), dict(like, extra=torch.zeros(1)))


def test_async_save_writes_the_values_before_an_in_place_update(tmp_path, monkeypatch):
    """The trainer's AdamW updates parameters in place, and on the CPU
    ``.cpu()``/``.numpy()`` are views of them: an async save must write the
    values it was given, even when the write runs after the update."""
    release = threading.Event()
    write = manager_mod._save_host

    def held_write(*args):
        assert release.wait(30)
        write(*args)

    monkeypatch.setattr(manager_mod, "_save_host", held_write)
    tree = _tree(4)
    before = map_leaves(tree, lambda path, a: a.clone() if isinstance(a, torch.Tensor) else a)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree)
    assert mgr.latest_step() is None                    # the write is held
    with torch.no_grad():
        for t in tree_leaves(tree["params"]):
            t.add_(1.0)
    release.set()
    mgr.wait()
    got, _ = mgr.restore(_tree())
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(before["params"])):
        assert torch.equal(_bits(a), _bits(b))


def test_straggler_monitor_flags_the_reference_tests_step(monkeypatch):
    """The reference test's timings (10 ms steps, 200 ms at step 6,
    threshold 3, warm-up 2), on a fake clock: both monitors flag step 6 and
    keep the same mean."""
    dts = [0.01 if step != 6 else 0.2 for step in range(8)]
    mons = {}
    for name, mod in (("port", monitor), ("reference", jmonitor)):
        clock = iter(np.cumsum([0.0] + [x for dt in dts for x in (dt, 1.0)]).tolist())
        monkeypatch.setattr(mod.time, "perf_counter", lambda clock=clock: next(clock))
        flagged = []
        mon = mod.StragglerMonitor(threshold=3.0, warmup_steps=2,
                                   on_straggler=lambda s, dt, mu: flagged.append(s))
        for step in range(8):
            mon.start()
            mon.stop(step)
        monkeypatch.undo()
        mons[name] = (flagged, mon.flagged, mon.mean)
    assert mons["port"][:2] == ([6], [6])
    assert mons["port"] == pytest.approx(mons["reference"])


def test_preemption_resume_bit_exact(tmp_path, capsys):
    """reduced wt103-47m-moe, 12 steps, checkpoints every 6; a run that
    fails at step 6 then resumes gives the uninterrupted run's losses and
    final state (parameters, AdamW moments and step, XL memories, the
    dropout generator) bit for bit. Dropout is on, so the generator's
    state has to come back."""
    common = ["--arch", "wt103-47m-moe", "--reduced", "--steps", "12", "--batch", "4",
              "--seq", "32", "--ckpt-every", "6", "--seed", "3", "--device", "cpu"]
    full = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        train_cli.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--fail-at-step", "6"])
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [6]
    capsys.readouterr()
    resumed = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert "[resume] restored step 6" in capsys.readouterr().out
    assert resumed["start_step"] == 6 and len(resumed["losses"]) == 6
    assert resumed["losses"] == full["losses"][6:]
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [6, 12]
    want = train_cli._checkpoint_tree(full["state"], torch.Generator())
    got = train_cli._checkpoint_tree(resumed["state"], torch.Generator())
    assert got["opt"]["step"] == want["opt"]["step"] == 12
    n = 0
    for a, b in zip(tree_leaves({k: got[k] for k in ("params", "opt", "mems")}),
                    tree_leaves({k: want[k] for k in ("params", "opt", "mems")})):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
            n += 1
    assert n > 100
    ck_a, _ = CheckpointManager(str(tmp_path / "a")).restore(want, step=12)
    ck_b, _ = CheckpointManager(str(tmp_path / "b")).restore(want, step=12)
    assert torch.equal(ck_a["rng"], ck_b["rng"])
