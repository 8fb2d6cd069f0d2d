"""The port's device mesh on ``torch.distributed`` against the reference's
``launch/mesh.py`` and ``sharding/context.py``, on the CPU: the axis
layouts, ``mesh_context``/``axis_size``/``current_mesh``, the world-size
checks, ``make_local_mesh`` on 4 gloo ranks (model=2: the axis shapes and
each axis group's members; model=3: the reference's divisor error, word for
word), and the collectives' forward and backward on 2 ranks. The ranks run
``tests/torch_mesh_ranks.py`` and are killed after 120 s."""
import json
import types

import jax
import pytest

from repro.launch import mesh as jax_mesh
from repro.sharding import context as jax_context
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding import Mesh, axis_size, current_mesh, mesh_context
from torch_mesh_ranks import collectives_body, local_mesh_body, run_ranks


def test_axis_layouts_equal_the_reference():
    assert mesh_mod.MESH_AXIS_LAYOUTS == jax_mesh.MESH_AXIS_LAYOUTS


def test_mesh_context_and_axis_size_as_the_reference():
    """Nested contexts restore the outer mesh, and axis_size reads a named
    axis or gives 1, with the reference's functions on the same stand-in."""
    outer = Mesh(axis_names=("data", "model"), shape={"data": 2, "model": 3},
                 coords={"data": 1, "model": 2})
    inner = types.SimpleNamespace(axis_names=("model",), shape={"model": 5})
    for ctx, size, current in ((mesh_context, axis_size, current_mesh),
                               (jax_context.mesh_context, jax_context.axis_size,
                                jax_context.current_mesh)):
        assert current() is None and size("model") == 1
        with ctx(outer):
            assert current() is outer
            assert [size(a) for a in ("data", "model", "pod")] == [2, 3, 1]
            with ctx(inner):
                assert size("model") == 5 and size("data") == 1
            assert current() is outer
        assert current() is None
    assert outer.index == 5 and outer.size == 6


def test_one_process_mesh_and_world_size_checks():
    """Without a launcher the world is one process: a 1x1 mesh has no
    process group; any larger mesh, and the production meshes, raise."""
    one = mesh_mod.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert one.shape == {"data": 1, "model": 1} and one.groups == {} and one.index == 0
    assert one.group() is None and one.group("model") is None
    assert mesh_mod.make_local_mesh(device="cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 1"):
        mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")


def test_local_mesh_on_four_ranks(tmp_path, monkeypatch):
    run_ranks(local_mesh_body, 4, tmp_path, str(tmp_path))
    # the reference's error for 4 devices and model=3
    monkeypatch.setattr(jax, "devices", lambda *a: [object()] * 4)
    with pytest.raises(ValueError) as want:
        jax_mesh.make_local_mesh(model=3)
    for rank in range(4):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        d, m = divmod(rank, 2)
        assert got["shape"] == {"data": 2, "model": 2}
        assert got["coords"] == {"data": d, "model": m} and got["index"] == rank
        # sums of 2**rank over each group: its members
        assert got["members"] == {"model": 3 << 2 * d, "data": 5 << m, "all": 15}
        assert got["sizes"] == {"data": 2, "model": 2, "pod": 1}
        assert got["inside"] and got["outside"]
        assert got["error"] == str(want.value)


def test_collectives_forward_and_backward_on_two_ranks(tmp_path):
    """all_to_all's backward is the inverse exchange; all_reduce_sum and
    pmean pass the cotangent through; each call is counted; the batch
    reductions and global_draw equal one process's on the whole batch
    (the asserts run in the ranks)."""
    run_ranks(collectives_body, 2, tmp_path, str(tmp_path))
    for rank in range(2):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        # 2 all_to_alls, 2 autograd all-reduces, then batch_mean, batch_sum,
        # batch_count and batch_logsumexp's two
        assert got["calls"] == {"all_to_all": 2, "all_reduce": 7}
