"""The kernel builder's variants (no nvcc or card needed): a library built
with extra ``-D`` defines has a path of its own, the plain build's path is
the one it always was, and ``selected`` puts the variant behind
``load`` for a block only."""
import hashlib

from repro_torch.kernels import build


def test_variant_libraries_have_paths_of_their_own():
    plain = build._lib_path("flash_attention")
    src = (build.CSRC / build.SOURCES["flash_attention"]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(build.CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:12]
    assert plain.name == f"libflash_attention-{tag}.so"
    faults = [build._lib_path("flash_attention", (f"K7_FAULT={f}",)) for f in (1, 2)]
    assert len({plain, *faults}) == 3
    assert all(p.parent == plain.parent and "K7_FAULT" in p.name for p in faults)
    assert build._flags(("K7_FAULT=2",)) == (*build.NVCC_FLAGS, "-DK7_FAULT=2")


def test_selected_routes_load_to_the_variant_for_the_block(monkeypatch):
    built = []

    class Info:
        def __init__(self, defines):
            self.path = f"lib{'+'.join(defines)}.so"

    def fake_build(names, defines=()):
        built.append((tuple(names), tuple(defines)))
        return {names[0]: Info(defines)}

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("loaded", path))
    monkeypatch.setattr(build, "_LIBS", {})
    assert build.load("flash_attention") == ("loaded", "lib.so")
    with build.selected("flash_attention", ("K7_FAULT=1",)):
        assert build.load("flash_attention") == ("loaded", "libK7_FAULT=1.so")
        assert build.load("cvmm") == ("loaded", "lib.so")
    assert build.load("flash_attention") == ("loaded", "lib.so")
    assert build._SELECTED == {}
    assert built == [(("flash_attention",), ()), (("flash_attention",), ("K7_FAULT=1",)),
                     (("cvmm",), ())]
