"""Import hygiene of the PyTorch port: it never imports jax or the JAX
package, its modules import cleanly without a card, and its config copy
equals the reference's field by field (the FFN config's kinds, impls,
derived PKM properties and ``validate`` too)."""
import ast
import dataclasses
import importlib
from pathlib import Path

import pytest

from repro.configs import FFNConfig as JaxFFNConfig
from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.configs import archs as jax_archs
from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro_torch.configs import FFNConfig, OptimizerConfig, archs, get_config, reduced
from repro_torch.configs.base import FFN_IMPLS, FFN_KINDS
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_modules_import_without_a_card():
    pkg = ROOT / "src" / "repro_torch"
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(pkg.parent).with_suffix("")
        name = ".".join(p for p in rel.parts if p != "__init__")
        importlib.import_module(name)


@pytest.mark.parametrize("make", [
    lambda get, red: get("granite-moe-3b-a800m"),
    lambda get, red: red("granite-moe-3b-a800m"),
], ids=["full", "reduced"])
def test_config_copy_matches_reference(make):
    assert (dataclasses.asdict(make(get_config, reduced))
            == dataclasses.asdict(make(jax_get_config, jax_reduced)))


@pytest.mark.parametrize("arch", ["wt103-47m-dense", "wt103-47m-moe"])
@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_training_config_copies_match_reference(arch, reduce):
    get, jget = (reduced, jax_reduced) if reduce else (get_config, jax_get_config)
    assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))


def test_optimizer_config_copy_matches_reference():
    assert (dataclasses.asdict(OptimizerConfig())
            == dataclasses.asdict(JaxOptimizerConfig()))


def _validates(cfg) -> bool:
    try:
        cfg.validate()
    except AssertionError:
        return False
    return True


def test_ffn_config_copy_matches_reference():
    assert (FFN_KINDS, FFN_IMPLS) == (jax_base.FFN_KINDS, jax_base.FFN_IMPLS)
    cases = [dict(kind="pkm", n_subkeys=45), dict(kind="pkm", n_subkeys=8, pkm_knn=4,
                                                  n_candidates=6),
             dict(kind="pkm", n_subkeys=8, pkm_knn=4, n_candidates=3),
             dict(kind="pkm", n_subkeys=8, pkm_knn=4, n_candidates=9),
             dict(kind="pkm", n_subkeys=8, d_ff=60), dict(kind="pkm", n_subkeys=1),
             dict(kind="topk", d_ff=96, topk_k=16), dict(kind="topk"),
             dict(kind="sigma_moe"), dict(kind="sigma_moe", n_experts=4, expert_size=8, k=2),
             dict(kind="nope"), dict(kind="dense", d_ff=8, impl="nope")]
    for kw in cases:
        cfg, jcfg = FFNConfig(**kw), JaxFFNConfig(**kw)
        assert (cfg.n_values, cfg.pkm_candidates) == (jcfg.n_values, jcfg.pkm_candidates)
        assert _validates(cfg) == _validates(jcfg), kw


def test_reduced_pkm_branch_matches_reference(monkeypatch):
    """No registered arch uses PKM, so one is registered in both packages
    for the test: wt103-47m-dense with its FFN swapped to PKM."""
    cfg = build_model("wt103-47m-dense", ffn="pkm").cfg
    monkeypatch.setitem(archs._REGISTRY, "pkm-test", lambda: cfg)
    monkeypatch.setitem(jax_archs._REGISTRY, "pkm-test",
                        lambda: jax_get_config("wt103-47m-dense").with_ffn(
                            JaxFFNConfig(**dataclasses.asdict(cfg.ffn))))
    got, want = reduced("pkm-test"), jax_reduced("pkm-test")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ffn.kind == "pkm" and got.ffn.n_subkeys == 8 and _validates(got.ffn)
