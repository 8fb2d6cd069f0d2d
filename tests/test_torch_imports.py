"""Import hygiene of the PyTorch port: it never imports jax or the JAX
package, its modules import cleanly without a card, and its config copy
equals the reference's field by field."""
import ast
import dataclasses
import importlib
from pathlib import Path

import pytest

from repro.configs import OptimizerConfig as JaxOptimizerConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro_torch.configs import OptimizerConfig, get_config, reduced

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
