"""``build_model(ffn=)``, the FFN swap of the trainer's ``--ffn``, on the
port against the reference's: for every swap kind on every port arch, full
and reduced, the config equal field by field (and passing ``validate``),
and at full width the port's parameter count (on the meta device) equal to
the reference's (``jax.eval_shape`` of its init), so no full-size
parameter is allocated."""
import dataclasses
import math

import jax
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models.registry import build_model as jax_build_model
from repro_torch.common import tree_leaves
from repro_torch.configs import archs, reduced
from repro_torch.models import build_model

KINDS = ("sigma_moe", "topk", "pkm", "dense", "glu")
ARCHS = sorted(archs._REGISTRY)


def test_swapped_configs_match_reference():
    for arch in ARCHS:
        for kind in KINDS + (None,):
            for red in (False, True):
                cfg, jcfg = (reduced(arch), jax_reduced(arch)) if red else (arch, arch)
                got = build_model(cfg, ffn=kind).cfg
                want = jax_build_model(jcfg, ffn=kind).cfg
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, kind, red)
                got.ffn.validate()
                assert got.ffn.kind == (kind or got.ffn.kind)
    with pytest.raises(ValueError, match="cannot swap ffn to switch"):
        build_model("wt103-47m-dense", ffn="switch")


@pytest.mark.parametrize("kind", KINDS)
def test_swapped_parameter_counts_match_reference(kind):
    for arch in ARCHS:
        jlm = jax_build_model(arch, ffn=kind)
        shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
        want = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
        params = build_model(arch, ffn=kind).init(torch.Generator().manual_seed(0),
                                                 device="meta")
        assert sum(p.numel() for p in tree_leaves(params)) == want, arch
