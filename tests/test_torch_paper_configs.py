"""The paper's six configs on the port (Tab. 8/9: the parameter-equal
dense/sigma-MoE pairs at 47M and 262M on WikiText-103 and at 41M on
enwik8): each equal to the reference's field by field, full and reduced,
and the port's parameter count equal to the reference's. The port counts
on the meta device and the reference through ``jax.eval_shape``, so no
full-size parameter is allocated."""
import dataclasses
import math

import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.lm import LM as JaxLM
from repro_torch.common import tree_leaves
from repro_torch.configs import get_config, reduced
from repro_torch.models import LM

# The reference's counts (jax.eval_shape of its LM.init).
PARAMS = {"wt103-47m-dense": 47_370_872, "wt103-47m-moe": 47_410_424,
          "wt103-262m-dense": 262_772_736, "wt103-262m-moe": 262_846_464,
          "enwik8-41m-dense": 41_518_080, "enwik8-41m-moe": 41_554_944}


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_paper_config_and_parameter_count_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(reduced(arch)) == dataclasses.asdict(jax_reduced(arch))
    shapes = jax.eval_shape(JaxLM(jax_get_config(arch)).init, jax.random.PRNGKey(0))
    want = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
    params = LM(get_config(arch)).init(torch.Generator().manual_seed(0), device="meta")
    assert all(p.is_meta for p in tree_leaves(params))
    got = sum(p.numel() for p in tree_leaves(params))
    assert got == want == PARAMS[arch]
