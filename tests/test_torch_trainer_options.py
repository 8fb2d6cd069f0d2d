"""The trainer's new options on the port, on the CPU: ``--grad-accum 2
--grad-compression int8 --remat full`` on the reduced wt103-47m-moe runs
(XL memories of one microbatch, int8 residuals in the state); a run with
int8 compression that fails at step 6 and resumes from its checkpoint
ends bit for bit where the uninterrupted run ends (the residuals are in
the checkpoint); and at full width the parameter counts of the paper's
MoE baselines (chip_smoke.BASELINES on wt103-47m-moe) and of
``--ffn sigma_moe`` on wt103-47m-dense equal the reference's
(``jax.eval_shape`` of its init; the port's on the meta device) and
chip_smoke.PAPER_PARAMS."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.models.lm import LM as JaxLM
from repro.models.registry import build_model as jax_build_model
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common import tree_leaves
from repro_torch.configs import get_config
from repro_torch.kernels import cvmm as K
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model

ARCH = "wt103-47m-moe"


def _bits(t):
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.detach().view(ints[t.dtype]) if t.dtype in ints else t.detach()


def test_cli_runs_grad_accum_int8_and_remat(capsys):
    out = train_cli.main(["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "4",
                          "--seq", "16", "--device", "cpu", "--grad-accum", "2",
                          "--grad-compression", "int8", "--remat", "full"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["launches"] == [dict.fromkeys(K.LAUNCHES, 0)] * 3      # plain on CPU
    state = out["state"]
    mems = tree_leaves(state["mems"])
    assert mems and all(m.shape[0] == 2 for m in mems)                # one microbatch
    err = tree_leaves(state["err"])
    assert len(err) == len(tree_leaves(state["params"])) and any(e.any() for e in err)
    assert "grad accum 2, compression int8, remat full" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not split"):
        train_cli.main(["--arch", ARCH, "--reduced", "--steps", "1", "--batch", "3",
                        "--seq", "16", "--device", "cpu", "--grad-accum", "2"])


def test_resume_with_int8_compression_is_bit_exact(tmp_path, capsys):
    """As tests/test_torch_checkpoint.py's resume, with int8 compression
    and dropout on: the residuals, like every other leaf, come back."""
    common = ["--arch", ARCH, "--reduced", "--steps", "8", "--batch", "4", "--seq", "16",
              "--ckpt-every", "4", "--seed", "3", "--device", "cpu",
              "--grad-compression", "int8"]
    full = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        train_cli.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--fail-at-step", "4"])
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [4]
    capsys.readouterr()
    resumed = train_cli.main(common + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert "[resume] restored step 4" in capsys.readouterr().out
    assert resumed["losses"] == full["losses"][4:]
    want = train_cli._checkpoint_tree(full["state"], torch.Generator())
    got = train_cli._checkpoint_tree(resumed["state"], torch.Generator())
    assert set(got) == set(want) and "err" in got
    n = 0
    for key in ("params", "opt", "err", "mems"):
        for a, b in zip(tree_leaves(got[key]), tree_leaves(want[key])):
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), key
                n += 1
    assert n > 150


@pytest.mark.parametrize("name", ["sbase", "noisy_topk", "switch", "--ffn sigma_moe"])
def test_new_full_size_parameter_counts_match_reference(name):
    if name.startswith("--ffn"):
        key = "wt103-47m-dense --ffn sigma_moe"
        lm = build_model("wt103-47m-dense", ffn="sigma_moe")
        jlm = jax_build_model("wt103-47m-dense", ffn="sigma_moe")
        assert lm.cfg.ffn.dispatch == "einsum" and lm.cfg.ffn.n_experts == 16
    else:
        key = f"{ARCH} {name}"
        cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
        lm = build_model(cfg.with_ffn(dataclasses.replace(cfg.ffn,
                                                          **chip_smoke.BASELINES[name])))
        jlm = JaxLM(jcfg.with_ffn(dataclasses.replace(jcfg.ffn,
                                                      **chip_smoke.BASELINES[name])))
        assert lm.cfg.ffn.kind == name
    assert dataclasses.asdict(lm.cfg) == dataclasses.asdict(jlm.cfg)
    lm.cfg.ffn.validate()
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    want = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
    params = lm.init(torch.Generator().manual_seed(0), device="meta")
    assert sum(p.numel() for p in tree_leaves(params)) == want == chip_smoke.PAPER_PARAMS[key]
