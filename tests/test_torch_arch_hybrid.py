"""The reference's attention-free, hybrid and encoder-decoder
architectures on the port, as ``test_torch_arch_dense.py`` checks the
others (forward logits, loss and gradients, contiguous-cache prefill and
decode, against the reference at the reduced size in float32):
mamba2-370m (SSD blocks only; 70 tokens over chunks of 32, the last one
padded), zamba2-7b (5 SSD blocks and one slot of the shared
attention + GLU block, whose weights cross over as one set) and
whisper-tiny (2 encoder layers over 32 frames, 3 decoder layers with
learned positions and cross-attention). Then the serving caches'
contract: the contiguous cache takes learned positions, SSM states and
the encoder's cross caches, and the paged pool refuses, as the
reference's does, learned positions, encoder-decoder models, vision
prefixes and SSM mixers."""
import jax
import numpy as np
import pytest

from repro.configs import reduced as jax_reduced
from repro.models.lm import LM as JaxLM
from repro_torch.configs import reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import LM
from test_torch_arch_dense import check_arch


@pytest.mark.parametrize("arch,seq", [("mamba2-370m", 70), ("zamba2-7b", 70),
                                      ("whisper-tiny", 40)])
def test_reduced_arch_matches_reference(arch, seq):
    check_arch(arch, seq=seq)


def test_shared_block_crosses_over_as_one_set():
    """zamba2's shared attention + GLU: one set of weights in the port, the
    reference's ``stack["shared"]`` as it is; its slot holds no weights of
    its own but a KV cache of its own."""
    cfg = reduced("zamba2-7b").override(dtype="float32", n_layers=12)
    jparams = JaxLM(jax_reduced("zamba2-7b").override(dtype="float32", n_layers=12)).init(
        jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    np.testing.assert_array_equal(params["stack"]["shared"]["attn"]["wq"].numpy(),
                                  np.asarray(jparams["stack"]["shared"]["attn"]["wq"]))
    seg = params["stack"]["segments"][0]
    assert len(seg["e0"]) == 2 and seg["e5"] == [{}, {}]
    cache = LM(cfg).init_cache(1, 8, device="cpu")["segments"][0]
    assert set(cache["e5"][0]) == {"self"} and set(cache["e0"][0]) == {"ssm"}
    assert cache["e5"][0]["self"]["k"] is not cache["e5"][1]["self"]["k"]


def test_paged_pool_refuses_what_the_reference_refuses():
    """The paged pool raises where the reference's does (a decoder-only
    whisper stands for learned positions without an encoder); the
    contiguous cache of each is made."""
    cases = [("whisper-tiny", "encoder-decoder"), ("pixtral-12b", "vision prefix"),
             ("mamba2-370m", "ssm mixers"), ("zamba2-7b", "ssm mixers"),
             ("whisper-decoder", "pos_encoding='learned'")]
    for arch, match in cases:
        def get(red):
            if arch == "whisper-decoder":
                return red("whisper-tiny").override(is_encoder_decoder=False)
            return red(arch)
        jlm, lm = JaxLM(get(jax_reduced)), LM(get(reduced))
        with pytest.raises(NotImplementedError, match=match):
            jlm.init_paged_cache(9, 8)
        with pytest.raises(NotImplementedError, match=match):
            lm.init_paged_cache(9, 8, device="cpu")
        assert lm.init_cache(1, 8, device="cpu")["segments"], arch
