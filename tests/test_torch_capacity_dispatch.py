"""The capacity ("einsum") dispatch on the port against the reference's
pure-JAX ``_einsum_path``, on the CPU: the output, the dropped fraction,
the pack's integer fields (bit-equal) and the gradients in the tokens,
the expert weights and the gates, at capacity factor 1.25 on skewed
routing (tokens drop), at 0.25 (the reference's
``test_capacity_drops_reported`` case) and with GLU experts; and the
einsum dispatch equal to the sort dispatch when nothing drops (the
reference's ``test_sort_equals_einsum_without_drops``). float32, seeded
numpy inputs; tolerances 1e-5 for outputs, 2e-4 for gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import moe_ffn as jax_moe_ffn
from repro.core import dispatch as jdispatch
from repro.core.routing import SelectionInfo as JaxSelectionInfo
from repro_torch.configs import moe_ffn
from repro_torch.core import dispatch, moe
from repro_torch.core.routing import SelectionInfo
from repro_torch.sharding import Mesh, mesh_context

N, D, E, G, K = 48, 32, 6, 16, 2


def _case(seed, glu):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    # skewed routing: expert 0 is every token's first choice
    idx = np.stack([np.zeros(N, np.int32), rng.integers(1, E, N).astype(np.int32)], 1)
    gates = rng.uniform(0.1, 1.0, (N, K)).astype(np.float32)
    ws = {"we1": rng.standard_normal((E, D, G)) * D ** -0.5,
          "we2": rng.standard_normal((E, G, D)) * G ** -0.5}
    if glu:
        ws["we1g"] = rng.standard_normal((E, D, G)) * D ** -0.5
    cot = rng.standard_normal((N, D)).astype(np.float32)
    return x, idx, gates, {k: v.astype(np.float32) for k, v in ws.items()}, cot


@pytest.mark.parametrize("factor,glu", [(1.25, False), (0.25, False), (1.25, True)],
                         ids=["1.25-skewed", "0.25", "1.25-glu"])
def test_einsum_path_matches_reference(factor, glu):
    x, idx, gates, ws, cot = _case(0, glu)
    kw = dict(dispatch="einsum", capacity_factor=factor, glu_experts=glu,
              activation="silu" if glu else "relu")
    cfg, jcfg = moe_ffn(E, G, K, **kw), jax_moe_ffn(E, G, K, **kw)
    names = sorted(ws)

    def jrun(x, g, *w):
        info = JaxSelectionInfo(probs=None, sel=None, idx=jnp.asarray(idx), gates=g)
        y, dropped = jdispatch._einsum_path(dict(zip(names, w)), x, jcfg, info, E)
        return jnp.sum(y * cot), (y, dropped)

    (_, (jy, jdropped)), jgrads = jax.value_and_grad(
        jrun, argnums=tuple(range(2 + len(names))), has_aux=True)(
        jnp.asarray(x), jnp.asarray(gates), *(jnp.asarray(ws[n]) for n in names))
    ins = [torch.from_numpy(a).requires_grad_() for a in [x, gates] + [ws[n] for n in names]]
    info = SelectionInfo(probs=None, sel=None, idx=torch.from_numpy(idx).long(), gates=ins[1])
    y, dropped = dispatch._einsum_path(dict(zip(names, ins[2:])), ins[0], cfg, info, E)
    (y * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    assert float(jdropped) > 0.0                            # expert 0 overflows
    np.testing.assert_allclose(float(dropped), float(jdropped), rtol=1e-6)
    assert dropped.dtype == torch.float32
    for name, t, jg in zip(["x", "gates"] + names, ins, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=2e-4, rtol=2e-4,
                                   err_msg=name)
    cap = dispatch._capacity(N, K, E, factor)
    assert cap == jdispatch._capacity(N, K, E, factor)
    buf, meta = dispatch._pack_capacity(torch.from_numpy(x), info, E, cap)
    jbuf, jmeta = jdispatch._pack_capacity(
        jnp.asarray(x), JaxSelectionInfo(None, None, jnp.asarray(idx), jnp.asarray(gates)),
        E, cap)
    for got, want in zip(meta, jmeta):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_allclose(float(dropped), 1.0 - int(meta[3].sum()) / (N * K),
                               rtol=1e-6)


def test_einsum_equals_sort_without_drops_and_shard_map_raises():
    """apply_moe with dispatch "einsum" at capacity factor 16 (nothing
    drops) equals the dropless sort dispatch, outputs and gradients;
    "shard_map" with no mesh is the capacity path, as in the reference, and
    on a mesh of two ranks with no "model" axis it falls back to the
    capacity path, which raises there and names ROADMAP queue 1 item 8."""
    cfg = moe_ffn(8, G, K, dispatch="sort", n_shared_experts=1)
    params = moe.init_moe(torch.Generator().manual_seed(1), D, cfg, 4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 10, D)).astype(
        np.float32))
    outs = []
    for c in (cfg, dataclasses.replace(cfg, dispatch="einsum", capacity_factor=16.0)):
        ps = {k: v.clone().requires_grad_() for k, v in params.items()}
        xs = x.clone().requires_grad_()
        y, aux = moe.apply_moe(ps, xs, c)
        (y.square().sum() + aux["moe_reg"]).backward()
        outs.append((y.detach(), float(aux["moe_dropped"]), xs.grad,
                     {k: v.grad for k, v in ps.items()}))
    (ys, ds, gxs, gs), (ye, de, gxe, ge) = outs
    np.testing.assert_allclose(ye.numpy(), ys.numpy(), atol=1e-5, rtol=1e-5)
    assert ds == de == 0.0
    np.testing.assert_allclose(gxe.numpy(), gxs.numpy(), atol=2e-4, rtol=2e-4)
    for name in gs:
        np.testing.assert_allclose(ge[name].numpy(), gs[name].numpy(), atol=2e-4,
                                   rtol=2e-4, err_msg=name)
    roomy = dataclasses.replace(cfg, dispatch="einsum", capacity_factor=16.0)
    with torch.no_grad():
        ysm, auxsm = moe.apply_moe(params, x, dataclasses.replace(roomy, dispatch="shard_map"))
        ycap, _ = moe.apply_moe(params, x, roomy)
    assert torch.equal(ysm, ycap) and float(auxsm["moe_dropped"]) == 0.0
    two_ranks = Mesh(axis_names=("data",), shape={"data": 2}, coords={"data": 0})
    with pytest.raises(NotImplementedError, match="queue 1 item 8"), mesh_context(two_ranks):
        moe.apply_moe(params, x, dataclasses.replace(cfg, dispatch="shard_map"))
