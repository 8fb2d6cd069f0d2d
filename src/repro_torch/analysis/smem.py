"""Shared memory of every launch the tuner can emit (the reference's
``analysis/vmem.py``, for Hopper's shared memory).

A launch whose shared memory passes the opt-in limit does not run: the
launcher's ``cudaFuncSetAttribute`` fails, or the kernel's ring is cut
below what its mainloop assumes. The CUDA sources size each instance at
compile time; this pass proves, on the CPU, that every schedule
``kernels/autotune.py`` can return (``enumerate_candidates``, heuristic and
tuned) lands on an instance that fits ``smem_block_bytes`` of every
hardware model in ``roofline/analysis.py``.

The proof uses ``launch_inventory``, which itemises each instance's
shared memory from its source (each entry names its declaration): the
ring's stages times the tile bytes, the epilogue's staging, the alignment
slack, and the static mbarriers and scalars. It is the one account of a
launch's shared memory: the tuner prunes its candidates by it
(``autotune.smem_bytes``), and ``chip_smoke.py`` holds it to the card:
each source exports a query of the dynamic bytes its launcher requests
and of the kernel's static bytes, and both must equal this inventory for
every instance.

K6 keeps no shared memory (each warp copies its slice of a row through
registers). The float32 bodies use static arrays only, at one fixed tile,
and take no tuned schedule but K3's and K5's chunk, which does not change
their memory.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..kernels import autotune
from ..kernels import flash_attention as K7
from ..roofline.analysis import CPU_STANDIN, H100
from .report import Finding

HARDWARE_MODELS = (H100, CPU_STANDIN)
ROW_GEMM_KERNELS = ("fused_w1", "fused_w2", "cvmm")
DW_KERNELS = ("dw_streamed", "cvmm_dw")
# The bf16 instances' compile-time budgets and ring limits (the sources'
# ws::BUDGET, the STAGES caps and the static_asserts on the minimum depth)
ROW_GEMM_BUDGET, ROW_GEMM_MAX_STAGES, ROW_GEMM_MIN_STAGES = 232448 - 2048, 5, 3
FLASH_BUDGET, FLASH_MAX_STAGES, FLASH_MIN_STAGES = 232448 - 1024, 4, 2
DW_STAGES = 4


def _bad(check: str, location: str, detail: str) -> Finding:
    return Finding("smem", check, location, detail)


Items = List[Tuple[str, int]]


def _row_gemm_ring(bn: int, glu: bool, save: bool) -> Tuple[int, int, int]:
    """(stages, bytes a stage, staging bytes) of ws::Shape<BN, GLU, SAVE>:
    as many stages as the budget leaves after the staging, at most 5."""
    stage = 128 * 64 * 2 + (1 + glu) * 64 * bn * 2
    staging = (1 + save + (save and glu)) * 2 * 64 * (bn * 2 + 16)
    return min(ROW_GEMM_MAX_STAGES, (ROW_GEMM_BUDGET - staging) // stage), stage, staging


def _flash_ring(d: int, bk: int) -> Tuple[int, int]:
    """(stages, head columns in shared memory) of ws::Shape<D, BK>."""
    dp = -(-d // 64) * 64
    return min(FLASH_MAX_STAGES, (FLASH_BUDGET - 128 * dp * 2) // (2 * bk * dp * 2)), dp


def _aligned(items: Items) -> Items:
    """Static shared memory with the compiler's padding to 16 bytes."""
    total = sum(n for _, n in items)
    pad = -total % 16
    return items + [("padding of the static block to 16 bytes", pad)] if pad else items


def launch_inventory(kernel: str, inst: Dict[str, int]) -> Tuple[Items, Items]:
    """(dynamic, static) shared memory of one bf16 instance of ``kernel``,
    each a list of (what, bytes). ``inst`` names the instance: ``bn``,
    ``glu``, ``save`` for K1/K2/K4; ``d``, ``bk`` for K7; nothing for K3/K5
    and K6."""
    if kernel in ROW_GEMM_KERNELS:
        # csrc/row_gemm.cuh, ws::Shape<BN, GLU, SAVE> and row_gemm_wgmma
        bn, glu, save = inst["bn"], bool(inst["glu"]), bool(inst["save"])
        nw, nout = 1 + glu, 1 + save + (save and glu)
        a_tile, w_tile = 128 * 64 * 2, 64 * bn * 2
        stages, _, staging = _row_gemm_ring(bn, glu, save)
        return ([(f"ring: {stages} stages x (A 128 x 64 bf16 + {nw} x W 64 x {bn} bf16)",
                  stages * (a_tile + nw * w_tile)),
                 (f"output staging: {nout} x 2 warpgroups x 64 rows x ({bn} bf16 + 16 B)",
                  staging),
                 ("the ring's alignment to 1,024 bytes", 1024)],
                _aligned([(f"mbarriers full[{stages}], empty[{stages}]", 2 * stages * 8)]))
    if kernel in DW_KERNELS:
        # csrc/dw_gemm.cuh, namespace tc and dw_bf16
        operand = 64 * 128 * 2
        return ([(f"ring: {DW_STAGES} stages x (A + B, 64 rows x 128 bf16 each)",
                  DW_STAGES * 2 * operand),
                 ("the ring's alignment to 1,024 bytes", 1024)],
                _aligned([(f"mbarriers full[{DW_STAGES}], empty[{DW_STAGES}]",
                           2 * DW_STAGES * 8), ("combine: red[32], last_s", 33 * 4)]))
    if kernel == "flash_attention":
        # csrc/flash_attention.cu, ws::Shape<D, BK> and flash_fwd_bf16
        d, bk = inst["d"], inst["bk"]
        stages, dp = _flash_ring(d, bk)
        q_tile, kv = 128 * dp * 2, bk * dp * 2
        return ([(f"Q: 128 packed rows x {dp} bf16", q_tile),
                 (f"ring: {stages} stages x (K + V, {bk} keys x {dp} bf16 each)",
                  stages * 2 * kv),
                 ("alignment to 1,024 bytes", 1024)],
                _aligned([(f"mbarriers full[{stages}], empty[{stages}]", 2 * stages * 8),
                          ("last_s", 4)]))
    if kernel == "gather_rows":
        return [], []
    raise ValueError(f"unknown kernel {kernel!r}")


def ring_stages(kernel: str, inst: Dict[str, int]) -> int:
    """The ring depth of one K1/K2/K4 or K7 instance."""
    if kernel == "flash_attention":
        return _flash_ring(inst["d"], inst["bk"])[0]
    return _row_gemm_ring(inst["bn"], bool(inst["glu"]), bool(inst["save"]))[0]


def launch_bytes(kernel: str, inst: Dict[str, int]) -> Tuple[int, int]:
    """(dynamic, static) bytes of one instance."""
    dyn, stat = launch_inventory(kernel, inst)
    return sum(n for _, n in dyn), sum(n for _, n in stat)


def instances():
    """Every bf16 instance the sources build: (kernel, inst)."""
    for kernel in ROW_GEMM_KERNELS:
        for (glu, save), widths in autotune.ROW_GEMM_WIDTHS.items():
            if kernel != "fused_w1" and (glu or save):
                continue
            for bn in widths:
                yield kernel, {"bn": bn, "glu": int(glu), "save": int(save)}
    for kernel in DW_KERNELS:
        yield kernel, {}
    for d in K7.HEAD_DIMS:
        for bk in autotune.FLASH_BK:
            yield "flash_attention", {"d": d, "bk": bk}
    for vpl in autotune.GATHER_VPL:
        yield "gather_rows", {"vpl": vpl}


def launch_instance(family: str, shape: Dict[str, int], tiles: Dict[str, int]):
    """The (kernel, inst) one launch of ``family`` runs."""
    if family == "row_gemm":
        return shape["kernel"], {"bn": tiles["bn"], "glu": int(shape["glu"]),
                                 "save": int(shape["save"])}
    if family == "dw_split":
        return shape["kernel"], {}
    if family == "flash":
        return "flash_attention", {"d": shape["d"], "bk": shape["bk"]}
    return "gather_rows", {"vpl": tiles["vpl"]}


def shape_grid(family: str):
    """Shapes the main paths give each family (serving decode and prefill,
    the 47M and 262M training steps, the PKM and K7 cases), and edges."""
    sms = H100.n_sms
    if family == "row_gemm":
        for kernel in ROW_GEMM_KERNELS:
            for m_pad in (128, 5120, 34944, 81920):
                for k_pad, n_pad in ((512, 128), (128, 512), (1536, 512), (512, 1536),
                                     (1024, 256), (256, 1024), (384, 640)):
                    for glu, save in ((False, False), (False, True), (True, False),
                                      (True, True)):
                        if kernel != "fused_w1" and (glu or save):
                            continue
                        for b in (2, 4):
                            yield {"kernel": kernel, "m_pad": m_pad, "k_pad": k_pad,
                                   "n_pad": n_pad, "glu": glu, "save": save,
                                   "n_experts": 16, "b": b, "sms": sms}
    elif family == "dw_split":
        for kernel in DW_KERNELS:
            variants = ((1, 0), (0, 1), (0, 0)) if kernel == "dw_streamed" else ((0, 0),)
            for m_pad, e in ((34944, 16), (2048, 16), (81920, 40), (1024, 4)):
                for k_pad, n_pad in ((512, 128), (128, 512), (1024, 256)):
                    for b in (2, 4):
                        for stream_x, gated in variants:
                            yield {"kernel": kernel, "m_pad": m_pad, "n_experts": e,
                                   "k_pad": k_pad, "n_pad": n_pad, "b": b,
                                   "stream_x": stream_x, "gated": gated, "sms": sms}
    elif family == "gather_rows":
        for m_pad in (128, 256, 5120, 16384):
            for row_bytes in (16, 256, 1024, 3072, 6144, 8192):
                yield {"m_pad": m_pad, "row_bytes": row_bytes, "sms": sms}
    elif family == "flash":
        for b, sq, h, kvh, sk, q_off, causal in (
                (1, 256, 24, 8, 4096, 3840, True), (8, 32, 24, 8, 128, 96, True),
                (4, 600, 32, 32, 600, 0, True), (2, 128, 4, 2, 128, 0, False),
                (1, 2048, 16, 16, 2048, 0, True), (1, 1, 8, 1, 4000, 3999, True)):
            for d in K7.HEAD_DIMS:
                bk = K7.FLASH_BK[d]
                yield {"b": b, "sq": sq, "h": h, "kvh": kvh, "sk": sk, "q_offset": q_off,
                       "causal": causal, "d": d, "bk": bk, "sms": sms}


def _check_instances(budget: int, where: str):
    findings: List[Finding] = []
    checks = 0
    for kernel, inst in instances():
        loc = f"{kernel}{inst} {where}"
        dyn, stat = launch_bytes(kernel, inst)
        checks += 2
        if dyn + stat > budget:
            findings.append(_bad("instance-budget", loc,
                                 f"{dyn} dynamic + {stat} static bytes pass the {budget}-byte "
                                 f"opt-in limit: the launch would fail"))
        if kernel in ROW_GEMM_KERNELS or kernel == "flash_attention":
            lo = ROW_GEMM_MIN_STAGES if kernel in ROW_GEMM_KERNELS else FLASH_MIN_STAGES
            if ring_stages(kernel, inst) < lo:
                findings.append(_bad("ring-depth", loc,
                                     f"a ring of {ring_stages(kernel, inst)} stages, below "
                                     f"the {lo} the mainloop assumes"))
    return findings, checks


def _check_candidates(budget: int, where: str):
    findings: List[Finding] = []
    checks = 0
    for family in autotune.families():
        for shape in shape_grid(family):
            for tuned in (False, True):
                cands = autotune.enumerate_candidates(family, shape, budget=budget,
                                                      tuned=tuned)
                loc = f"{family}{shape} {where}{' tuned' if tuned else ''}"
                checks += 1
                if not cands:
                    findings.append(_bad("no-candidate", loc,
                                         "no legal schedule: the call could not launch"))
                    continue
                if cands[0] != autotune.heuristic(family, shape):
                    findings.append(_bad("heuristic-first", loc,
                                         f"the first candidate {cands[0]} is not the "
                                         f"heuristic's schedule"))
                for c in cands:
                    checks += 1
                    if shape.get("b", 2) != 2 and family in ("row_gemm",):
                        continue            # the float32 body ignores the width
                    dyn, stat = launch_bytes(*launch_instance(family, shape, c))
                    if dyn + stat > budget:
                        findings.append(_bad("candidate-budget", loc,
                                             f"candidate {c} needs {dyn} + {stat} bytes, the "
                                             f"budget is {budget}: it would fail to launch"))
    return findings, checks


def check_smem() -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    checks = 0
    for hw in HARDWARE_MODELS:
        budget = autotune.default_smem_budget(hw)
        for check in (_check_instances, _check_candidates):
            f, c = check(budget, hw.name)
            findings += f
            checks += c
    return findings, checks
