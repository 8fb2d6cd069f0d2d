"""Kernel-contract analyzer: the invariants the port's kernels, plan
builders and launch schedules rely on, proven on the CPU before anything
launches (the reference's ``analysis/``).

Module map
----------
report.py     ``Finding`` and ``Report``. Every pass returns ``(findings,
              checks)``, so an empty sweep cannot look clean.
plans.py      Plan invariants of ``CvmmPlan``, ``GatherPlan`` and
              ``DedupGatherPlan`` (tile purity, injective slots, the
              sentinel and zero gates on slack slots, the dedup union),
              swept over adversarial routings through the real builders,
              the decode skeleton's assembled plans included.
smem.py       Shared memory: a launch inventory itemised from the CUDA
              sources, which the tuner prunes by, proves every schedule
              the tuner can emit fits the opt-in limit. It takes the
              place of the reference's ``vmem.py``.
schedules.py  Partitions: the port's own item walks (``row_gemm``, K3/K5's
              split, K7's key splits, K6's grid) replayed for every
              candidate schedule cover their work exactly once. It takes
              the place of the reference's ``pipeline.py``, whose DMA
              rings have no counterpart here.
check.py      The CLI, ``python -m repro_torch.analysis.check --all``, and
              ``run_passes``, which tests share.

The reference's sharding pass (``analysis/sharding.py``) waits for the
port's device mesh.
"""
from .report import Finding, Report

__all__ = ["Finding", "PASSES", "Report", "run_passes"]


def __getattr__(name):
    # Lazy: ``python -m repro_torch.analysis.check`` imports this package
    # first, and an eager import of check.py would put it in sys.modules
    # before runpy runs it.
    if name in ("PASSES", "run_passes"):
        from . import check
        return getattr(check, name)
    raise AttributeError(name)
