"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library, loaded with ``ctypes``. Libraries go
to ``build/repro_torch/`` at the root of the checkout, named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is never served by a stale library. ``build()`` starts one ``nvcc``
per missing library, all at once, and waits for all of them. A variant
built with extra ``-D`` defines gets a library of its own, and
``selected`` makes the kernel's wrapper call it for a block. Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"cvmm": "cvmm.cu", "gather_rows": "gather_rows.cu",
           "fused_w1": "fused_w1.cu", "fused_w2": "fused_w2.cu",
           "dw_streamed": "dw_streamed.cu", "cvmm_dw": "cvmm_dw.cu",
           "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_SELECTED: Dict[str, Tuple[str, ...]] = {}


@dataclass
class BuildInfo:
    name: str
    path: Path
    seconds: float          # 0.0 when an up-to-date library was found
    ptxas: str              # nvcc's -Xptxas -v report (registers, smem)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(defines: Sequence[str]) -> Tuple[str, ...]:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:12]
    variant = "".join(f"-{d.replace('=', '')}" for d in defines)
    return BUILD_DIR / f"lib{name}{variant}-{tag}.so"


def build(names: Optional[Iterable[str]] = None,
          defines: Sequence[str] = ()) -> Dict[str, BuildInfo]:
    """Compile every named kernel library that is not built yet, in parallel,
    each with ``-D`` for every entry of ``defines`` (``"NAME=VALUE"``).

    Raises RuntimeError with the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    infos: Dict[str, BuildInfo] = {}
    procs = {}
    nvcc = None
    for name in names:
        out = _lib_path(name, defines)
        log = out.with_suffix(".log")
        if out.exists():
            infos[name] = BuildInfo(name, out, 0.0,
                                    log.read_text() if log.exists() else "")
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out, log)
    failed = []
    for name, (proc, t0, tmp, out, log) in procs.items():
        report, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{report}")
            continue
        log.write_text(report)
        os.replace(tmp, out)
        infos[name] = BuildInfo(name, out, seconds, report)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return infos


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built with the defines that
    ``selected`` holds for it (none outside such a block), built first if
    needed."""
    key = (name, _SELECTED.get(name, ()))
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build([name], key[1])[name].path))
        _LIBS[key] = lib
    return lib


@contextmanager
def selected(name: str, defines: Sequence[str]):
    """Inside the block, ``load(name)``, and so kernel ``name``'s wrapper,
    uses the library built with ``defines``."""
    saved = _SELECTED.get(name)
    _SELECTED[name] = tuple(defines)
    try:
        yield
    finally:
        if saved is None:
            del _SELECTED[name]
        else:
            _SELECTED[name] = saved
