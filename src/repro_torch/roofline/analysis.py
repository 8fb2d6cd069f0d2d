"""The hardware model behind the port's tile decisions, and the model's
useful operation count (the reference's ``roofline/analysis.py``).

``Hardware`` carries the rates a roofline needs (dense bf16 and float32
operations per second, HBM bytes per second) and the resources a launch
schedule must fit: the SM count and the dynamic shared memory one block
may opt in to, ``smem_block_bytes``, which takes the place of the
reference's ``vmem_bytes``. The autotuner (``kernels/autotune.py``) ranks
candidate schedules on it and the shared-memory pass
(``analysis/smem.py``) proves every candidate fits it.

Figures of the H100 SXM model: 989 TFLOP/s dense bf16 (67 TFLOP/s float32
without TF32), 3.35 TB/s of HBM3 and 80 GB (the data sheet at 700 W), 132
SMs and 232,448 bytes of shared memory a block can opt in to
(``cudaDevAttrMaxSharedMemoryPerBlockOptin``). ``hardware_for`` reads the
SM count, the memory size and the opt-in limit from the card itself, so a
card with fewer SMs gets its own model; the rates stay the H100's.

``CPU_STANDIN`` is the tests' stand-in, as the reference's
``CPU_INTERPRET``: its rates only order candidates, and it keeps the H100's
SM count and shared memory so that a decision made for a CPU tensor (a
decode skeleton's widths, say) is the one the card would make.

The reference's HLO reader (``roofline/hlo_analysis.py``) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float            # dense bf16 operations per second
    peak_flops_f32: float        # float32 on the CUDA cores (no TF32)
    hbm_bw: float                # bytes per second
    hbm_bytes: float             # device memory
    n_sms: int                   # streaming multiprocessors
    smem_block_bytes: int        # shared memory one block may opt in to

    def peak(self, dtype_bytes: int) -> float:
        """Operations per second at an operand width of ``dtype_bytes``."""
        return self.peak_flops if dtype_bytes <= 2 else self.peak_flops_f32


H100 = Hardware(name="nvidia_h100_sxm", peak_flops=989e12, peak_flops_f32=67e12,
                hbm_bw=3.35e12, hbm_bytes=80e9, n_sms=132, smem_block_bytes=232448)

CPU_STANDIN = Hardware(name="cpu_standin", peak_flops=2e11, peak_flops_f32=1e11,
                       hbm_bw=4e10, hbm_bytes=32e9, n_sms=H100.n_sms,
                       smem_block_bytes=H100.smem_block_bytes)

_CARDS: Dict[int, Hardware] = {}


def hardware_for(device=None) -> Hardware:
    """The model of ``device`` (default: the current CUDA device if there is
    one, else the CPU stand-in). A CUDA card gets the H100's rates with its
    own SM count, memory and shared-memory opt-in limit, read once."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_STANDIN
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CARDS:
        props = torch.cuda.get_device_properties(index)
        optin = getattr(props, "shared_memory_per_block_optin", H100.smem_block_bytes)
        name = H100.name if "H100" in props.name else props.name.lower().replace(" ", "_")
        if props.multi_processor_count != H100.n_sms:
            name += f"_{props.multi_processor_count}sm"
        _CARDS[index] = dataclasses.replace(
            H100, name=name, hbm_bytes=float(props.total_memory),
            n_sms=props.multi_processor_count, smem_block_bytes=int(optin))
    return _CARDS[index]


def model_flops(cfg, shape, n_tokens: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE), D the tokens
    processed: training counts forward and backward (6x), decode and
    prefill the forward only (2x). ``shape`` is any object with
    ``seq_len``, ``global_batch`` and ``mode`` ("train", "prefill" or
    "decode"), as the reference's ``ShapeConfig``."""
    n_active = cfg.param_counts()["active"]
    if n_tokens is None:
        if shape.mode == "decode":
            n_tokens = shape.global_batch            # one token a sequence
        else:
            n_tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.mode == "train" else 2.0
    return mult * n_active * n_tokens
