"""The hardware model and the model's useful operation count
(``analysis.py``); the reference's HLO reader is not ported."""
from .analysis import CPU_STANDIN, H100, Hardware, hardware_for, model_flops

__all__ = ["CPU_STANDIN", "H100", "Hardware", "hardware_for", "model_flops"]
