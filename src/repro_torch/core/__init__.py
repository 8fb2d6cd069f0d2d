"""The paper's sigma-MoE: routing, parameters and planned execution."""
from .dispatch import expert_mlp, resolve_impl, set_decode_provider
from .moe import apply_moe, init_moe, n_experts_padded
from .routing import SelectionInfo, norm_topk, select_experts, top_k

__all__ = ["SelectionInfo", "apply_moe", "expert_mlp", "init_moe",
           "n_experts_padded", "norm_topk", "resolve_impl", "select_experts",
           "set_decode_provider", "top_k"]
