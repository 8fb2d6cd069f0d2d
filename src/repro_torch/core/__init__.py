"""The paper's approximators: sigma-MoE and the baseline MoEs' routing,
parameters and planned execution, PKM and the top-K MLP over the shared
weighted value sum."""
from .dispatch import (Selection, expert_mlp, resolve_impl, selection_usage,
                       set_decode_provider, value_sum_path, weighted_value_sum)
from .moe import apply_moe, init_moe, n_experts_padded
from .pkm import apply_pkm, init_pkm, pkm_select
from .regularizers import usage_stats
from .routing import (SelectionInfo, norm_topk, select_experts,
                      select_experts_sbase, sinkhorn, top_k, two_stage_topk)

__all__ = ["Selection", "SelectionInfo", "apply_moe", "apply_pkm",
           "expert_mlp", "init_moe", "init_pkm", "n_experts_padded",
           "norm_topk", "pkm_select", "resolve_impl", "select_experts",
           "select_experts_sbase", "selection_usage", "sinkhorn", "set_decode_provider", "top_k",
           "two_stage_topk", "usage_stats", "value_sum_path",
           "weighted_value_sum"]
