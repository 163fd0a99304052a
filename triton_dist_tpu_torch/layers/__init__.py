from triton_dist_tpu_torch.layers.tp import MOE_CAPACITY_FACTOR, TP_Attn, TP_MLP, TP_MoE, RMSNorm, apply_rope

__all__ = ["MOE_CAPACITY_FACTOR", "RMSNorm", "TP_Attn", "TP_MLP", "TP_MoE", "apply_rope"]
