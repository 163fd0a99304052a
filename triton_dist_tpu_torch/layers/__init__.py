from triton_dist_tpu_torch.layers.tp import TP_Attn, TP_MLP, RMSNorm, apply_rope

__all__ = ["RMSNorm", "TP_Attn", "TP_MLP", "apply_rope"]
