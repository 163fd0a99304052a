from triton_dist_tpu_torch.layers.sp import AGSPAttn, Ring2DSPAttn, RingSPAttn, UlyssesSPAttn
from triton_dist_tpu_torch.layers.tp import MOE_CAPACITY_FACTOR, TP_Attn, TP_MLP, TP_MoE, RMSNorm, apply_rope

__all__ = ["AGSPAttn", "MOE_CAPACITY_FACTOR", "RMSNorm", "Ring2DSPAttn", "RingSPAttn", "TP_Attn", "TP_MLP", "TP_MoE",
           "UlyssesSPAttn", "apply_rope"]
