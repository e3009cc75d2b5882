"""llama4-maverick-400b-a17b [moe]: 128 routed experts top-1 + shared expert,
MoE interleaved every other layer; text backbone (early-fusion frontend not
in scope of the assigned shapes). [hf:meta-llama/Llama-4-*]
48L d_model=5120 40H (kv=8) d_ff=8192(expert) vocab=202048."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,  # expert FFN size
    vocab_size=202048,
    rope_theta=5e5,
    moe=MoEConfig(n_experts=128, top_k=1, n_shared=1, d_expert=8192,
                  moe_layer_step=2, first_dense_layers=0, dense_d_ff=16384),
)
