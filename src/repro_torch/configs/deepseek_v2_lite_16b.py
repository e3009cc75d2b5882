"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + fine-grained MoE.
[arXiv:2405.04434; hf] 27L d_model=2048 16H vocab=102400; 64 routed experts
top-6 + 2 shared, d_expert=1408; first layer dense (d_ff=10944)."""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-assignment: the expert FFN size
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  moe_layer_step=1, first_dense_layers=1, dense_d_ff=10944),
)
