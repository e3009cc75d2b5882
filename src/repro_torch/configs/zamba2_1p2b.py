"""zamba2-1.2b [hybrid]: 38 Mamba2 layers + shared attention block.
[arXiv:2411.15242; hf] 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64. Shared transformer block applied every 6 SSM layers."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=64, expand=2, conv_width=4, head_dim=64,
                  chunk=128, shared_attn_every=6),
    supports_long_context=True,  # SSM state is O(1); shared-attn KV at B=1 fits
)
