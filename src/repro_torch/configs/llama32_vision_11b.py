"""llama-3.2-vision-11b [vlm]: cross-attention image layers every 5th layer;
vision frontend stubbed (precomputed patch embeddings via input_specs).
[hf:meta-llama/Llama-3.2-11B-Vision] 40L d_model=4096 32H (kv=8) d_ff=14336
vocab=128256."""
from .base import ArchConfig, CrossAttnConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    cross_attn=CrossAttnConfig(every=5, n_image_tokens=1601),
)
