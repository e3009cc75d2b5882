"""whisper-large-v3 [audio]: encoder-decoder, conv frontend stubbed
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]
32L(enc)+32L(dec) d_model=1280 20H d_ff=5120 vocab=51866."""
from .base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    act="gelu",
    tie_embeddings=True,
    encdec=EncDecConfig(n_encoder_layers=32),
)
