"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks. [arXiv:2405.04517]
48L d_model=2048 4H vocab=50304; blocks carry their own up/down projections
(d_ff=0 per assignment)."""
from .base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, conv_width=4, chunk=512),
    supports_long_context=True,  # recurrent state is O(1) in sequence length
)
