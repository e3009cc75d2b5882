"""Model stack of the port: the ten architectures' serving side (layers,
MoE, Mamba2, xLSTM, the five family modules, `build_model`), and the paged
KV cache (`paged_kv`)."""
from .model import (  # noqa: F401
    Model,
    build_model,
    cache_shapes,
    count_params,
    input_specs,
    lm_loss,
    make_input_batch,
    param_shapes,
)
from .transformer import Runtime  # noqa: F401
