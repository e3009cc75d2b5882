"""Optimizer and gradient compression of the port (`repro.optim`): AdamW
with a warmup-cosine schedule and global-norm clipping, error-feedback int8
and top-k compressors, over parameter trees in `repro`'s leaf order
(`optim.tree`)."""
