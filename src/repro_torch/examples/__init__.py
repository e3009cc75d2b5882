"""The repo's four examples on the port: ``python -m
repro_torch.examples.<name>`` for quickstart, spmv_pipeline, serve_decode
and train_tinylm. Each runs on the card unless ``--device cpu`` is given
(without a card and without it, it raises)."""
