"""End to end: train a ~100M-parameter LM for a few hundred steps
(port of ``examples/train_tinylm.py``).

The model is a llama-family config (~128M parameters, the embedding tied)
built from the same stack as the assigned architectures; training runs the
full production path: microbatched, checkpointed, with the deterministic
data pipeline, on the card unless ``--device cpu`` is given. The config is
`repro`'s, float32 included.

CPU demo (short):   PYTHONPATH=src python -m repro_torch.examples.train_tinylm
                        --steps 30 --device cpu
Full run (~100M x 300 steps; minutes on one H100):
                    PYTHONPATH=src python -m repro_torch.examples.train_tinylm
                        --steps 300
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.runtime import resolve_device
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model, count_params
from repro_torch.models.transformer import Runtime
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train.loop import TrainConfig, train

TINYLM_100M = ArchConfig(
    name="tinylm-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=3072,
    vocab_size=32000,
    tie_embeddings=True,
    dtype="float32",  # CPU demo; bf16 on TPU
)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_tinylm")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", type=str,
                    default=os.path.join(tempfile.gettempdir(),
                                         "tinylm_ckpt"))
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = build_model(TINYLM_100M)
    n_params = count_params(model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    print(f"tinylm-100m: {n_params / 1e6:.1f}M params")

    out = train(
        model,
        rt=Runtime(remat="dots"),
        opt_cfg=OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        tcfg=TrainConfig(
            total_steps=args.steps,
            microbatches=args.microbatches,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=max(10, args.steps // 5),
            log_every=max(1, args.steps // 20),
        ),
        data_cfg=DataConfig(
            vocab_size=TINYLM_100M.vocab_size,
            seq_len=args.seq,
            global_batch=args.batch,
        ),
        device=dev,
    )
    print(json.dumps(out["history"], indent=2))
    print(f"wall: {out['wall_seconds']:.1f}s  final loss: {out['final_loss']}")
    return out


if __name__ == "__main__":
    main()
