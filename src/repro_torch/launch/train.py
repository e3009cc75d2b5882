"""Training launcher (port of `repro.launch.train`):
``python -m repro_torch.launch.train --arch <id> [--reduced]``.

Trains on the card unless ``--device cpu`` is given (without a card and
without it, it raises). On the card `train` captures the update as one
CUDA graph after its first, eager step and replays it a step (`repro` jits
it), on one card or on an NCCL process mesh; on the CPU and on a gloo
mesh every step runs eagerly. ``--embed-backend`` takes the port's gather
backends: ``index`` (the default, `repro`'s ``jnp``), ``coalesced``,
``cuda`` (`repro`'s ``pallas``; it has no gradient and raises under
training, as ``pallas`` does) or ``auto``. Prints `repro`'s JSON
(``history``, ``wall_seconds``) with the tokens per second over the whole
run, the peak device memory (null on the CPU), whether the update was
captured and the capture's seconds (null when it was not).

``--mesh data,model`` trains sharded on a process mesh of that shape, one
rank a process, started by ``python -m torch.distributed.run
--nproc-per-node <data*model> -m repro_torch.launch.train ... --mesh d,m``:
NCCL on the cards, gloo with ``--device cpu`` (a mesh of one rank needs no
launcher). Every rank trains; rank 0 prints the JSON once every rank has
finished, with the mesh's shape.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import Runtime
from repro_torch.optim.optimizer import OptConfig
from repro_torch.train.loop import TrainConfig, train


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", type=str, default="none",
                    choices=["none", "full", "dots"])
    ap.add_argument("--embed-backend", type=str, default="index",
                    choices=["index", "coalesced", "cuda", "auto"])
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    ap.add_argument("--mesh", type=str, default=None,
                    help="data,model: train on a process mesh")
    return ap


def _mesh_shape(spec: str):
    parts = [p.strip() for p in spec.replace("x", ",").split(",")]
    try:
        sizes = tuple(int(p) for p in parts)
    except ValueError:
        sizes = ()
    if len(sizes) != 2 or min(sizes) < 1:
        raise ValueError(f"--mesh expects two positive sizes 'data,model', "
                         f"got {spec!r}")
    return sizes


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    rt = Runtime(remat=args.remat, embed_backend=args.embed_backend)
    mesh = None
    if args.mesh is not None:
        mesh = make_process_mesh(*_mesh_shape(args.mesh),
                                 device=args.device)
    if args.device == "cuda" and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()

    out = train(
        model,
        mesh=mesh,
        rt=rt,
        opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps),
        tcfg=TrainConfig(
            total_steps=args.steps,
            microbatches=args.microbatches,
            ckpt_dir=args.ckpt_dir,
            grad_compression=args.grad_compression,
        ),
        data_cfg=DataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq,
            global_batch=args.batch,
        ),
        device=args.device,
    )
    device = out["device"]
    tokens = out["steps"] * args.batch * args.seq
    summary = {
        "history": out["history"],
        "wall_seconds": out["wall_seconds"],
        "tokens_per_s": tokens / out["wall_seconds"]
        if out["wall_seconds"] > 0 else None,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(device)
        if device.type == "cuda" else None,
        "device": str(device),
        "captured": out["captured"],
        "capture_seconds": out["capture_seconds"],
    }
    if mesh is None:
        print(json.dumps(summary, indent=2))
        return out
    import torch.distributed as dist

    summary["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dist.barrier()  # every rank has trained
    if dist.get_rank() == 0:
        print(json.dumps(summary, indent=2), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
