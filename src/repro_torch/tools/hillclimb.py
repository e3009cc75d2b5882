"""Hill-climb (port of ``tools/hillclimb.py``): run the picked cells
of the dry-run (`launch.dryrun.run_cell`, on a fake 16x16 world) under
candidate layouts, record each run's JSON under its tag in
``artifacts/dryrun_torch/``, and print its counts against the cell's
recorded 16x16 baseline (``python -m repro_torch.launch.dryrun`` writes
it, tag ``baseline``).

Three phases, `repro`'s run table (`PHASES`, 18 runs):

  --phase 1  per-lever sweep: data-local MoE dispatch, ZeRO-1, full remat,
             capacity factor, sequence-sharded attention (smollm)
  --phase 2  EP layout constraint + FSDP param sharding
  --phase 3  combined best levers; llama4 2D expert sharding

Every figure is a count of what rank 0 of the fake world would hold, run
and send (`launch.dryrun`), not a device measurement. The port runs every
layer (it has no layer scan), so ``--unrolled-final`` changes no count: it
re-tags the runs, as ``dryrun --unrolled`` does.

Usage: PYTHONPATH=src python -m repro_torch.tools.hillclimb [--phase N]
       [--only ARCH] [--unrolled-final] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

from repro_torch.configs import ARCHS, SHAPES_BY_NAME
from repro_torch.core.runtime import resolve_device
from repro_torch.launch import dryrun
from repro_torch.models.transformer import Runtime


def _mem_gib(memory) -> float:
    return sum(
        memory.get(k, 0) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes",
        )
    ) / 2**30


def _baseline(arch: str, shape: str) -> Optional[Dict[str, Any]]:
    f = dryrun.ARTIFACTS / f"{arch}__{shape}__16x16__baseline.json"
    return json.loads(f.read_text()) if f.exists() else None


def show(res, base=None, *, colls=False):
    """`repro`'s line of a run (and its ratios to `base`, a baseline's
    JSON), its error or, with `colls`, its collective bytes by kind."""
    c = res.collectives.get("total_bytes", 0)
    f = res.cost.get("flops", 0)
    m = _mem_gib(res.memory)
    line = (f"  {res.runtime['tag']:24s} ok={res.ok} flops={f:.3e} "
            f"coll={c:.3e} mem={m:7.1f}GiB ({res.seconds:.0f}s)")
    if base is not None and res.ok:
        bc = base["collectives"].get("total_bytes", 1) or 1
        bf = base["cost"].get("flops", 1) or 1
        bm = _mem_gib(base["memory"]) or 1
        line += f"  [coll x{c/bc:.3f} mem x{m/bm:.3f} flops x{f/bf:.3f}]"
    print(line, flush=True)
    if not res.ok:
        print("   ERR:", res.error[:500])
    elif colls:
        print("   colls:", {k: f"{v:.2e}" for k, v in
                            res.collectives.items()})
    return res


# Every run: (arch, shape, tag, Runtime kwargs, run_cell flags). scan_layers
# is handled by `run` (--unrolled-final flips it off and re-tags).
_EP = dict(moe_dp_shards=16, moe_ep_constraint=True)
PHASES = {
    1: [
        # iteration 1: data-local MoE dispatch
        ("deepseek-v2-lite-16b", "train_4k", "hc1_localdispatch",
         dict(remat="dots", moe_dp_shards=16), {}),
        ("llama4-maverick-400b-a17b", "train_4k", "hc1_localdispatch",
         dict(remat="dots", moe_dp_shards=16), {}),
        # iteration 2: + ZeRO-1 optimizer sharding
        ("deepseek-v2-lite-16b", "train_4k", "hc2_zero1",
         dict(remat="dots", moe_dp_shards=16), dict(zero1=True)),
        ("llama4-maverick-400b-a17b", "train_4k", "hc2_zero1",
         dict(remat="dots", moe_dp_shards=16), dict(zero1=True)),
        # iteration 3: + full remat (memory term)
        ("deepseek-v2-lite-16b", "train_4k", "hc3_rematfull",
         dict(remat="full", moe_dp_shards=16), dict(zero1=True)),
        ("llama4-maverick-400b-a17b", "train_4k", "hc3_rematfull",
         dict(remat="full", moe_dp_shards=16), dict(zero1=True)),
        # iteration 4: capacity factor 1.0 (dispatch slab size)
        ("deepseek-v2-lite-16b", "train_4k", "hc4_cap1",
         dict(remat="full", moe_dp_shards=16, moe_capacity_factor=1.0),
         dict(zero1=True)),
        ("llama4-maverick-400b-a17b", "train_4k", "hc4_cap1",
         dict(remat="full", moe_dp_shards=16, moe_capacity_factor=1.0),
         dict(zero1=True)),
        # smollm iteration 1: sequence-sharded attention
        ("smollm-360m", "train_4k", "hc1_sp",
         dict(remat="dots", seq_shard_attention=True), {}),
        # smollm iteration 2: + full remat (scores memory)
        ("smollm-360m", "train_4k", "hc2_sp_rematfull",
         dict(remat="full", seq_shard_attention=True), {}),
        # smollm iteration 3: + zero1
        ("smollm-360m", "train_4k", "hc3_sp_zero1",
         dict(remat="full", seq_shard_attention=True), dict(zero1=True)),
    ],
    2: [
        ("deepseek-v2-lite-16b", "train_4k", "hc5_ep",
         dict(remat="dots", **_EP), dict(zero1=True)),
        ("llama4-maverick-400b-a17b", "train_4k", "hc5_ep",
         dict(remat="dots", **_EP), dict(zero1=True)),
        ("llama4-maverick-400b-a17b", "train_4k", "hc6_ep_fsdp",
         dict(remat="dots", **_EP), dict(zero1=True, fsdp=True)),
        ("deepseek-v2-lite-16b", "train_4k", "hc6_ep_fsdp",
         dict(remat="dots", **_EP), dict(zero1=True, fsdp=True)),
    ],
    3: [
        # hc7: best-so-far combo + remat full + tight capacity
        ("deepseek-v2-lite-16b", "train_4k", "hc7_combo",
         dict(remat="full", moe_capacity_factor=1.0, **_EP),
         dict(zero1=True)),
        # llama4 hc7: 2D expert sharding (params+moments), EP constraint
        ("llama4-maverick-400b-a17b", "train_4k", "hc7_expert2d",
         dict(remat="dots", **_EP), dict(zero1=True, expert_2d=True)),
        ("llama4-maverick-400b-a17b", "train_4k", "hc8_expert2d_rfull",
         dict(remat="full", moe_capacity_factor=1.0, **_EP),
         dict(zero1=True, expert_2d=True)),
    ],
}


def run(arch: str, shape: str, tag: str, rtkw: Dict[str, Any],
        flags: Dict[str, Any], *, unrolled_final: bool = False,
        device=None):
    """One run of the table: `launch.dryrun.run_cell` of the cell under
    ``Runtime(**rtkw)`` and `flags`, tagged (``_unrolled`` appended with
    `unrolled_final`)."""
    rt = Runtime(scan_layers=not unrolled_final, **rtkw)
    return dryrun.run_cell(
        ARCHS[arch], SHAPES_BY_NAME[shape], rt=rt,
        tag=tag + ("_unrolled" if unrolled_final else ""), device=device,
        **flags)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools.hillclimb")
    ap.add_argument("--phase", type=int, default=1,
                    choices=sorted(PHASES))
    ap.add_argument("--only", type=str, default=None,
                    help="run only configs whose arch id contains this")
    ap.add_argument("--unrolled-final", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="the fake tensors' device (nothing is allocated)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    for arch, shape, tag, rtkw, flags in PHASES[args.phase]:
        if args.only and args.only not in arch:
            continue
        print(f"{arch} {shape} -> {tag}", flush=True)
        res = run(arch, shape, tag, rtkw, flags,
                  unrolled_final=args.unrolled_final, device=device)
        show(res, _baseline(arch, shape), colls=args.phase > 1)


if __name__ == "__main__":
    main()
