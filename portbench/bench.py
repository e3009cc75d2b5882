"""One run of one cell: set-up, warm-up, the window, the check, the line.

`run` is everything after `run.py`'s look for a card: the tests drive it
on the CPU at small sizes, with the port broken underneath.
"""
from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time
from typing import Optional

import torch

from . import check, drive, program, reference, spec, trace

BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Record:
    """What a metric's reader reads (`metrics/<name>.py`)."""
    cell: spec.Cell
    device_kind: str
    n_rows: int
    n_cols: int
    nnz: int                  # the operator's nonzeros, counted from the CSR
    plan_elements: int        # what the port's plan walks per pass
    plan_s: float             # CSR in hand to a planned engine
    setup_s: float            # process start to the window's start
    window: drive.Window
    trace: Optional[trace.Summary]


def device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit from nvidia-smi (None off the card)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
             "nounits", f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def banned_modules() -> list:
    """Modules of JAX or the JAX package loaded in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _release(port) -> None:
    """Free the port's state before the reference runs."""
    port.release()
    gc.collect()
    if port.device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: spec.Cell, *, seed: int, seconds: float, traced: bool,
        device, t_start: float, port=None) -> dict:
    """Run `cell` once and return its result line (a dict)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, traffic = cell.config, cell.traffic
    port = port if port is not None else program.Port(dev)
    gen = spec.generator(cfg["generator"])
    n, indptr, indices, data = gen.build(cfg, dev)
    t = time.perf_counter()
    port.plan(cfg, n, indptr, indices, data)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    plan_s = time.perf_counter() - t
    plan_elements = port.plan_elements()
    kind = cell.kind
    pool = drive.make_pool(traffic, kind, n, dev)

    def answer(x):
        return port.answer(kind, traffic, x)

    kind.warm(answer, traffic, pool)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    tracer = trace.Tracer(dev) if traced else None
    captured0 = port.captures()
    win = drive.window(answer, kind, traffic, pool, seconds, seed, dev,
                       tracer)
    win.captures = port.captures() - captured0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = tracer.summary() if tracer is not None else None
    _release(port)

    op = reference.Operator(n, indptr, indices, data, kind=cfg["operator"],
                            device=dev)
    checks = check.numbers(kind, traffic, cell.limits, op, pool, win.samples,
                           raised=win.raised, unconverged=win.unconverged)
    rec = Record(cell=cell, device_kind=device_kind(dev), n_rows=n,
                 n_cols=n, nnz=op.nnz, plan_elements=plan_elements,
                 plan_s=plan_s, setup_s=setup_s, window=win, trace=summary)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": rec.device_kind,
                "count": 1,
                "memory_peak_bytes": int(peak)}
    line = {"correct": check.passed(checks), "attempted": win.attempted,
            "failed": win.failed, "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        line["traced_part"] = {
            "completed": win.completed - win.untraced_completed,
            "seconds": summary.window_s}
        line["breakdown"] = {
            "device_ops": [[n_, s] for n_, s in summary.device_ops],
            "idle_gaps": [[n_, s] for n_, s in summary.idle_gaps],
        }
    line["window_counts"] = {"seconds": win.seconds,
                             "iterations": win.iterations,
                             "matvecs": win.matvecs}
    line["power_limit_w"] = power_limit_w(dev)
    line["captured_in_window"] = win.captures
    if win.errors:
        line["first_error"] = win.errors[0][:500]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in checks.items()}
    return line
