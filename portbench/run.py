"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with ``--trace 1`` also
`breakdown`; the numbers compared with their limits come last, under
`checks`); the last lines of standard error are the same numbers. Exits
non-zero, printing no result, without a card, without the port's sources,
or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()  # set-up is timed from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no plan store."""
    cache = os.path.join(ROOT, "build", "portbench-cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ.pop("REPRO_SCHEDULE_CACHE", None)
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("portbench: the port's sources (src/repro_torch) are not in "
              "this checkout", file=sys.stderr)
        return 5
    import torch

    from portbench import bench, spec

    cell = spec.resolve(spec.load_spec(ROOT), ROOT, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line = bench.run(cell, seed=args.seed, seconds=args.seconds,
                     traced=bool(args.trace), device="cuda:0",
                     t_start=T_START)
    banned = bench.banned_modules()
    if banned:
        print(f"portbench: loaded {banned}, which the port must not use",
              file=sys.stderr)
        return 4
    for c in line["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])  # JSON has no inf or nan
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
