"""The benchmark of ``timewarp_tpu_torch`` on NVIDIA H100s: one run of
one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload gossip-1m.steady --seed 7 \\
        --seconds 10 --trace 0

It builds the cell's engine, warms it up, runs its traffic for
``--seconds`` (``--trace 1``: with a slice of it under
``torch.profiler``), checks the program's states against the plain
reference (``reference/``), and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number with its limit, which also end standard error. Without
a CUDA device, or with the JAX package or JAX loaded in this process,
it prints no result and exits with 1.
"""

import os
import time


def _process_age() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that must not be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "timewarp_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the caches a run may write stay inside the checkout, at fixed paths
    cache = ROOT / "build" / "benchmark-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))
    sys.path.insert(0, str(ROOT))
    pre = {"interpreter": time.perf_counter() - T_START}
    t = time.perf_counter()
    import torch
    from benchmark import harness
    pre["import_torch"] = time.perf_counter() - t
    chips = harness.Bench(ROOT).cell(args.workload).workload["chips"]
    t = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 1
    torch.cuda.init()
    pre["cuda_init"] = time.perf_counter() - t
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", ROOT, T_START, pre)
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
