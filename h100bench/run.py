"""Run one cell of the benchmark of ``repro_torch`` on the card:

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Sets up the cell (weights and inputs from the
seed, the program's default plan, the cell's own shapes warmed up),
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones, read
from a profiled slice of the window. Exits non-zero, and prints no result,
when the card is missing or the process holds JAX or the JAX package once
the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the run inside the checkout, at fixed paths
CACHE = ROOT / "build" / "h100bench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from h100bench import harness

    chips = harness.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    run = harness.new_run(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    line = harness.measure(run, T_START)
    held = harness.forbidden_modules()
    if held:
        print(f"h100bench: the process holds {held} once the window has "
              f"closed", file=sys.stderr)
        return 3
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
