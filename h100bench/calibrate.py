"""Read the numbers a cell's correctness check compares, for the program
and for its control, over many seeds in one process: the readings a
cell's limits are set from (the lower reading is the largest the program
gives, the upper the smallest the control gives).

    python3 h100bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 5

The control is the plain reference computed in the precision below the
configuration's, in the program's place (the BCNN: bfloat16; DeepSeek-V2:
float8 e4m3 products). Each seed prints one JSON line; the last line holds
the largest program reading and the smallest control reading of each
number."""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def seeds(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--look", action="store_true",
                    help="also print each compared row's witness readings "
                         "(drivers whose check takes look=True)")
    args = ap.parse_args()

    import torch
    from h100bench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    lower: dict = {}
    upper: dict = {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        run = harness.new_run(args.workload, seed, args.seconds, False)
        driver = harness.load_module("drivers", run.workload["driver"])
        state = driver.setup(run)
        setup_s = time.perf_counter() - t0
        record = driver.drive(run, state)
        out = {"seed": seed, "setup_s": setup_s, "e2e": record["e2e"],
               "attempted": record["attempted"]}
        if seed in args.seeds:
            kw = {"look": True} if args.look else {}
            out["program"] = driver.check(run, state, record, **kw)
            if args.look:
                out["look"] = record["look"]
            for k, v in out["program"].items():
                lower[k] = max(lower.get(k, v), v)
        if seed in args.control_seeds:
            out["control"] = driver.check(run, state, record, control=True)
            for k, v in out["control"].items():
                upper[k] = min(upper.get(k, v), v)
        out["check_s"] = time.perf_counter() - t0 - setup_s - args.seconds
        print(json.dumps(out), flush=True)
        del state, record, run
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
