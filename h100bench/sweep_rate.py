"""Find the knee of ``bcnn.online64`` once, on the card: the highest
offered rate at which the engine keeps up (no backlog growing through the
window) with the 95th percentile under the configuration's online
deadline. The cell then offers 0.8 of it, a number written into its
workload file.

    python3 h100bench/sweep_rate.py --workload bcnn.online64 --seed 11 \
        --seconds 5 --rates 20000,30000,40000

One engine serves every rate in turn. Each row: offered rate, requests,
answered per second of the window, p50 and p95 (ms, from the due time),
and the backlog (queued + in slots) when the window closed."""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="bcnn.online64")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()

    import numpy as np
    import torch
    from h100bench import harness
    if not torch.cuda.is_available():
        print("sweep_rate: no CUDA device", file=sys.stderr)
        return 2
    run = harness.new_run(args.workload, args.seed, args.seconds, False)
    driver = harness.load_module("drivers", run.workload["driver"])
    state = driver.setup(run)
    deadline_ms = run.config["online_deadline_s"] * 1e3
    slots = run.params["n_slots"]
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        rec = driver.drive(run, state, rate=rate)
        lat = rec["latency_s"] * 1e3
        ok = (rec["backlog_at_close"] <= 2 * slots
              and float(np.percentile(lat, 95)) < deadline_ms
              and rec["failed"] == 0)
        row = {"rate_hz": rate, "requests": rec["attempted"],
               "answered_per_s": (rec["attempted"] - rec["failed"])
               / args.seconds,
               "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": float(np.percentile(lat, 95)),
               "backlog_at_close": rec["backlog_at_close"], "keeps_up": ok}
        print(json.dumps(row), flush=True)
        if ok:
            knee = rate
    print(json.dumps({"knee_hz": knee, "cell_rate_hz":
                      None if knee is None else 0.8 * knee,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
