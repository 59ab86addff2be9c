"""The readings the correctness limits are set from, on the card, at a
cell's own size (``harness/readings.py``).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--faults half_batch,altered] \\
        [--fault-seeds 1,2,3] [--out FILE]

Prints one JSON line a reading and a summary: per number, the largest
program reading (the lower reading), the smallest control reading and
the smallest reading of each fault. ``--out`` keeps the whole record.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def summary(readings: list[dict]) -> dict:
    out: dict = {}
    for kind in sorted({r["kind"] for r in readings}):
        rows = [r for r in readings if r["kind"] == kind]
        pick = max if kind == "program" else min
        out[kind] = {n: pick(r[n] for r in rows) for n in rows[0]
                     if n.endswith(("_gap", "_median", "_kernels"))}
        out[kind]["seeds"] = len(rows)
    return out


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=ints, default=[])
    ap.add_argument("--control-seeds", type=ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=ints, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark.harness import driver, spec

    cell = spec.resolve(spec.load_spec(), args.workload)
    payload = {"seeds": args.seeds, "control_seeds": args.control_seeds,
               "faults": [f for f in args.faults.split(",") if f],
               "fault_seeds": args.fault_seeds}
    t = time.perf_counter()
    if args.seeds or args.fault_seeds:
        recs = driver.run_ranks(cell, "readings", payload, deadline_s=3000.0)
    else:
        # the control alone: the reference twice on one card, at the cell's
        # global batch
        from benchmark.harness import readings as rd
        recs = [rd.readings_rank(0, cell.chips, cell, payload)]
    readings = recs[0]["readings"]
    for r in readings:
        print(json.dumps(r), flush=True)
    import torch

    record = {"workload": cell.name, "card": torch.cuda.get_device_name(0),
              **driver.card_info(), "seconds": time.perf_counter() - t,
              "summary": summary(readings), "readings": readings}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({k: record[k] for k in ("workload", "card",
                                             "power_limit", "seconds",
                                             "summary")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from benchmark.run import environment

    environment()
    sys.exit(main(sys.argv[1:]))
