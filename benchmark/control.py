"""Readings that set a cell's limits: the numbers compared, of the program
on many seeds and of the control (the reference in the program's place, one
precision lower) on some, each at the cell's own size after a short window
at the cell's own load, all in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 3 [--out readings.jsonl]

Prints one JSON line per reading: {"cell", "seed", "side", "numbers"}, side
"program" or the control's precision; where the kind selects by key
(`keyed_numbers`), also "keyed-<precision>" on the control seeds: the
reference put in the scan's place with the configuration's key selection,
its products in a precision below the configuration's (KEYED). Needs a
CUDA card, as a run does.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import core, reference  # noqa: E402

# Precisions below the codes' in which the keyed readings take the scan's
# products: a 1xTF32 or bf16 scan of float32 codes, an fp8 scan of bf16.
KEYED = {"f32": ("tf32", "bf16"), "bf16": ("fp8",)}


def readings(cell: str, seeds, control_seeds, seconds: float, device, spec=None, cfg=None,
             traffic=None):
    """Yield one reading dict per (seed, side)."""
    spec = spec or core.load_spec()
    w = core.workload(spec, cell)
    cfg = cfg or core.config(spec, w["config"])
    traffic = traffic or core.traffic(w["traffic"])
    Run = core.kind(traffic["kind"]).Run
    codes = cfg["build"].get("precision", "f32")
    control = reference.CONTROL[codes]
    for seed in seeds:
        run = Run(cfg, traffic, seed, device)
        run.setup()
        run.window(seconds)
        run.collect()
        yield {"cell": cell, "seed": seed, "side": "program", "numbers": run.numbers()}
        if seed in control_seeds:
            yield {"cell": cell, "seed": seed, "side": control,
                   "numbers": run.numbers(control)}
            if hasattr(run, "keyed_numbers"):
                for p in KEYED[codes]:
                    yield {"cell": cell, "seed": seed, "side": f"keyed-{p}",
                           "numbers": run.keyed_numbers(p)}
        del run
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    t0 = time.perf_counter()
    for r in readings(args.workload, seeds, cseeds, args.seconds, torch.device("cuda:0")):
        r["t_s"] = time.perf_counter() - t0
        line = json.dumps(r)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
