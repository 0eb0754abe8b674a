"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up (CUDA, the kernels' load, the inputs made on the device from the
seed, the index's build, warm-up of the cell's shapes) is timed as
`setup_s`; then one window of `--seconds`. With `--trace 1` a traced window
follows for the per-layer metrics, and the result line carries them in
place of the end-to-end ones. After the windows the plain reference
(benchmark/reference.py) judges what the timed path produced; the numbers
compared, each with its limit, are the last lines on standard error and the
last key of the result line, the last line on standard output.

Exits with 2 and prints no result where there is no CUDA card or fewer than
the cell asks for, and where the process holds JAX or the JAX package once
the windows have closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import core  # noqa: E402

OUT_DIR = ROOT / ".bench_out"  # the traced window's Chrome trace, per cell


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             spec=None, cfg=None, traffic=None, lims=None):
    """Set up, measure and judge one run of a cell on `device`. Returns
    (result dict, checks, stderr lines). The arguments after t_start let a
    test drive a cut-down cell on the CPU."""
    spec = spec or core.load_spec()
    w = core.workload(spec, cell)
    cfg = cfg or core.config(spec, w["config"])
    traffic = traffic or core.traffic(w["traffic"])
    lims = lims if lims is not None else core.limits(cell)
    run = core.kind(traffic["kind"]).Run(cfg, traffic, seed, device)
    cuda = torch.device(device).type == "cuda"
    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    t_cuda = time.perf_counter()
    try:  # the kernels' build or load, where the port has one to call
        import quake_tpu_torch._ext as ext
        if cuda and hasattr(ext, "lib"):
            ext.lib()
    except ImportError:
        pass
    t_load = time.perf_counter()
    run.setup()
    setup_s = time.perf_counter() - t_start
    phases = {"start": t - t_start, "cuda_init": t_cuda - t, "kernel_load": t_load - t_cuda}
    phases.update(run.setup_phases)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run.window(seconds)
    if trace:
        logdir = OUT_DIR / cell
        logdir.mkdir(parents=True, exist_ok=True)
        run.traced_window(float(traffic["trace_seconds"]), logdir)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    run.collect()
    numbers = run.numbers()
    correct, checks = core.judge(numbers, lims)
    e2e = run.end_to_end()
    e2e["setup_s"] = setup_s

    metrics, lines = {}, []
    if trace:
        if hasattr(run, "work"):
            run.work()
        for m in core.cell_metrics(spec, cell, "per_layer"):
            value = core.metric_reader(m["name"]).read(run.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in core.cell_metrics(spec, cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    lines.append("setup phases (s): " + json.dumps(phases))
    lines.extend(getattr(run, "notes", []))
    ops = run.readings.ops
    if ops:
        lines.append("maintenance: splits %d, deletes %d over %d ops" % (
            sum(o["splits"] for o in ops), sum(o["deletes"] for o in ops), len(ops)))
    lines.append("end to end: " + json.dumps(e2e))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        tr = run.readings.trace
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        breakdown = tr.breakdown()
    for name, c in checks.items():
        lines.append(f"check {name}: {c['value']} (limit {c['limit']})")
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info, "breakdown": breakdown}
    return result, checks, lines


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = core.load_spec()
    w = core.workload(spec, args.workload)
    chips = int(w["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA card(s), this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, checks, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     torch.device("cuda:0"), T_START, spec=spec)
    found = core.forbidden_modules()
    if found:
        log(f"no result: the process holds {', '.join(found)}")
        return 2
    result["device"]["count"] = chips
    result["device"]["power_limit_w"] = power_limit_w()
    for line in lines:
        log(line)
    print(core.result_line(result["correct"], result["attempted"], result["failed"],
                           result["metrics"], result["device"], checks,
                           breakdown=result["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
