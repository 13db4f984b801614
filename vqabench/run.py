"""The benchmark of the PyTorch/H100 port (``vqa_tpu_torch``).

    python3 -m vqabench.run --workload NAME --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` on the card it is started on: the
cell's driver (named by its traffic file) sets up the program from the
seed, the window measures for ``--seconds``, and the plain reference then
judges what the window produced. The last line of stdout is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read
from a torch.profiler trace of the window), ``device`` and, traced,
``breakdown``; its last key, ``compared``, holds each number the check
compared with its limit, which also end standard error.

Without a CUDA card, or with fewer than the cell asks for, it exits with
code 2 and prints no result. It exits with code 3 and prints no result
when JAX, Flax or the JAX package ``vqa_tpu`` was loaded in the process.
"""

from __future__ import annotations

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "vqabench-cache"
# caches at fixed paths inside the checkout, set before torch is imported
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vqa_tpu")
_IMPORTED_AT = time.monotonic()


def process_age() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED_AT


def forbidden_modules():
    """Top-level module names of JAX, Flax or the JAX package that this
    process holds (compared whole: ``vqa_tpu_torch`` is not ``vqa_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit in watts, by nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Run:
    """One run of a cell: what the driver reads and where it leaves things."""

    def __init__(self, cell, config, traffic, seed, seconds, trace, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.cleanup = []
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a part of set-up on the host clock, the card synchronized
        at its end, into ``phases`` (s)."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        self.phases[name] = time.perf_counter() - t0

    def span(self, name: str):
        """A range of the benchmark's own around a call into the program,
        recorded in the traced run."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)


class Readings:
    """What a per-layer metric's reader gets: the run, the window's
    measurement, the trace summary (None untraced) and the peak memory."""

    def __init__(self, run, measurement, summary, peak_bytes):
        self.config, self.traffic = run.config, run.traffic
        self.measurement, self.trace = measurement, summary
        self.peak_bytes = peak_bytes


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device):
    """Set up, measure, judge; returns the result object (without the
    ``compared`` lines' stderr copy)."""
    import torch

    from vqabench import manifest
    from vqabench.reference.precision import exact_float32
    from vqabench.trace import WINDOW, Tracer

    driver = manifest.driver(traffic["driver"])
    run = Run(cell, config, traffic, seed, seconds, trace, device)
    run.phases["start"] = process_age()
    cuda = device.type == "cuda"
    try:
        if cuda:
            with run.phase("context"):
                torch.cuda.set_device(device)
                torch.empty(1, device=device)  # the context, before the stats
                torch.cuda.reset_peak_memory_stats(device)
        state = driver.setup(run)
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = process_age()
        with Tracer(trace, cuda) as tracer:
            with run.span(WINDOW):
                measurement = driver.window(run, state)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        driver.release(run, state)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        exact_float32()
        compared, notes = driver.check(run, state)
    finally:
        for f in reversed(run.cleanup):
            f()
    name = cell["name"]
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if manifest.applies(m, name):
                value = setup_s if m["name"] == "setup_s" \
                    else measurement["metrics"][m["name"]]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        cell_e2e = {m["name"] for m in bench["end_to_end"]
                    if manifest.applies(m, name)}
        readings = Readings(run, measurement, tracer.summary, peak)
        for m in bench["per_layer"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            if m["moves"] not in cell_e2e:
                continue
            value = manifest.reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= limit for _, v, limit in compared) and bool(compared)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": measurement["work"],
              "failed": 0, "metrics": metrics, "device": dev}
    if trace and tracer.summary is not None:
        dev["busy_s"] = tracer.summary.busy_s()
        dev["window_s"] = tracer.summary.window_s
        result["breakdown"] = {"device_ops": tracer.summary.device_ops(),
                               "idle_gaps": tracer.summary.idle_gaps()}
    notes["setup_phases"] = run.phases
    if "quarter_rates" in measurement:
        notes["quarter_rates"] = measurement["quarter_rates"]
    result["notes"] = notes
    result["compared"] = {k: {"value": v, "limit": limit}
                          for k, v, limit in compared}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from vqabench import manifest

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    config = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"vqabench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    try:
        result = run_cell(bench, cell, config, traffic, args.seed,
                          args.seconds, bool(args.trace), device)
    except Exception:
        traceback.print_exc()
        print("vqabench: the run failed; no result", file=sys.stderr)
        return 1
    # read after the window, so that set-up does not wait on nvidia-smi
    result["device"]["power_limit_w"] = power_limit_w()
    found = forbidden_modules()
    if found:
        print(f"vqabench: the process loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
