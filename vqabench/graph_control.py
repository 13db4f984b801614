"""The readings that the limits of a GCN-LSTM training cell are set from
(``vqabench.control`` for the driver ``graph_train``).

    python3 -m vqabench.graph_control --workload NAME --seeds S1 S2 ... [--seconds 2]

For each seed it runs the cell as the benchmark does (set-up, a window of
``--seconds``, the program's state freed) and reads each compared number
of the driver (:func:`vqabench.drivers.graph_train.readings`): the
program against the float32 reference (the lower reading: sound runs),
the control (the reference computed on float8 operands in the program's
place, the precision below the configuration's bfloat16), and the
reference with a planted fault against the sound reference: half of each
batch left out, the decoder reading the attended features in place of
the graph stage's output, the correlation softmaxed over axis 2, the
label bias left out, the graph stage's dropout left out
(:data:`vqabench.reference.gcn_lstm.FAULTS`). ``--program-only`` reads
the first way alone. One JSON line a seed on stdout, with the window's
conv routes. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from vqabench import control, manifest
from vqabench.drivers import graph_train
from vqabench.reference import gcn_lstm
from vqabench.reference.precision import Precision, exact_float32
from vqabench.run import Run

# the readings beside the program's: (name, precision, fault)
READINGS = (("control", "fp8", None), ("half_batch", "f32", "half"),
            *((f, "f32", f) for f in gcn_lstm.FAULTS))


def readings(cell, config, traffic, seed, seconds, device,
             program_only=False):
    run = Run(cell, config, traffic, seed, seconds, False, device)
    try:
        control._program_settings()
        state = graph_train.setup(run)
        graph_train.window(run, state)
        graph_train.release(run, state)
        control._freed(device)
        exact_float32()
        sound = graph_train.readings(run, state, Precision("f32"))
        out = {"seed": seed,
               "program": {k: sound[k] for k in control.TRAIN_KEYS},
               "worst_leaves": [sound["grad_leaf"], sound["update_leaf"],
                                sound["diff_leaf"]],
               "left_out": sound["left_out"], "routes": state["routes"]}
        if program_only:
            return out
        for name, prec, fault in READINGS:
            r = graph_train.readings(run, state, Precision(prec), fault=fault)
            out[name] = {k: r[k] for k in control.TRAIN_KEYS}
            out[name]["worst_leaf"] = r["grad_leaf"]
        return out
    finally:
        for f in reversed(run.cleanup):
            f()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--program-only", action="store_true")
    args = parser.parse_args(argv)
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    config = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    if traffic["driver"] != "graph_train":
        print(f"vqabench.graph_control: {args.workload} is not a GCN-LSTM "
              "training cell; use vqabench.control", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("vqabench.graph_control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, config, traffic, seed, args.seconds, device,
                       args.program_only)
        out["s"] = time.perf_counter() - t0
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
