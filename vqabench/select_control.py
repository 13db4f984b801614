"""The readings that the limits of a max-relevance cell are set from
(``vqabench.control`` for the driver ``select_train``).

    python3 -m vqabench.select_control --workload NAME --seeds S1 S2 ... [--seconds 2]

For each seed it runs the cell as the benchmark does (set-up, a window of
``--seconds``, the program's state freed) and reads each compared number
of the driver (:func:`vqabench.drivers.select_train.readings`): the
program against the float32 reference (the lower reading: sound runs),
the control (the reference computed on float8 operands in the program's
place, the precision below the configuration's bfloat16), and the
reference with a planted fault against the sound reference: half of each
batch left out, the first candidate always chosen, the highest-loss
candidate chosen, the head's fusion softmax over the boxes
(:data:`vqabench.reference.qrel.FAULTS`). ``--program-only`` reads the
first way alone. One JSON line a seed on stdout, with the selection's
notes beside each reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from vqabench import control, manifest
from vqabench.drivers import select_train
from vqabench.reference import qrel
from vqabench.reference.precision import Precision, exact_float32
from vqabench.run import Run

KEYS = control.TRAIN_KEYS + ("select_agree", "select_gap")
# the readings beside the program's: (name, precision, fault)
READINGS = (("control", "fp8", None), ("half_batch", "f32", "half"),
            *((f, "f32", f) for f in qrel.FAULTS))


def readings(cell, config, traffic, seed, seconds, device,
             program_only=False):
    run = Run(cell, config, traffic, seed, seconds, False, device)
    try:
        control._program_settings()
        state = select_train.setup(run)
        select_train.window(run, state)
        select_train.release(run, state)
        control._freed(device)
        exact_float32()
        sound = select_train.readings(run, state, Precision("f32"))
        out = {"seed": seed, "program": {k: sound[k] for k in KEYS},
               "worst_leaves": [sound["grad_leaf"], sound["update_leaf"],
                                sound["diff_leaf"]],
               "left_out": sound["left_out"]}
        if program_only:
            return out
        for name, prec, fault in READINGS:
            r = select_train.readings(run, state, Precision(prec), fault=fault)
            out[name] = {k: r[k] for k in KEYS}
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
    if traffic["driver"] != "select_train":
        print(f"vqabench.select_control: {args.workload} is not a "
              "max-relevance cell; use vqabench.control", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("vqabench.select_control: no CUDA card", file=sys.stderr)
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
