"""The readings that the limits of ``correct`` are set from.

    python3 -m vqabench.control --workload NAME --seeds S1 S2 ... [--seconds 2]

For each seed it runs the cell as the benchmark does (set-up, a window of
``--seconds``, the program's state freed) and reads each compared number
three ways: the program against the float32 reference (the lower
reading: sound runs), the control against the same reference (the
reference computed on float8 operands in the program's place, the
precision below the configurations' bfloat16: the upper reading), and,
for a training cell, the reference with half of each batch left out and
the means taken over the rest (a planted fault); for a training cell with
a caption decoder also the program set up again with each of the
decode-attention backward kernels writing zeros (``decode_att_dvp``,
``decode_att_bwd``: planted faults). ``--program-only`` reads the first
way alone. One JSON line a seed on stdout. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import torch

from vqabench import manifest
from vqabench.reference.precision import Precision, exact_float32
from vqabench.run import Run


# planted faults of the program: the decode-attention kernel (on the CPU,
# its plain version) whose outputs are replaced by zeros
ZEROED_KERNELS = {"att_dvp_zero": "decode_att_dvp",
                  "att_bwd_zero": "decode_att_bwd"}
TRAIN_KEYS = ("loss_gap", "grad_gap", "update_gap", "grad_diff",
              "grad_diff_median")


@contextlib.contextmanager
def planted(fault: str):
    """The program with the kernel that ``fault`` names (and its plain
    version) writing zeros in place of each output."""
    from vqa_tpu_torch.ops.kernels import decode_att as da

    names = [ZEROED_KERNELS[fault], ZEROED_KERNELS[fault] + "_reference"]
    saved = {n: getattr(da, n) for n in names}

    def zeroed(f):
        def broken(*args, **kwargs):
            out = f(*args, **kwargs)
            if isinstance(out, tuple):
                return tuple(torch.zeros_like(o) for o in out)
            return torch.zeros_like(out)
        return broken

    try:
        for n, f in saved.items():
            setattr(da, n, zeroed(f))
        yield
    finally:
        for n, f in saved.items():
            setattr(da, n, f)


# torch's TF32 settings as the program finds them in a run of its own
_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _program_settings():
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = _TF32


def _freed(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(bench, cell, config, traffic, seed, seconds, device,
             program_only=False):
    driver = manifest.driver(traffic["driver"])
    run = Run(cell, config, traffic, seed, seconds, False, device)
    try:
        _program_settings()
        state = driver.setup(run)
        driver.window(run, state)
        driver.release(run, state)
        _freed(device)
        exact_float32()
        out = {"seed": seed}
        if traffic["driver"] == "train":
            sound = driver.readings(run, state, Precision("f32"))
            out.update(program={k: sound[k] for k in TRAIN_KEYS},
                       worst_leaves=[sound["grad_leaf"], sound["update_leaf"],
                                     sound["diff_leaf"]],
                       left_out=sound["left_out"],
                       leaves=sound["leaves"])
            if program_only:
                return out
            for name, prec, fault in (("control", "fp8", None),
                                      ("half_batch", "f32", "half")):
                r = driver.readings(run, state, Precision(prec), fault=fault)
                out[name] = {k: r[k] for k in TRAIN_KEYS}
            for fault in ZEROED_KERNELS if traffic.get("caption") else ():
                _program_settings()
                with planted(fault):
                    broken = driver.setup(run)
                driver.release(run, broken)
                _freed(device)
                exact_float32()
                broken["reference"] = state["reference"]
                r = driver.readings(run, broken, Precision("f32"))
                out[fault] = {k: r[k] for k in TRAIN_KEYS}
                out[fault]["worst_leaf"] = r["grad_leaf"]
        else:
            prog = driver.judge(run, state, Precision("f32"))
            out.update(program={"answer_gap": prog[0]})
            if len(prog) > 2:
                out["program"]["score_mismatch"] = prog[1]
            if program_only:
                return out
            ctrl = driver.judge(run, state, Precision("fp8"))
            out.update(control={"answer_gap": ctrl[0]})
            if len(prog) > 2:
                out["control"]["score_mismatch"] = ctrl[1]
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
    if not torch.cuda.is_available():
        print("vqabench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(bench, cell, config, traffic, seed, args.seconds, device,
                       args.program_only)
        out["s"] = time.perf_counter() - t0
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
