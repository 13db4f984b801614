"""Experiment logging: file+stdout logger and scalar metrics writer
(counterpart of ``vqa_tpu/training/logging.py``, a copy).

A timestamped file logger under ``checkpoint/<exp>/`` and per-batch scalar
series (the reference's TensorBoard tags ``train/loss``, ``train/score``,
``train/cap/loss``, ``train/eval``, ``val/vqa/score``). Scalars always go
to a JSONL file (``scalars.jsonl``, which ``scripts/gate_check.py`` reads);
TensorBoard event files are written too when tensorboard is importable.
``NullLog`` stands in for both on a rank that writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class Logger:
    """File + stdout logger (util/utils.py:38-55 semantics)."""

    def __init__(self, exp_name: str, log_name: str = "log.txt",
                 root: str = "checkpoint"):
        save_path = os.path.join(root, exp_name)
        os.makedirs(save_path, exist_ok=True)
        t = time.strftime("%y%m%d-%H-%M-%S_", time.localtime())
        self.log_file = open(os.path.join(save_path, t + log_name), "w+")
        self.exp_name = exp_name
        self.save_path = save_path

    def write(self, msg: str) -> None:
        self.log_file.write(time.strftime("%y%m%d-%H:%M:%S ", time.localtime()))
        self.log_file.write(msg + "\n")
        self.log_file.flush()

    def show(self, msg: str) -> None:
        print(msg)
        self.write(msg)

    def close(self) -> None:
        self.log_file.close()


class NullLog:
    """The logger and metrics writer of a rank that writes no artifacts
    (under several processes rank 0 alone logs): every call does nothing."""

    def write(self, *args, **kwargs) -> None:
        pass

    show = add_scalar = add_scalars = add_hparams = flush = close = write


class MetricsWriter:
    """Scalar series writer: JSONL always, TensorBoard if available."""

    def __init__(self, save_path: str, comment: str = ""):
        os.makedirs(save_path, exist_ok=True)
        self.jsonl = open(os.path.join(save_path, "scalars.jsonl"), "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(comment=comment)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                     "step": int(step),
                                     "ts": time.time()}) + "\n")
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def add_hparams(self, hparams: Dict, metrics: Dict) -> None:
        self.jsonl.write(json.dumps({"hparams": hparams,
                                     "metrics": {k: float(v) for k, v in
                                                 metrics.items()}}) + "\n")
        if self.tb is not None:
            self.tb.add_hparams(hparam_dict=hparams, metric_dict=metrics)

    def flush(self) -> None:
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self) -> None:
        self.flush()
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
