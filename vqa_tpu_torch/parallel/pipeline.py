"""Pipelined execution over devices (counterpart of
``vqa_tpu/parallel/pipeline.py``).

- :class:`TwoStagePipeline`: the encoder (stage 0) on one device and the
  caption generator (stage 1) on another, the teacher-forced caption
  forward over microbatches, each stage on a CUDA stream of its own and the
  activations crossing the stage boundary in a ``non_blocking`` copy that
  waits on an event, so that stage 0 of microbatch i + 1 is queued before
  stage 1 of microbatch i, the JAX package's dispatch order. On one card
  both stages run on ``cuda:0`` (JAX's ``devices[0]`` and ``devices[-1]``
  on one device), still on two streams.
- :func:`pipeline_apply`: an N-stage GPipe-style pipeline of one
  homogeneous stage function, stage s on device s, over the same
  ``M + S - 1`` tick schedule as JAX's ``shard_map`` version (tick t feeds
  microbatch t to stage 0, stage s runs microbatch t - s, the last stage
  collects the outputs). JAX computes every stage on every tick and masks
  the bubble; here a stage with no microbatch at a tick runs nothing, with
  the same outputs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# the encoder outputs the teacher-forced generator reads
_STAGE_KEYS = ("v", "c", "c_target", "cap_len")


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass the devices "
                           "(torch.device('cpu') for the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class TwoStagePipeline:
    """Encoder/generator pipeline over two devices (default: the first and
    the last CUDA device). The model's encoder and generator move to their
    stages' devices."""

    def __init__(self, model, device0=None, device1=None):
        if model.generator is None:
            raise ValueError("the pipeline needs a generator stage")
        devices = None if device0 is not None and device1 is not None \
            else _cuda_devices()
        self.d0 = torch.device(device0 if device0 is not None else devices[0])
        self.d1 = torch.device(device1 if device1 is not None else devices[-1])
        self.encoder = model.encoder.to(self.d0).eval()
        self.generator = model.generator.to(self.d1).eval()
        self.s0 = torch.cuda.Stream(self.d0) if self.d0.type == "cuda" else None
        self.s1 = torch.cuda.Stream(self.d1) if self.d1.type == "cuda" else None

    def _encode(self, mb: Dict[str, Any]):
        with torch.cuda.stream(self.s0):     # no-op without a stream
            batch = {k: torch.as_tensor(v).to(self.d0, non_blocking=True)
                     for k, v in mb.items() if np.ndim(v) > 0}
            embed = self.encoder(batch)
            done = None
            if self.s0 is not None:
                done = torch.cuda.Event()
                done.record(self.s0)
        return embed, done

    def _generate(self, embed, done):
        with torch.cuda.stream(self.s1):
            if done is not None:
                self.s1.wait_event(done)
            # the stage boundary: an asynchronous copy of the activations
            moved = {}
            for k in _STAGE_KEYS:
                t = embed[k]
                if self.s1 is not None and t.device.type == "cuda":
                    t.record_stream(self.s1)
                moved[k] = t.to(self.d1, non_blocking=True)
            return self.generator(moved)

    def run(self, microbatches: Sequence[Dict[str, Any]]) -> List[Dict]:
        """The pipelined teacher-forced caption forward over
        ``microbatches`` (dicts of arrays or tensors; scalars are dropped):
        the generator's output of each, on stage 1's device."""
        outputs: List[Optional[Dict]] = [None] * len(microbatches)
        with torch.inference_mode():
            prev = None
            for i, mb in enumerate(microbatches):
                cur = self._encode(mb)          # queue stage 0 for i
                if prev is not None:
                    outputs[i - 1] = self._generate(*prev)
                prev = cur
            if prev is not None:
                outputs[-1] = self._generate(*prev)
        for stream, dev in ((self.s0, self.d0), (self.s1, self.d1)):
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)
        return outputs


def split_microbatches(batch: Dict[str, Any], n_micro: int
                       ) -> List[Dict[str, Any]]:
    """Split a batch into ``n_micro`` equal microbatches along axis 0.
    Scalar bookkeeping entries (the Loader's ``nvalid``) go into every
    microbatch unchanged."""
    size = next(v.shape[0] for v in batch.values() if np.ndim(v) > 0)
    if size % n_micro:
        raise ValueError(f"batch {size} not divisible by {n_micro}")
    step = size // n_micro
    return [{k: (v[i * step:(i + 1) * step] if np.ndim(v) > 0 else v)
             for k, v in batch.items()}
            for i in range(n_micro)]


def make_stage_mesh(n_stages: int, devices: Optional[Sequence] = None
                    ) -> List[torch.device]:
    """The devices of ``n_stages`` stages: the first ``n_stages`` of
    ``devices`` (default: the CUDA devices)."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else _cuda_devices())]
    if len(devices) < n_stages:
        raise ValueError(f"{n_stages} stages need as many devices, "
                         f"have {len(devices)}")
    return devices[:n_stages]


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def pipeline_apply(devices: Sequence[torch.device],
                   stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any,
                   microbatches: torch.Tensor) -> torch.Tensor:
    """N-stage pipeline: stage s holds ``stacked_params``' slice s (a tensor
    or a dict / list of tensors with the stages on the leading axis) on
    ``devices[s]`` and applies ``stage_fn(params, x)``, which keeps the
    activation's shape. ``microbatches`` [M, mb, ...] -> [M, mb, ...] on
    their own device."""
    n_stages, n_micro = len(devices), microbatches.shape[0]
    params = [_tree_map(lambda p, s=s: p[s].to(devices[s]), stacked_params)
              for s in range(n_stages)]
    inbox: List[Optional[torch.Tensor]] = [None] * n_stages
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        nxt: List[Optional[torch.Tensor]] = [None] * n_stages
        for s in range(n_stages):
            i = t - s                    # the microbatch stage s runs now
            if not 0 <= i < n_micro:
                continue
            x = microbatches[i].to(devices[0]) if s == 0 else inbox[s]
            y = stage_fn(params[s], x)
            if s == n_stages - 1:
                outs[i] = y
            else:   # to the next stage's device, for the next tick
                nxt[s + 1] = y.to(devices[s + 1], non_blocking=True)
        inbox = nxt
    return torch.stack([o.to(microbatches.device) for o in outs])
