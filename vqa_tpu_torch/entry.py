"""The flagship forward and the multi-process dry run as functions (counterpart
of ``__graft_entry__.py``).

- ``entry(device=None)`` returns ``(forward, (params, batch))``: the
  flagship Up-Down VQA forward (MultiplyAttention, full production dims)
  as a function of its parameters, ``forward(params, batch) -> logits
  [32, 3129]``, with the parameters (``dict(model.named_parameters())``)
  and a B=32 batch drawn by ``np.random.default_rng(0)`` as the JAX entry
  point draws it.
- ``dryrun_multichip(n)`` runs the multi-process dry run of the training
  steps (``parallel/dryrun.py``) over n ranks.

Both run on the card unless ``device="cpu"`` is passed.

    python -m vqa_tpu_torch.entry [--device cuda|cpu]

runs the forward once and prints its shape, then the dry run over 8
processes, as the JAX entry point's ``__main__`` does over 8 devices.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from vqa_tpu_torch.models.wrapper import resolve_device, set_model

NTOKEN, ANS_DIM, V_DIM, NUM_OBJS, Q_LEN, BATCH = 20000, 3129, 2048, 36, 10, 32


def example_batch(rng: np.random.Generator,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """``__graft_entry__._batch``'s draws, in its order: features, question
    tokens, answer targets."""
    img = rng.standard_normal((BATCH, NUM_OBJS, V_DIM)).astype(np.float32)
    q = rng.integers(0, NTOKEN, (BATCH, Q_LEN))
    a = (rng.random((BATCH, ANS_DIM)) < 0.01).astype(np.float32)
    return {k: torch.from_numpy(v).to(device)
            for k, v in (("img", img), ("q", q), ("a", a))}


def entry(device=None) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor],
                                                Dict[str, torch.Tensor]]]:
    """(forward, (params, batch)) for the flagship Up-Down VQA forward in
    eval mode; ``forward(params, batch)`` is ``functional_call`` of the
    model over ``params``."""
    dev = resolve_device(device)
    model = set_model(
        encoder_type="base", predictor_type="base", decoder_type="none",
        ntoken=NTOKEN, v_dim=V_DIM, embed_dim=300, hidden_dim=1024,
        decoder_hidden_dim=512, ans_dim=ANS_DIM, c_len=20, dropout=0.2,
        att_type="new", generator=torch.Generator().manual_seed(0),
        device=dev).eval()
    batch = example_batch(np.random.default_rng(0), dev)
    params = dict(model.named_parameters())

    def forward(params: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        predict, _ = functional_call(model, params, (batch,))
        return predict

    return forward, (params, batch)


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """The training steps over ``n_devices`` processes at tiny shapes
    (``python -m vqa_tpu_torch.parallel.dryrun``); raises when a rank
    fails."""
    from vqa_tpu_torch.parallel import dryrun

    argv = ["--procs", str(n_devices), "--device",
            resolve_device(device).type]
    if dryrun.main(argv) != 0:
        raise RuntimeError(f"dryrun_multichip({n_devices}): a rank failed")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = None if args.device == "cuda" else "cpu"
    forward, (params, batch) = entry(device)
    with torch.inference_mode():
        out = forward(params, batch)
    print("entry forward:", tuple(out.shape), flush=True)
    dryrun_multichip(8, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
