"""Multi-process dry run of the port's training steps (counterpart of
``__graft_entry__.dryrun_multichip``).

    python -m vqa_tpu_torch.parallel.dryrun --procs N [--device cuda|cpu]

spawns N ranks, each a fresh interpreter, joined through the
``VQA_TPU_MULTIHOST`` variables on a free localhost port. They run on the
card (``--device cuda``, the default; without a CUDA device the run
raises) unless ``--device cpu`` is given. The ranks form
an ``(N / 2, 2)`` mesh where N is even, else ``(N, 1)``, and each takes
one step of the MTL model (encoder, VQA-E head, BUTD decoder), of ReGAT
(the relation encoder; its graphs shard with the features) and of the
max-relevance ``train_select`` step, at the dry run's tiny shapes, on its
rows of a seeded global batch, and prints one OK line for each. On CUDA
with ranks sharing a card the backend is gloo, which cannot all-gather
CUDA tensors, so the mesh is ``(N, 1)`` there and the run says so. Exits
non-zero when a rank fails.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# __graft_entry__.dryrun_multichip's shapes
DIMS = dict(ntoken=64, v_dim=32, embed_dim=12, hidden_dim=16,
            decoder_hidden_dim=16, ans_dim=16, c_len=8, dropout=0.1,
            att_type="new")
OBJS, Q_LEN, N_CAP = 6, 5, 3


def global_batch(rng, batch_size, caption=False, graph=False, select=False):
    """The dry run's seeded global batch (``__graft_entry__._batch``)."""
    nt, cl = DIMS["ntoken"], DIMS["c_len"]
    out = {"img": rng.standard_normal(
               (batch_size, OBJS, DIMS["v_dim"])).astype(np.float32),
           "q": rng.integers(0, nt, (batch_size, Q_LEN)),
           "a": (rng.random((batch_size, DIMS["ans_dim"])) < 0.01
                 ).astype(np.float32)}
    if caption:
        out["c"] = rng.integers(0, nt, (batch_size, cl))
        out["cap_len"] = rng.integers(5, cl + 1, (batch_size,))
    if graph:
        out["graph"] = rng.integers(0, 12, (batch_size, OBJS, OBJS))
    if select:
        out["c_all"] = rng.integers(0, nt, (batch_size, N_CAP, cl))
        out["cap_len_all"] = rng.integers(3, cl + 1, (batch_size, N_CAP))
    return out


def run_rank(device: str) -> None:
    from vqa_tpu_torch.models.wrapper import set_model
    from vqa_tpu_torch.parallel import mesh as mesh_lib
    from vqa_tpu_torch.training.optim import make_optimizer
    from vqa_tpu_torch.training.select import make_train_select_step
    from vqa_tpu_torch.training.state import TrainState, make_train_step

    world = mesh_lib.init_distributed(device)
    n_model = 2 if world.world % 2 == 0 else 1
    if n_model == 2 and world.backend == "gloo" and world.device.type == "cuda":
        n_model = 1
        if mesh_lib.is_main():
            print("dryrun: the ranks share a card, so the backend is gloo, "
                  "which cannot all-gather CUDA tensors: mesh "
                  f"({world.world}, 1), no tensor parallelism", flush=True)
    mesh = mesh_lib.make_mesh(n_model=n_model)
    n_data = world.world // n_model
    rng = np.random.default_rng(0)
    cases = (("mtl", dict(encoder_type="base", predictor_type="base-cap",
                          decoder_type="butd", use_mtl=True),
              dict(caption=True), make_train_step),
             ("regat", dict(encoder_type="relation", predictor_type="base",
                            decoder_type="none", conv_layer=1),
              dict(graph=True), make_train_step),
             ("train_select", dict(encoder_type="base",
                                   predictor_type="base-cap",
                                   decoder_type="base", use_mtl=True),
              dict(select=True), make_train_select_step))
    try:
        for name, kinds, extra, factory in cases:
            model = set_model(**DIMS, **kinds, device=world.device,
                              generator=torch.Generator().manual_seed(0))
            mesh_lib.shard_params(model, mesh)
            opt = make_optimizer(model, lr=2e-3, steps_per_epoch=10,
                                 step_size=2, warm_up=1)
            state = TrainState(model, opt, seed=0)
            mesh_lib.replicate_global(mesh, state)
            batch = global_batch(rng, 2 * n_data, **extra)
            local = {k: torch.as_tensor(v).to(world.device)
                     for k, v in mesh_lib.shard_batch(mesh, batch).items()}
            metrics = factory(model, opt, compute_dtype=None,
                              mesh=mesh)(state, local)
            loss = metrics["loss"].item()
            if not np.isfinite(loss) or state.step != 1:
                raise RuntimeError(f"[{name}] loss {loss}, step {state.step}")
            print(f"dryrun[{name}] OK: rank {world.rank} of {world.world}, "
                  f"mesh (data={n_data}, model={n_model}), "
                  f"sharded {len(getattr(model, 'tp_layout', {}))} tensors, "
                  f"loss={loss:.4f}", flush=True)
    finally:
        if world.created:
            torch.distributed.destroy_process_group()


def free_port() -> int:
    """A free localhost port for the process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def wait_ranks(procs, timeout: float) -> list:
    """Wait for every rank's process; as soon as one fails, or the time
    runs out, kill the others (they would wait in a collective for the
    failed one). Returns each process's output (None where not piped);
    the caller reads the return codes."""
    outs = [None] * len(procs)

    def drain(i):
        outs[i] = procs[i].communicate()[0]

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or \
                any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.1)
    for t in threads:
        t.join()
    return outs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--timeout", type=float, default=600.0)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the dry run on the CPU")
    if os.environ.get("VQA_TPU_PROC_ID") is not None:
        run_rank(args.device)
        return 0
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for rank in range(args.procs):
        env = dict(os.environ, VQA_TPU_MULTIHOST="1",
                   VQA_TPU_COORD=f"localhost:{port}",
                   VQA_TPU_NPROCS=str(args.procs), VQA_TPU_PROC_ID=str(rank),
                   PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vqa_tpu_torch.parallel.dryrun",
             "--procs", str(args.procs), "--device", args.device], env=env))
    wait_ranks(procs, args.timeout)
    failed = sum(p.returncode != 0 for p in procs)
    print(f"dryrun: {args.procs - failed} of {args.procs} ranks passed",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
