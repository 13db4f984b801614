"""Training and evaluation loops (counterpart of ``vqa_tpu/training/train.py``).

The JAX package's semantics, step for step: Adamax + StepLR with warm-up and
the gradient clip (``training/optim.py``), per-batch scalar logging, the
metric fetch deferred one step (a step issues no host synchronisation, and
the host reads step i-1's scalars only after step i is queued),
validation before each epoch checkpoint, the mid-epoch average over the
steps actually run, asynchronous interval and epoch saves, a synchronous
``best_model.ckpt`` (best by validation score, or by train caption loss
without a VQA head) that the first validation always materializes, and
padded tail rows masked by ``nvalid`` in evaluation. ``train_select`` is
the same loop over all-candidate batches with the max-relevance step.

Over a mesh (``parallel/mesh.py``; ``mesh=``) each process feeds its own
shard (``Loader.for_process``): ``train`` slices the tensor-parallel heads
(``shard_params``), broadcasts rank 0's initial state, steps with the
gradients averaged over the data group, lets rank 0 alone write the logs
and checkpoints (every rank takes part in a save, which gathers the
slices) and ends on a barrier; ``evaluate`` gathers every rank's
per-sample results and dedupes them by sample id, so the score is exact
for any world size.

Kept as the JAX package has them, since they change numbers its tests
compare: with ``batches`` set, the epoch-end average divides by
``batches + 1``; and ``val_checkpoint`` 1 (or True) validates every
``num_samples`` batches, a modulus no epoch reaches when it has fewer
batches than samples.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from vqa_tpu_torch import tracing
from vqa_tpu_torch.data.loader import prefetch_to_device
from vqa_tpu_torch.models.wrapper import VQAModel
from vqa_tpu_torch.parallel import mesh as mesh_lib
from vqa_tpu_torch.training import optim as optim_lib
from vqa_tpu_torch.training.checkpoint import Checkpointer, save_checkpoint
from vqa_tpu_torch.training.logging import Logger, MetricsWriter, NullLog
from vqa_tpu_torch.training.select import make_train_select_step
from vqa_tpu_torch.training.state import (
    TrainState, make_eval_step, make_train_step)

MODEL_KEYS = ("img", "img_q", "img_scale", "q", "a", "c", "cap_len", "graph",
              "c_all", "cap_len_all")


def model_batch(batch: Dict) -> Dict:
    """Strip loader bookkeeping keys; keep only model inputs."""
    return {k: batch[k] for k in MODEL_KEYS if k in batch}


def compute_dtype_of(train_dtype: str) -> Optional[torch.dtype]:
    """The step's compute dtype for ``--train_dtype`` (None: f32)."""
    if train_dtype in ("float32", "f32", ""):
        return None
    return getattr(torch, train_dtype)


def evaluate(eval_step, dataloader, device, logger: Optional[Logger] = None,
             writer: Optional[MetricsWriter] = None,
             ans_index: Optional[Dict] = None,
             save_path: Optional[str] = None, mesh=None):
    """VQA evaluation over ``dataloader`` (``eval_step`` from
    ``make_eval_step``; batches go to ``device``).

    Returns (score, bound), or the per-answer-type metric dict when
    ``ans_index`` is given. Padded tail rows are masked via ``nvalid``.
    Under several processes (a ``mesh``; one process has none) each
    rank scores the rows of its loader's shard; then every rank's ids,
    scores, labels and bounds are gathered and deduplicated by sample id
    (the shards wrap-pad with repeats), in dataset order, so the score and
    the answer-type breakdown are those of one process.
    """
    all_score, all_label, all_bound, all_id = [], [], [], []
    n = dataloader.num_samples
    running = 0.0
    start = time.time()
    feed = prefetch_to_device(iter(dataloader), device, keys=MODEL_KEYS)
    for i, batch in enumerate(feed):
        nvalid = int(batch.pop("nvalid"))
        if "id" in batch:
            all_id.append(np.asarray(batch["id"])[:nvalid])
        s, label, bound = eval_step(model_batch(batch))
        s = s.float().cpu().numpy()[:nvalid]
        all_score.append(s)
        all_label.append(label.cpu().numpy()[:nvalid])
        all_bound.append(bound.float().cpu().numpy()[:nvalid])
        running += float(s.sum())
        if writer:
            writer.add_scalar("val/vqa/score", running / n, i)

    all_score = np.concatenate(all_score)
    all_label = np.concatenate(all_label)
    all_bound = np.concatenate(all_bound)
    if mesh is not None:
        if not all_id:
            raise ValueError("evaluate under several processes needs the "
                             "sample ids ('id') in the batches")
        parts = mesh_lib.all_gather_object(
            (np.concatenate(all_id), all_score, all_label, all_bound))
        ids, all_score, all_label, all_bound = (
            np.concatenate([p[k] for p in parts]) for k in range(4))
        # dedupe the wrap-pad repeats; dataset order for ans_index
        _, keep = np.unique(ids.astype(np.int64), return_index=True)
        all_score, all_label, all_bound = (
            all_score[keep], all_label[keep], all_bound[keep])
        n = len(keep)
    # summed in one order on every world size, so the scores agree exactly
    score = float(all_score.astype(np.float64).sum()) / n
    target_score = float(all_bound.astype(np.float64).sum()) / n
    if logger:
        t = time.strftime("%H:%M:%S", time.gmtime(time.time() - start))
        logger.show(f"[{t}] evaluate score: {score:.10f} / bound: {target_score:.10f}")

    if save_path:
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, "scores.npy"), all_score)
        np.save(os.path.join(save_path, "labels.npy"), all_label)

    if ans_index is not None:
        output = {}
        for ans in ans_index:
            idx = np.asarray(ans_index[ans])
            # a mismatched index file is a data bug: fail loudly
            if idx.size and idx.max() >= len(all_score):
                raise ValueError(
                    f"answer-type index '{ans}' refers to sample "
                    f"{int(idx.max())} but only {len(all_score)} evaluated "
                    "samples exist — index file does not match the val split")
            output["hparam/" + ans] = float(all_score[idx].sum() / max(len(idx), 1))
        if logger:
            for k in output:
                logger.write(f"\t{k}: {output[k]:.10f}")
        output["hparam/score"] = score
        return output
    return score, target_score


def train(model: VQAModel,
          lr: float,
          train_loader,
          val_loader,
          logger: Logger,
          save_path: str,
          num_epoches: int,
          comment: str = "",
          checkpoint: int = 10000,
          start_epoch: int = 0,
          batches: int = 0,
          max_norm: float = 0.25,
          best_score: float = 0.0,
          warm_up: int = 0,
          step_size: int = 0,
          gamma: float = 0.5,
          lr_vqa: float = 0.0,
          lr_cap: float = 0.0,
          val_checkpoint: int = 0,
          seed: int = 1111,
          init_state: Optional[TrainState] = None,
          profile_dir: Optional[str] = None,
          profile_steps: tuple = (10, 20),
          train_dtype: str = "float32",
          step_factory=None, mesh=None) -> TrainState:
    """Train ``model`` in place; returns the final TrainState.

    ``init_state`` (a resumed state, its optimizer included) replaces the
    fresh one; over a tensor-parallel mesh its model must have been sliced
    (``mesh.shard_params``) before its optimizer was made. ``profile_dir``:
    a ``torch.profiler`` trace of global steps [profile_steps) goes to
    ``profile_dir/trace.json``. ``step_factory``: ``(model, optimizer,
    compute_dtype=, mesh=) -> step``, ``make_train_step`` when None.
    ``mesh``: train over the mesh's processes (the module docstring); the
    model stays sliced afterwards.
    """
    main = mesh_lib.is_main()
    writer = MetricsWriter(save_path, comment=comment) if main else NullLog()
    logger = logger if main else NullLog()
    steps_per_epoch = batches if batches else len(train_loader)
    device = next(model.parameters()).device
    # the JAX loop draws one sample batch to initialise its state; drawing
    # it here too keeps the shuffled order of the epochs the same
    if next(iter(train_loader), None) is None:
        raise ValueError("empty train loader")
    if init_state is not None:
        state = init_state
    else:
        mesh_lib.shard_params(model, mesh)
        optimizer = optim_lib.make_optimizer(
            model, lr=lr, lr_vqa=lr_vqa, lr_cap=lr_cap, max_norm=max_norm,
            warm_up=warm_up, step_size=step_size, gamma=gamma,
            steps_per_epoch=steps_per_epoch)
        state = TrainState(model, optimizer, seed=seed)
    mesh_lib.replicate_global(mesh, state)
    train_step = (step_factory or make_train_step)(
        model, state.optimizer, compute_dtype=compute_dtype_of(train_dtype),
        mesh=mesh)
    eval_step = make_eval_step(model)
    checkpointer = Checkpointer()

    has_predictor = model.predictor is not None
    best_epoch = start_epoch
    best_path = os.path.join(save_path, "best_model.ckpt")
    # every rank takes part in a save: they share rank 0's view of the file
    have_best = mesh_lib.broadcast_object(os.path.exists(best_path))

    def val(avg_loss, best_score, best_epoch, epoch, start):
        nonlocal have_best
        if has_predictor:
            eval_score, bound = evaluate(eval_step, val_loader, device,
                                         mesh=mesh)
            t = time.strftime("%H:%M:%S", time.gmtime(time.time() - start))
            logger.show(f"[Epoch {epoch}] avg_loss: {avg_loss:.4f} | "
                        f"score: {eval_score:.10f} ({t})")
            writer.add_scalar("train/eval", eval_score, epoch)
            if eval_score > best_score:     # strict >, as the reference
                save_checkpoint(best_path, state, epoch, eval_score)
                best_score = eval_score
                best_epoch = epoch
            elif not have_best:
                # materialize a best checkpoint on the first validation,
                # without adopting its score as the threshold
                save_checkpoint(best_path, state, epoch, eval_score)
            logger.show(f"[Result] best epoch: {best_epoch}, "
                        f"score: {best_score:.10f} / {bound:.10f}")
        else:
            logger.show(f"[Epoch {epoch}] avg_loss: {avg_loss:.4f}")
            # caption-only runs: best by train caption loss, stored as -loss
            # so that "higher is better" holds for best_score
            if (-avg_loss) > best_score:
                save_checkpoint(best_path, state, epoch, -avg_loss)
                best_score = -avg_loss
                best_epoch = epoch
            elif not have_best:
                save_checkpoint(best_path, state, epoch, -avg_loss)
            logger.show(f"[Result] best epoch: {best_epoch}, "
                        f"cap loss: {-best_score:.10f}")
        have_best = True
        return best_score, best_epoch

    profiler = None
    try:
        for epoch in range(start_epoch, num_epoches):
            # join the previous epoch's saves before this epoch's first step,
            # as the JAX loop does: at most one epoch's saves are pending
            checkpointer.wait_for_checkpoints()
            start = time.time()
            avg_loss = 0.0
            prev_loss = 0.0
            i = -1
            pending = None   # (global step, device metrics) not yet fetched

            def drain():
                nonlocal avg_loss, pending
                if pending is None:
                    return
                pgstep, pmetrics = pending
                pending = None
                names = list(pmetrics)
                # one host synchronisation for all of the step's scalars
                values = torch.stack([pmetrics[k].detach().float().reshape(())
                                      for k in names]).tolist()
                fetched = dict(zip(names, values))
                writer.add_scalars({k: v for k, v in fetched.items()
                                    if k != "loss"}, pgstep)
                avg_loss += fetched["loss"]

            feed = prefetch_to_device(
                (model_batch(b) for b in train_loader), device, size=2,
                keys=MODEL_KEYS)
            for i, mb in enumerate(feed):
                if batches and i == batches:
                    break
                gstep = epoch * steps_per_epoch + i
                if profile_dir and gstep == profile_steps[0]:
                    profiler = _start_profiler(device)
                metrics = train_step(state, mb)
                if profiler is not None and gstep + 1 == profile_steps[1]:
                    _stop_profiler(profiler, device, profile_dir)
                    profiler, profile_dir = None, None   # capture once
                drain()                  # step i-1's scalars, overlapped
                pending = (gstep, metrics)

                if checkpoint and i % checkpoint == 0 and i != 0:
                    drain()
                    t = time.strftime("%H:%M:%S", time.gmtime(time.time() - start))
                    logger.write(f"[Batch {i}] loss: "
                                 f"{(avg_loss - prev_loss) / checkpoint:.4f} ({t})")
                    prev_loss = avg_loss
                # 1 / True: the reference's batches-vs-samples modulus
                # (train.py:121); a value > 1 validates every N batches
                val_every = (train_loader.num_samples if val_checkpoint in (1, True)
                             else int(val_checkpoint))
                if val_every and i != 0 and i % val_every == 0:
                    drain()
                    best_score, best_epoch = val(avg_loss / (i + 1), best_score,
                                                 best_epoch, epoch, start)
                    checkpointer.save_checkpoint_async(os.path.join(
                        save_path, f"epoch_{epoch}_batch_{i}.ckpt"), state,
                        epoch, best_score)

            # validate first, then write the epoch checkpoint: it stores
            # best_score for resume
            drain()
            best_score, best_epoch = val(avg_loss / max(i + 1, 1), best_score,
                                         best_epoch, epoch, start)
            checkpointer.save_checkpoint_async(
                os.path.join(save_path, f"epoch_{epoch}.ckpt"), state, epoch,
                best_score)
            if epoch >= warm_up and step_size != 0:
                factor = optim_lib.steplr_factor(epoch + 1, warm_up, step_size, gamma)
                logger.show(f"learning rate factor: {factor}")
    finally:
        if profiler is not None:
            profiler.stop()
        checkpointer.close()
        writer.close()
    # every rank sees rank 0's checkpoints before it reads them
    mesh_lib.barrier()
    return state


def _start_profiler(device: torch.device):
    """A profiler over the next steps, of every thread: the Loader's
    producer (``vqa.feed.batch``) and autograd's device thread too. The
    spans' totals (``vqa_tpu_torch/tracing.py``) start again with it."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, experimental_config=
                   _ExperimentalConfig(profile_all_threads=True))
    tracing.reset()
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, profile_dir: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def train_select(model: VQAModel, lr: float, train_loader, val_loader,
                 logger: Logger, save_path: str, num_epoches: int,
                 **kwargs) -> TrainState:
    """The max-relevance (Q-Relevant) training loop: ``train`` with the
    step of ``training/select.py``. ``train_loader`` yields all-candidate
    batches: ``Loader(dataset, ..., batch_method="get_batch_all",
    length=len(dataset.questions))`` over a ``VQACaptionAllDataset``."""
    return train(model=model, lr=lr, train_loader=train_loader,
                 val_loader=val_loader, logger=logger, save_path=save_path,
                 num_epoches=num_epoches, step_factory=make_train_select_step,
                 **kwargs)
