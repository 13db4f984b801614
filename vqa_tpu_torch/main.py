"""CLI entry point of the port: train / val / decode.

Run as ``python -m vqa_tpu_torch.main`` with the flags of ``main.py`` (the
JAX package's entry point), and the same mode dispatch and artifact layout
under ``checkpoint/<comment>/``: ``param.pkl``, ``param.txt``, the log,
``scalars.jsonl``, ``epoch_{n}.ckpt``, ``best_model.ckpt``, ``valid/``
(``scores.npy``, ``labels.npy``) and ``decode.txt``.

It builds on ``--device`` (default ``cuda``, this rank's card
``cuda:{LOCAL_RANK % device_count}``); without a CUDA device it fails
unless ``--device cpu`` is given, where the kernels run as their plain
versions. Checkpoints are the port's own ``torch.save`` format
(``training/checkpoint.py``); ``--load_model`` also takes a reference
``torch.save(state_dict())`` file for val, decode and a warm start. Where
``--pretrained_embed_path`` names a file, its GloVe table is the encoder's
frozen word embedding, as in the JAX entry point. ``--train_strategy
select`` trains with the max-relevance step over every candidate caption
(CONFIGS.md config 4; its feed is the dense features of the all-captions
dataset, as the JAX entry point builds it).

Several processes (``parallel/mesh.py``): ``torchrun --nproc_per_node N -m
vqa_tpu_torch.main ...``, or N processes each with ``VQA_TPU_MULTIHOST=1
VQA_TPU_COORD=host:port VQA_TPU_NPROCS=N VQA_TPU_PROC_ID=i``. The ranks
form an ``(N / n_model_shards, n_model_shards)`` mesh: ``--batch_size`` is
each data rank's batch, each data rank reads its shard of the split, and
training slices the wide heads over ``--n_model_shards`` ranks (backend:
``nccl`` where each rank has a card, ``gloo`` on the CPU or where ranks
share a card; gloo cannot all-gather CUDA tensors, so tensor parallelism on
CUDA needs a card a rank). Rank 0 alone writes the artifacts; validation
gathers every rank's scores, and decoding every rank's captions, to one
``valid/`` and one ``decode.txt`` in dataset order.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from vqa_tpu_torch.config import (
    Argument, dataset_type_from_args, parse_args, save_args)
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.data.loader import Loader, prefetch_to_device
from vqa_tpu_torch.data.tokenizer import Vocab
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.ops.embedding import load_glove_table
from vqa_tpu_torch.parallel import mesh as mesh_lib
from vqa_tpu_torch.tools.beam import make_beam_search, tokens_to_captions
from vqa_tpu_torch.training import optim as optim_lib
from vqa_tpu_torch.training.checkpoint import (
    load_checkpoint, load_params, merge_params, restore_params)
from vqa_tpu_torch.training.logging import Logger, MetricsWriter, NullLog
from vqa_tpu_torch.training.state import TrainState, make_eval_step
from vqa_tpu_torch.training.train import (
    MODEL_KEYS, evaluate, model_batch, train, train_select)

_DECODE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(args, vocab: Vocab, ans_list, device: torch.device):
    frozen = None
    if args.pretrained_embed_path and os.path.exists(args.pretrained_embed_path):
        frozen = load_glove_table(args.pretrained_embed_path)
    return set_model(
        encoder_type=args.encoder_type,
        predictor_type=args.predictor_type,
        decoder_type=args.decoder_type,
        ntoken=len(vocab),
        v_dim=args.v_dim,
        embed_dim=args.embed_dim,
        hidden_dim=args.hidden_dim,
        decoder_hidden_dim=args.decoder_hidden_dim,
        rnn_layer=args.rnn_layer,
        ans_dim=len(ans_list),
        cls_layer=args.cls_layer,
        c_len=args.c_len,
        dropout=args.dropout,
        rnn_type=args.rnn_type,
        att_type=args.att_type,
        conv_layer=args.conv_layer,
        conv_type=args.conv_type,
        use_spa=bool(getattr(args, "use_spa", 1)),
        use_imp=bool(getattr(args, "use_imp", 0)),
        use_sem=bool(getattr(args, "use_sem", 0)),
        use_mtl=args.use_mtl,
        frozen_embedding=frozen,
        use_pallas=bool(getattr(args, "use_pallas", 0)),
        use_int8=bool(getattr(args, "use_int8", 0)),
        generator=torch.Generator().manual_seed(args.seed),
        device=device,
    )


def make_loader(args, ans_list, dataset_type, mesh, is_train=False,
                is_val=False, shuffle=False):
    graph_path = args.graph_path if args.encoder_type == "relation" else ""
    feature_dtype = getattr(args, "feature_dtype", "float32")
    ds = set_dataset(
        load_path=args.load_path,
        feature_path=args.feature_path,
        ans_dim=len(ans_list),
        caption_id_path=args.select_path,
        graph_path=graph_path,
        is_train=is_train,
        is_val=is_val,
        dataset_type=dataset_type,
        # int8: the loader emits img_q / img_scale and the model dequantizes
        # on the device
        feature_mode="int8" if feature_dtype == "int8" else "float32",
    )
    transform = None
    if feature_dtype not in ("float32", "int8"):
        dtype = np.dtype(feature_dtype)

        def transform(batch, _dtype=dtype):
            batch["img"] = batch["img"].astype(_dtype)
            return batch
    if mesh_lib.axis_size(mesh, "data") > 1:
        # each data rank loads its shard; batch_size is per data rank
        return Loader.for_process(ds, args.batch_size, mesh=mesh,
                                  shuffle=shuffle, seed=args.seed,
                                  transform=transform)
    # caption length bucketing: training feed only (decode and eval run the
    # generator at the full c_len)
    bucket = bool(getattr(args, "length_bucket", 0)) and is_train \
        and args.decoder_type != "none"
    bounds = tuple(
        int(b) for b in
        str(getattr(args, "bucket_bounds", "8,10,12,14,16")).split(",") if b)
    bounds = tuple(b for b in bounds if b < args.c_len) + (args.c_len,)
    return Loader(ds, args.batch_size, shuffle=shuffle, seed=args.seed,
                  transform=transform, length_bucket=bucket,
                  bucket_bounds=bounds)


def _optimizer(args, model, steps: int):
    return optim_lib.make_optimizer(
        model, lr=args.lr, lr_vqa=args.lr_vqa, lr_cap=args.lr_cap,
        warm_up=args.warm_up, step_size=args.step_size, gamma=args.gamma,
        steps_per_epoch=steps)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.load_setting:
        args = Argument(os.path.join("checkpoint", args.comment))
    # --val_every N overrides the reference's derived mid-epoch validation
    val_checkpoint = (getattr(args, "val_every", 0)
                      or (args.select_path == "none"))
    world = mesh_lib.init_distributed(getattr(args, "device", "cuda") or "cuda")
    try:
        mesh = mesh_lib.make_mesh(n_model=args.n_model_shards)
        logger = Logger(args.comment) if mesh_lib.is_main() else NullLog()
        try:
            _run(args, world.device, mesh, logger, val_checkpoint)
        finally:
            logger.close()
    finally:
        if world.created:
            dist.destroy_process_group()


def _run(args, device: torch.device, mesh, logger, val_checkpoint) -> None:
    main_rank = mesh_lib.is_main()
    vocab = Vocab.load(args.vocab_path)
    with open(args.ans_path, encoding="utf-8") as f:
        ans_list = f.read().split("\n")
    save_path = os.path.join("checkpoint", args.comment)
    if main_rank:
        save_args(args, save_path)
    logger.write(repr(args.__dict__))

    model = build_model(args, vocab, ans_list, device)
    print("model ready.")
    dataset_type = dataset_type_from_args(args)

    if args.mode == "train":
        train_loader = make_loader(args, ans_list, dataset_type, mesh,
                                   is_train=True, shuffle=args.shuffle)
        val_loader = make_loader(args, ans_list, dataset_type, mesh,
                                 is_val=True)
        # the tensor-parallel heads are sliced before any optimizer is made
        mesh_lib.shard_params(model, mesh)

        best_score = 0.0
        init_state = None
        if args.start_epoch != 0:
            # resume: full state from the previous epoch checkpoint
            path = os.path.join(save_path, f"epoch_{args.start_epoch - 1}.ckpt")
            steps = args.batches or len(train_loader)
            # the JAX entry point draws a sample batch here; so does the
            # port, to keep the shuffled order of the epochs the same
            next(iter(train_loader))
            blank = TrainState(model, _optimizer(args, model, steps),
                               seed=args.seed)
            restored = load_checkpoint(path, blank)
            init_state = restored["state"]
            best_score = restored["best_score"]
            print("load parameters:", path)
        elif args.load_model != "":
            # warm start: parameters only, strict=False semantics
            path = os.path.join(save_path, args.load_model)
            next(iter(train_loader))
            model.load_state_dict(merge_params(
                model.state_dict(),
                mesh_lib.local_state_dict(model, load_params(path))))
            print("load parameters:", path)

        if getattr(args, "train_dtype", "float32") not in ("float32", "f32", ""):
            logger.show(f"[notice] train_dtype={args.train_dtype}: matmuls run "
                        "in mixed precision (master params/moments stay f32); "
                        "pass --train_dtype float32 for the reference "
                        "recipe's f32 numerics")
        print("start training.")
        common = dict(model=model, lr=args.lr, val_loader=val_loader,
                      num_epoches=args.epoches, save_path=save_path,
                      logger=logger, checkpoint=10000, max_norm=0.25,
                      comment=args.comment + "_train",
                      start_epoch=args.start_epoch, batches=args.batches,
                      best_score=best_score, warm_up=args.warm_up,
                      step_size=args.step_size, gamma=args.gamma,
                      lr_vqa=args.lr_vqa, lr_cap=args.lr_cap,
                      val_checkpoint=val_checkpoint, seed=args.seed,
                      init_state=init_state,
                      profile_dir=args.profile_dir or None,
                      train_dtype=getattr(args, "train_dtype", "float32"),
                      mesh=mesh)
        if getattr(args, "train_strategy", "joint") == "select":
            # max-relevance training over every candidate caption: the
            # all-captions dataset's dense features, as the JAX entry point
            # builds it (no feature mode, no transform, no length buckets)
            all_ds = set_dataset(
                load_path=args.load_path, feature_path=args.feature_path,
                ans_dim=len(ans_list), caption_id_path=args.select_path,
                graph_path=args.graph_path
                if args.encoder_type == "relation" else "",
                is_train=True, dataset_type="all")
            sel_loader = Loader.for_process(
                all_ds, args.batch_size, mesh=mesh, shuffle=args.shuffle,
                seed=args.seed, batch_method="get_batch_all",
                length=len(all_ds.questions))
            train_select(train_loader=sel_loader, **common)
        else:
            train(train_loader=train_loader, **common)

    if args.mode in ("train", "val") and args.predictor_type != "none":
        load_model = args.load_model or os.path.join(save_path, "best_model.ckpt")
        restore_params(model, load_params(load_model))
        print("load parameters: ", load_model)

        index_path = os.path.join(args.load_path, args.index_path)
        if index_path.endswith(".pkl"):
            # the reference's pickle index
            with open(index_path, "rb") as f:
                ans_index = pickle.load(f)
        else:
            with open(index_path) as f:
                ans_index = json.load(f)

        val_loader = make_loader(args, ans_list, dataset_type, mesh,
                                 is_val=True)
        writer = (MetricsWriter(save_path, comment=args.comment + "_val")
                  if main_rank else NullLog())
        metric = evaluate(make_eval_step(model), val_loader, device,
                          logger=logger, writer=writer, ans_index=ans_index,
                          save_path=os.path.join(save_path, "valid")
                          if main_rank else None, mesh=mesh)
        for i in metric:
            if main_rank:
                print(f"{i}\t {metric[i] * 100:.4f} %")
        writer.add_hparams(
            hparams={"name": args.comment, "embed_dim": args.embed_dim,
                     "hidden_dim": args.hidden_dim,
                     "rnn_layer": args.rnn_layer,
                     "cls_layer": args.cls_layer,
                     "gcn_layer": args.conv_layer,
                     "dropout": args.dropout},
            metrics=metric)
        writer.close()
    elif args.mode in ("train", "val"):
        print("predictor_type none: no VQA head to validate; skipping "
              "val (decode mode scores captions via cap_eval.py).")

    if args.mode == "decode":
        load_model = args.load_model or os.path.join(save_path, "best_model.ckpt")
        if not os.path.exists(load_model) and not args.load_model:
            # fall back to the newest epoch checkpoint
            epochs = glob.glob(os.path.join(save_path, "epoch_*.ckpt"))
            if epochs:
                load_model = max(epochs, key=os.path.getmtime)
        restore_params(model, load_params(load_model))
        print("load parameters: ", load_model)
        decode_dtype = _DECODE_DTYPES[getattr(args, "decode_dtype", "float32")]
        model = model.to(decode_dtype).eval()
        val_loader = make_loader(args, ans_list, dataset_type, mesh,
                                 is_val=True)
        # --use_pallas also routes the beam's vocab head through the fused
        # kernel (GEMM + running top-k + online logsumexp)
        beam = make_beam_search(model, k=3, c_len=args.c_len,
                                start_id=vocab.start, end_id=vocab.end,
                                fused_vocab=bool(getattr(args, "use_pallas", 0)))
        ids, caps = [], []
        for batch in prefetch_to_device(iter(val_loader), device,
                                        keys=MODEL_KEYS):
            nvalid = int(batch.pop("nvalid"))
            mb = model_batch(batch)
            for key in ("img", "img_scale"):
                # the scale's dtype is the dequant dtype on the device
                if key in mb:
                    mb[key] = mb[key].to(decode_dtype)
            tokens, _ = beam(mb)
            ids.extend(np.asarray(batch["id"])[:nvalid].tolist())
            caps.extend(tokens_to_captions(tokens[:nvalid, 0].cpu().numpy(),
                                           vocab, vocab.end))
        # every rank's captions to rank 0, one per question in dataset order
        # (the shards' wrap-pad repeats dropped)
        by_id = {}
        for rank_ids, rank_caps in mesh_lib.all_gather_object((ids, caps)):
            by_id.update(zip(rank_ids, rank_caps))
        if main_rank:
            with open(os.path.join(save_path, "decode.txt"), "w") as f:
                for i in sorted(by_id):
                    f.write(by_id[i] + "\n")


if __name__ == "__main__":
    try:
        main()
    except Exception:
        error = traceback.format_exc()
        print(error)
        os.makedirs("checkpoint", exist_ok=True)
        with open("checkpoint/error.txt", "w") as f:
            f.write(time.ctime())
            f.write("\n")
            f.write(error)
        sys.exit(1)
