"""CLI / config system of the port's entry point (counterpart of
``vqa_tpu/config.py``, a copy with the same flags and defaults).

Per-experiment persistence as ``param.pkl`` (dict pickle) + human-readable
``param.txt``; reload via ``--load_setting`` (class ``Argument``).

One flag differs: ``--device`` (default ``cuda``) is the device the port
builds on, where the JAX package accepts it and ignores it. ``cpu`` runs
the port on the CPU, its kernels as their plain versions. The
``type=bool`` flags (``--load_setting``, ``--shuffle``, ``--use_mtl``)
keep the JAX package's argparse trap (any non-empty string, ``False``
included, parses as True), so one command line parses the same in both.
``--decoder_device`` is accepted and ignored, as there.
"""

from __future__ import annotations

import argparse
import os
import pickle


class Argument:
    """Reload a saved experiment config (reference main.py:21-37)."""

    def __init__(self, load_dir: str):
        with open(os.path.join(load_dir, "param.pkl"), "rb") as f:
            inputs = pickle.load(f)
        for key, value in inputs.items():
            setattr(self, key, value)

    def __repr__(self):
        return "".join(f"{k}: {v}\n" for k, v in self.__dict__.items())

    def save(self, save_dir: str):
        with open(os.path.join(save_dir, "param.pkl"), "wb") as f:
            pickle.dump(self.__dict__, f)


def save_args(args, save_dir: str) -> None:
    """Persist param.pkl + param.txt (reference main.py:128-135)."""
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "param.pkl"), "wb") as f:
        pickle.dump(args.__dict__, f)
    with open(os.path.join(save_dir, "param.txt"), "w") as f:
        for key, value in args.__dict__.items():
            f.write(f"{key}: {value}\n")


def parse_args(argv=None):
    """The reference CLI (main.py:40-107), flag for flag."""
    parser = argparse.ArgumentParser()

    # save settings
    parser.add_argument("--comment", type=str, default="exp1")
    parser.add_argument("--load_setting", type=bool, default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the port builds on (cuda, cuda:N "
                             "or cpu); without CUDA pass cpu")
    parser.add_argument("--seed", type=int, default=1111)

    # path settings
    parser.add_argument("--vocab_path", type=str, default="../data/vocab_list.txt")
    parser.add_argument("--ans_path", type=str, default="../data/answer_candidate.txt")
    parser.add_argument("--load_path", type=str, default="../annot")
    parser.add_argument("--feature_path", type=str, default="../../COCO_feature_36")
    parser.add_argument("--select_path", type=str,
                        default="../annot/select_caption/most_relevant.pkl")
    parser.add_argument("--graph_path", type=str, default="../../COCO_graph_36")
    parser.add_argument("--index_path", type=str, default="index.json",
                        help="answer-type index (canonical JSON; the reference "
                             "mixed pkl/json, SURVEY.md 2.1 #10)")

    # dataset and dataloader settings
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--shuffle", type=bool, default=True)
    parser.add_argument("--c_len", type=int, default=20)

    # encoder settings
    parser.add_argument("--encoder_type", type=str, default="base")
    parser.add_argument("--rnn_type", type=str, default="GRU")
    parser.add_argument("--att_type", type=str, default="new")
    parser.add_argument("--embed_dim", type=int, default=300)
    parser.add_argument("--hidden_dim", type=int, default=1024)
    parser.add_argument("--v_dim", type=int, default=2048)
    parser.add_argument("--dropout", type=float, default=0.2)
    parser.add_argument("--rnn_layer", type=int, default=1)

    # predictor settings
    parser.add_argument("--predictor_type", type=str, default="base")
    parser.add_argument("--cls_layer", type=int, default=2)

    # relation encoder settings
    parser.add_argument("--conv_type", type=str, default="corr")
    parser.add_argument("--conv_layer", type=int, default=1)
    # Relation-branch toggles: the reference defines use_imp/use_spa/use_sem
    # on RelationEncoder (encoder.py:202-208) but never exposes them through
    # the CLI/factory; full ReGAT = spatial + implicit, so the rebuild does
    # (int 0/1: argparse type=bool is a truthiness trap on strings).
    parser.add_argument("--use_spa", type=int, default=1,
                        help="relation encoder: spatial-relation GCN branch")
    parser.add_argument("--use_imp", type=int, default=0,
                        help="relation encoder: implicit (fully-connected) branch")
    parser.add_argument("--use_sem", type=int, default=0,
                        help="relation encoder: semantic branch (graph via "
                             "batch['sem_graph'])")

    # pre-trained word embedding
    parser.add_argument("--pretrained_embed_path", type=str,
                        default="../data/glove.6B/glove.6B.300d.txt")

    # decoder settings
    parser.add_argument("--decoder_type", type=str, default="base")
    parser.add_argument("--decoder_hidden_dim", type=int, default=512)
    parser.add_argument("--decoder_device", type=str, default="",
                        help="accepted for parity; ignored")

    # learning rate scheduler settings
    parser.add_argument("--lr", type=float, default=0.002)
    parser.add_argument("--lr_vqa", type=float, default=0)
    parser.add_argument("--lr_cap", type=float, default=0)
    parser.add_argument("--warm_up", type=int, default=0)
    parser.add_argument("--step_size", type=int, default=0)
    parser.add_argument("--gamma", type=float, default=0.5)
    parser.add_argument("--use_mtl", type=bool, default=True)

    # training/validating process settings
    parser.add_argument("--mode", type=str, default="train")
    parser.add_argument("--load_model", type=str, default="")
    parser.add_argument("--epoches", type=int, default=15)
    parser.add_argument("--batches", type=int, default=0)
    parser.add_argument("--start_epoch", type=int, default=0)

    # additions of the JAX package (absent in the reference)
    parser.add_argument("--n_model_shards", type=int, default=1,
                        help="tensor-parallel axis size of the process "
                             "mesh (ranks that slice the wide heads; the "
                             "world size must divide by it)")
    parser.add_argument("--train_strategy", type=str, default="joint",
                        help="joint | select (Q-Relevant max-relevance "
                             "backprop over every candidate caption)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="capture a torch.profiler trace of steps "
                             "[10, 20)")
    # (int 0/1, not type=bool: bool('0') is True — the truthiness trap)
    parser.add_argument("--use_pallas", type=int, default=0,
                        help="route eligible ops through the hand-written "
                             "kernels (bf16 inference fast path; in MTL "
                             "caption training, the fused decode-attention "
                             "kernels, whose dropout masks come from an "
                             "in-kernel Philox stream)")
    parser.add_argument("--approx_topk", type=int, default=0,
                        help="accepted for parity and ignored: the port's "
                             "beam top-k is exact")
    parser.add_argument("--use_int8", type=int, default=0,
                        help="int8 GEMMs at inference (training always "
                             "differentiates the float path): the attention "
                             "v-projection consumes the quantized feed "
                             "directly when the batch ships img_q "
                             "(--feature_dtype int8; no-op on dense feeds), "
                             "and ReGAT's GCN projections dynamically "
                             "row-quantize their layer input (any feed)")
    parser.add_argument("--feature_dtype", type=str, default="float32",
                        help="dtype of visual features on device")
    parser.add_argument("--decode_dtype", type=str, default="float32",
                        help="beam-decode compute dtype (float32 | "
                             "bfloat16); opt-in because rare near-tie token "
                             "picks can differ from the f32 decode")
    parser.add_argument("--train_dtype", type=str, default="bfloat16",
                        help="matmul compute dtype for training "
                             "(float32 | bfloat16); master params and "
                             "optimizer moments stay f32 (mixed precision); "
                             "pass --train_dtype float32 for the reference "
                             "recipe's f32 numerics")
    parser.add_argument("--length_bucket", type=int, default=0,
                        help="bucket training batches by caption length and "
                             "truncate the caption axis to the bucket bound "
                             "(8/10/12/14/16/c_len): the decoder scan skips "
                             "all-masked steps, with the same loss per "
                             "sample. Batch composition diverges from the "
                             "reference's uniform shuffle")
    parser.add_argument("--bucket_bounds", type=str, default="8,10,12,14,16",
                        help="comma-separated --length_bucket bounds; c_len "
                             "is always appended as the last bucket")
    parser.add_argument("--prng_impl", type=str, default="rbg",
                        help="accepted for parity and ignored: the port's "
                             "dropout draws from torch generators and Philox "
                             "streams seeded by (--seed, step)")
    parser.add_argument("--val_every", type=int, default=0,
                        help="validate every N batches mid-epoch (0 keeps the "
                             "reference's samples-modulus quirk, train.py:121)")

    return parser.parse_args(argv)


def dataset_type_from_args(args) -> str:
    """select_path sentinel mapping (reference main.py:162-164)."""
    if args.select_path == "vqa-e":
        return "vqa-e"
    if args.select_path == "none":
        return "all"
    if args.select_path == "vqa":
        return "vqa"  # TPU-native addition: plain VQA dataset is selectable
    return "select"
