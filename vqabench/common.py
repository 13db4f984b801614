"""What the cells share: sub-seeds, the weights and inputs made on the
device from the seed, the program's model built from a configuration
file, and the comparisons that decide ``correct``."""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

import torch

MASK64 = (1 << 64) - 1
# set_model's keyword arguments that a configuration file may hold
MODEL_ARGS = ("encoder_type", "predictor_type", "decoder_type", "ntoken",
              "v_dim", "embed_dim", "hidden_dim", "decoder_hidden_dim",
              "ans_dim", "c_len", "dropout", "att_type", "att_dropout",
              "use_mtl", "use_pallas", "use_int8")


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose (weights, inputs, sampling) of a run
    seed, by SplitMix64's output function."""
    x = (seed * 0x9E3779B97F4A7C15 + purpose + 0x632BE59BD9B4E019) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return (x ^ (x >> 31)) >> 1


WEIGHTS, INPUTS, SAMPLE, TRAIN = 1, 2, 3, 4


def generator(device, seed: int, purpose: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return g


def _sibling(name: str, shapes: Dict[str, tuple], stems) -> str:
    for stem in stems:
        if stem in shapes:
            return stem
    raise KeyError(f"no weight beside {name}")


def _bound(name: str, shapes: Dict[str, tuple]) -> float:
    """U(-bound, bound) of torch's default init for the tensor ``name``:
    1 / sqrt(fan in) for a Linear and its bias, 1 / sqrt(hidden) for a
    recurrent cell."""
    base, _, leaf = name.rpartition(".")
    if leaf.startswith(("weight_ih", "weight_hh", "bias_ih", "bias_hh")):
        suffix = leaf.split("_", 2)[2] if leaf.count("_") >= 2 else ""
        hh = f"{base}.weight_hh" + (f"_{suffix}" if suffix else "")
        return shapes[hh][1] ** -0.5
    if leaf == "bias":
        w = _sibling(name, shapes, (base + ".weight_v", base + ".weight"))
        return shapes[w][1] ** -0.5
    return shapes[name][1] ** -0.5


def make_weights(shapes: Dict[str, tuple], seed: int, device,
                 dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Weights for every tensor of a state_dict's ``shapes``, drawn on the
    device from the seed in two calls (one uniform, one normal): word
    embeddings N(0, 1) with the padding row zero, the MTL weights 0,
    weight-norm gains equal to the norm of their direction, the rest
    torch's uniform init. Returned in ``dtype``."""
    gen = generator(device, seed, WEIGHTS)
    uniform = [n for n, s in shapes.items()
               if len(s) >= 1 and not n.endswith(("embedding.weight",
                                                   "log_vars"))]
    normal = [n for n in shapes if n.endswith("embedding.weight")]
    sizes = [torch.Size(shapes[n]).numel() for n in uniform]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat.mul_(2).sub_(1)
    out: Dict[str, torch.Tensor] = {}
    for n, part in zip(uniform, torch.split(flat, sizes)):
        out[n] = part.view(shapes[n]).mul_(_bound(n, shapes))
    sizes = [torch.Size(shapes[n]).numel() for n in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    for n, part in zip(normal, torch.split(flat, sizes)):
        table = part.view(shapes[n])
        table[-1] = 0.0        # the padding row
        out[n] = table
    for n, s in shapes.items():
        if n.endswith("log_vars"):
            out[n] = torch.zeros(s, device=device)
        elif n.endswith("weight_g"):
            out[n] = out[n[:-1] + "v"].norm().reshape(s)
    return {n: out[n].to(dtype) for n in shapes}


def build_model(run, dtype: torch.dtype):
    """The program's model for the run's configuration, in ``dtype``, with
    the benchmark's weights loaded; returns (model, weights)."""
    cfg, device, seed = run.config, run.device, run.seed
    from vqa_tpu_torch.models.wrapper import set_model

    with run.phase("set_model"):
        model = set_model(**{k: cfg[k] for k in MODEL_ARGS if k in cfg},
                          generator=torch.Generator().manual_seed(0),
                          device=device).to(dtype)
    with run.phase("weights"):
        shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
        weights = make_weights(shapes, seed, device, dtype)
        model.load_state_dict(weights, strict=True)
    return model, weights


def back_to_back(run, call) -> tuple:
    """Call ``call()`` back to back until ``run.seconds`` have passed, at
    most two calls in flight on the card, and wait for the last; returns
    (calls, elapsed seconds, the calls issued in each quarter of the
    window)."""
    cuda = run.device.type == "cuda"
    pending, n, stamps = [], 0, []
    t0 = time.perf_counter()
    while True:
        stamps.append(time.perf_counter() - t0)
        call()
        done = torch.cuda.Event() if cuda else None
        if cuda:
            done.record()
        pending.append(done)
        n += 1
        if len(pending) >= 2 and cuda:
            pending.pop(0).synchronize()
        if time.perf_counter() - t0 >= run.seconds:
            break
    if cuda:
        torch.cuda.synchronize(run.device)
    elapsed = time.perf_counter() - t0
    quarters = [0] * 4
    for t in stamps:
        quarters[min(3, int(4 * t / elapsed))] += 1
    return n, elapsed, quarters


# --------------------------------------------------------------- inputs


def quantize(x: torch.Tensor):
    """Per-box symmetric int8: scales absmax / 127 (at least 1e-8), the
    payload rounded half to even and clipped to +-127."""
    scales = torch.clamp_min(x.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.div(x, scales[..., None]).round_().clamp_(-127, 127)
    return q.to(torch.int8), scales


def features(gen: torch.Generator, rows: int, boxes: int, dim: int,
             chunk: int = 4096):
    """Normal box features drawn in float32 and quantized: (int8 payload
    [rows, boxes, dim], float32 scales [rows, boxes]), ``chunk`` rows of
    float32 at a time."""
    dev = gen.device
    q = torch.empty((rows, boxes, dim), dtype=torch.int8, device=dev)
    s = torch.empty((rows, boxes), dtype=torch.float32, device=dev)
    for lo in range(0, rows, chunk):
        hi = min(rows, lo + chunk)
        q[lo:hi], s[lo:hi] = quantize(
            torch.randn((hi - lo, boxes, dim), generator=gen, device=dev))
    return q, s


def questions(gen: torch.Generator, rows: int, length: int, ntoken: int,
              shortest: int = 4):
    """Question tokens [rows, length]: a length drawn from
    ``shortest .. length``, words uniform over the vocabulary, then the
    padding token ``ntoken``."""
    dev = gen.device
    words = torch.randint(0, ntoken, (rows, length), generator=gen, device=dev)
    n = torch.randint(shortest, length + 1, (rows, 1), generator=gen,
                      device=dev)
    pos = torch.arange(length, device=dev)[None, :]
    return torch.where(pos < n, words, torch.full_like(words, ntoken))


def answer_ids(gen: torch.Generator, rows: int, answers: int,
               per_question: int = 10):
    """Ten annotators' answers a question [rows, 10], skewed towards the
    common answers (index ``answers * u**3``)."""
    u = torch.rand((rows, per_question), generator=gen, device=gen.device)
    return (u.pow(3) * answers).long().clamp_(max=answers - 1)


def soft_scores(ids: torch.Tensor, answers: int) -> torch.Tensor:
    """VQA's soft scores min(count, 3) / 3 [rows, answers] of the
    annotators' answers."""
    counts = torch.zeros((ids.shape[0], answers), device=ids.device)
    counts.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float32))
    return torch.clamp(counts, max=3.0) / 3.0


def captions(gen: torch.Generator, rows: int, length: int, ntoken: int,
             shortest: int, longest: int):
    """Caption tokens [rows, length] and lengths [rows] drawn from
    ``shortest .. longest``; the positions past a length hold words that
    the loss masks out."""
    dev = gen.device
    c = torch.randint(0, ntoken, (rows, length), generator=gen, device=dev)
    n = torch.randint(shortest, longest + 1, (rows,), generator=gen,
                      device=dev, dtype=torch.int32)
    return c, n


# ---------------------------------------------------------- comparisons


def answer_gap(ref_logits: torch.Tensor, answers: torch.Tensor):
    """(the widest gap by which a given answer's reference logit lies
    below the reference's best, over the rows; the median best): the
    program's answers are judged by the reference's logits."""
    best = ref_logits.max(dim=1).values
    got = ref_logits.gather(1, answers.long()[:, None])[:, 0]
    return float((best - got).max()), float(best.median())


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str], scale: Optional[Dict[str, float]] = None):
    """(the widest gap between the program's and the reference's number
    of a leaf, over the leaves, each against the larger of the
    reference's norm of that leaf and of the median leaf of its module
    (``scale``, the norms, where ``ref`` holds no norms); that leaf)."""
    gaps = relative_gaps(prog, ref, leaves, scale)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def module(leaf: str) -> str:
    """A leaf's module: the first two parts of its name."""
    return ".".join(leaf.split(".")[:2])


def _medians(norms: Dict[str, float], leaves) -> Dict[str, float]:
    """The median of ``norms`` over each module's leaves."""
    return {m: statistics.median(norms[k] for k in leaves if module(k) == m)
            for m in {module(k) for k in leaves}}


def relative_gaps(prog: Dict[str, float], ref: Dict[str, float],
                  leaves: List[str], scale: Optional[Dict[str, float]] = None):
    """Each leaf's gap of :func:`leaf_gaps`."""
    scale = ref if scale is None else scale
    med = _medians(scale, leaves)
    return {k: abs(prog[k] - ref[k]) / max(scale[k], med[module(k)], 1e-30)
            for k in leaves}


def moved_leaves(first_grad_norms: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is more than a thousandth of
    the median leaf's of their module: the others (a bias under softmax)
    move under Adamax by round-off alone."""
    med = _medians(first_grad_norms, first_grad_norms)
    return sorted(k for k, v in first_grad_norms.items()
                  if v > 1e-3 * med[module(k)])
