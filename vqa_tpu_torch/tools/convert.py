"""Convert ``vqa_tpu`` parameters into the port's ``state_dict``.

Input: the flax parameter tree of a ``vqa_tpu`` model (``model.init(...)
["params"]``) as nested dicts of numpy arrays. Output: a ``state_dict``
whose keys are the reference's torch names, which the port uses too:

- WNDense ``{v [in, out], g, b}`` -> ``weight_v`` [out, in], 0-dim
  ``weight_g``, ``bias``;
- FCNet ``fc{i}`` -> ``main.{3i}`` (slots Linear, ReLU, Dropout), and
  ConcatAttention ``fc{i}`` -> ``sequence.{2i}`` (slots Linear, ReLU);
- SentenceEmbedding ``wi_l0`` / ``bi_l0`` / ``wh_l0`` / ``bh_l0`` ->
  ``rnn.weight_ih_l0`` (transposed) / ``rnn.bias_ih_l0`` / ...;
- decoder cells ``wi`` / ``bi`` / ``wh`` / ``bh`` -> ``weight_ih``
  (transposed) / ``bias_ih`` / ... on the cell itself, as ``nn.GRUCell``;
- the decoders' plain Linear ``{w [in, out], b}`` -> ``weight`` [out, in],
  ``bias``;
- WordEmbedding ``table`` -> ``weight`` (the base, relation and caption
  encoders alike); a frozen GloVe table is a constant in the JAX package
  and a non-persistent buffer in the port, so neither side has its key;
- the ``base-cap`` head's ``c_rnn`` (a SentenceEmbedding) and ``c_net``
  (an FCNet) by the rules above: ``predictor.c_rnn.rnn.weight_ih_l0``,
  ``predictor.c_net.main.0.weight_v``, ...;
- an LReLUNet, a module whose one leaf is ``w`` [in, out] -> ``main.0.weight``
  [out, in] (the reference's Sequential(Linear(bias=False), LeakyReLU));
  so the ``q-cap`` head maps as ``predictor.v_net.main.0.weight``, ...,
  ``predictor.caption_embedding.attention.W_v.main.0.weight`` / ``W_q``,
  ``predictor.caption_embedding.fcnet.main.0.weight``, and its two RNNs by
  the SentenceEmbedding rule: ``predictor.caption_embedding.word_rnn.rnn.
  weight_ih_l0``, ``....caption_rnn.rnn.weight_ih_l0``, ...;
- the MTL weights ``log_vars`` as they are;
- the GCN convs ``*_encoder.conv{i}`` of the relation encoder: the
  bias-free direction weights ``w{j}`` [in, out] -> ``w{j}.weight`` [out,
  in], ``label_bias`` as it is, the DotProduct ``{wa, ba, wb, bb}`` ->
  ``dot_product.wa.weight`` (transposed) / ``dot_product.wa.bias`` / ...;
  a BaseGraphConv's ``weight`` [in, out] and ``bias`` as they are.

``vqa_tpu/tools/import_torch.py`` ``import_reference_state_dict`` is the
inverse for everything but the GCN convs, which reference checkpoints do
not carry; :func:`gcn_params_from_state_dict` is the inverse for those.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_RNN_LEAF = re.compile(r"^(wi|bi|wh|bh)(?:_(l\d+(?:_reverse)?))?$")
_RNN_NAMES = {"wi": "weight_ih", "bi": "bias_ih", "wh": "weight_hh",
              "bh": "bias_hh"}
_GCN_CONV = re.compile(r"conv\d+")
_GCN_KEY = re.compile(r"^(.*_encoder\.conv\d+)\.(.+)$")
# the DotProduct's flax leaves by its torch module: (weight, bias)
_DOT_PRODUCT = {"wa": ("wa", "ba"), "wb": ("wb", "bb")}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _walk(node: Dict[str, Any], path: List[str],
          out: Dict[str, torch.Tensor]) -> None:
    for key, child in node.items():
        if isinstance(child, dict) and {"v", "g"} <= set(child) \
                and set(child) <= {"v", "g", "b"}:
            base = ".".join(path + [_module_name(key, path)])
            out[f"{base}.weight_v"] = _tensor(child["v"]).t().contiguous()
            out[f"{base}.weight_g"] = _tensor(child["g"]).reshape(())
            if "b" in child:
                out[f"{base}.bias"] = _tensor(child["b"])
        elif isinstance(child, dict) and set(child) == {"w"}:
            base = ".".join(path + [key])
            out[f"{base}.main.0.weight"] = _tensor(child["w"]).t().contiguous()
        elif isinstance(child, dict) and set(child) == {"w", "b"}:
            base = ".".join(path + [key])
            out[f"{base}.weight"] = _tensor(child["w"]).t().contiguous()
            out[f"{base}.bias"] = _tensor(child["b"])
        elif isinstance(child, dict) and _GCN_CONV.fullmatch(key) \
                and path and path[-1].endswith("_encoder"):
            _gcn_conv(child, ".".join(path + [key]), out)
        elif isinstance(child, dict):
            _walk(child, path + [_module_name(key, path)], out)
        elif key == "table":
            out[".".join(path + ["weight"])] = _tensor(child)
        elif key == "log_vars" and not path:
            out[key] = _tensor(child)
        elif _RNN_LEAF.match(key):
            kind, rest = _RNN_LEAF.match(key).groups()
            t = _tensor(child)
            t = t.t().contiguous() if kind.startswith("w") else t
            # a stacked RNN nests its weights as ``rnn.*_l{k}``; a cell
            # holds them itself
            name = [_RNN_NAMES[kind]] if rest is None \
                else ["rnn", f"{_RNN_NAMES[kind]}_{rest}"]
            out[".".join(path + name)] = t
        else:
            raise KeyError(f"no port name for parameter "
                           f"{'.'.join(path + [key])}")


def _gcn_conv(node: Dict[str, Any], base: str,
              out: Dict[str, torch.Tensor]) -> None:
    for key, child in node.items():
        if re.fullmatch(r"w\d+", key):
            out[f"{base}.{key}.weight"] = _tensor(child).t().contiguous()
        elif key in ("label_bias", "weight", "bias"):
            out[f"{base}.{key}"] = _tensor(child)
        elif key == "dot_product" and set(child) == {"wa", "ba", "wb", "bb"}:
            for name, (w, b) in _DOT_PRODUCT.items():
                out[f"{base}.dot_product.{name}.weight"] = \
                    _tensor(child[w]).t().contiguous()
                out[f"{base}.dot_product.{name}.bias"] = _tensor(child[b])
        else:
            raise KeyError(f"no port name for parameter {base}.{key}")


def _module_name(key: str, path: List[str]) -> str:
    m = re.fullmatch(r"fc(\d+)", key)
    if m is None:
        return key
    i = int(m.group(1))
    # fc{i} directly under `attention` is ConcatAttention's Sequential
    if path and path[-1] == "attention":
        return f"sequence.{2 * i}"
    return f"main.{3 * i}"


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``vqa_tpu`` params tree -> port ``state_dict`` (f32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, [], out)
    return out


def gcn_params_from_state_dict(sd: Dict[str, torch.Tensor]
                               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """The inverse for the GCN convs: port ``state_dict`` -> (the flax
    params of its ``*_encoder.conv{i}`` as nested dicts of numpy arrays, the
    other entries)."""
    tree: Dict[str, Any] = {}
    rest: Dict[str, torch.Tensor] = {}
    for key, t in sd.items():
        m = _GCN_KEY.match(key)
        if m is None:
            rest[key] = t
            continue
        a = t.detach().cpu().numpy()
        leaf = m.group(2).split(".")
        if len(leaf) == 2 and re.fullmatch(r"w\d+", leaf[0]) \
                and leaf[1] == "weight":
            name, a = [leaf[0]], a.T
        elif leaf[0] == "dot_product" and len(leaf) == 3 \
                and leaf[1] in _DOT_PRODUCT:
            w, b = _DOT_PRODUCT[leaf[1]]
            name, a = (["dot_product", w], a.T) if leaf[2] == "weight" \
                else (["dot_product", b], a)
        elif len(leaf) == 1 and leaf[0] in ("label_bias", "weight", "bias"):
            name = leaf
        else:
            raise KeyError(f"no flax name for GCN parameter {key}")
        node = tree
        for p in m.group(1).split(".") + name[:-1]:
            node = node.setdefault(p, {})
        node[name[-1]] = np.ascontiguousarray(a)
    return tree, rest
