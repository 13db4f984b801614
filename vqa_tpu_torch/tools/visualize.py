"""Attention visualization: draw the top-k attended boxes on the image (the
port's counterpart of ``vqa_tpu/tools/visualize.py``).

Port of the reference's `tools/visualize.py`: crop/paste the top-k attended
regions with alpha dimming, rectangle + score overlays; graph-attention view
via the relation encoder's correlation alphas. The model half
(:func:`attention`, :func:`graph_attention`) runs the port's ``nn.Module``
on its own device; the drawing half is PIL, on the host (off the hot path).
The functions take the module where the JAX package's take ``(model,
params)``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

try:
    from PIL import Image, ImageDraw, ImageFont
    HAS_PIL = True
except ImportError:  # headless minimal envs
    HAS_PIL = False


def sample_one_batch(dataset, sample: int = 0) -> dict:
    """One example as a batch-of-1 with host metadata (visualize.py:7-24)."""
    batch = {k: v[None] for k, v in dataset[sample].items()}
    meta = {
        "feature": dataset.questions[sample]["img_file"],
        "q_word": dataset.questions[sample].get("q_word", ""),
        "target": dataset.answers[sample],
    }
    if hasattr(dataset, "captions") and hasattr(dataset, "caption_id"):
        img_id = str(int(meta["feature"][-16:-4]))
        meta["c_word"] = dataset.captions[img_id]["c_word"][
            dataset.caption_id[sample]]
    return {**batch, "_meta": meta}


# dimming levels: everything outside the top-k fades to BACKDROP_ALPHA;
# top-k boxes other than the argmax fade to RUNNERUP_ALPHA
BACKDROP_ALPHA = 30
RUNNERUP_ALPHA = 128
TOP_COLOR = "red"          # argmax box
OTHER_COLOR = "lightcoral"  # remaining top-k boxes


def _label_box(draw, xy, text, color, font):
    """Rectangle outline + a filled score tag in its top-left corner."""
    x0, y0, x1, y1 = xy
    draw.rectangle([(x0, y0), (x1, y1)], outline=color, width=2)
    l, t, r, b = draw.textbbox((0, 0), text, font=font)
    draw.rectangle([(x0, y0), (x0 + (r - l) + 1, y0 + (b - t) + 1)], fill=color)
    draw.text([x0, y0], text)


def show_att(att: np.ndarray, img, bbox: np.ndarray, k: int = 3,
             output=None):
    """Render an attention map over the image's boxes.

    The whole image is dimmed, the k highest-attention boxes are pasted back
    (argmax fully opaque, the rest half-faded) and outlined with their
    attention scores. Same artifact as the reference tool
    (the reference's `tools/visualize.py:27-59`), reimplemented on numpy
    ranking + PIL compositing.
    """
    if not HAS_PIL:
        raise RuntimeError("PIL required for visualization")
    att = np.asarray(att).reshape(-1)
    # top-k box indices, strongest first
    ranked = np.argsort(-att)[:k]

    if output is None:
        output = img.copy()
        output.putalpha(BACKDROP_ALPHA)

    # paste weakest -> strongest so stronger boxes win overlaps
    for box_id in reversed(ranked):
        x0, y0, x1, y1 = bbox[box_id][:4]
        region = img.crop([x0, y0, x1, y1])
        if att[box_id] < att[ranked[0]]:
            region.putalpha(RUNNERUP_ALPHA)
        output.paste(region, (int(x0), int(y0)))

    draw = ImageDraw.Draw(output)
    font = ImageFont.load_default()
    for rank, box_id in enumerate(ranked):
        color = TOP_COLOR if rank == 0 else OTHER_COLOR
        _label_box(draw, bbox[box_id][:4], f"{att[box_id]:.2f}", color, font)
    return output


def print_result(meta: dict, predict: np.ndarray, ans_list: List[str]):
    print("Q:", meta.get("q_word", ""))
    if "c_word" in meta:
        print("C:", meta["c_word"])
    print("target:")
    for i, j in meta["target"].items():
        print(f"{min(j, 3) / 3:.2f}", ans_list[int(i)])
    print("\npredict: ", ans_list[int(np.argmax(predict))])


def on_model_device(batch: Dict[str, np.ndarray],
                    model) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``model``'s device; the features and their
    scales in its parameters' dtype (the dequant dtype), as the entry
    point's decode feeds them."""
    param = next(model.parameters())
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value)).to(param.device)
        out[key] = t.to(param.dtype) if key in ("img", "img_scale") else t
    return out


def attention(model, batch: Dict[str, np.ndarray]):
    """(predict [B, ans_dim], att [B, num_objs]) of ``model.get_att`` on a
    host batch, as f32 numpy arrays."""
    model.eval()
    with torch.inference_mode():
        predict, att = model.get_att(on_model_device(batch, model))
    att = att.reshape(att.shape[0], -1)
    return predict.float().cpu().numpy(), att.float().cpu().numpy()


def graph_attention(model, batch: Dict[str, np.ndarray], layer: int = -1):
    """(predict, att, g_att) for the first sample of a host batch: the
    relation encoder's correlation alphas of conv ``layer`` from the box
    ``model.get_att`` attends to most, with that box's own weight set to 1
    (f32 numpy)."""
    predict, att = attention(model, batch)
    index = int(np.argmax(att[0]))
    with torch.inference_mode():
        alphas = model.encoder(on_model_device(batch, model), graph_alpha=True)
    g_att = alphas[layer][0, index, :].float().cpu().numpy().copy()
    g_att[index] = 1.0
    return predict, att, g_att


def _image_and_boxes(dataset, meta: dict, img_path: str):
    """The sample's image (``<img_path>/<split>/<name>.jpg``) and its boxes:
    from its ``.npz`` file, or from a packed store's ``_bbox.npy``."""
    img = Image.open(os.path.join(img_path, dataset.dataset_name,
                                  meta["feature"][:-3] + "jpg"))
    packed = getattr(dataset.backend, "packed", None)
    if packed is not None:
        if packed.bbox is None:
            raise ValueError("the packed store holds no boxes")
        return img, np.asarray(packed.bbox[packed.row(meta["feature"])])
    with np.load(os.path.join(dataset.backend.feature_dir,
                              meta["feature"])) as z:
        return img, z["bbox"]


def show_top_k_regions(model, dataset, ans_list, sample: int = 0,
                       img_path: str = "../COCO", k: int = 3):
    """Top-k attended regions for one sample (the reference's
    visualize.py:97-118)."""
    batch = sample_one_batch(dataset, sample)
    meta = batch.pop("_meta")
    predict, att = attention(model, batch)
    img, bbox = _image_and_boxes(dataset, meta, img_path)
    output = show_att(att[0], img, bbox, k=k)
    print_result(meta, predict[0], ans_list)
    return output


def show_graph_att(model, dataset, ans_list, sample: int = 0,
                   img_path: str = "../COCO", k: int = 3, layer: int = -1):
    """Correlation-alpha view of the relation encoder (the reference's
    visualize.py:71-94)."""
    batch = sample_one_batch(dataset, sample)
    meta = batch.pop("_meta")
    predict, _, g_att = graph_attention(model, batch, layer)
    img, bbox = _image_and_boxes(dataset, meta, img_path)
    output = show_att(g_att, img, bbox, k=k + 1)
    print_result(meta, predict[0], ans_list)
    return output
