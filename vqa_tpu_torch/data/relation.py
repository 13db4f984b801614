"""Spatial-relation graphs over bounding boxes (the port's copy of
``vqa_tpu/data/relation.py``, itself a port of the reference's
``util/relation.py:3-79``, "Exploring Visual Relationship for Image
Captioning" spatial classes):

    0      no relation
    1 / 2  a includes b / a is covered by b (IoU box == the smaller box)
    3      overlap with IoU >= 0.5
    4..11  angle bucket ceil(((angle) % 360) / 45) + 3 when the center
           distance is <= 0.5 x image diagonal

``spatial_relation`` is the scalar form; ``relation_graph`` the per-image
builder; ``relation_graphs_batched`` the vectorized numpy builder of the
[B, N, N] label matrices, equal to ``relation_graph`` per image.

Reference quirks replicated exactly:
- "area" is computed even for an empty intersection box; with both extents
  negative the product is positive, so disjoint boxes can register IoU >= 0.5
  (relation.py:28-30).
- angle delta that is an exact multiple of 360 yields ceil(0)+3 = 3,
  colliding with the overlap label (relation.py:41).
- equality with the intersection box is exact float equality
  (relation.py:24-25).
"""

from __future__ import annotations

import numpy as np


def spatial_relation(a, b, w, h):
    """Scalar relation between two bboxes [x0, y0, x1, y1] -> (label_ab, label_ba).

    Direct port of relation.py:3-45.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    iou_box = np.array([
        max(a[0], b[0]), max(a[1], b[1]),
        min(a[2], b[2]), min(a[3], b[3]),
    ])
    if np.array_equal(iou_box, b):
        return 1, 2  # b inside a
    if np.array_equal(iou_box, a):
        return 2, 1  # a covered by b

    area = lambda x: (x[3] - x[1]) * (x[2] - x[0])
    iou = area(iou_box) / (area(a) + area(b) - area(iou_box))
    if iou >= 0.5:
        return 3, 3

    center = lambda x: np.array([x[0] + (x[2] - x[0]) / 2,
                                 x[1] + (x[3] - x[1]) / 2])
    ca, cb = center(a), center(b)
    dist = np.linalg.norm(ca - cb) / np.linalg.norm([w, h])
    if dist <= 0.5:
        d = cb - ca
        delta = np.rad2deg(np.arctan2(*d)) - 90
        index = lambda x: int(np.ceil((x % 360) / 45) + 3)
        return index(delta), index(delta + 180)
    return 0, 0


def relation_graph(bbox: np.ndarray, w: float, h: float,
                   relation=spatial_relation) -> np.ndarray:
    """Per-image [N, N] relation labels, pairwise loop (relation.py:65-79)."""
    num_objs = bbox.shape[0]
    output = np.zeros((num_objs, num_objs))
    for i in range(num_objs):
        for j in range(i + 1, num_objs):
            output[i, j], output[j, i] = relation(bbox[i], bbox[j], w, h)
    return output


def relation_graphs_batched(bbox: np.ndarray, w: np.ndarray, h: np.ndarray
                            ) -> np.ndarray:
    """Vectorized [B, N, N] spatial-relation labels.

    bbox: [B, N, 4]; w, h: [B]. Produces int8 labels identical to running
    ``relation_graph`` per image, at numpy-vector speed.
    """
    bbox = np.asarray(bbox, dtype=np.float64)
    B, N, _ = bbox.shape
    a = bbox[:, :, None, :]    # [B, N, 1, 4]
    b = bbox[:, None, :, :]    # [B, 1, N, 4]

    ix0 = np.maximum(a[..., 0], b[..., 0])
    iy0 = np.maximum(a[..., 1], b[..., 1])
    ix1 = np.minimum(a[..., 2], b[..., 2])
    iy1 = np.minimum(a[..., 3], b[..., 3])

    eq_b = ((ix0 == b[..., 0]) & (iy0 == b[..., 1])
            & (ix1 == b[..., 2]) & (iy1 == b[..., 3]))
    eq_a = ((ix0 == a[..., 0]) & (iy0 == a[..., 1])
            & (ix1 == a[..., 2]) & (iy1 == a[..., 3]))

    area_i = (iy1 - iy0) * (ix1 - ix0)  # reference computes this unconditionally
    area_a = (a[..., 3] - a[..., 1]) * (a[..., 2] - a[..., 0])
    area_b = (b[..., 3] - b[..., 1]) * (b[..., 2] - b[..., 0])
    denom = area_a + area_b - area_i
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = area_i / denom
    overlap = iou >= 0.5

    ca = np.stack([a[..., 0] + (a[..., 2] - a[..., 0]) / 2,
                   a[..., 1] + (a[..., 3] - a[..., 1]) / 2], axis=-1)
    cb = np.stack([b[..., 0] + (b[..., 2] - b[..., 0]) / 2,
                   b[..., 1] + (b[..., 3] - b[..., 1]) / 2], axis=-1)
    d = cb - ca                                   # [B, N, N, 2]
    diag = np.sqrt(np.asarray(w, np.float64) ** 2
                   + np.asarray(h, np.float64) ** 2)[:, None, None]
    dist_ok = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2) / diag <= 0.5

    delta = np.rad2deg(np.arctan2(d[..., 0], d[..., 1])) - 90
    angle_ab = np.ceil((delta % 360) / 45) + 3
    angle_ba = np.ceil(((delta + 180) % 360) / 45) + 3

    # priority: eq_b -> eq_a -> overlap -> angle -> none (relation.py:24-45)
    lab = np.zeros((B, N, N), dtype=np.float64)
    lab = np.where(dist_ok, angle_ab, lab)
    lab = np.where(overlap, 3, lab)
    lab = np.where(eq_a, 2, lab)
    lab = np.where(eq_b, 1, lab)

    lab_t = np.zeros((B, N, N), dtype=np.float64)
    lab_t = np.where(dist_ok, angle_ba, lab_t)
    lab_t = np.where(overlap, 3, lab_t)
    lab_t = np.where(eq_a, 1, lab_t)
    lab_t = np.where(eq_b, 2, lab_t)

    # Assemble exactly like the reference's upper-triangle fill
    # (out[i,j], out[j,i] = relation(i, j)): the (i<j) entry takes lab,
    # the mirrored (j,i) entry takes lab_t transposed.
    out = np.zeros((B, N, N), dtype=np.int8)
    iu = np.triu_indices(N, k=1)
    out[:, iu[0], iu[1]] = lab[:, iu[0], iu[1]].astype(np.int8)
    out[:, iu[1], iu[0]] = lab_t[:, iu[0], iu[1]].astype(np.int8)
    return out
