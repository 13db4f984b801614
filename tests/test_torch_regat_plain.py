"""The port's ReGAT spatial model (CONFIGS.md config 5) against the
benchmark's plain reference (``vqabench/reference/regat.py``, which writes
the graph convolution unfolded), on the CPU in float32 with the
benchmark's seeded weights, inputs and spatial graphs: both feeds,
``use_pallas`` on and off; planted faults and a bf16 forward must fall
outside the tolerance. Also the reference's spatial label rule against
`relation_graphs_batched`, quirks included, and the driver's model build.
No JAX."""

import copy

import numpy as np
import pytest
import torch

from vqa_tpu_torch.data.relation import relation_graphs_batched
from vqa_tpu_torch.ops import gcn
from vqa_tpu_torch.ops.kernels import gcn_chain
from vqabench import common, manifest
from vqabench.drivers import staged_regat
from vqabench.reference import regat
from vqabench.reference.precision import Precision
from vqabench.run import Run

B, SEED = 8, 2 ** 31 + 12345
CELL = "regat-answer-staged"
# the configuration at test widths: 36 boxes as published (the fused
# chain takes 36 only), narrow features
TEST_DIMS = dict(ntoken=50, embed_dim=12, hidden_dim=32, v_dim=64, q_len=5,
                 ans_dim=20)
# Largest |program - reference| over the largest |reference logit|. The
# program folds w0 + w1 and Wa Wb^T into one f32 weight each and sums the
# label bias by counts, so its f32 sums round in another order: a few f32
# ulps of the largest terms (measured 5e-7). 1e-4 leaves 200x of that, and
# a bf16 forward (about 7e-3) reads 70x above it.
REL_TOL = 1e-4
# a planted fault must read at least this many tolerances off
FAULT_MARGIN = 100


def _bench():
    bench = manifest.load()
    cell = manifest.cell(bench, CELL)
    cfg = copy.deepcopy(manifest.config(bench, cell["config"]))
    cfg.update(TEST_DIMS)
    return cell, cfg, copy.deepcopy(manifest.traffic(cell["traffic"]))


def _model(use_pallas: bool, dtype=torch.float32):
    cell, cfg, tr = _bench()
    run = Run(cell, dict(cfg, use_pallas=use_pallas), tr, SEED, 0.0, False,
              torch.device("cpu"))
    model, weights = staged_regat.build_model(run, dtype)
    return model.eval(), weights


@pytest.fixture(scope="module")
def case():
    """(the int8-feed batch, the dense batch, the f32 weights, the
    reference's logits)."""
    _, cfg, tr = _bench()
    gen = common.generator("cpu", SEED, common.INPUTS)
    q = common.questions(gen, B, cfg["q_len"], cfg["ntoken"])
    img_q, scale = common.features(gen, B, cfg["num_objs"], cfg["v_dim"])
    graph = regat.spatial_labels(
        staged_regat.boxes(gen, B, cfg["num_objs"], tr["image"],
                           tr["box_side"]), *tr["image"]).to(torch.int32)
    batch = {"q": q, "img_q": img_q, "img_scale": scale, "graph": graph}
    dense = {"q": q, "img": img_q.float() * scale[..., None], "graph": graph}
    _, weights = _model(False)
    with torch.no_grad():
        ref = regat.answer(weights, batch, Precision())
    assert ref.abs().max() > 0
    return batch, dense, weights, ref


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref).abs().max() / ref.abs().max())


def _logits(model, batch) -> torch.Tensor:
    with torch.no_grad():
        return model(batch)[0]


@pytest.mark.parametrize("feed", ["int8", "dense"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_logits_match_the_plain_reference(case, feed, use_pallas):
    batch, dense, _, ref = case
    model, _ = _model(use_pallas)
    got = _logits(model, batch if feed == "int8" else dense)
    assert rel_err(got, ref) <= REL_TOL


def _chain_softmax_over_axis_2(out_self, proj, alpha_raw, graph, bias,
                               num_labels=12):
    """gcn_chain_reference with the softmax over axis 2, not 1."""
    f32 = torch.float32
    adj = (graph != 0).to(f32)
    o = (out_self.float() + adj @ proj.float()
         + gcn_chain.label_counts(graph, num_labels, f32) @ bias.float())
    return torch.softmax(adj @ alpha_raw.float(), dim=2) @ o


@pytest.mark.parametrize("fault", ["softmax_axis_2", "no_label_bias",
                                   "gcn_identity"])
def test_a_planted_fault_fails_the_tolerance(case, fault, monkeypatch):
    """On the cell's route (int8 feed, ``use_pallas``): the chain's softmax
    over the wrong axis, the label bias left out, the graph convolution's
    output replaced by its input."""
    batch, _, _, ref = case
    model, _ = _model(True)
    assert rel_err(_logits(model, batch), ref) <= REL_TOL
    if fault == "softmax_axis_2":
        monkeypatch.setattr(gcn_chain, "gcn_chain_fused",
                            _chain_softmax_over_axis_2)
    elif fault == "no_label_bias":
        with torch.no_grad():
            model.encoder.spatial_encoder.conv0.label_bias.zero_()
    else:
        monkeypatch.setattr(gcn.GCN, "forward",
                            lambda self, feature, graph, get_alpha=False:
                            feature)
    assert rel_err(_logits(model, batch), ref) > FAULT_MARGIN * REL_TOL


def test_a_bf16_forward_falls_outside_the_f32_tolerance(case):
    batch, _, _, ref = case
    model, _ = _model(True, torch.bfloat16)
    got = _logits(model, dict(batch, img_scale=batch["img_scale"].bfloat16()))
    assert rel_err(got, ref) > 10 * REL_TOL


def test_the_driver_builds_config_5():
    """One correlated convolution over the spatial graph, as the
    configuration says, where ``set_model``'s own default builds two."""
    model, _ = _model(True)
    enc = model.encoder
    assert enc.branches == ["spatial"]
    assert enc.spatial_encoder.conv_layer == 1
    assert enc.spatial_encoder.conv_type == "corr"
    assert isinstance(enc.spatial_encoder.conv0, gcn.CorrelatedGraphConv)
    assert not hasattr(enc.spatial_encoder, "conv1")


# boxes built to hit the reference's quirks, on a 640 x 480 image: a
# disjoint pair whose intersection has two negative extents (positive
# "area", IoU 1: label 3), a box inside another (equal to the
# intersection: 1 / 2), two equal boxes, and centres level with each other
# (delta 0 or a multiple of 360: label 3 one way, 7 the other)
QUIRKS = np.array([[[0, 0, 10, 10], [20, 20, 30, 30],
                    [100, 100, 200, 200], [120, 120, 150, 150],
                    [300, 300, 320, 330], [300, 300, 320, 330],
                    [400, 50, 420, 70], [480, 50, 500, 70]]], np.float64)


def test_the_label_rule_is_the_references():
    gen = torch.Generator().manual_seed(5)
    seeded = staged_regat.boxes(gen, 16, 36, (640, 480), (0.05, 0.8))
    for boxes in (seeded.numpy(), QUIRKS):
        n = boxes.shape[0]
        want = relation_graphs_batched(boxes, np.full(n, 640.0),
                                       np.full(n, 480.0))
        got = regat.spatial_labels(torch.from_numpy(boxes), 640, 480)
        np.testing.assert_array_equal(got.numpy(), want)
    got = regat.spatial_labels(torch.from_numpy(QUIRKS), 640, 480)[0]
    assert got[0, 1] == got[1, 0] == 3                  # disjoint, "IoU" 1
    assert (got[2, 3], got[3, 2]) == (1, 2)             # 3 inside 2
    assert (got[4, 5], got[5, 4]) == (1, 2)             # equal boxes
    assert (got[6, 7], got[7, 6]) == (3, 7)             # delta 0
    assert set(np.unique(regat.spatial_labels(seeded, 640, 480))) \
        == set(range(12))
