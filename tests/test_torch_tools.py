"""The port's tools (vqa_tpu_torch/tools: porter, metrics, metric,
select_caption, visualize) against vqa_tpu.tools on seeded inputs.

The text metrics are the same pure-Python arithmetic in both packages, so
their scores are equal exactly. visualize's model half runs the port's
nn.Module, held to the flax model's ``get_att`` and the relation encoder's
``graph_alpha`` at f32 with the same weights (converted by
tools/convert.py) within 1e-5 relative (f32 sums in another order over a
few hundred terms); its drawing half must then draw the same picture.
"""

import filecmp
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from vqa_tpu.data.dataset import set_dataset as jax_set_dataset
from vqa_tpu.data.synthetic import make_synthetic_root as jax_make_root
from vqa_tpu.models.wrapper import set_model as jax_set_model
from vqa_tpu.tools import metric as jax_metric
from vqa_tpu.tools import metrics as jax_metrics
from vqa_tpu.tools import select_caption as jax_select
from vqa_tpu.tools import visualize as jax_visualize
from vqa_tpu.tools.porter import porter_stem as jax_porter_stem
from vqa_tpu_torch.data.dataset import set_dataset
from vqa_tpu_torch.models.wrapper import set_model
from vqa_tpu_torch.tools import metric, metrics, select_caption, visualize
from vqa_tpu_torch.tools.convert import flax_to_state_dict
from vqa_tpu_torch.tools.porter import porter_stem

WORDS = ("caresses ponies ties caress cats feed agreed plastered bled motoring "
         "sing conflated troubled sized hopping tanned falling hissing fizzed "
         "failing filing happy sky relational conditional rational valenci "
         "hesitanci digitizer conformabli radicalli differentli vileli "
         "analogousli vietnamization predication operator feudalism "
         "decisiveness hopefulness callousness formaliti sensitiviti "
         "sensibiliti triplicate formative formalize electriciti electrical "
         "hopeful goodness revival allowance inference airliner gyroscopic "
         "adjustable defensible irritant replacement adjustment dependent "
         "adoption homologou communism activate angulariti homologous "
         "effective bowdlerize probate rate cease controll roll generalization "
         "oscillators a is riding skateboarding standing sitting people's").split()
# caption words: the bundled synonym and paraphrase tables' entries, stems
# that share a root, and filler
CAPTION_WORDS = ("a man guy gentleman woman lady the group of several bunch "
                 "riding rides ride bike bicycle cycling street road next to "
                 "beside near is standing stands sitting sits dog dogs "
                 "picture photo of taking on top atop large big small little "
                 "with and in red blue").split()
TOL = dict(rtol=1e-5, atol=1e-6)


def test_porter_stem_equals_jax():
    got = [porter_stem(w) for w in WORDS]
    assert got == [jax_porter_stem(w) for w in WORDS]
    # Porter (1980)'s own examples
    assert [porter_stem(w) for w in ("caresses", "ponies", "relational",
                                     "hopping", "generalization")] == \
        ["caress", "poni", "relat", "hop", "gener"]


@pytest.fixture(scope="module")
def captions():
    """Seeded references (5 an image) and hypotheses over CAPTION_WORDS."""
    rng = np.random.default_rng(14)

    def sentence():
        return " ".join(rng.choice(CAPTION_WORDS, rng.integers(4, 13)))
    refs = {i: [sentence() for _ in range(5)] for i in range(40)}
    hyps = {i: [sentence()] for i in range(40)}
    hyps[3] = [refs[3][0]]                     # one exact match
    hyps[7] = ["a man is riding a bike next to the street"]
    refs[7][1] = "a guy rides a bicycle beside the road"
    return refs, hyps


def test_bundled_tables_are_the_ports_own():
    for name in ("meteor_synonyms_mini.txt", "meteor_paraphrases_mini.txt"):
        path = metrics.bundled_table(name)
        assert os.path.dirname(path) == os.path.join(
            os.path.dirname(metrics.__file__), "data")
        assert filecmp.cmp(path, jax_metrics.bundled_table(name), shallow=False)
    assert metrics.bundled_table("missing.txt") == ""


def test_text_metrics_equal_jax(captions):
    refs, hyps = captions
    assert metrics.bleu(refs, hyps) == jax_metrics.bleu(refs, hyps)
    assert metrics.rouge_l(refs, hyps) == jax_metrics.rouge_l(refs, hyps)
    assert metrics.cider(refs, hyps) == jax_metrics.cider(refs, hyps)
    syn = metrics.load_synsets(metrics.bundled_table("meteor_synonyms_mini.txt"))
    para = metrics.load_paraphrases(
        metrics.bundled_table("meteor_paraphrases_mini.txt"))
    jsyn = jax_metrics.load_synsets(
        jax_metrics.bundled_table("meteor_synonyms_mini.txt"))
    jpara = jax_metrics.load_paraphrases(
        jax_metrics.bundled_table("meteor_paraphrases_mini.txt"))
    variants = [dict(use_stem=False), dict(), dict(alignment="greedy"),
                dict(alignment="greedy", use_stem=False)]
    scores = set()
    for kw in variants:
        got = metrics.meteor(refs, hyps, **kw)
        assert got == jax_metrics.meteor(refs, hyps, **kw), kw
        scores.add(got)
    got = metrics.meteor(refs, hyps, synsets=syn, paraphrases=para)
    assert got == jax_metrics.meteor(refs, hyps, synsets=jsyn, paraphrases=jpara)
    scores.add(got)
    assert len(scores) >= 3          # the modules change the scores
    got = metrics.score(refs, hyps, synsets=syn, paraphrases=para)
    assert got == jax_metrics.score(refs, hyps, synsets=jsyn, paraphrases=jpara)
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                        "CIDEr", "ROUGE_L"}
    assert all(np.isfinite(v) and v > 0 for v in got.values())


def test_metric_tools_equal_jax(captions, rng):
    refs, hyps = captions
    assert metric.explanation_quality(refs, hyps) == \
        jax_metric.explanation_quality(refs, hyps)
    explanations = [hyps[i][0] for i in range(40)]
    answers = [str(rng.choice(CAPTION_WORDS)) for _ in range(39)] + [""]
    rate = metric.answer_mention_rate(explanations, answers)
    assert rate == jax_metric.answer_mention_rate(explanations, answers)
    assert 0 < rate < 1
    att = rng.random((4, 6, 36))
    att /= att.sum(-1, keepdims=True)
    for k in (1, 3, 36):
        assert metric.attention_coverage(att, k) == \
            jax_metric.attention_coverage(att, k)
    assert metric.attention_coverage(att, 36) == pytest.approx(1.0)


def test_select_caption_equals_jax(tmp_path, rng):
    """``similarity``, ``select_caption`` and the offline ``build_selection``
    (its pickle) over a seeded GloVe table and tokens."""
    glove = rng.standard_normal((30, 8))
    a, b = rng.standard_normal((5, 8)), rng.standard_normal((7, 8))
    assert select_caption.similarity(a, b) == jax_select.similarity(a, b)
    assert select_caption.similarity(a[:0], b) == 0.0
    caps = [rng.standard_normal((n, 8)) for n in (3, 6, 4, 2)]
    assert select_caption.select_caption(a, b, caps) == \
        jax_select.select_caption(a, b, caps)
    pad = 29
    questions = [{"img_file": f"COCO_train2014_{str(i % 3 + 1).zfill(12)}.npz",
                  "q": list(rng.integers(0, 25, 5)) + [pad] * 2}
                 for i in range(12)]
    answers = [{str(rng.integers(0, 4)): int(rng.integers(1, 5))}
               if i % 5 else {} for i in range(12)]
    by_img = {str(i): {"c": [list(rng.integers(0, 25, 6)) + [pad] * 3
                             for _ in range(5)]} for i in (1, 2, 3)}
    ans_list = ["w1", "w2 w3", "w4", "w5 w6"]
    vocab_index = {f"w{i}": i for i in range(25)}.get
    got = select_caption.build_selection(questions, answers, by_img, ans_list,
                                         glove, vocab_index,
                                         str(tmp_path / "port.pkl"), pad)
    want = jax_select.build_selection(questions, answers, by_img, ans_list,
                                      glove, vocab_index,
                                      str(tmp_path / "jax.pkl"), pad)
    assert got == want and len(set(got.values())) > 1
    with open(tmp_path / "port.pkl", "rb") as f:
        assert pickle.load(f) == want


# visualize: a small Up-Down model and a small ReGAT model (v_dim = hidden =
# 128 so that JAX's gates admit its kernels as in tests/test_torch_regat.py)
OBJS, V_DIM, HIDDEN, EMBED, NTOKEN, ANS = 6, 128, 128, 12, 40, 9
DIMS = dict(predictor_type="base", decoder_type="none", ntoken=NTOKEN,
            v_dim=V_DIM, embed_dim=EMBED, hidden_dim=HIDDEN, ans_dim=ANS,
            dropout=0.2, att_type="new")
REGAT = dict(DIMS, encoder_type="relation", conv_layer=2, conv_type="corr",
             use_spa=True, use_imp=False)


@pytest.fixture(scope="module")
def vis_root(tmp_path_factory):
    """A synthetic root with graphs, both packages' datasets over it, and a
    picture for the first question's image."""
    from PIL import Image
    root = str(tmp_path_factory.mktemp("vis_root"))
    jax_make_root(root, split="train2014", num_images=4, num_questions=10,
                  num_objs=OBJS, v_dim=V_DIM, vocab_size=NTOKEN,
                  num_answers=ANS, q_len=7, c_len=8, seed=3)
    args = (os.path.join(root, "annot"), os.path.join(root, "features"), ANS)
    kw = dict(graph_path=os.path.join(root, "graphs"), is_train=True,
              dataset_type="vqa")
    images = os.path.join(root, "images", "train2014")
    os.makedirs(images)
    pixels = np.random.default_rng(4).integers(0, 256, (520, 640, 3), np.uint8)
    for i in range(1, 5):
        Image.fromarray(pixels).save(
            os.path.join(images, f"COCO_train2014_{str(i).zfill(12)}.jpg"))
    return (set_dataset(*args, **kw), jax_set_dataset(*args, **kw),
            os.path.join(root, "images"))


def _twins(dims, jax_dataset):
    jm = jax_set_model(**dims)
    batch = jax_visualize.sample_one_batch(jax_dataset, 0)
    batch.pop("_meta")
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(2), batch)["params"])
    port = set_model(**dims, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return jm, params, port.eval()


@pytest.mark.parametrize("sample", [0, 5])
def test_visualize_get_att_matches_jax(vis_root, sample):
    """The Up-Down model: ``attention`` against the flax ``get_att`` on the
    same sample (``VQADataset.__getitem__`` in both packages), then the
    same picture from ``show_top_k_regions``."""
    port_ds, jax_ds, images = vis_root
    jm, params, port = _twins(dict(DIMS, encoder_type="base"), jax_ds)
    batch = visualize.sample_one_batch(port_ds, sample)
    want_batch = jax_visualize.sample_one_batch(jax_ds, sample)
    assert batch.pop("_meta") == want_batch.pop("_meta")
    predict, att = visualize.attention(port, batch)
    w_pred, w_att = jm.apply({"params": params}, want_batch, method="get_att")
    w_att = np.asarray(w_att).reshape(1, -1)
    assert att.shape == (1, OBJS) and predict.shape == (1, ANS)
    np.testing.assert_allclose(att, w_att, **TOL)
    np.testing.assert_allclose(predict, np.asarray(w_pred), **TOL)
    assert att.sum() == pytest.approx(1.0, rel=1e-6)
    got = visualize.show_top_k_regions(port, port_ds, ["x"] * ANS, sample,
                                       img_path=images)
    want = jax_visualize.show_top_k_regions(jm, params, jax_ds, ["x"] * ANS,
                                            sample, img_path=images)
    assert got.size == (640, 520)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("layer", [-1, 0])
def test_visualize_graph_alphas_match_jax(vis_root, layer):
    """ReGAT (two corr-GCN layers): ``graph_attention`` against the flax
    relation encoder's ``graph_alpha`` of the same layer from the same box,
    then the same picture from ``show_graph_att``."""
    port_ds, jax_ds, images = vis_root
    jm, params, port = _twins(REGAT, jax_ds)
    batch = visualize.sample_one_batch(port_ds, 2)
    batch.pop("_meta")
    predict, att, g_att = visualize.graph_attention(port, batch, layer)
    want_batch = jax_visualize.sample_one_batch(jax_ds, 2)
    want_batch.pop("_meta")
    _, w_att = jm.apply({"params": params}, want_batch, method="get_att")
    index = int(np.argmax(np.asarray(w_att)[0]))
    assert index == int(np.argmax(att[0]))
    alphas = jm.apply({"params": params}, want_batch,
                      method=lambda m, b: m.encoder(b, graph_alpha=True))
    assert len(alphas) == 2
    want = np.asarray(alphas[layer])[0, index, :].copy()
    want[index] = 1.0
    assert g_att.shape == (OBJS,)
    np.testing.assert_allclose(g_att, want, **TOL)
    got = visualize.show_graph_att(port, port_ds, ["x"] * ANS, 2,
                                   img_path=images, layer=layer)
    ref = jax_visualize.show_graph_att(jm, params, jax_ds, ["x"] * ANS, 2,
                                       img_path=images, layer=layer)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_no_module_of_the_port_imports_jax_or_vqa_tpu():
    """Every module of vqa_tpu_torch (the host library's bindings, the
    tools, the bench, the entry point and the path benchmarks included)
    and chip_smoke.py import no jax, flax or optax and nothing of
    vqa_tpu."""
    code = ("import importlib, pkgutil, sys\n"
            "import vqa_tpu_torch, chip_smoke\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    vqa_tpu_torch.__path__, 'vqa_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'optax', 'vqa_tpu'))\n"
            "assert not bad, bad\n"
            "assert {'vqa_tpu_torch.data.native', 'vqa_tpu_torch.tools.visualize',\n"
            "        'vqa_tpu_torch.preprocessing', 'vqa_tpu_torch.cap_eval',\n"
            "        'vqa_tpu_torch.bench', 'vqa_tpu_torch.entry',\n"
            "        'vqa_tpu_torch.scripts._bench_util', 'vqa_tpu_torch.scripts.bench_beam',\n"
            "        'vqa_tpu_torch.scripts.bench_regat', 'vqa_tpu_torch.scripts.bench_train',\n"
            "        'vqa_tpu_torch.scripts.bench_feed'} <= set(names)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr
