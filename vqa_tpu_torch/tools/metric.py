"""Explainability metrics for caption-based VQA explanations (the port's
copy of ``vqa_tpu/tools/metric.py``).

The reference's `tools/metric.py` is an empty TODO stub
(SURVEY.md section 2 row 30). This implements the intended capability —
scoring how well generated explanation captions explain the VQA answer:

- ``explanation_quality`` — text overlap of generated explanations against
  ground-truth explanation captions (BLEU/METEOR/ROUGE-L/CIDEr, the VQA-E
  protocol) via the native metric suite.
- ``answer_mention_rate`` — fraction of explanations that mention the
  predicted answer string (a standard faithfulness probe for VQA-E-style
  explanations).
- ``attention_coverage`` — mean attention mass concentrated on the top-k
  boxes; measures how peaked (interpretable) the visual evidence is.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from vqa_tpu_torch.tools.metrics import score as caption_score


def explanation_quality(refs: Dict[int, List[str]],
                        hyps: Dict[int, List[str]]) -> Dict[str, float]:
    """VQA-E explanation scoring: caption metrics vs reference explanations."""
    return caption_score(refs, hyps)


def answer_mention_rate(explanations: Sequence[str],
                        answers: Sequence[str]) -> float:
    """Fraction of explanations containing their predicted answer string."""
    hits = sum(1 for e, a in zip(explanations, answers)
               if a and a.lower() in e.lower())
    return hits / max(len(explanations), 1)


def attention_coverage(att: np.ndarray, k: int = 3) -> float:
    """Mean attention mass on the top-k boxes. att: [..., num_objs]."""
    att = np.asarray(att)
    att = att.reshape(-1, att.shape[-1])
    top = np.sort(att, axis=1)[:, -k:]
    return float(top.sum(axis=1).mean())
