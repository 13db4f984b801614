"""VQA-E caption selection: pick the most QA-relevant caption per pair (the
port's copy of ``vqa_tpu/tools/select_caption.py``).

Port of the reference's `util/select_caption.py` (Ch. 3.1 of "VQA-E:
Explaining, Elaborating, and Enhancing Your Answers for Visual Questions"):
relevance(caption) = (sim(question, caption) + sim(answer, caption)) / 2 where
sim(a, b) = mean over words w_a of max cosine similarity to any word of b.

Two deliberate fixes over the reference (documented divergences):
- the reference scores the *whole caption list* instead of caption i
  (``get_similarity(question, answer, captions)`` at select_caption.py:38 —
  every candidate gets the same score and index 0 always wins; SURVEY.md
  section 2.1 defect 7). Here each caption is scored individually.
- the word loop is replaced by one [a_len, b_len] cosine matrix per pair
  (vectorized numpy); identical math.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Sequence

import numpy as np


def similarity(a: np.ndarray, b: np.ndarray, eps: float = 1e-8) -> float:
    """Mean over rows of a of the max cosine similarity to rows of b.

    a: [a_len, embed_dim]; b: [b_len, embed_dim].
    """
    if len(a) == 0 or len(b) == 0:
        return 0.0
    a_n = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), eps)
    b_n = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), eps)
    cos = a_n @ b_n.T                       # [a_len, b_len]
    return float(cos.max(axis=1).mean())


def select_caption(question: np.ndarray, answer: np.ndarray,
                   captions: Sequence[np.ndarray]) -> int:
    """Index of the caption most relevant to the QA pair (select_caption.py:26-43,
    with the per-candidate scoring fixed)."""
    best_score, best_index = -np.inf, 0
    for i, cap in enumerate(captions):
        score = (similarity(question, cap) + similarity(answer, cap)) / 2
        if score > best_score:
            best_index, best_score = i, score
    return best_index


def build_selection(questions: List[dict], answers: List[dict],
                    captions_by_img: Dict[str, dict], ans_list: List[str],
                    glove: np.ndarray, vocab_index, out_path: str,
                    pad_id: int) -> Dict[int, int]:
    """Offline pass: most-relevant caption id per question -> pickle.

    ``glove`` is the [vocab, embed] table; question/caption tokens embed by
    lookup (pad rows dropped); answers embed their candidate words.
    """
    selection = {}
    for qi, q in enumerate(questions):
        img_id = str(int(q["img_file"][-16:-4]))
        q_emb = glove[[t for t in q["q"] if t != pad_id]]
        # answer words: highest-count candidate's tokens
        ans_dict = answers[qi]
        if ans_dict:
            best_ans = max(ans_dict, key=ans_dict.get)
            words = ans_list[int(best_ans)].split()
            a_tokens = [vocab_index(w) for w in words]
            a_emb = glove[a_tokens]
        else:
            a_emb = np.zeros((0, glove.shape[1]))
        caps = [glove[[t for t in c if t != pad_id]]
                for c in captions_by_img[img_id]["c"]]
        selection[qi] = select_caption(q_emb, a_emb, caps)
    with open(out_path, "wb") as f:
        pickle.dump(selection, f)
    return selection
