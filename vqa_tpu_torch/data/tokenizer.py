"""Vocabulary and soft answer scores (counterpart of
``vqa_tpu/data/tokenizer.py`` ``Vocab`` and ``soft_answer_scores``)."""

from __future__ import annotations

from typing import List, Sequence


class Vocab:
    """Vocabulary with O(1) token lookup; id order == file line order.

    The vocab file is GloVe words followed by the 4 specials
    ``<oov> <start> <end> <pad>``; the first occurrence of a word wins, as
    with ``list.index``.
    """

    SPECIALS = ("<oov>", "<start>", "<end>", "<pad>")

    def __init__(self, words: Sequence[str]):
        self.words: List[str] = list(words)
        self._index = {}
        for i in range(len(self.words) - 1, -1, -1):
            self._index[self.words[i]] = i
        self.oov = self._index["<oov>"]
        self.start = self._index["<start>"]
        self.end = self._index["<end>"]
        self.pad = self._index["<pad>"]

    @classmethod
    def load(cls, vocab_path: str) -> "Vocab":
        """Read a newline-separated vocab file."""
        with open(vocab_path, encoding="utf-8") as f:
            return cls(f.read().split("\n"))

    def __len__(self) -> int:
        return len(self.words)

    def index(self, word: str) -> int:
        return self._index.get(word, self.oov)

    def __contains__(self, word: str) -> bool:
        return word in self._index


def soft_answer_scores(ans_dict: dict, ans_dim: int) -> List[float]:
    """Densify {ans_idx: count} into soft scores min(count, 3) / 3."""
    out = [0.0] * ans_dim
    for key, value in ans_dict.items():
        out[int(key)] = min(value, 3) / 3.0
    return out
