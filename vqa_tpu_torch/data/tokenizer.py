"""Vocabulary, tokenization, padding and soft answer scores (counterpart of
``vqa_tpu/data/tokenizer.py``).

The text pipeline is the reference's (its preprocessing.py:102-130):
lowercase, strip quote boundaries and newlines, remove ``.,?``, split the
possessive ``'s``, split on whitespace; captions get ``<start>`` / ``<end>``
before padding, which truncates or pads to a fixed length with ``<pad>`` and
reports the valid length.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


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


def get_tokens(sentence: str, vocab: Vocab, is_cap: bool = False
               ) -> Tuple[str, List[int]]:
    """(normalized sentence, token ids) of ``sentence``; a caption
    (``is_cap``) is wrapped in ``<start>`` ... ``<end>``."""
    sentence = sentence.lower()
    for c in [" '", "' ", ' "', '" ', "\n"]:
        sentence = sentence.replace(c, " ")
    for c in ".,?":
        sentence = sentence.replace(c, "")
    sentence = sentence.replace("'s", " 's")
    words = [w for w in sentence.split() if len(w) > 0]
    if is_cap:
        words.insert(0, "<start>")
        words.append("<end>")
    tokens = [vocab.index(w) for w in words]
    return " ".join(words), tokens


def padding(tokens: List[int], max_l: int, pad_id: int) -> Tuple[List[int], int]:
    """``tokens`` padded with ``pad_id`` or truncated to ``max_l``, and their
    valid length."""
    l = min(len(tokens), max_l)
    if l < max_l:
        tokens = tokens + [pad_id] * (max_l - l)
    else:
        tokens = tokens[:l]
    return tokens, l


def soft_answer_scores(ans_dict: dict, ans_dim: int) -> List[float]:
    """Densify {ans_idx: count} into soft scores min(count, 3) / 3."""
    out = [0.0] * ans_dim
    for key, value in ans_dict.items():
        out[int(key)] = min(value, 3) / 3.0
    return out
