"""Porter stemmer (Porter, 1980) — pure Python, no dependencies (the port's
copy of ``vqa_tpu/tools/porter.py``).

Implements the five-step suffix-stripping algorithm from "An algorithm for
suffix stripping" exactly as published. Used as METEOR 1.5's module-2
("stem") word matcher in vqa_tpu_torch/tools/metrics.py — the reference scores
captions with the METEOR jar whose English config enables exact + stem +
synonym + paraphrase modules (the reference's `cap_eval.py:7,25-28`); stem
is the highest-impact module reproducible without WordNet/Java.
"""

from __future__ import annotations

_VOWELS = frozenset("aeiou")


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m in the paper: number of VC sequences in c*(VC)^m v*."""
    forms = "".join("c" if _is_cons(stem, i) else "v" for i in range(len(stem)))
    return forms.count("vc")


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    """*o: stem ends cvc where the final c is not w, x or y."""
    if len(word) < 3:
        return False
    return (_is_cons(word, len(word) - 3)
            and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)
            and word[-1] not in "wxy")


def _replace(word: str, suffix: str, repl: str, min_m: int) -> str | None:
    """If word ends with suffix and m(stem) > min_m, swap the suffix."""
    if not word.endswith(suffix):
        return None
    stem = word[: len(word) - len(suffix)]
    if _measure(stem) > min_m:
        return stem + repl
    return word  # suffix matched but condition failed: stop this step


_STEP2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
          ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
          ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
          ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
          ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
          ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
          ("biliti", "ble")]

_STEP3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
          ("ical", "ic"), ("ful", ""), ("ness", "")]

_STEP4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
          "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize"]


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w

    # Step 1a: plurals
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # Step 1b: -eed / -ed / -ing
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        stripped = None
        if w.endswith("ed") and _has_vowel(w[:-2]):
            stripped = w[:-2]
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            stripped = w[:-3]
        if stripped is not None:
            w = stripped
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += "e"

    # Step 1c: y -> i
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2 (m > 0 suffix swaps; longest listed match wins)
    for suffix, repl in _STEP2:
        if w.endswith(suffix):
            out = _replace(w, suffix, repl, 0)
            if out is not None:
                w = out
            break

    # Step 3
    for suffix, repl in _STEP3:
        if w.endswith(suffix):
            out = _replace(w, suffix, repl, 0)
            if out is not None:
                w = out
            break

    # Step 4 (m > 1 deletions; -ion only after s/t)
    for suffix in _STEP4:
        if w.endswith(suffix):
            stem = w[: len(w) - len(suffix)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                and _measure(w[:-3]) > 1:
            w = w[:-3]

    # Step 5a: drop trailing e
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem

    # Step 5b: -ll -> -l for m > 1
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w
