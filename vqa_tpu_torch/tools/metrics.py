"""Caption evaluation metrics: BLEU-1..4, ROUGE-L, CIDEr, METEOR (the port's
copy of ``vqa_tpu/tools/metrics.py``; the bundled tables are its own, in
``vqa_tpu_torch/tools/data/``).

Native implementations of the metrics the reference obtains from
``pycocoevalcap`` (the reference's `cap_eval.py:22-39`), which is not
available in this environment:

- **BLEU-1..4** — corpus-level, clipped n-gram precision, closest-reference
  brevity penalty (the pycocoevalcap BleuScorer 'closest' option).
- **ROUGE-L** — LCS F-measure with beta=1.2, max precision/recall over
  references, corpus mean (pycocoevalcap rouge.py semantics).
- **CIDEr** — tf-idf n-gram cosine with reference-corpus document
  frequencies, Gaussian length penalty sigma=6, x10 (pycocoevalcap
  cider_scorer.py semantics).
- **METEOR** — exact + Porter-stem + synonym + paraphrase matching (all
  four METEOR 1.5 modules with the English module weights 1.0 / 0.6 /
  0.8 / 0.6; alpha=0.9 harmonic mean, chunk fragmentation penalty
  gamma=0.5, beta=3), resolved by the jar Aligner's beam search (max
  coverage -> max module weight -> min chunks -> min total distance,
  beam 40 — exhaustive at caption lengths). The reference wraps the Java
  METEOR 1.5 jar, whose synonym/paraphrase modules read bundled corpora
  (WordNet synsets, paraphrase-en) that are not present in this
  environment — so those two modules run only when their tables are
  supplied (``load_synsets`` / ``load_paraphrases``; see their docstrings
  for how to generate the tables from public data). Remaining documented
  delta vs the jar: the bundled table *contents*, and the jar's
  task-tuned scoring parameters (this module defaults to the original
  METEOR alpha/beta/gamma, all exposed as kwargs). The exact-only variant
  is kept as ``meteor(..., use_stem=False)``, the earlier greedy
  alignment as ``alignment='greedy'``, and the agreement between variants
  is pinned in tests/test_tools.py (and this copy against it in
  tests/test_torch_tools.py).

API mirrors cap_eval.score: ``score(refs, hyps) -> {metric: value}`` where
refs/hyps map id -> [sentence, ...].
"""

from __future__ import annotations

import math
import os
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ----------------------------------------------------------------- BLEU

def bleu(refs: Dict, hyps: Dict, max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with closest-ref-length brevity penalty."""
    clipped = [0] * max_n
    total = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for key in hyps:
        hyp = hyps[key][0].split()
        ref_tok = [r.split() for r in refs[key]]
        hyp_len += len(hyp)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in ref_tok)[1]
        for n in range(1, max_n + 1):
            hyp_ng = _ngrams(hyp, n)
            max_ref = Counter()
            for r in ref_tok:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            clipped[n - 1] += sum(min(c, max_ref[ng])
                                  for ng, c in hyp_ng.items())
            total[n - 1] += max(sum(hyp_ng.values()), 0)
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    out = []
    log_sum = 0.0
    for n in range(max_n):
        p = clipped[n] / total[n] if total[n] else 0.0
        log_sum += math.log(max(p, 1e-12))
        out.append(bp * math.exp(log_sum / (n + 1)))
    return out


# ----------------------------------------------------------------- ROUGE-L

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(cur[j - 1], prev[j])
        prev = cur
    return prev[len(b)]


def rouge_l(refs: Dict, hyps: Dict, beta: float = 1.2) -> float:
    scores = []
    for key in hyps:
        hyp = hyps[key][0].split()
        prec, rec = [], []
        for r in refs[key]:
            ref = r.split()
            lcs = _lcs_len(hyp, ref)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(ref) if ref else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            scores.append(((1 + beta ** 2) * p * r) / (r + beta ** 2 * p))
        else:
            scores.append(0.0)
    return sum(scores) / max(len(scores), 1)


# ----------------------------------------------------------------- CIDEr

def cider(refs: Dict, hyps: Dict, n: int = 4, sigma: float = 6.0) -> float:
    # document frequency over the reference corpus
    df = defaultdict(float)
    for key in refs:
        seen = set()
        for r in refs[key]:
            for k in range(1, n + 1):
                seen.update(_ngrams(r.split(), k).keys())
        for ng in seen:
            df[ng] += 1.0
    log_n_imgs = math.log(max(len(refs), 1))

    def to_vec(tokens):
        vecs, norms = [], []
        for k in range(1, n + 1):
            vec = {}
            for ng, c in _ngrams(tokens, k).items():
                idf = log_n_imgs - math.log(max(df[ng], 1.0))
                vec[ng] = c * idf
            vecs.append(vec)
            norms.append(math.sqrt(sum(v * v for v in vec.values())))
        return vecs, norms, len(tokens)

    scores = []
    for key in hyps:
        hyp_vec, hyp_norm, hyp_len = to_vec(hyps[key][0].split())
        img_score = 0.0
        for r in refs[key]:
            ref_vec, ref_norm, ref_len = to_vec(r.split())
            delta = float(hyp_len - ref_len)
            val = 0.0
            for k in range(n):
                num = sum(min(c, ref_vec[k].get(ng, 0.0)) * ref_vec[k].get(ng, 0.0)
                          for ng, c in hyp_vec[k].items())
                if hyp_norm[k] != 0 and ref_norm[k] != 0:
                    s = num / (hyp_norm[k] * ref_norm[k])
                else:
                    s = 0.0
                val += s * math.exp(-(delta ** 2) / (2 * sigma ** 2))
            img_score += val / n
        scores.append(10.0 * img_score / max(len(refs[key]), 1))
    return sum(scores) / max(len(scores), 1)


# ----------------------------------------------------------------- METEOR

def _align_stage(hyp: List[str], ref: List[str], hyp_used, ref_used,
                 key) -> List[Tuple[int, int]]:
    """Greedy left-to-right matching of unused words under key()."""
    ref_keys = [key(w) for w in ref]
    pairs = []
    for i, w in enumerate(hyp):
        if hyp_used[i]:
            continue
        kw = key(w)
        for j in range(len(ref)):
            if not ref_used[j] and kw == ref_keys[j]:
                hyp_used[i] = True
                ref_used[j] = True
                pairs.append((i, j))
                break
    return pairs


_BEAM = 40  # the METEOR 1.5 Aligner's beam width


class SynsetTable:
    """Synonym lookup for METEOR module 3 (the jar's WordNet synonymy).

    Built from synonym *groups* (synsets): two words are synonyms iff they
    share at least one group — exactly WordNet's synset relation, which is
    what the METEOR 1.5 jar tests (the reference's `cap_eval.py:25-28`
    pipeline). File format for ``load_synsets``: one group per line,
    whitespace-separated lowercase words; ``#`` comments allowed. Generate
    from WordNet where nltk corpus data exists::

        from nltk.corpus import wordnet
        with open("english.synsets", "w") as f:
            for s in wordnet.all_synsets():
                names = {l.name().lower() for l in s.lemmas()
                         if "_" not in l.name()}
                if len(names) > 1:
                    f.write(" ".join(sorted(names)) + "\\n")
    """

    def __init__(self, groups):
        self._sets: Dict[str, set] = {}
        for gid, group in enumerate(groups):
            for w in group:
                self._sets.setdefault(w, set()).add(gid)

    def synonyms(self, a: str, b: str) -> bool:
        sa = self._sets.get(a)
        return bool(sa) and not sa.isdisjoint(self._sets.get(b, ()))


def bundled_table(name: str) -> str:
    """Path of a bundled mini table (vqa_tpu_torch/tools/data/<name>).

    The jar bundles its full WordNet + paraphrase-en corpora; those are not
    redistributable here, so small hand-written stand-ins ship instead and
    ``scripts/make_meteor_tables.py`` converts the real downloads into the
    same formats. Returns "" if the file is missing (module stays off).
    """
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", name)
    return path if os.path.exists(path) else ""


def load_synsets(path: str) -> SynsetTable:
    groups = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                groups.append(line.lower().split())
    return SynsetTable(groups)


class ParaphraseTable:
    """Phrase table for METEOR module 4 (the jar's paraphrase matching).

    Maps multi-word (or single-word) phrases to sets of equivalent
    phrases; lookup is symmetric. The METEOR 1.5 jar ships a
    ``paraphrase-en`` table mined from parallel corpora (Denkowski &
    Lavie 2014) — distribute-your-own here, same posture as
    ``SynsetTable``. File format for ``load_paraphrases``: one pair per
    line, ``phrase a ||| phrase b`` (lowercase; ``#`` comments allowed).
    """

    def __init__(self, pairs):
        self._map: Dict[Tuple[str, ...], set] = {}
        self.max_len = 1
        for a, b in pairs:
            ta, tb = tuple(a), tuple(b)
            if not ta or not tb or ta == tb:
                continue
            self._map.setdefault(ta, set()).add(tb)
            self._map.setdefault(tb, set()).add(ta)
            self.max_len = max(self.max_len, len(ta), len(tb))

    def paraphrases(self, phrase: Tuple[str, ...]) -> set:
        return self._map.get(phrase, set())


def load_paraphrases(path: str) -> ParaphraseTable:
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "|||" not in line:
                continue
            a, b = line.lower().split("|||", 1)
            pairs.append((a.split(), b.split()))
    return ParaphraseTable(pairs)


def _beam_align(hyp: List[str], ref: List[str], use_stem: bool,
                stem_weight: float, synsets: SynsetTable = None,
                syn_weight: float = 0.8,
                paraphrases: "ParaphraseTable" = None,
                para_weight: float = 0.6
                ) -> Tuple[int, int, float, float, int]:
    """METEOR 1.5 Aligner-style beam search
    -> (m_hyp, m_ref, w_hyp, w_ref, chunks): words covered on each side,
    module-weighted word mass on each side, and chunk count.

    Candidate matches: per word pair, by module precedence — exact
    (weight 1.0), else synonym (shared synset, ``syn_weight`` — the
    METEOR 1.5 English weight 0.8), else Porter-stem equal
    (``stem_weight``); plus, when a phrase table is supplied, span
    matches — a hypothesis span whose phrase the table maps to a
    reference span (module 4, ``para_weight`` — the 1.5 English weight
    0.6), covering every word of both spans. The search walks hypothesis
    positions left to right, each step either skipping the word or laying
    down a match starting there; partial alignments are ranked by the
    jar's resolution order — most words covered (both sides), then
    highest module weight, then fewest chunks, then smallest total match
    distance — keeping the top ``_BEAM`` states. At caption lengths
    (<= ~20 tokens) this is effectively exhaustive.
    """
    if use_stem:
        from vqa_tpu_torch.tools.porter import porter_stem
        hyp_stem = [porter_stem(w) for w in hyp]
        ref_stem = [porter_stem(w) for w in ref]
    # unigram candidates: [(j, weight)]
    uni: List[List[Tuple[int, float]]] = []
    for i, w in enumerate(hyp):
        row = []
        for j, rw in enumerate(ref):
            if w == rw:
                row.append((j, 1.0))
            elif synsets is not None and synsets.synonyms(w, rw):
                row.append((j, syn_weight))
            elif use_stem and hyp_stem[i] == ref_stem[j]:
                row.append((j, stem_weight))
        uni.append(row)
    # span candidates: [(hyp_len, j, ref_len, weight)]
    spans: List[List[Tuple[int, int, int, float]]] = [[] for _ in hyp]
    if paraphrases is not None:
        ref_t = tuple(ref)
        for i in range(len(hyp)):
            for li in range(1, min(paraphrases.max_len, len(hyp) - i) + 1):
                for pp in paraphrases.paraphrases(tuple(hyp[i:i + li])):
                    lj = len(pp)
                    for j in range(len(ref) - lj + 1):
                        if ref_t[j:j + lj] == pp:
                            spans[i].append((li, j, lj, para_weight))

    # state: 4 rank fields (covered, weight, -chunks, -dist) + payload
    # (ref_mask, next_i, last_hyp_end, last_ref_end, m_h, m_r, w_h, w_r)
    states = [(0, 0.0, 0, 0, 0, 0, -2, -2, 0, 0, 0.0, 0.0)]
    for i in range(len(hyp)):
        nxt = []
        for s in states:
            (covered, weight, nchunks, ndist,
             mask, next_i, lhe, lre, m_h, m_r, w_h, w_r) = s
            if next_i > i:          # mid-span: nothing to decide here
                nxt.append(s)
                continue
            # skip word i
            nxt.append((covered, weight, nchunks, ndist, mask, i + 1,
                        lhe, lre, m_h, m_r, w_h, w_r))
            for j, w8 in uni[i]:
                if mask >> j & 1:
                    continue
                contiguous = (lhe == i - 1 and lre == j - 1)
                nxt.append((covered + 2, weight + 2 * w8,
                            nchunks - (0 if contiguous else 1),
                            ndist - abs(i - j), mask | (1 << j), i + 1,
                            i, j, m_h + 1, m_r + 1, w_h + w8, w_r + w8))
            for li, j, lj, w8 in spans[i]:
                span_bits = ((1 << lj) - 1) << j
                if mask & span_bits:
                    continue
                contiguous = (lhe == i - 1 and lre == j - 1)
                nxt.append((covered + li + lj, weight + w8 * (li + lj),
                            nchunks - (0 if contiguous else 1),
                            ndist - abs(i - j), mask | span_bits, i + li,
                            i + li - 1, j + lj - 1, m_h + li, m_r + lj,
                            w_h + w8 * li, w_r + w8 * lj))
        nxt.sort(key=lambda s: s[:4], reverse=True)
        # dedupe identical (mask, position, last match) states
        seen = set()
        states = []
        for s in nxt:
            sig = (s[4], s[5], s[6], s[7])
            if sig in seen:
                continue
            seen.add(sig)
            states.append(s)
            if len(states) == _BEAM:
                break
    best = states[0]
    return best[8], best[9], best[10], best[11], -best[2]


def _meteor_single(hyp: List[str], ref: List[str], alpha=0.9, beta=3.0,
                   gamma=0.5, use_stem: bool = True,
                   stem_weight: float = 0.6,
                   alignment: str = "beam",
                   synsets: SynsetTable = None,
                   paraphrases: ParaphraseTable = None) -> float:
    """METEOR for one hypothesis/reference pair.

    Matches per the METEOR 1.5 modules: exact (weight 1.0), Porter-stem
    (0.6), synonym (0.8, active when a ``synsets`` table is supplied — see
    ``SynsetTable``), paraphrase (0.6, active when a ``paraphrases`` phrase
    table is supplied — see ``ParaphraseTable``; spans cover every word of
    both sides, precision/recall weigh each side's covered word count and
    the fragmentation denominator is the two sides' mean — the 1.5 phrase
    semantics, which reduce exactly to the unigram formulas when all
    matches are single words). ``alignment='beam'`` resolves the match set
    the way the jar's Aligner does (beam search: max coverage -> max
    weight -> min chunks -> min distance); ``alignment='greedy'`` keeps
    the earlier staged left-to-right greedy (cheaper, exact+stem only,
    kept for comparison). Reference pipeline:
    the reference's cap_eval.py:25-28.
    """
    if not hyp or not ref:
        return 0.0
    if alignment == "beam":
        m_h, m_r, w_h, w_r, chunks = _beam_align(
            hyp, ref, use_stem, stem_weight, synsets=synsets,
            paraphrases=paraphrases)
        if m_h == 0:
            return 0.0
        p = w_h / len(hyp)
        r = w_r / len(ref)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        penalty = gamma * (chunks / ((m_h + m_r) / 2.0)) ** beta
        return fmean * (1 - penalty)
    else:
        hyp_used = [False] * len(hyp)
        ref_used = [False] * len(ref)
        exact = _align_stage(hyp, ref, hyp_used, ref_used, lambda w: w)
        stem: List[Tuple[int, int]] = []
        if use_stem:
            from vqa_tpu_torch.tools.porter import porter_stem
            stem = _align_stage(hyp, ref, hyp_used, ref_used, porter_stem)
        align = sorted(exact + stem)
        m = len(align)
        if m == 0:
            return 0.0
        m_w = len(exact) + stem_weight * len(stem)
        chunks = 1
        for (i1, j1), (i2, j2) in zip(align, align[1:]):
            if i2 != i1 + 1 or j2 != j1 + 1:
                chunks += 1
    # module-weighted match mass for precision/recall; the chunk penalty
    # counts matches unweighted (METEOR 1.5 semantics).
    p = m_w / len(hyp)
    r = m_w / len(ref)
    fmean = p * r / (alpha * p + (1 - alpha) * r)
    penalty = gamma * (chunks / m) ** beta
    return fmean * (1 - penalty)


def meteor(refs: Dict, hyps: Dict, use_stem: bool = True,
           alignment: str = "beam", synsets: SynsetTable = None,
           paraphrases: ParaphraseTable = None) -> float:
    scores = []
    for key in hyps:
        hyp = hyps[key][0].split()
        scores.append(max(_meteor_single(hyp, r.split(), use_stem=use_stem,
                                         alignment=alignment,
                                         synsets=synsets,
                                         paraphrases=paraphrases)
                          for r in refs[key]))
    return sum(scores) / max(len(scores), 1)


# ----------------------------------------------------------------- all of them

def score(ref: Dict, sample: Dict, synsets: SynsetTable = None,
          paraphrases: ParaphraseTable = None) -> Dict[str, float]:
    """All metrics at once (cap_eval.py:22-39 interface).

    ``synsets`` / ``paraphrases``: optional METEOR synonym / paraphrase
    tables (``load_synsets`` / ``load_paraphrases``)."""
    b = bleu(ref, sample)
    return {
        "Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2], "Bleu_4": b[3],
        "METEOR": meteor(ref, sample, synsets=synsets,
                         paraphrases=paraphrases),
        "CIDEr": cider(ref, sample),
        "ROUGE_L": rouge_l(ref, sample),
    }
