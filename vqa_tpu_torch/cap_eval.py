"""Caption metric scoring CLI of the port
(``python -m vqa_tpu_torch.cap_eval``), the counterpart of the repository's
root ``cap_eval.py``.

Same flags, artifacts and score dict as the reference's ``cap_eval.py``:
reads ``checkpoint/<exp>/decode.txt`` (relative to the working directory)
and a reference-captions JSON, scores BLEU-1..4 / METEOR / ROUGE-L / CIDEr,
writes ``eval_result.txt``. The scoring is the port's
``vqa_tpu_torch/tools/metrics.py`` (pycocoevalcap's semantics written out;
see that module's docstring), with its own bundled METEOR tables.
"""

from __future__ import annotations

import argparse
import json
import os


def load_decoded(path: str) -> dict:
    """decode.txt -> {line_index: [caption]} with <start> markers stripped."""
    with open(path, encoding="utf-8") as f:
        lines = [ln.replace("<start> ", "") for ln in f.read().splitlines() if ln]
    return {i: [ln] for i, ln in enumerate(lines)}


def load_reference_captions(path: str) -> dict:
    """{split}_captions.json -> {line_index: [caption, ...]} per question.

    Each entry's ``c_word`` may be a single caption (VQA-E explanation) or
    the full 5-caption COCO group; scoring always receives a list.
    """
    with open(path, encoding="utf-8") as f:
        data = json.load(f)["data"]
    refs = {}
    for i, entry in enumerate(data):
        caps = entry["c_word"]
        refs[i] = caps if isinstance(caps, list) else [caps]
    return refs


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--load_ref", type=str,
                        default="../annot/VQA-E/val2014_captions.json")
    parser.add_argument("--load_path", type=str)
    parser.add_argument("--synonym_path", type=str, default="auto",
                        help="synset table for the METEOR synonym module "
                             "(one synonym group per line; see "
                             "vqa_tpu_torch.tools.metrics.SynsetTable). 'auto' "
                             "(default): the bundled mini table, so all "
                             "four METEOR 1.5 modules run out of the box — "
                             "generate the full WordNet table with "
                             "scripts/make_meteor_tables.py. 'none': "
                             "exact+stem modules only")
    parser.add_argument("--paraphrase_path", type=str, default="auto",
                        help="phrase table for the METEOR paraphrase "
                             "module ('phrase a ||| phrase b' per line; "
                             "see vqa_tpu_torch.tools.metrics.ParaphraseTable). "
                             "'auto' (default): the bundled mini table; "
                             "'none': module off")
    args = parser.parse_args(argv)

    from vqa_tpu_torch.tools.metrics import (score, load_synsets,
                                       load_paraphrases, bundled_table)

    for attr, name in (("synonym_path", "meteor_synonyms_mini.txt"),
                       ("paraphrase_path", "meteor_paraphrases_mini.txt")):
        val = getattr(args, attr)
        if val == "auto":
            setattr(args, attr, bundled_table(name))
        elif val in ("", "none"):
            setattr(args, attr, "")
    print(f"METEOR tables: synonyms={args.synonym_path or '(off)'} "
          f"paraphrases={args.paraphrase_path or '(off)'}")

    exp_dir = os.path.join("checkpoint", args.load_path)
    hypotheses = load_decoded(os.path.join(exp_dir, "decode.txt"))
    references = load_reference_captions(args.load_ref)
    print(f"scoring {len(hypotheses)} decoded captions from {exp_dir} "
          f"against {args.load_ref}")

    synsets = load_synsets(args.synonym_path) if args.synonym_path else None
    paraphrases = (load_paraphrases(args.paraphrase_path)
                   if args.paraphrase_path else None)
    result = score(references, hypotheses, synsets=synsets,
                   paraphrases=paraphrases)
    report = "\n".join(f"{name}: {100 * value:.8f} %"
                       for name, value in result.items())
    print(report)
    with open(os.path.join(exp_dir, "eval_result.txt"), "w") as f:
        f.write(report + "\n")
    return result


if __name__ == "__main__":
    main()
