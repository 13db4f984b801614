"""Qualitative VQA sampling: one Q/A prediction logged per batch, and the
histogram of predicted answers (counterpart of ``vqa_tpu/tools/sample.py``).

The reference's ``sample.py`` calls ``.argmax`` on the model's output
tuple and cannot run (SURVEY.md section 2.1 defect 5); this keeps its
output format over the port's inference step.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from vqa_tpu_torch.data.loader import prefetch_to_device
from vqa_tpu_torch.training.state import make_infer_step
from vqa_tpu_torch.training.train import MODEL_KEYS, model_batch


def sample_vqa(model, dataloader, ans_list: List[str], logger=None,
               sample: int = 0) -> Dict[str, int]:
    """Log the first prediction of each batch of ``dataloader`` (the first
    ``sample`` batches, every batch when 0) as ``<id> | Q: ... | A: ...
    (score: ...)`` and return the histogram of the predicted answers over
    the valid rows. The batches go to the model's device."""
    infer = make_infer_step(model)
    device = next(model.parameters()).device
    count = np.zeros(len(ans_list), np.int64)
    feed = prefetch_to_device(iter(dataloader), device, keys=MODEL_KEYS)
    for i, batch in enumerate(feed):
        if i == sample and sample != 0:
            break
        nvalid = int(batch.pop("nvalid"))
        target = batch["a"].float().cpu().numpy()
        predict = infer(model_batch(batch)).float().cpu().numpy()[:nvalid]
        labels = predict.argmax(1)

        index, answer = int(batch["id"][0]), int(labels[0])
        result = (str(index).zfill(12)
                  + " | Q: " + dataloader.dataset.questions[index].get("q_word", "")
                  + "? | A: " + ans_list[answer]
                  + f" (score: {target[0, answer]:.2f})")
        if logger is not None:
            logger.write(result)
        np.add.at(count, labels, 1)
    return {ans_list[i]: int(count[i]) for i in np.nonzero(count)[0]}
