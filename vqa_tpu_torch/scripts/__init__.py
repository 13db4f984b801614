"""Path benchmarks of the port (counterparts of the root ``scripts/bench_*``).

    python -m vqa_tpu_torch.scripts.bench_beam [all|fused]
    python -m vqa_tpu_torch.scripts.bench_regat [full]
    python -m vqa_tpu_torch.scripts.bench_train [MODE]
    python -m vqa_tpu_torch.scripts.bench_feed [--images N] ...

Each runs on the card (``bench_feed`` is host-only) and prints the rows of
its JAX counterpart in the same format; ``_bench_util`` holds the timing.
"""
