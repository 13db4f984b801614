"""Parallelism over processes and devices (counterpart of
``vqa_tpu/parallel``): the ``('data', 'model')`` process mesh with
batch-sharded data parallelism and tensor-sharded classifier / vocab heads
(``mesh.py``), the two-stage and N-stage pipelines (``pipeline.py``), and a
multi-process dry run of the training steps (``dryrun.py``).

Launch several processes with ``torchrun --nproc_per_node N`` or the JAX
entry point's ``VQA_TPU_MULTIHOST`` / ``VQA_TPU_COORD`` /
``VQA_TPU_NPROCS`` / ``VQA_TPU_PROC_ID`` variables (``mesh.py``).
"""

from vqa_tpu_torch.parallel.mesh import (
    batch_shardings, init_distributed, make_mesh, param_shardings, replicate,
    replicate_global, shard_batch, shard_params,
)

__all__ = ["batch_shardings", "init_distributed", "make_mesh",
           "param_shardings", "replicate", "replicate_global", "shard_batch",
           "shard_params"]
