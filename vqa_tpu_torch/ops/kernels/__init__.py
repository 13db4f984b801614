"""Hand-written Hopper kernels, one module per ``vqa_tpu/ops/pallas`` kernel.

Each module holds the kernel's wrapper and its plain PyTorch version
(``*_reference``). A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches the kernel or raises. Importing a module builds and
loads nothing: the library is built at the first launch.

The package exports the library kernels of ``vqa_tpu/ops/pallas/__init__.py``
(the fused top-down attention with pooling, and the question GRU over the
whole sequence), which no model path calls.
"""

from vqa_tpu_torch.ops.kernels.fused_attention import (
    fused_multiply_attention_pool, multiply_attention_pool_reference,
)
from vqa_tpu_torch.ops.kernels.gru import (
    gru_last_state, gru_last_state_reference,
)

__all__ = [
    "fused_multiply_attention_pool", "multiply_attention_pool_reference",
    "gru_last_state", "gru_last_state_reference",
]
