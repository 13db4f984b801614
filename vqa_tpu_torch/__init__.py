"""PyTorch port of ``vqa_tpu`` for one NVIDIA H100.

Module names mirror ``vqa_tpu/`` so each counterpart is easy to find. This
package imports ``torch`` and never ``jax``; the JAX package stays the
reference the port is held against (``tests/test_torch_*.py``).
"""
