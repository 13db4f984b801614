"""Hand-written Hopper kernels, one module per ``vqa_tpu/ops/pallas`` kernel.

Each module holds the kernel's wrapper and its plain PyTorch version
(``*_reference``). A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches the kernel or raises.
"""
