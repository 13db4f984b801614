"""The port's host data layer: its own copy of ``vqa_tpu/data`` and
``vqa_tpu/native.py`` (vocabulary and tokenizer, int8 feature quantization,
the packed store and its packer, relation graphs, synthetic roots, the
datasets, the ``Loader``, and the native library's threaded gathers and
answer densify, bound with ctypes).

It imports neither torch nor jax: batches are dicts of numpy arrays, which
the caller moves to the card (``loader.prefetch_to_device``, which imports
torch when it is called).
"""
