"""The port's host data layer: a numpy-only copy of the parts of
``vqa_tpu/data`` the port's paths read (vocabulary, int8 feature
quantization, synthetic roots, the datasets and the ``Loader``).

It imports neither torch nor jax: batches are dicts of numpy arrays, which
the caller moves to the card (``loader.prefetch_to_device``, which imports
torch when it is called).
"""
