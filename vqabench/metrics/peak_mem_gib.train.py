"""The peak of the allocator's device memory over set-up and window, GiB
(``torch.cuda.max_memory_allocated``)."""


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None
