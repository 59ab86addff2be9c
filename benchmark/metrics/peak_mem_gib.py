"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` from the
process's start through the window, the largest over the ranks (GiB)."""


def read(run: dict) -> float:
    return run["memory_peak_bytes"] / 2 ** 30
