"""``setup_s``: from the process's start to the window's opening (s):
the import, the kernels' build or load, the weights and batches made from
the seed, the first three steps (the warm-up the reference follows)."""


def read(run: dict) -> float:
    return run["setup_s"]
