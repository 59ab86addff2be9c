"""``train_step_ms``: the window's wall time over the train steps
completed in it (ms; rank 0's window over several cards)."""


def read(run: dict) -> float:
    return run["step_s"] * 1e3
