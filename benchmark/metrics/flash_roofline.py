"""``flash_roofline``: the attention layer's least time a step (the op's
forward and backward at the real 196 positions, each tensor read or
written once) over the device time of every kernel launched inside the
attention op's forward and backward (%). None where the cell runs no such
op."""


def read(run: dict) -> float | None:
    t, bound = run.get("trace"), run["bounds"].get("flash")
    if not t or bound is None:
        return None
    spent = t["op_device_s"].get("flash", 0.0) / t["steps"]
    return 100.0 * bound / spent if spent > 0 else None
