"""``conv_bwd_roofline``: the conv backward layer's least time a step
(the configuration's bound of the work its shapes need) over the device
time of every kernel launched inside that layer's backward ops (%). The
ops are found by name in the profile, not the kernels, so the share reads
the same work whatever kernel does it. None where the cell runs no such
op."""


def read(run: dict) -> float | None:
    t, bound = run.get("trace"), run["bounds"].get("conv_bwd")
    if not t or bound is None:
        return None
    spent = t["op_device_s"].get("conv_bwd", 0.0) / t["steps"]
    return 100.0 * bound / spent if spent > 0 else None
