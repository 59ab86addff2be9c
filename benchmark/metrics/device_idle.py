"""``device_idle``: the share of the profiled stretch's wall time in which
no kernel, copy or set ran on rank 0's card (%)."""


def read(run: dict) -> float | None:
    t = run.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
