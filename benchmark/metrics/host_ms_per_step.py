"""``host_ms_per_step``: the host's wall time inside the train-step call
(the benchmark's own span around it), a step, over fenced steps that each
begin on an empty launch queue (ms)."""


def read(run: dict) -> float | None:
    host = run.get("host")
    if not host or not host["steps"]:
        return None
    return host["call_s"] / host["steps"] * 1e3
