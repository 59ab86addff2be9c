"""``nccl_ms``: device ms a step in NCCL's kernels on rank 0, from the
profiled stretch. None where none ran."""


def read(run: dict) -> float | None:
    t = run.get("trace")
    if not t or not t["class_s"].get("nccl"):
        return None
    return t["class_s"]["nccl"] / t["steps"] * 1e3
