"""``gemm_conv_ms``: device ms a step in cuBLAS GEMMs and cuDNN convs,
from the profiled stretch."""

CLASSES = ("gemm (cuBLAS)", "conv (cuDNN)")


def read(run: dict) -> float | None:
    t = run.get("trace")
    if not t:
        return None
    return sum(t["class_s"].get(c, 0.0) for c in CLASSES) / t["steps"] * 1e3
