"""``elementwise_ms``: device ms a step in elementwise and reduction
kernels and in casts and copies (BatchNorm, norms, activations, residual
adds, casts), from the profiled stretch."""

CLASSES = ("other elementwise/reduction", "casts and copies")


def read(run: dict) -> float | None:
    t = run.get("trace")
    if not t:
        return None
    return sum(t["class_s"].get(c, 0.0) for c in CLASSES) / t["steps"] * 1e3
