"""Analysis tooling of the PyTorch port: the compile-count guard
(:mod:`compile_guard`), which counts the nvcc builds of the port's
kernel libraries, and the hot-path lint (:mod:`lint`: KO101, KO102 and
KO121-KO123, the reference's KO1xx rules that carry over to PyTorch;
``python -m kubeoperator_tpu_torch.analysis.lint``). The reference's
other rules (its jit, donation and sharding rules, KO3xx concurrency and
the project rules) have no counterpart here."""

from kubeoperator_tpu_torch.analysis.compile_guard import (
    CompileCountGuard, active_guard, compile_count_guard,
)

__all__ = ["CompileCountGuard", "active_guard", "compile_count_guard"]
