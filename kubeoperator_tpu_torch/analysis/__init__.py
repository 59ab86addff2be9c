"""Analysis tooling of the PyTorch port: the compile-count guard
(:mod:`compile_guard`), which counts the nvcc builds of the port's
kernel libraries. The reference's static lint (KO1xx-KO3xx) is not
ported."""

from kubeoperator_tpu_torch.analysis.compile_guard import (
    CompileCountGuard, active_guard, compile_count_guard,
)

__all__ = ["CompileCountGuard", "active_guard", "compile_count_guard"]
