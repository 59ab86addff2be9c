"""A compile-count guard for the port: the counterpart of
``kubeoperator_tpu/analysis/compile_guard.py``.

The reference counts trace events: one per (jitted function, shape
signature) that JAX traces. The port traces nothing; what it compiles is
its kernel libraries, each built by one nvcc run from ``csrc/``. So here
one compile event is one nvcc build of a library, keyed by (library
name, source digest), the digest ``kernels.lib_path`` keys the build
with. Inside ``with compile_count_guard() as guard:`` every nvcc run
reports to the guard: ``kernels.build`` and the compile cache's miss path
alike (``aot.CompileCache``). A library already built, in
``build/torch_kernels/`` or in a cache entry, counts nothing.

The guard hooks ``kernels`` (it joins ``kernels.guards`` while active),
not ``torch``; nothing is patched when this module is imported.
"""

from __future__ import annotations

import threading
from typing import Any

from kubeoperator_tpu_torch import kernels

Signature = tuple[str, str]        # (library name, source digest)


class CompileCountGuard:
    """Context manager that joins ``kernels.guards`` while active; each
    nvcc build reported to it counts one event under its (library,
    source digest) in :attr:`counts`."""

    def __init__(self) -> None:
        self.counts: dict[Signature, int] = {}
        self._lock = threading.Lock()

    # -- context protocol ---------------------------------------------------
    def __enter__(self) -> "CompileCountGuard":
        kernels.guards.append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        kernels.guards.remove(self)

    # -- recording ----------------------------------------------------------
    def record_aot_compile(self, name: str, digest: str = "") -> None:
        """One nvcc build of library ``name`` from sources of ``digest``:
        ``kernels.build`` and the compile cache's miss path report here, so
        a cold bring-up fails :meth:`assert_zero_compiles`."""
        with self._lock:
            key = (name, digest)
            self.counts[key] = self.counts.get(key, 0) + 1

    # -- reporting ----------------------------------------------------------
    def traces_for(self, name: str) -> list[int]:
        """Per-digest build counts for one library."""
        with self._lock:
            return [c for (n, _), c in sorted(self.counts.items())
                    if n == name]

    def total(self, name: str | None = None) -> int:
        with self._lock:
            return sum(c for (n, _), c in self.counts.items()
                       if name is None or n == name)

    def by_function(self) -> dict[str, dict[str, int]]:
        """name -> {'signatures': distinct source digests, 'traces':
        builds}."""
        out: dict[str, dict[str, int]] = {}
        with self._lock:
            for (n, _), c in self.counts.items():
                slot = out.setdefault(n, {"signatures": 0, "traces": 0})
                slot["signatures"] += 1
                slot["traces"] += c
        return out

    def assert_zero_compiles(self, name: str | None = None) -> None:
        """Raise if anything was built: the warm bring-up contract, where a
        worker constructed against a populated compile cache loads its
        libraries and runs no nvcc."""
        with self._lock:
            bad = [(n, c) for (n, _), c in sorted(self.counts.items())
                   if c and (name is None or n == name)]
        if bad:
            detail = ", ".join(f"{n}×{c}" for n, c in bad)
            raise AssertionError(
                f"warm bring-up compiled — expected zero nvcc builds, "
                f"got: {detail}")

    def assert_single_compile(self, name: str | None = None) -> None:
        """Raise if a (library, source digest) was built more than once: a
        rebuild of sources already built."""
        with self._lock:
            bad = [(n, c) for (n, _), c in sorted(self.counts.items())
                   if c > 1 and (name is None or n == name)]
        if bad:
            detail = ", ".join(f"{n}×{c}" for n, c in bad)
            raise AssertionError(
                f"rebuild detected — >1 nvcc build per source digest: "
                f"{detail}")

    def signature_names(self) -> set[str]:
        """The libraries built while the guard was active."""
        with self._lock:
            return {n for (n, _) in self.counts}

    def assert_within_baseline(self, names: set[str] | None = None) -> None:
        """Raise unless every library built at runtime is one the port
        declares (``kernels.SIGNATURES``, its C entry points by library):
        the counterpart of the reference's check against its KO140
        signature baseline."""
        observed = names if names is not None else self.signature_names()
        unknown = sorted(n for n in observed if n not in kernels.SIGNATURES)
        if unknown:
            raise AssertionError(
                f"library(ies) built at runtime but absent from "
                f"kernels.SIGNATURES: {unknown} — declare their entry "
                f"points there")


def compile_count_guard() -> CompileCountGuard:
    """``with compile_count_guard() as guard: ...`` — see the module
    docstring."""
    return CompileCountGuard()


def active_guard() -> CompileCountGuard | None:
    """The innermost active guard, if any: the one an nvcc build reports
    to."""
    return kernels.guards[-1] if kernels.guards else None
