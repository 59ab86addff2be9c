"""Persistent compile-artifact cache of the port (zero-build bring-up).

See :mod:`kubeoperator_tpu_torch.aot.cache` for the design; the public
surface is the reference's: :class:`CompileCache` + :class:`CacheKey`
(what engines and trainers consult at construction),
:func:`default_cache_dir` (where the CLI and the jobs agree to look),
:func:`mesh_signature`, and :func:`warm`/:data:`CATALOG` (the pre-build
step). The reference's ``shape_signature`` and ``baseline_fingerprint``
have no counterpart: no shape and no jit baseline changes a kernel
library.
"""

from kubeoperator_tpu_torch.aot.cache import (AotResult, CacheKey,
                                              CompileCache, default_cache_dir,
                                              mesh_signature)
from kubeoperator_tpu_torch.aot.warm import CATALOG, warm

__all__ = [
    "AotResult", "CacheKey", "CompileCache", "CATALOG", "default_cache_dir",
    "mesh_signature", "warm",
]
