"""Persistent compile-artifact cache of the port: bring-up as a load, not
a build. The counterpart of ``kubeoperator_tpu/aot/cache.py``.

The reference stores serialized XLA executables, one per traced function
and shape signature. The port traces nothing: its compiled artifacts are
its kernel libraries, each built by nvcc from ``csrc/<name>.cu``
(``kernels.compile_library``), and the kernels take their shapes at run
time. So :class:`CompileCache` stores those libraries, keyed by a
:class:`CacheKey` of exactly what changes one:

* the library's name and its source digest (``kernels.source_digest``:
  the ``.cu`` file, every ``.cuh`` header and the flags);
* ``kernels.NVCC_FLAGS``;
* the card: its name and compute capability;
* the toolkit: nvcc's release and ``torch.version.cuda``.

Left out on purpose: the reference's shape signature, donation, static
argnums, closure, jax/jaxlib versions and KO140 baseline, none of which
changes a library. The mesh goes into ``meta.json`` only (for ``list``):
a library does not depend on it.

On a hit the entry's checks pass (schema, the key's fields, the
artifact's sha256) and the stored library is installed
(``kernels.install``): the wrappers' next ``load`` opens it, and no nvcc
runs. On a miss the builder (nvcc, never a copy of ``build/
torch_kernels/``) writes the library into a temporary directory inside
the cache root, the build is reported to the active compile-count guard,
and the entry is published with one ``os.replace``; the loser of a
publish race keeps the winner's copy. An entry that fails its checks is
quarantined and rebuilt, and counted as a miss. A build that fails
raises.

A consumer (an engine, a trainer, a job) consults the cache for the
libraries its configuration will launch, at construction
(:meth:`CompileCache.consult`): one :class:`AotResult` with a row per
library, or ``source`` "none" when it launches none.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Sequence

from kubeoperator_tpu_torch import kernels
from kubeoperator_tpu_torch.telemetry.metrics import record_aot_event

_SCHEMA = 1
_META = "meta.json"
_ARTIFACT = "artifact.so"
_IN_USE = "in_use.json"
_KIND = "library"


def default_cache_dir() -> str:
    """``KO_AOT_CACHE`` if set, else a per-user cache directory apart from
    the JAX package's."""
    env = os.environ.get("KO_AOT_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "kubeoperator-tpu-torch", "aot")


def mesh_signature(spec: Any) -> str:
    """Canonical string for a MeshSpec (axis sizes > 1), ``solo`` for the
    single-device path."""
    if spec is None:
        return "solo"
    parts = [f"{n}{s}" for n, s in spec.sizes() if s > 1]
    return ",".join(parts) or "solo"


def card_toolkit() -> dict:
    """The key's fields of this machine: the card (name and compute
    capability), nvcc's release and the CUDA version torch was built
    for. Needs the card and nvcc."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the compile cache keys its "
                           "libraries on the card")
    major, minor = torch.cuda.get_device_capability(0)
    return {"device_kind": f"{torch.cuda.get_device_name(0)} "
                           f"sm_{major}{minor}",
            "nvcc_version": kernels.nvcc_version(),
            "torch_cuda": str(torch.version.cuda)}


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """Everything that changes a kernel library."""

    name: str
    device_kind: str
    source_digest: str
    nvcc_flags: tuple[str, ...]
    nvcc_version: str
    torch_cuda: str

    def payload(self) -> dict:
        d = dataclasses.asdict(self)
        d["nvcc_flags"] = list(self.nvcc_flags)
        return d

    def fingerprint(self) -> str:
        blob = json.dumps(self.payload(), sort_keys=True).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()[:20]


@dataclasses.dataclass
class AotResult:
    """What one consult produced. For one library: whether it was a hit,
    the library installed (``path``) and how long bring-up took. For a
    consumer (``CompileCache.consult``): its libraries' rows, ``hit`` when
    all of them hit, a fingerprint of theirs and the total seconds;
    ``source`` "none" with no rows when it launches no library."""

    name: str
    fingerprint: str
    hit: bool
    seconds: float
    source: str               # cache | compile | none
    path: str | None = None
    libraries: tuple["AotResult", ...] = ()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError):
        return False
    return True


def _sha256(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


class CompileCache:
    """Filesystem-backed kernel-library cache. Layout::

        <root>/<name>/<fingerprint>/meta.json    key, sha256, mesh, kind
                                    artifact.so  the nvcc-built library
                                    in_use.json  pid marker while loaded

    ``builder(name, out)`` builds library ``name`` into the file ``out``
    (default ``kernels.compile_library``, nvcc); ``toolkit()`` gives the
    key's machine fields (default ``card_toolkit``). Counters
    (:attr:`hits`/:attr:`misses`) are process-local; the families
    ``ko_aot_cache_{hits,misses}_total`` and ``ko_aot_bringup_seconds``
    get one sample per library consulted.
    """

    def __init__(self, root: str | None = None, *,
                 builder: Callable[[str, Path], Any] | None = None,
                 toolkit: Callable[[], dict] | None = None):
        self.root = os.path.abspath(root or default_cache_dir())
        os.makedirs(self.root, exist_ok=True)
        self.builder = builder or kernels.compile_library
        self._toolkit_fn = toolkit or card_toolkit
        self._toolkit: dict | None = None
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        self._in_use: set[str] = set()

    # -- key construction ---------------------------------------------------
    def toolkit(self) -> dict:
        """The machine's key fields, read once per cache."""
        if self._toolkit is None:
            self._toolkit = dict(self._toolkit_fn())
        return self._toolkit

    def key_for(self, name: str) -> CacheKey:
        if name not in kernels.SIGNATURES:
            raise KeyError(f"no kernel library {name!r} (have: "
                           f"{sorted(kernels.SIGNATURES)})")
        tk = self.toolkit()
        return CacheKey(name=name, device_kind=tk["device_kind"],
                        source_digest=kernels.source_digest(name),
                        nvcc_flags=tuple(kernels.NVCC_FLAGS),
                        nvcc_version=tk["nvcc_version"],
                        torch_cuda=tk["torch_cuda"])

    # -- the entry points consumers use --------------------------------------
    def consult(self, name: str, libraries: Sequence[str], *,
                mesh_spec: Any = None) -> AotResult:
        """Bring up consumer ``name``'s ``libraries`` through the cache:
        one row each, ``hit`` when every row hit. With no library it says
        so (``source`` "none") and writes nothing."""
        if not libraries:
            return AotResult(name=name, fingerprint="none", hit=True,
                             seconds=0.0, source="none")
        rows = tuple(self.load_or_compile(lib, mesh_spec=mesh_spec)
                     for lib in libraries)
        blob = json.dumps([r.fingerprint for r in rows]).encode("utf-8")
        hit = all(r.hit for r in rows)
        return AotResult(name=name,
                         fingerprint=hashlib.sha256(blob).hexdigest()[:20],
                         hit=hit, seconds=sum(r.seconds for r in rows),
                         source="cache" if hit else "compile",
                         libraries=rows)

    def load_or_compile(self, name: str, *, mesh_spec: Any = None
                        ) -> AotResult:
        """Install library ``name`` from its entry, building the entry
        first on a miss (reported to the active compile-count guard as one
        nvcc build)."""
        key = self.key_for(name)
        fp = key.fingerprint()
        entry = self._entry_dir(name, fp)
        t0 = time.perf_counter()
        hit = self._try_load(entry, key)
        if not hit:
            self._build(entry, key, mesh_spec)
        artifact = os.path.join(entry, _ARTIFACT)
        kernels.install(name, artifact)
        seconds = time.perf_counter() - t0

        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
            self._in_use.add(fp)
        self._mark_in_use(entry)
        record_aot_event(name, hit=hit, seconds=seconds)
        return AotResult(name=name, fingerprint=fp, hit=hit,
                         seconds=seconds, source="cache" if hit else "compile",
                         path=artifact)

    # -- load / store --------------------------------------------------------
    def _try_load(self, entry: str, key: CacheKey) -> bool:
        """Whether the entry holds this key's library intact; an entry
        that fails a check is quarantined."""
        meta_path = os.path.join(entry, _META)
        art_path = os.path.join(entry, _ARTIFACT)
        if not (os.path.isfile(meta_path) and os.path.isfile(art_path)):
            return False
        try:
            with open(meta_path, encoding="utf-8") as fh:
                meta = json.load(fh)
            if meta.get("schema") != _SCHEMA:
                raise ValueError(f"schema {meta.get('schema')} != {_SCHEMA}")
            if meta.get("kind") != _KIND:
                raise ValueError(f"kind {meta.get('kind')!r} != {_KIND!r}")
            stored, want = meta.get("key", {}), key.payload()
            for field, value in want.items():
                if stored.get(field) != value:
                    raise ValueError(f"built with {field} "
                                     f"{stored.get(field)!r}, running "
                                     f"{value!r}")
            if _sha256(art_path) != meta.get("artifact_sha256"):
                raise ValueError("artifact differs from its recorded sha256")
        except (OSError, ValueError, AttributeError):
            # corrupt, tampered or built by another toolkit: quarantine so
            # the rebuild gets a clean slate
            self._quarantine(entry)
            return False
        return True

    def _build(self, entry: str, key: CacheKey, mesh_spec: Any) -> None:
        """Build the library into a temporary directory beside the entry
        and publish it with one rename; a concurrent winner's entry
        stands."""
        tmp = f"{entry}.tmp-{os.getpid()}-{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)
        try:
            art = os.path.join(tmp, _ARTIFACT)
            self.builder(key.name, Path(art))
            kernels.report_compile(key.name)
            meta = {"schema": _SCHEMA, "kind": _KIND, "key": key.payload(),
                    "fingerprint": key.fingerprint(),
                    "artifact_bytes": os.path.getsize(art),
                    "artifact_sha256": _sha256(art),
                    "mesh": mesh_signature(mesh_spec),
                    "created_at": time.time()}
            with open(os.path.join(tmp, _META), "w", encoding="utf-8") as fh:
                json.dump(meta, fh, indent=1, sort_keys=True)
            try:
                os.replace(tmp, entry)
            except OSError:
                if not os.path.isfile(os.path.join(entry, _ARTIFACT)):
                    raise
                # publish race: another bring-up won; keep the winner's copy
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _quarantine(self, entry: str) -> None:
        try:
            os.replace(entry, f"{entry}.corrupt-{os.getpid()}")
        except OSError:
            shutil.rmtree(entry, ignore_errors=True)

    def _mark_in_use(self, entry: str) -> None:
        try:
            with open(os.path.join(entry, _IN_USE), "w",
                      encoding="utf-8") as fh:
                json.dump({"pid": os.getpid(), "at": time.time()}, fh)
        except OSError:
            pass

    # -- inventory / control plane -------------------------------------------
    def _entry_dir(self, name: str, fingerprint: str) -> str:
        return os.path.join(self.root, name, fingerprint)

    def meta(self, row: dict) -> dict:
        """The ``meta.json`` of an ``entries()`` row (the mesh it was first
        built under is there)."""
        path = os.path.join(self._entry_dir(row["name"], row["fingerprint"]),
                            _META)
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)

    def entries(self) -> list[dict]:
        """Inventory rows for ``list`` and ``status``: one per published
        library, sizes included, live holders marked."""
        rows: list[dict] = []
        with self._lock:
            local = set(self._in_use)
        if not os.path.isdir(self.root):
            return rows
        for name in sorted(os.listdir(self.root)):
            group = os.path.join(self.root, name)
            if not os.path.isdir(group):
                continue
            for fp in sorted(os.listdir(group)):
                entry = os.path.join(group, fp)
                meta_path = os.path.join(entry, _META)
                if (".corrupt-" in fp or ".tmp-" in fp
                        or not os.path.isfile(meta_path)):
                    continue
                try:
                    with open(meta_path, encoding="utf-8") as fh:
                        meta = json.load(fh)
                except (OSError, ValueError):
                    continue
                size = 0
                for f in os.listdir(entry):
                    try:
                        size += os.path.getsize(os.path.join(entry, f))
                    except OSError:
                        pass
                holder = self._holder_pid(entry)
                rows.append({
                    "name": name, "fingerprint": fp,
                    "kind": meta.get("kind"), "size_bytes": size,
                    "created_at": meta.get("created_at"),
                    "key": meta.get("key", {}),
                    "in_use": fp in local or holder is not None,
                    "holder_pid": holder,
                })
        return rows

    def _holder_pid(self, entry: str) -> int | None:
        try:
            with open(os.path.join(entry, _IN_USE), encoding="utf-8") as fh:
                pid = int(json.load(fh).get("pid", -1))
        except (OSError, ValueError):
            return None
        return pid if _pid_alive(pid) else None

    def status(self) -> dict:
        rows = self.entries()
        return {"root": self.root,
                "entries": rows,
                "count": len(rows),
                "total_bytes": sum(r["size_bytes"] for r in rows),
                "hits": self.hits,
                "misses": self.misses}

    def purge(self, fingerprint: str | None = None, *,
              force: bool = False) -> dict:
        """Delete entries (all, or one fingerprint). Entries held by a
        running process, this one's loads or any entry whose
        ``in_use.json`` names a live pid, are refused unless ``force``."""
        removed: list[str] = []
        refused: list[str] = []
        for row in self.entries():
            fp = row["fingerprint"]
            if fingerprint is not None and fp != fingerprint:
                continue
            if row["in_use"] and not force:
                refused.append(fp)
                continue
            shutil.rmtree(self._entry_dir(row["name"], fp),
                          ignore_errors=True)
            removed.append(fp)
            with self._lock:
                self._in_use.discard(fp)
        return {"removed": removed, "refused": refused}
