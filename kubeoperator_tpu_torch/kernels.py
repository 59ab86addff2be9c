"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, into ``build/torch_kernels/`` at the root
of the checkout, keyed on a hash of the source, so a fresh checkout builds
everything the first time a kernel launches and reuses it after. Nothing
here runs when the module is imported: the CPU tests import it without a
compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of every entry point, by library
SIGNATURES = {
    "flash_attention": {
        "ko_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
        "ko_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                            _I, _P],
        "ko_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                             _I, _I, _P],
        # the packed layout [B, T, H·D]: (b, t, h, d) where bh had (bh, t, d)
        "ko_flash_fwd_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                _I, _P],
        "ko_flash_bwd_dq_packed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _F, _I, _I, _P],
        "ko_flash_bwd_dkv_packed": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _F, _I, _I, _P],
        # Δ of either layout: (do, o, delta, b, t, nh, d, stream)
        "ko_flash_delta": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "conv_bwd": {
        "ko_conv1x1_bwd_dx": [_P, _P, _P, _I, _I, _I, _P],
        "ko_conv1x1_bwd_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "ko_bn_bwd_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _P],
        "ko_bn_bwd_dx": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P],
        "ko_bn_bwd_dw": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _P],
        "ko_channel_sum": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: dict[str, dict] = {}     # name -> {"seconds", "cached", "ptxas"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda)")


def _source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def lib_path(name: str) -> Path:
    """The library's path, keyed on its source, the shared headers and
    the flags."""
    text = _source(name).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists. Safe against concurrent builds: each writes a temporary file
    and renames it into place."""
    out = lib_path(name)
    if out.exists():
        build_log.setdefault(name, {"seconds": 0.0, "cached": True, "ptxas": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(_source(name))],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    os.replace(tmp, out)
    build_log[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                       "ptxas": proc.stderr}
    return out


def build_all() -> dict[str, dict]:
    """Build every library, one ``nvcc`` per source, all started
    together."""
    with ThreadPoolExecutor(len(SIGNATURES)) as pool:
        list(pool.map(build, SIGNATURES))
    return dict(build_log)


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_wgmma_kernel<128>`` for a kernel's mangled name: the
    length-prefixed identifier that ends in ``_kernel`` and opens the
    template arguments, with their integer values. Anything else is
    returned as it is."""
    for m in re.finditer(r"\d+", mangled):
        # the length may follow a name that ends in digits (_GLOBAL__N_1)
        for k in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[k:m.end()])]
            rest = mangled[m.end() + len(name):]
            if name.endswith("_kernel") and rest.startswith("I"):
                targs = re.match(r"I((?:L[ib]\d+E)*)", rest).group(1)
                return f"{name}<{','.join(re.findall(r'[0-9]+', targs))}>"
    return mangled


def ptxas_report(log: str) -> dict[str, dict]:
    """Each kernel's resources from nvcc's ``-Xptxas -v`` output (a
    library's ``build_log[name]["ptxas"]``), by ``kernel_name``:
    registers, stack, spill stores and loads in bytes, and the ptxas
    warnings given while it compiled (C7508 means ``setmaxnreg`` was
    ignored)."""
    out: dict[str, dict] = {}
    kernel = ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            kernel = kernel_name(m.group(1))
            out.setdefault(kernel, {"warnings": []})
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            out[kernel].update(zip(("stack", "spill_stores", "spill_loads"),
                                   map(int, m.groups())))
        elif m := re.search(r"Used (\d+) registers", line):
            out[kernel]["registers"] = int(m.group(1))
        elif "warning" in line:
            out.setdefault(kernel, {"warnings": []})["warnings"].append(
                line.strip())
    return out


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
