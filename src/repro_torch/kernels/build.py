"""Build and load the hand-written CUDA kernels; count their launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. A build
happens at first use (or all at once, in parallel, through
:func:`build_all`) into ``kernels/_build/``, which git ignores; the
library's file name carries a hash of its sources and flags, so an
edited source rebuilds. Nothing here runs at import time: importing the
package needs neither ``nvcc`` nor a GPU.

``LAUNCHES`` counts, per kernel, the launches its wrapper made — the
count a run reads to show that its main path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("segment_window_agg", "segment_bin_agg", "segment_bin_agg_edges",
           "segment_window_bin_agg", "window_agg")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: "collections.Counter[str]" = collections.Counter()
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together. Returns ``{name: {"seconds", "log"}}`` for the
    libraries built by this call (``-Xptxas -v`` register/shared-memory
    report in ``log``). Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    report = {}
    failed = []
    for name, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The launch function ``fn`` of library ``name`` (built on first
    use), with its ``argtypes`` set and an ``int`` error-code result."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        lib.agg_error_string.argtypes = [ctypes.c_int]
        lib.agg_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(name: str, code: int) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if code != 0:
        msg = _LIBS[name].agg_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} "
                           f"({msg})")
