"""Builds the CUDA sources of ``repro_torch/csrc`` into one shared library.

The library is built at first use with ``nvcc`` (one compile per source,
all started together, then one link) into ``<checkout>/build/`` under a
directory keyed by a hash of the sources and flags, and loaded with
``ctypes``. Each kernel module binds its C entry point through
:func:`function`, which declares ``argtypes`` and ``restype``. Every
``nvcc`` compile counts as one build in :mod:`repro_torch.compat`.

The first build is guarded by a lock: serving workers are threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

from repro_torch import compat

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_functions: Dict[str, ctypes._CFuncPtr] = {}


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDACXX"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDACXX or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _build(out_dir: Path) -> Path:
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="kernels-", dir=BUILD_ROOT))
    srcs = sources()
    procs = []
    for src in srcs:
        obj = tmp / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs[src.name] = out
        if proc.returncode != 0:
            failed.append(src.name)
    compat.note_build(len(srcs))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    lib = tmp / LIB_NAME
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(lib),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (tmp / "nvcc.log").write_text(
        "\n".join(f"== {n}\n{log}" for n, log in logs.items()))
    try:
        tmp.rename(out_dir)
    except OSError:                  # another process finished first
        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / LIB_NAME


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / f"kernels-{source_hash()}"
            path = out_dir / LIB_NAME
            if not path.is_file():
                path = _build(out_dir)
            _lib, _lib_path = ctypes.CDLL(str(path)), path
        return _lib


def ptxas_log() -> str:
    """The ``nvcc -Xptxas -v`` output of the loaded library's build."""
    if _lib_path is None:
        return ""
    log = _lib_path.parent / "nvcc.log"
    return log.read_text() if log.is_file() else ""


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``name`` of the library with ``argtypes`` declared
    (``c_void_p`` for every pointer and the stream) and an ``int`` return
    holding the launch's CUDA error code."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def copy_probe(x):
    """Copy a contiguous fp32 CUDA tensor through ``csrc/probe.cu``: the
    toolchain probe (port of ``repro.compat.pallas_interpret_works``)."""
    import torch
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("copy_probe: needs a contiguous fp32 CUDA tensor")
    out = torch.empty_like(x)
    fn = function("repro_copy_probe_f32",
                  [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p])
    check("copy_probe", fn(x.data_ptr(), out.data_ptr(), x.numel(),
                           torch.cuda.current_stream(x.device).cuda_stream))
    return out
