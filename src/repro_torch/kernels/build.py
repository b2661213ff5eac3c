"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface.  Libraries go to ``_build/``
beside this package (listed in ``.gitignore``), named by a digest of
the source, the ``csrc/`` headers it includes and the flags, so an
edited source or header rebuilds.  Building happens at
first use, never at import; ``build`` starts one ``nvcc`` per source,
all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNELS = ("decode_attention", "prefill_attention", "mamba_scan",
           "prefill_attention_bwd", "mamba_scan_bwd", "slstm_scan",
           "slstm_scan_bwd", "mlstm_scan", "mlstm_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _sources(name: str) -> bytes:
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes
    (``#include "..."``, also from a header), in a fixed order."""
    seen, todo, out = set(), [f"{name}.cu"], []
    while todo:
        path = CSRC_DIR / todo.pop(0)
        if path.name in seen:
            continue
        seen.add(path.name)
        text = path.read_bytes()
        out.append(text)
        todo += re.findall(r'^#include "([^"]+)"', text.decode(), re.M)
    return b"".join(out)


def library_path(name: str) -> Path:
    digest = hashlib.sha256(_sources(name)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named source not yet built, all nvcc processes
    started together.  Returns name -> compiler log (ptxas register and
    shared-memory report); raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    logs: Dict[str, str] = {}
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        log.write_text(text)
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load_all(names: Iterable[str] = KERNELS) -> None:
    """Build every named source (one ``nvcc`` each, all at once) and load
    it, so that no caller's first launch pays the build: the gateway
    does this before its replicas' driver threads start."""
    names = tuple(names)
    build(names)
    for name in names:
        load(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
