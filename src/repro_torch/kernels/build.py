"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, on first use, into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  The library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and a current one reused.  Builds
land in ``build/kernels/`` at the repository root, which git ignores.
``ptxas``'s resource report of every kernel (registers, spill bytes,
static shared memory; ``-Xptxas -v``) is kept beside each library as
``lib<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_decode_attention", "paged_prefill_attention",
           "decode_attention", "flash_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def cuda_tool(name: str) -> str:
    """Path of the CUDA toolkit's ``name`` (nvcc, cuobjdump, ...)."""
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / name).exists():
        return str(home / "bin" / name)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: set CUDA_HOME or put it on "
                           f"PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (``-Xptxas -v``)."""
    return library_path(name).with_suffix(".log").read_text()


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> path."""
    nvcc = None
    procs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or cuda_tool("nvcc")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
