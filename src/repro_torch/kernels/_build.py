"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/lib<name>-<hash>.so``
at first use, where the hash covers the file's source and the compiler
flags, so an edited source is rebuilt and an unchanged one is reused. All
missing libraries are compiled at once, one nvcc process per source, in
parallel. The sources have a plain C interface (no PyTorch headers), which
keeps a build to seconds.

Only the CUDA branch of a kernel wrapper imports this module: importing the
package, or running it on the CPU, never needs a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/src/repro_torch/kernels/_build.py -> <repo>/build/repro_torch_kernels
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}   # name -> nvcc wall time this process


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME); the "
                           "CUDA kernels are built from source at first use")
    return found


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _lib_path(name: str, src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for inc in sorted(CSRC.glob("*.cuh")):
        h.update(inc.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every missing library in parallel; return name -> path.

    The compiler's ptxas report (registers, shared memory, spills) is kept
    beside each library as ``<lib>.ptxas.txt``. A failed build raises with
    the compiler's output.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name, src) for name, src in sources().items()}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failures = []
    for name, (proc, tmp, path, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name} (exit {proc.returncode})\n{out}")
            continue
        path.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, path)      # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("repro_torch: nvcc failed\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no CUDA source csrc/{name}.cu")
            _LIBS[name] = ctypes.CDLL(str(paths[name]))
        return _LIBS[name]
