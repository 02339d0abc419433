"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own ``.so`` under ``build/kernels/`` at the repo root (listed in
``.gitignore``), named by a hash of the source and the flags, then loaded
with ``ctypes``.  A rebuilt source gets a new name, so a stale library is
never loaded.  :func:`build_all` starts one ``nvcc`` per missing source,
all together, and waits for them; the compiler's ``-Xptxas -v`` report
(registers, spills) is kept beside each library as ``.log``.

Nothing here runs at import: only the first launch of a kernel on a CUDA
tensor builds and loads its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Every CUDA source of the port, by library name.
SOURCES = {"pointer_double": "pointer_double.cu",
           "segment_reduce": "segment_reduce.cu",
           "flash_attention": "flash_attention.cu",
           "graph_loop": "graph_loop.cu"}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Callable] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is missing."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives once built."""
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` each, all started together.  Returns name → library path;
    raises ``RuntimeError`` with the compiler output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)        # atomic: readers never see half a file
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all([name])[name]))
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> Callable:
    """The C entry point ``symbol`` of library ``name``, its ``argtypes``
    set and returning ``int`` (a ``cudaError_t``); built and loaded at
    first use."""
    with _lock:
        fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        with _lock:
            _fns[(name, symbol)] = fn
    return fn


def launch(kernel: str, fn: Callable, device: "torch.device", *args) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream; raises
    ``RuntimeError`` naming ``kernel`` if the launch returned a CUDA
    error."""
    import torch

    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{err}")
