"""Build the port's CUDA kernels with ``nvcc`` and load them.

Two kinds of library, both for ``sm_90a``:

* Each source in :data:`SOURCES` has a plain C interface and is compiled
  on its own into a shared library loaded with ctypes::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so <name>.cu

* :data:`OPERATORS` — ``ops.cpp`` with the ``binstats``, ``histbin``,
  ``iqr`` and ``rolling`` kernels — is one library of PyTorch operators
  (``TORCH_LIBRARY``), loaded with ``torch.ops.load_library``: a call
  checks its arguments, allocates its outputs, takes the current stream
  and launches in C++.
  ``ops.cpp`` is the only file that includes PyTorch's headers, and
  ``nvcc`` hands it to the host compiler alone, with torch's include
  paths, its C++ ABI flag, and links to ``c10``, ``c10_cuda``,
  ``torch_cpu`` and ``torch_cuda`` with an rpath to them. The kernels'
  ``.cu`` files keep their C entry points, which the library also exports.

A library's name carries a hash of its sources and flags (and, for the
operators, of the torch version), so an edited source or a new torch is
rebuilt and a stale library is never loaded. Builds happen at first use
(or all at once through :func:`build_all`, one ``nvcc`` per library, all
started together) into ``build/torch_kernels/`` at the root of the
checkout, or into ``$REPRO_TORCH_BUILD_DIR`` when that is set. Nothing is
built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flashattn", "ssd")
OPERATORS = ("ops.cpp", "binstats.cu", "histbin.cu", "iqr.cu", "rolling.cu")
LIBRARIES = SOURCES + ("ops",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Any] = {}
_ops: List[Any] = []


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def inputs(name: str) -> List[Path]:
    """The source files of library ``name``."""
    if name == "ops":
        return [CSRC / f for f in OPERATORS]
    return [CSRC / f"{name}.cu"]


def _torch_flags() -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) of the operator library: torch's
    include paths and C++ ABI, and its libraries with an rpath."""
    import torch
    root = Path(torch.__file__).resolve().parent
    lib = str(root / "lib")
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    compile_flags = ["-I", str(root / "include"),
                     "-I", str(root / "include" / "torch" / "csrc" / "api"
                               / "include"),
                     f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
    link = ["-L", lib, "-lc10", "-lc10_cuda", "-ltorch_cpu", "-ltorch_cuda",
            "-Xlinker", "-rpath", "-Xlinker", lib]
    return compile_flags, link


def _flags(name: str) -> Tuple[List[str], List[str], str]:
    """(compile flags, link flags, what else the library's hash covers)."""
    if name != "ops":
        return list(NVCC_FLAGS), [], ""
    import torch
    compile_flags, link = _torch_flags()
    return list(NVCC_FLAGS) + compile_flags, link, torch.__version__


def lib_path(name: str) -> Path:
    flags, link, extra = _flags(name)
    h = hashlib.sha256()
    for path in inputs(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(flags + link + [extra]).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def command(name: str, out: Path) -> List[str]:
    """The ``nvcc`` command that builds library ``name`` into ``out``."""
    flags, link, _ = _flags(name)
    return [nvcc_path(), *flags, "-o", str(out),
            *(str(p) for p in inputs(name)), *link]


def build_all(names: Sequence[str] = LIBRARIES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per library, all in
    parallel. Returns ``{name: seconds}`` for the ones it compiled;
    raises with the compiler's output if any of them fails."""
    import time

    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = out_dir / f"{name}.{os.getpid()}.tmp.so"
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    seconds, errors = {}, []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (its C entry points), building it first
    if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def operators() -> Any:
    """``torch.ops.repro_torch``, the operators of :data:`OPERATORS`,
    built and registered at the first call."""
    if not _ops:
        import torch
        with _lock:
            if not _ops:
                build_all(["ops"])
                torch.ops.load_library(str(lib_path("ops")))
                _ops.append(torch.ops.repro_torch)
    return _ops[0]


def function(name: str, symbol: str, argtypes: Sequence[Any],
             restype: Any = ctypes.c_int) -> Any:
    """The typed C function ``symbol`` of library ``name``, built and
    loaded at the first call. Later calls are one dictionary lookup: no
    lock and no ``argtypes`` assignment on the launch path."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[(name, symbol)] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
