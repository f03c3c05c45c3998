"""Build and load the hand-written kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/kernels/`` at the
repository root; each ``csrc/<name>.cpp`` (host code) likewise by the
host C++ compiler (``$CXX``, else ``c++``).  A library is named by a
hash of its source and flags (and, for host code, the compiler's
version), built on first use and loaded with ``ctypes``.  Building a
CUDA source needs ``nvcc`` (``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``
or ``PATH``); a missing compiler or a failed build raises.  No CUDA
source is built or loaded on the CPU path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# No -march=native: a build directory copied to another machine must
# not hold a library that its CPU cannot run.  -ffp-contract=off: each
# host source copies a library's float order to the bit (the JPEG 2000
# decoder's 9/7 path among them), so every float multiply and add is
# rounded on its own, never fused.
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall", "-ffp-contract=off"]

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # kernel name -> compiler output of its build


def nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def cxx() -> str:
    name = os.environ.get("CXX") or "c++"
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"host C++ compiler {name!r} not found: set CXX or put c++ on PATH")
    return path


@functools.lru_cache(maxsize=None)
def _compiler_version(path: str) -> bytes:
    """The compiler's ``--version`` output: a library built by another
    compiler (another C++ runtime) is another library."""
    return subprocess.run([path, "--version"], capture_output=True, check=True).stdout


def sources() -> List[str]:
    """The CUDA sources' names."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def host_sources() -> List[str]:
    """The host C++ sources' names."""
    return sorted(p.stem for p in CSRC.glob("*.cpp"))


def source(name: str) -> Path:
    """``csrc/<name>.cu`` or ``csrc/<name>.cpp``."""
    for suffix in (".cu", ".cpp"):
        path = CSRC / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _command(name: str) -> List[str]:
    """The compiler and flags for ``name``'s source, output and input
    left out."""
    if source(name).suffix == ".cu":
        return [nvcc(), *NVCC_FLAGS]
    return [cxx(), *CXX_FLAGS]


def _target(name: str, command: List[str]) -> Path:
    key = source(name).read_bytes() + " ".join(command[1:]).encode()
    if source(name).suffix == ".cpp":
        key += _compiler_version(command[0])
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: List[str] = None) -> Dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu`` and
    ``csrc/*.cpp``), one compiler process per source, all started
    together.  Sources whose library already exists are skipped.  A
    library is written under a temporary name and renamed into place,
    so processes that build at the same moment never load a partial
    file.  Raises on any failure."""
    names = sources() + host_sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    commands = {name: _command(name) for name in names}
    targets = {name: _target(name, commands[name]) for name in names}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [*commands[name], "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        build_logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: {Path(commands[name][0]).name} exited "
                          f"{proc.returncode}\n{build_logs[name]}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` or
    ``csrc/<name>.cpp``, built on first use."""
    with _lock:
        if name not in _libraries:
            _libraries[name] = ctypes.CDLL(str(build([name])[name]))
        return _libraries[name]
