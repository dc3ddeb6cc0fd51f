"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``vcagan_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into ``vcagan_torch/_build/<name>-<hash>.so`` (the
hash covers the source, the shared headers ``csrc/*.cuh``, the flags and the
libraries it links, so an edited source or header builds anew).
Nothing is built when a module is imported.  A missing ``nvcc`` or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The toolkit libraries a kernel's library links beyond the CUDA runtime,
# found at run time where the toolkit keeps them (PyTorch has usually loaded
# the same ones already).
LIBRARIES = {"griffin_lim": ("cufft",)}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under the CUDA toolkit PyTorch finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def sources(name: str) -> list[str]:
    """The files a build of ``name`` reads: its source and every header of
    ``csrc`` (which the sources share)."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, f) for f in (f"{name}.cu", *headers)]


def link_flags(name: str, compiler: str) -> list[str]:
    """The linker's part of the command: each library of ``LIBRARIES`` and
    the toolkit's library directory as the run-time search path."""
    libs = LIBRARIES.get(name, ())
    if not libs:
        return []
    lib_dir = os.path.join(os.path.dirname(os.path.dirname(compiler)), "lib64")
    return [*(f"-l{lib}" for lib in libs), "-Xlinker", f"-rpath={lib_dir}"]


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join((*NVCC_FLAGS, *LIBRARIES.get(name, ()))).encode())
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """The compiler's log (ptxas register and spill report) of the build."""
    return library_path(name)[:-3] + ".log"


def build(names) -> None:
    """Build the libraries of ``names`` that are not built yet: one nvcc for
    each source, all started together; raises if any of them fails."""
    missing = [name for name in names if not os.path.exists(library_path(name))]
    if not missing:
        return
    compiler = nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    running, failed = [], []
    try:
        for name in missing:
            tmp = f"{library_path(name)}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [compiler, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu"),
                   *link_flags(name, compiler)]
            with open(log_path(name), "w") as log:
                proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            running.append((name, tmp, proc))
        for name, tmp, proc in running:
            rc = proc.wait()
            if rc == 0:
                os.replace(tmp, library_path(name))
            else:
                with open(log_path(name)) as f:
                    failed.append(f"nvcc failed for {name}.cu (exit {rc}):\n{f.read()}")
    finally:
        for _, _, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(library_path(name))
        return lib
