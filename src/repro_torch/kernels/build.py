"""Build the package's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` file exports a plain C interface and compiles on its
own into ``build/lib<name>-<hash>.so`` beside this module (the directory is
git-ignored).  The hash covers the source, every ``csrc/*.cuh`` header (a
source may include one) and the flags, so an edited source or header never
loads a stale library.  A build happens at first use, on the machine
with the card: ``load(name)`` builds what is missing and returns the loaded
library.  ``build(names)`` starts one ``nvcc`` per missing source, all at
once, and waits for them, so the build time of several kernels is that of
the slowest.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every named source whose library is missing, all in parallel.

    Returns {name: nvcc output} for the sources it compiled (``-Xptxas -v``
    puts each kernel's registers, shared memory and spills there).  Raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of ``csrc/<name>.cu`` with its argument
    types declared (pointers and the stream as ``c_void_p``, so ctypes never
    cuts them to 32 bits) and an int return code."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, code: int) -> None:
    """Raise with the CUDA error string when a launch returned ``code`` != 0
    (``csrc/<name>.cu`` exports ``<name>_error_string``)."""
    if code == 0:
        return
    fn = getattr(load(name), f"{name}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{name} launch failed: {fn(code).decode()} ({code})")


def check_cuda_tensors(kernel: str, tensors: dict) -> None:
    """Every tensor on one CUDA device and contiguous, or raise: a kernel
    takes nothing else (``kernels.ops`` dispatches CPU tensors to the plain
    versions)."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, the kernel takes CUDA tensors "
                             "(kernels.ops dispatches by device)")
        if t.device != first.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the others on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
