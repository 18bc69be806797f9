"""Build and load the package's CUDA kernels.

`csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface, `build/islands_tpu_torch/lib<name>-<hash>.so` under
the repository root, at its first use (the hash of the source names the file,
so an edited source builds anew). The library is loaded with `ctypes`, and
`entry` hands out each entry point typed once, at its first use. Nothing
here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "islands_tpu_torch"

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless it is built already. Returns the
    compiler's output (ptxas registers and shared memory per kernel), empty
    when nothing was built. Raises if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, building it if needed."""
    if name not in _libs:
        build(name)
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]


def entry(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """The C function `symbol` of the named kernel's library, loaded (and
    built) and given its argument and result types at the first call."""
    key = (name, symbol)
    if key not in _entries:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = argtypes, restype
        _entries[key] = fn
    return _entries[key]


def check(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")
