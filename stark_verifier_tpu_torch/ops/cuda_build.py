"""Builds the package's CUDA sources with `nvcc` and loads them with ctypes.

Each source under `ops/csrc/` has a plain C interface and includes no
PyTorch header, so a build takes seconds. The shared libraries go into
`build/` at the repository root (git-ignored), named after a hash of the
source and of the headers it includes from `csrc/`, so an edited source or
header is never served by a stale library. Everything
happens at first use, never at import: a machine without `nvcc` can import
the package and run it on CPU tensors.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>_<hash>.so ops/csrc/<name>.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# every hand-written CUDA source of the package, by library name
SOURCES = {"poseidon_gl": "poseidon_gl.cu",
           "poseidon_gl_mma": "poseidon_gl_mma.cu",
           "probes": "probes.cu",
           "poseidon_bn254": "poseidon_bn254.cu"}

# -Xptxas -v makes the compiler report each kernel's registers and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _with_headers(path: Path, seen=None) -> bytes:
    """The bytes of `path` followed by those of every header it includes
    with quotes (and that these include), each once."""
    seen = set() if seen is None else seen
    seen.add(path)
    text = path.read_bytes()
    for inc in _INCLUDE.findall(text):
        header = path.parent / inc.decode()
        if header not in seen:
            text += _with_headers(header, seen)
    return text


def _target(name: str) -> Path:
    src = _with_headers(CSRC / SOURCES[name])
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target, cmd)."""
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target, cmd


def build_all(names=None) -> dict[str, str]:
    """Build every missing library, one nvcc per source, all started
    together. Returns the compiler's output by name (empty when the
    library was already there). Raises if a build fails."""
    names = list(names or SOURCES)
    started = {n: _start(n) for n in names if not _target(n).exists()}
    logs = {n: "" for n in names}
    for n, (proc, tmp, target, cmd) in started.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {SOURCES[n]} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{out}")
        os.replace(tmp, target)  # atomic: a reader never sees half a file
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built first if it is not there yet."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
