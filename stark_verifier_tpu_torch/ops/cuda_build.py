"""Builds the package's CUDA sources with `nvcc` and loads them with ctypes.

Each source under `ops/csrc/` has a plain C interface and includes no
PyTorch header, so a build takes seconds. The shared libraries go into
`build/` at the repository root (git-ignored), named after a hash of the
source and of the headers it includes from `csrc/`, so an edited source or
header is never served by a stale library; the compiler's output (with
`-Xptxas -v`, each kernel's registers and spills) is kept beside it. Everything
happens at first use, never at import: a machine without `nvcc` can import
the package and run it on CPU tensors.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v [SOURCE_FLAGS] \
         -o build/lib<name>_<hash>.so ops/csrc/<name>.cu
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
           "poseidon_bn254": "poseidon_bn254.cu",
           "witness": "witness.cu",
           "field": "field.cu",
           "ntt": "ntt.cu"}

# -Xptxas -v makes the compiler report each kernel's registers and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source, after NVCC_FLAGS. The bridge: at its default level
# ptxas schedules independent products side by side and spills at the
# 128-register cap; at -O1 it keeps their order and spills nothing, for a
# few per cent of time (csrc/poseidon_bn254.cu says more).
SOURCE_FLAGS = {"poseidon_bn254": ["-Xptxas", "-O1"]}

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
    tag = hashlib.sha1(src + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _flags(name: str) -> list:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target, cmd)."""
    target = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
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
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)  # atomic: a reader never sees half a file
    return logs


def ptxas_report(name: str) -> dict:
    """Registers and spill bytes of every kernel in the library `name`, by
    the kernel's identifier (template arguments kept in the mangled name's
    tail), from the `-Xptxas -v` output saved beside the library when it
    was built: {identifier: [{"function", "registers", "spill_stores",
    "spill_loads"}, ...]}."""
    log = _target(name).with_suffix(".log").read_text()
    report, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = {"function": m.group(1)}
            ident = re.match(r"_Z(\d+)", current["function"])
            key = (current["function"][len(ident.group(0)):][:int(ident.group(1))]
                   if ident else current["function"])
            report.setdefault(key, []).append(current)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current["spill_stores"], current["spill_loads"] = map(int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
            current = None
    return report


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built first if it is not there yet."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


# libraries whose C signatures are bound; devices each library's tables are on
_bound: set = set()
_served: dict[str, set] = {}


def library_on(name: str, device, bind, upload) -> ctypes.CDLL:
    """The library `name` for a launch on the CUDA device `device`: loaded
    and bound (`bind(lib)`) once a process, its tables uploaded
    (`upload(lib)`) once for each device, inside `torch.cuda.device(device)`
    and before that device's first launch. A library's `__device__` and
    `__constant__` tables are symbols of each device, which
    `cudaMemcpyToSymbol` sets on the current one only."""
    import torch

    lib = load(name)
    if name not in _bound:
        bind(lib)
        _bound.add(name)
    index = device.index if device.index is not None else torch.cuda.current_device()
    served = _served.setdefault(name, set())
    if index not in served:
        with torch.cuda.device(index):
            upload(lib)
        served.add(index)
    return lib
