"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The libraries go into ``pointnet2_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, its headers and the flags:
an edited source rebuilds, an unchanged one loads. Nothing is built at
import. The first launch of a kernel builds its own library; ``build_all()``
builds every source at once, one nvcc process each, all started together.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fps", "ball_query", "gather", "scatter", "three_nn", "fused_mlp")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists. Returns
    (target, tmp, process) with process None when nothing is to build."""
    target = _target(name)
    if target.is_file():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp: Path | None, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent build loads either


def _load(name: str, target: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(target))
    lib.pn2_strerror.argtypes = [ctypes.c_int]
    lib.pn2_strerror.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def build_all(names=SOURCES) -> None:
    """Build (in parallel) and load every named source not loaded yet."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = []
        try:
            for n in todo:
                started.append((n, *_start(n)))
            for n, target, tmp, proc in started:
                _finish(n, target, tmp, proc)
        finally:
            for _, _, _, proc in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n, target, _, _ in started:
            _load(n, target)


def ptxas_report(name: str) -> list[str]:
    """Registers, shared memory, stack frame and spills of each kernel of
    one source: the source compiled once more with ``-Xptxas -v`` into a
    scratch file, ptxas's lines back, one per kernel ("<kernel>: <usage>;
    <N bytes stack frame, N bytes spill stores, N bytes spill loads>")."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"ptxas-{name}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            [nvcc_path(), *FLAGS, "-Xptxas", "-v", "-o", str(tmp),
             str(CSRC / f"{name}.cu")], capture_output=True, text=True,
            check=True)
    finally:
        tmp.unlink(missing_ok=True)
    report, kernel, spills = [], None, ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            # the mangled name without its namespace and parameter list:
            # the kernel and its template arguments (I...E)
            m = re.search(r"_cu_[0-9a-f]+\d+(\w+?_kernel(I\w*?E)?)E",
                          line)
            kernel = m.group(1) if m else line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and kernel is not None:
            report.append(f"{kernel}: {line.split('Used', 1)[1].strip()}; "
                          f"{spills}")
    return report


def mma_counts(sass: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel of a
    ``cuobjdump -sass`` listing: {mangled kernel name: count}."""
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            counts[kernel] = 0
        elif kernel is not None and re.search(r"\bHG?MMA\b", line):
            counts[kernel] += 1
    return counts


def sass_mma_counts(name: str) -> dict:
    """:func:`mma_counts` of one built library's SASS (cuobjdump, beside
    nvcc)."""
    build_all((name,))
    tool = Path(nvcc_path()).with_name("cuobjdump")
    return mma_counts(subprocess.run(
        [str(tool), "-sass", str(_target(name))], capture_output=True,
        text=True, check=True).stdout)


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all((name,))
    return _libs[name]


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of library ``name``, typed: every pointer
    and the stream as c_void_p (an undeclared int would be cut to 32 bits),
    returning the launch's cudaError_t as int."""
    key = (name, symbol)
    fn = _funcs.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    if err != 0:
        msg = _libs[name].pn2_strerror(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
