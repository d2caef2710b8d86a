"""Build the port's CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` (plain C entry points, no PyTorch
headers) for ``sm_90a``, one compiler process per source and all started
together, and links the objects into one shared library, loaded with
``ctypes``. A build takes seconds. The library is cached under
``kmer_hasher_tpu_torch/build/`` by a hash of the sources and flags, so a
changed source or flag rebuilds and an unchanged one loads at once.

``--fmad=false``: B2's f32 error lanes are held bitwise against a plain
version whose every product and sum is rounded on its own, so nvcc must
not contract a multiply and an add into one fused operation.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"kmh_kernels-{h.hexdigest()[:16]}.so"


def find_nvcc() -> Path:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then $PATH, then the toolkit
    PyTorch itself found. Raises if there is none."""
    cands = [os.environ.get(v) for v in ("CUDA_HOME", "CUDA_PATH")]
    paths = [Path(c) / "bin" / "nvcc" for c in cands if c]
    on_path = shutil.which("nvcc")
    if on_path:
        paths.append(Path(on_path))
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        paths.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for p in paths:
        if p.is_file():
            return p
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "kmer_hasher_tpu_torch cannot be built")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Returns its path; the compiler's report is beside it as ``.log``."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(find_nvcc())
    tag = f"{out.stem}.{os.getpid()}"
    cus = [s for s in sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cus]
    tmp = out.with_name(f"{tag}.tmp.so")
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(cus, objs)]
    log = ""
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        failed = None
        for c, p in zip(cmds, procs):  # every process is waited for
            text, _ = p.communicate()
            log += f"$ {' '.join(c)}\n{text}"
            if p.returncode != 0 and failed is None:
                failed = p.returncode
        if failed is None:
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            res = subprocess.run(link, capture_output=True, text=True)
            log += f"$ {' '.join(link)}\n{res.stdout}{res.stderr}"
            failed = res.returncode or None
        if failed is not None:
            raise RuntimeError(f"nvcc failed (exit {failed}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def build_log() -> str:
    """nvcc's report (``-Xptxas -v``: registers, shared memory, spills) of
    the build of the current sources, or '' before the first build."""
    p = library_path().with_suffix(".log")
    return p.read_text() if p.is_file() else ""


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.kmh_error_string.argtypes = [ctypes.c_int]
            lib.kmh_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a nonzero CUDA error."""
    if err:
        msg = lib.kmh_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
