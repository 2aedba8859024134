"""Build and load the port's CUDA sources: ``nvcc`` → ``build/*.so`` → ``ctypes``.

Every kernel of the port has a plain C interface and is compiled by ``nvcc``
into a shared library, loaded with ``ctypes``.  A library is named by a hash
of its source, the shared headers of ``kernels/csrc/`` and the flags, so a
changed source is rebuilt and an unchanged one is loaded as is.  Sources may
be files of the checkout (``lstm_seq.cu``, ``tanh_lut.cu``) or text emitted at
run time (the generated stage kernels); emitted text is written beside its
library under ``build/`` (git-ignored).  Nothing is built or loaded when a
module is imported: the first call on the card builds.  The compiler's
output (with ``-Xptxas -v``: registers, shared memory and spills per kernel)
is kept beside each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}")

# int32 words of GridBarrier (csrc/grid_barrier.cuh), allocated by the wrappers
GRID_BARRIER_WORDS = 4

# Calls of a persistent kernel (lstm_seq, the generated stages), each of
# which waits for its stream on the host to read the grid barrier's error
# word: one host round-trip each, which the server reports as kernel_syncs.
# Counted per thread, so that servers driven on separate threads (one
# AsyncServer each) count only their own calls.
_syncs = threading.local()


def count_host_sync() -> None:
    """One host round-trip inside a kernel call, on the calling thread."""
    _syncs.n = getattr(_syncs, "n", 0) + 1


def host_syncs() -> int:
    """Host round-trips counted on the calling thread so far."""
    return getattr(_syncs, "n", 0)


_loaded: dict[Path, ctypes.CDLL] = {}
_by_text: dict[tuple[str, str], ctypes.CDLL] = {}   # emitted sources, by name and text
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if path is None and os.path.exists(toolkit):
        path = toolkit
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def build(name: str, source: str | Path) -> Path:
    """Compile ``source`` (a path, or emitted text) unless its library is
    already built; returns the library's path.  Raises with the compiler's
    errors if ``nvcc`` fails."""
    text = Path(source).read_text() if isinstance(source, Path) else source
    tag = hashlib.sha256(text.encode())
    for header in sorted(CSRC.glob("*.cuh")):
        tag.update(header.read_bytes())
    tag.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{tag.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if isinstance(source, Path):
        cu = source
    else:
        cu = out.with_suffix(".cu")
        cu.write_text(source)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(cu)],
                          capture_output=True, text=True, timeout=600)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {cu}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_many(items: list[tuple[str, str | Path]], workers: int | None = None) -> list[Path]:
    """Build several ``(name, source)`` libraries at once, one ``nvcc`` each,
    all started together; returns their paths in order."""
    workers = workers or max(1, min(len(items), os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda item: build(*item), items))


def load(name: str, source: str | Path) -> ctypes.CDLL:
    """Build (if needed) and load a library once per process.  An emitted
    source is looked up by its text first, so a call on the hot path (the
    generated stage kernels) neither hashes nor touches the file system."""
    key = (name, source) if isinstance(source, str) else None
    lib = _by_text.get(key) if key else None
    if lib is not None:
        return lib
    path = build(name, source)
    with _lock:
        lib = _loaded.get(path)
        if lib is None:
            lib = _loaded[path] = ctypes.CDLL(str(path))
        if key:
            _by_text[key] = lib
    return lib


__all__ = ["BUILD_DIR", "CSRC", "GRID_BARRIER_WORDS", "NVCC_FLAGS", "build", "build_many",
           "count_host_sync", "host_syncs", "load"]
