"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``kernels/<name>/csrc/*.cu`` is one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/`` at the repository root on first use.  The sources share
device code through the headers in ``include/`` (on the include path).
A library's file name carries a hash of its source, of every header and
of the flags, so an edited source or header is rebuilt and an unchanged
one is reused within a checkout.  Nothing is downloaded, and there is no
fallback: a missing ``nvcc`` or a failed compile raises.

    python -c "from repro_torch.kernels import build; build.build_all()"
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
INCLUDE_DIR = KERNELS_DIR / "include"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(INCLUDE_DIR))


def sources() -> List[Path]:
    """Every kernel source in the package, in a stable order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def headers() -> List[Path]:
    """Every shared header, in a stable order."""
    return sorted(INCLUDE_DIR.glob("*.cuh"))


def library_path(source: Path) -> Path:
    """Where ``source``'s library goes: the name hashes the source, every
    shared header (a source may include any of them) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in headers():
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source: Path):
    """Start one ``nvcc`` for ``source``; returns (target, tmp, process),
    with process None when the library is already built."""
    target = library_path(source)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def build_all(srcs=None) -> Dict[str, str]:
    """Compile every source that is not built yet, one ``nvcc`` each, all
    started together.  Returns ``{source name: compiler output}`` (the
    ``-Xptxas -v`` register and shared-memory report); raises on the
    first failed compile after every compiler has exited."""
    jobs = [(s, *_start(s)) for s in (sources() if srcs is None else srcs)]
    reports, failed = {}, []
    for source, target, tmp, proc in jobs:
        if proc is None:
            reports[source.name] = f"cached {target.name}"
            continue
        out, _ = proc.communicate()
        reports[source.name] = out
        if proc.returncode != 0:
            failed.append(f"{source}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(source: Path) -> ctypes.CDLL:
    """Load the library of one kernel source, building it first if
    needed.  Callers keep the result (``kernel.py`` caches it)."""
    source = Path(source)
    build_all([source])
    return ctypes.CDLL(str(library_path(source)))
