"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` (one
process per source, all started together), linked into one shared library
with a plain C interface, and loaded with ``ctypes``.  The library lands in
``kernels/_build/`` (listed in ``.gitignore``) under a name that hashes the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as is.  Nothing here runs at import time: the first CUDA launch
builds, and a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# C signatures: every pointer (and the stream) is a c_void_p, every int
# c_int, a 64-bit int c_longlong and a double c_double
SIGNATURES = {
    "actor_moe_forward": [_P] * 16 + [_I, _P],
    "screen_score_forward": [_P] * 10 + [_I, _I, _P],
    "sumtree_set_many": [_P, _P, _P, _D, _I, _L, _P],
    "sumtree_sample": [_P, _P, _P, _I, _L, _L, _P],
    "fused_mlp_forward": [_P] * 8 + [_I] * 6 + [_P],
    "flash_attention_forward": [_P] * 5 + [_I] * 6 + [_L] * 12
    + [_I, _I, _D, _I, _P],
    "flash_attention_backward": [_P] * 11 + [_I] * 8 + [_D, _I, _P],
    "ssm_scan_forward": [_P] * 9 + [_I] * 4 + [_P],
    "ssm_scan_backward": [_P] * 16 + [_I] * 5 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
last_build_log: str = ""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of repro_torch are built from source at first use")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(*, verbose: bool = False, force: bool = False,
          defines: Sequence[str] = ()) -> Path:
    """Compile the kernels into ``_build/`` and return the library path.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) and keeps the compiler output in :data:`last_build_log`.
    ``defines`` (``NAME=VALUE``) build a variant into a library of its own
    (``scripts/flash_attention_bq.py`` times two tile sizes that way)."""
    global last_build_log
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{_digest(flags)}.so"
    if lib_path.exists() and not force:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [exe, *flags, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== nvcc {src.name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            last_build_log = "\n".join(log)
            raise RuntimeError(f"nvcc failed for {failed}:\n{last_build_log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [exe, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        last_build_log = "\n".join(log)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{last_build_log}")
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builds agree
    return lib_path


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
