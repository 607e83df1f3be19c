"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``reprover_tpu_torch/csrc/`` is compiled by its
own ``nvcc`` for Hopper (``sm_90a``), all of them at once, and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, into
``build/kernels/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the sources and the flags, so an edit
rebuilds and an unchanged tree reuses the library. Nothing is built when the
package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libreprover_torch_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class BuildInfo:
    """What the last :func:`load_library` call did (for logs and reports)."""

    seconds: float = 0.0
    built: bool = False
    path: str = ""
    log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of reprover_tpu_torch cannot be built"
    )


def _check(cmd: List[str], out: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.t5_attn_forward.argtypes = [vp] * 8 + [i] * 9 + [vp]
    lib.t5_attn_forward.restype = i
    lib.attn_bisect_forward.argtypes = [vp] * 7 + [i] * 6 + [vp]
    lib.attn_bisect_forward.restype = i
    for name in ("t5_attn_backward_dq", "t5_attn_backward_dkv"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 11 + [i] * 9 + [vp]
        fn.restype = i
    lib.beam_reorder_append.argtypes = [vp] * 9 + [i] * 7 + [vp]
    lib.beam_reorder_append.restype = i
    lib.quant_matmul_launch.argtypes = [i] + [vp] * 5 + [i] * 6 + [vp]
    lib.quant_matmul_launch.restype = i
    lib.kernel_error_string.argtypes = [i]
    lib.kernel_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC_DIR.glob("*.cu"))
        if not sources:
            raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in sorted(CSRC_DIR.glob("*.cu*")):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
        out_dir = BUILD_ROOT / digest.hexdigest()[:16]
        lib_path = out_dir / LIB_NAME
        t0 = time.perf_counter()
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            # Build under private names, then rename: processes that build
            # at the same time never load a half-written library.
            tag = f"{os.getpid()}.tmp"
            nvcc = _nvcc()
            objects = [out_dir / f".{src.stem}.{tag}.o" for src in sources]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objects)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for cmd in cmds]
            logs = [(cmd, proc.communicate()[0], proc.returncode)
                    for cmd, proc in zip(cmds, procs)]
            for cmd, out, rc in logs:
                _check(cmd, out, rc)
            tmp = out_dir / f".{LIB_NAME}.{tag}"
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            _check(link, proc.stdout, proc.returncode)
            os.replace(tmp, lib_path)
            for obj in objects:
                obj.unlink()
            BuildInfo.built = True
            BuildInfo.log = "".join(out for _, out, _ in logs)
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.path = str(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _declare(lib)
        _lib = lib
        return lib
