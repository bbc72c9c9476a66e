"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch/<name>-<hash>/lib<name>.so``
at the repository root (listed in ``.gitignore``), keyed by a hash of the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is built at
import time: ``load`` builds on first use.

``LAUNCHES`` counts the launches of every kernel since the last
``reset_launches()``; each wrapper adds one where it launches its kernel
(``count``) and nowhere else. The count is process-wide; ranks that run
as threads of one process (a ``cc`` mesh on one card) each also read
their own thread's launches (``thread_launches``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}

#: launches of each CUDA kernel since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {
    "mvcc_resolve": 0, "mvcc_resolve_masked": 0, "mvcc_resolve_paged": 0,
    # which form each resolve launch took: the store read in place
    # (rows) or pre-gathered windows
    "mvcc_resolve/rows": 0, "mvcc_resolve/windows": 0,
    "mvcc_resolve_masked/rows": 0, "mvcc_resolve_masked/windows": 0,
    "mvcc_resolve_paged/rows": 0, "mvcc_resolve_paged/windows": 0,
    "decode_attention": 0, "flash_attention_causal": 0,
    # which of flash_attention_causal's three kernels each launch took
    "flash_attention_causal/wgmma": 0,
    "flash_attention_causal/tf32x3": 0,
    "flash_attention_causal/cuda_cores": 0,
    # flash_attention_causal's gradient: one a call, the call's route
    # (its three kernels on the tensor cores in bf16 or 3xTF32, or on the
    # CUDA cores), and each of the call's three kernels
    "flash_attention_causal_bwd": 0,
    "flash_attention_causal_bwd/wgmma": 0,
    "flash_attention_causal_bwd/tf32x3": 0,
    "flash_attention_causal_bwd/cuda_cores": 0,
    "flash_attention_causal_bwd/stats": 0,
    "flash_attention_causal_bwd/dkdv": 0,
    "flash_attention_causal_bwd/dq": 0}

#: a launch function's return at or above this is a failed TMA tensor-map
#: encoding (csrc/hopper.cuh's kEncodeError + the CUresult it returned)
ENCODE_ERROR = 100000


_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()


def count(*names: str) -> None:
    """Add one launch to each of ``names`` (a wrapper calls this where it
    launches its kernel), process-wide and for the calling thread."""
    with _COUNT_LOCK:
        mine = thread_launches()
        for name in names:
            LAUNCHES[name] += 1
            mine[name] = mine.get(name, 0) + 1


def thread_launches() -> Dict[str, int]:
    """The calling thread's launches since its start or its last
    ``reset_launches()``."""
    mine = getattr(_THREAD, "launches", None)
    if mine is None:
        mine = _THREAD.launches = {}
    return mine


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        thread_launches().clear()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then /usr/local/cuda, then
    ``PATH``. Raises when none exists."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / f"{name}-{key[:16]}" / f"lib{name}.so"


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns the library's path and nvcc's output (empty when reused);
    raises with the compiler's output if it fails."""
    path = lib_path(name)
    if path.exists():
        return path, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{output}")
    os.replace(tmp, path)              # atomic: concurrent builders
    return path, output


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)[0]))
    return lib


def call(name: str, fn_name: str, argtypes, args, device) -> None:
    """Call ``fn_name`` of ``csrc/<name>.cu``'s library with ``args`` then
    the current stream of ``device``: declares the C signature
    (``argtypes``, the stream pointer appended) on first use and raises
    when the function reports a launch error (a nonzero cudaError_t)."""
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"{fn_name}: TMA tensor-map encoding failed "
                           f"(CUresult {err - ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed "
                           f"(cudaError {err})")
