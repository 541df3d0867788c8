"""Builds the port's CUDA kernels and keeps their launch counts.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The libraries go to ``_build/`` beside
this file (listed in ``.gitignore``), named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused. All
sources are compiled at once, one ``nvcc`` process each. A failed build
raises with nvcc's stderr; nothing falls back to another path.

``LAUNCHES`` holds one plain integer per kernel of the main path: each
wrapper adds to it where it launches its kernel (the tile, SW and batched
bodies that run fused inside the megakernel are counted by the megakernel
itself, one per dispatch or fired batch, see ``device/megakernel.py``;
``"vector"`` counts the subtree engine's runs, inside the megakernel and
standalone; ``"fr_expand"`` / ``"fr_expand_batch"`` the frontier's
scalar and batched EXPAND bodies of the three families, ``"dg_expand"``
the same bodies run in a dynamic-graph table (clamped, spare-aware),
``"dg_splice"`` / ``"dg_splice_batch"`` the UPDATE bodies, ``"dg_query"``
the QUERY body, scalar and batched, ``"bnb_node"`` the knapsack NODE
body, scalar and batched, ``"tracebuf"`` the megakernel launches that
ran an observed instance: the flight recorder or the quiesce poll, and
``"stream"`` the entries of the streaming front door's kernel
(``csrc/stream.cuh``, in the megakernel library), whose body dispatches fold into the body counters
as the megakernel's do); the mesh kernels of ``csrc/mesh.cuh`` (in the
megakernel library): ``"mesh_round"`` the sharded runner's grid launches
(one a steal round), ``"ici_ring"`` and ``"resident_steal"`` the launches
of the ring and the resident steal kernels (one a run).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["LAUNCHES", "reset_launches", "build_all", "library", "lib_path",
           "check"]

CSRC = Path(__file__).with_name("csrc")
BUILD = Path(__file__).with_name("_build")
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# Kernel name -> launches (see module docstring).
LAUNCHES: Dict[str, int] = {
    "megakernel": 0, "potrf": 0, "trsmcol": 0, "updrow": 0, "trsm": 0,
    "uts": 0, "fib_batch": 0, "uts_node_batch": 0, "updrow_batch": 0,
    "sw_tile": 0, "sw_wave_batch": 0, "vector": 0, "sw_scores": 0,
    "add_tile": 0, "fa_stencil": 0, "fa_map": 0, "fa_stencil_batch": 0,
    "fa_map_batch": 0, "fr_expand": 0, "fr_expand_batch": 0, "bnb_node": 0,
    "dg_expand": 0, "dg_splice": 0, "dg_splice_batch": 0, "dg_query": 0,
    "tracebuf": 0, "stream": 0, "mesh_round": 0, "ici_ring": 0,
    "resident_steal": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "port's kernels are built on the machine with the card"
        )
    return found


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every ``csrc/*.cu`` that has no current library, all at
    once; returns {source name: seconds} (0.0 for one already built)."""
    BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    times: Dict[str, float] = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        out = lib_path(src.stem)
        if out.exists():
            times[src.stem] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp, out)
    errors = []
    for name, (p, tmp, out) in procs.items():
        _, err = p.communicate()
        times[name] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{err}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.hclib_error_string.restype = ctypes.c_char_p
        lib.hclib_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = lib.hclib_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
