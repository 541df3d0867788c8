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
(``csrc/stream.cuh``, in the megakernel library), whose body dispatches
fold into the body counters as the megakernel's do); the mesh kernels
of ``csrc/mesh.cuh`` (in the megakernel library): ``"mesh_round"`` the
sharded runner's grid launches (one a steal round), ``"ici_ring"`` and
``"resident_steal"`` the launches of the ring and the resident kernel's
steal-only configuration (one a run), ``"resident_pgas"`` its PGAS
configurations (channels, with or without steal), ``"resident_homed"``
its migrating configuration (homed copies with their completions, value
args), ``"resident_inject"`` its injecting instances (the injection ring
and mesh tenancy, any configuration), ``"resident_fault"`` its instances
with the fault layer (a ``DeviceFaultPlan``: dropped, duplicated and
delayed steal credits, a dead device; any steal configuration),
``"resident_obs"`` and ``"ici_ring_obs"`` the observed instances of the
resident kernel and the ring (the flight recorder, and the resident
kernel's quiesce word; any configuration, faults and injection included);
``"pgas_ring"`` the launches of
PGASMegakernel's ring kernel (``pgas_ring_kernel``, a mesh whose size is
not a power of two; in a user library's PGAS variant, observed or not);
``"mk_user"`` the launches of a
user-body library's scheduler (``csrc/user.cuh`` ``mk_user_kernel``: a
user table on one device, or a grid launch of the sharded runner). A
user table's launches of the ring and the resident kernel count as
those kernels'.

A table with user-defined bodies (``Megakernel(kernels=[(name, fn,
cuda)])``) builds its own small library from a generated source,
``user_library``: ``csrc/user.cuh`` and the bodies' CUDA statements,
keyed by a hash of that text and of the headers it includes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

__all__ = ["LAUNCHES", "reset_launches", "build_all", "library", "lib_path",
           "check", "user_library", "user_lib_path", "user_key"]

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
    "resident_steal": 0, "resident_pgas": 0, "resident_homed": 0,
    "resident_inject": 0, "resident_fault": 0, "resident_obs": 0,
    "ici_ring_obs": 0, "mk_user": 0, "pgas_ring": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_USER_LIBS: Dict[str, ctypes.CDLL] = {}  # generated source -> its library


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


# The headers a user-body library includes (csrc/user.cuh and what it
# includes): part of its key.
USER_HEADERS = ("layout.cuh", "sched.cuh", "mesh.cuh", "user.cuh")


def user_key(source: str) -> str:
    """The key of a user-body library: a hash of the flags, its generated
    source (the user bodies' text) and the headers it includes."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(source.encode())
    for name in USER_HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def user_lib_path(source: str) -> Path:
    """Where the user-body library of generated ``source`` is built."""
    return BUILD / f"libuser-{user_key(source)}.so"


def _compile(jobs) -> Dict[str, float]:
    """Run nvcc on every (name, source, library) job at once, one process
    each; {name: seconds from the start to the end of its own process}.
    Raises with nvcc's stderr if any fails."""
    nvcc = _nvcc()
    BUILD.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, src, out in jobs:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        # stderr to a file: a pipe nobody drains while polling could fill.
        err = tempfile.TemporaryFile(mode="w+")
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=err, text=True
        ), err, tmp, out)
    times, errors = {}, []
    while len(times) < len(procs):
        for name, (p, err, tmp, out) in procs.items():
            if name in times or p.poll() is None:
                continue
            times[name] = time.perf_counter() - t0
            if p.returncode != 0:
                err.seek(0)
                errors.append(f"nvcc failed on {name}.cu:\n{err.read()}")
            else:
                os.replace(tmp, out)
            err.close()
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def _user_job(source: str):
    """The build job of a user-body library: its source written under
    _build/, and its library path."""
    key = "user-" + user_key(source)
    BUILD.mkdir(exist_ok=True)
    cu = BUILD / f"{key}.cu"
    cu.write_text(source)
    return key, cu, user_lib_path(source)


def build_all(user_sources=()) -> Dict[str, float]:
    """Compile every ``csrc/*.cu``, and the user-body library of each
    generated source in ``user_sources``, that has no current library,
    all at once (one nvcc each); returns {name: seconds} (0.0 for one
    already built; ``user-<key>`` for a user library). A failed build
    raises with nvcc's stderr."""
    jobs = [(src.stem, src, lib_path(src.stem))
            for src in sorted(CSRC.glob("*.cu"))]
    jobs += [_user_job(src) for src in user_sources]
    todo = {name: job for name, *job in jobs if not job[1].exists()}
    times = {name: 0.0 for name, *_ in jobs}
    times.update(_compile([(n, *j) for n, j in todo.items()]))
    return times


def user_library(source: str) -> ctypes.CDLL:
    """The loaded user-body library of generated ``source`` (built on
    first use, by itself: megakernel.cu's library is not rebuilt). Found
    by its source text once loaded: its key reads and hashes the headers,
    ~1 ms that a fresh table's first launch would otherwise pay inside
    its timed window."""
    lib = _USER_LIBS.get(source)
    if lib is not None:
        return lib
    key = "user-" + user_key(source)
    lib = _LIBS.get(key)
    if lib is None:
        path = user_lib_path(source)
        if not path.exists():
            _compile([_user_job(source)])
        lib = ctypes.CDLL(str(path))
        lib.hclib_error_string.restype = ctypes.c_char_p
        lib.hclib_error_string.argtypes = [ctypes.c_int]
        _LIBS[key] = lib
    _USER_LIBS[source] = lib
    return lib


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
