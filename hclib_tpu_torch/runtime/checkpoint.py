"""Checkpoint/restore of the megakernel, its stream and its resident
mesh: versioned bundles of quiesced scheduler state and a crash-safe
store of them.

Port of ``hclib_tpu/runtime/checkpoint.py``, with its on-disk format
unchanged, so a bundle written by either package loads in the other:

- **Quiesce** (``Megakernel(checkpoint=True)``, device/megakernel.py):
  the scheduler polls the quiesce word every ``quiesce_stride`` rounds
  and stops popping at a round boundary; lanes spill to the ready ring
  and prefetches drain, and the run returns ``info['state']``, numpy
  copies of the live task table, ready ring, counters, value slots and
  data buffers.
- **Bundle** (``CheckpointBundle``): that state plus the kernel table's
  description, as a directory holding ``state.npz`` (the arrays; data
  buffers as ``data/<name>``, bf16 buffers as their 16-bit patterns with
  the true dtype in ``meta['dtypes']``) and ``manifest.json`` (magic,
  version, kind, meta, sha256 of the npz), integrity-checked on load.
- **Restore** (``restore_megakernel``): validate the manifest against a
  freshly built megakernel of the same table and relaunch mid-graph
  (``Megakernel.resume``: all value slots staged, the free stack rebuilt
  from the tombstones), so quiesce at round k + restore + run to the end
  equals the uninterrupted run bit for bit.
- **Durable store** (``BundleStore``): generations published by staging,
  fsync, atomic rename and a ``CURRENT`` pointer written last, ``keep``
  retention, and a newest-first ``load_latest`` that quarantines a
  generation that does not validate and falls back to the next.

- **Streams** (``snapshot_stream`` / ``restore_stream``): a quiesced
  ``StreamingMegakernel.run_stream`` (device/inject.py) bundles with its
  ring residue, the per-tenant ``tctl`` / ``tstats`` blocks, the egress
  token table and the telemetry blocks; ``checkpoint_on_preempt`` binds
  a running stream's quiesce to process preemption.

- **Resident meshes** (``snapshot_resident`` / ``restore_resident``):
  a quiesced ``ResidentKernel.run`` (device/resident.py) bundles with its
  wait table, ring residue and tenant blocks; ``restore_resident``
  checks the kernel table and the tenant roster and re-homes the queues
  through ``CheckpointBundle.reshard`` when the mesh size differs (only
  ready link-free rows move; wait-parked rows move with their waits).

Left out, each raising ``NotImplementedError`` naming its ROADMAP item:
a dynamic-graph bundle's reshard (``reshard_dyngraph``, A11c) and
``metrics=`` (no metrics registry in the port yet, A13).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..device import tracebuf as tb
from ..device.descriptor import (
    DESC_WORDS,
    F_CSR_N,
    F_DEP,
    F_FN,
    F_HOME,
    F_OUT,
    F_SUCC0,
    F_SUCC1,
    NO_TASK,
)
from . import env as _env
from . import resilience

__all__ = [
    "MAGIC",
    "BUNDLE_VERSION",
    "BundleFault",
    "BundleStore",
    "CheckpointBundle",
    "CheckpointError",
    "default_store",
    "snapshot_megakernel",
    "snapshot_stream",
    "snapshot_resident",
    "restore_megakernel",
    "restore_stream",
    "restore_resident",
    "checkpoint_on_preempt",
]

MAGIC = "hclib-tpu-checkpoint"
BUNDLE_VERSION = 1

# State keys every bundle holds (data buffers ride as ``data/<name>``),
# and the optional ones of the stream and resident kinds, carried through
# unchanged when a bundle of the JAX package holds them.
_STATE_KEYS = ("tasks", "succ", "ready", "counts", "ivalues")
_OPT_KEYS = (
    "ring_rows", "waits", "ictl", "tctl", "tstats", "etok",
    "tele", "tlat",
)


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def _no_metrics(metrics) -> None:
    if metrics is not None:
        raise _later("metrics= (a MetricsRegistry of the port)", "A13")


class CheckpointError(RuntimeError):
    """A bundle failed validation: corrupt artifact, version mismatch, or
    a restore target whose configuration contradicts the manifest."""


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss
    (best-effort: some filesystems refuse O_RDONLY directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _dtype_name(dt) -> str:
    """A data spec's dtype as numpy names it (``float32``, ``bfloat16``),
    for a torch or a numpy dtype."""
    name = str(dt)
    return name[len("torch."):] if name.startswith("torch.") else str(
        np.dtype(dt))


def _kernel_meta(mk) -> Dict[str, Any]:
    m = {
        "kernel_names": list(mk.kernel_names),
        "capacity": int(mk.capacity),
        "num_values": int(mk.num_values),
        "succ_capacity": int(mk.succ_capacity),
        "data_specs": {
            k: {"shape": [int(x) for x in shape], "dtype": _dtype_name(dt)}
            for k, (shape, dt) in mk.data_specs.items()
        },
    }
    # A dynamic-graph build stamps its layout (plain ints and the bound
    # update stream) into the manifest, as JAX's does.
    dg = getattr(mk, "_dyngraph", None)
    if dg is not None:
        m["dyngraph"] = {
            k: (list(map(list, v)) if k == "updates" else v)
            for k, v in dg.items()
        }
    return m


def _kernel_table_diff(mine: List[str], theirs: List[str]) -> str:
    """Positional diff of two kernel tables: F_FN words index by
    position, so the per-position story is what fixes a mismatch."""
    lines = []
    for i in range(max(len(mine), len(theirs))):
        a = mine[i] if i < len(mine) else "<absent>"
        b = theirs[i] if i < len(theirs) else "<absent>"
        if a != b:
            lines.append(f"[{i}] {a!r} here != {b!r} in the bundle")
    return "; ".join(lines)


def _where(bundle_or_meta) -> str:
    """Location context for a diagnostic: the bundle's source path and
    store generation when it came off disk, empty for in-memory ones."""
    src = getattr(bundle_or_meta, "source_path", None)
    gen = getattr(bundle_or_meta, "generation", None)
    if src is None and gen is None:
        return ""
    parts = []
    if src is not None:
        parts.append(str(src))
    if gen is not None:
        parts.append(f"generation {gen}")
    return f" ({', '.join(parts)})"


def _check_kernel_meta(mk, meta: Dict[str, Any], where: str = "") -> None:
    """The restore target must be the same program shape the bundle was
    taken from: a renamed or reordered table would run the wrong
    bodies."""
    mine = _kernel_meta(mk)
    if mine["kernel_names"] != meta.get("kernel_names"):
        detail = _kernel_table_diff(
            list(mine["kernel_names"]),
            list(meta.get("kernel_names") or []),
        )
        raise CheckpointError(
            f"restore target mismatch{where}: the kernel_names table "
            f"differs positionally - {detail} - rebuild the megakernel "
            "exactly as checkpointed (names, order, capacities)"
        )
    for key in ("capacity", "num_values", "succ_capacity"):
        if mine[key] != meta.get(key):
            raise CheckpointError(
                f"restore target mismatch{where}: {key} is {mine[key]!r} "
                f"here but {meta.get(key)!r} in the bundle - rebuild the "
                "megakernel exactly as checkpointed (names, order, "
                "capacities)"
            )
    if set(mine["data_specs"]) != set(meta.get("data_specs", {})):
        raise CheckpointError(
            f"restore target mismatch{where}: data buffers "
            f"{sorted(mine['data_specs'])} != bundle "
            f"{sorted(meta.get('data_specs', {}))}"
        )


class CheckpointBundle:
    """One checkpoint: ``kind`` (this port writes "megakernel"), ``meta``
    (the JSON manifest body) and ``arrays`` (flat name -> np.ndarray;
    data buffers under ``data/<name>``)."""

    def __init__(self, kind: str, meta: Dict[str, Any],
                 arrays: Dict[str, np.ndarray]) -> None:
        self.kind = kind
        self.meta = meta
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        # Provenance, set by load() / BundleStore, named by diagnostics.
        self.source_path: Optional[str] = None
        self.generation: Optional[int] = None

    # ---- state <-> arrays ----

    @staticmethod
    def _flatten_state(state: Dict[str, Any], meta: Dict[str, Any],
                       bf16=()) -> Dict[str, np.ndarray]:
        """Flatten a state dict into named arrays. bf16 buffers (the
        names in ``bf16``, which the port carries as their uint16 bit
        patterns, or ml_dtypes arrays) are stored as uint16 with the true
        dtype in ``meta['dtypes']``, the JAX package's encoding."""
        arrays = {k: np.asarray(state[k]) for k in _STATE_KEYS}
        for k in _OPT_KEYS:
            if k in state:
                arrays[k] = np.asarray(state[k])
        for name, buf in (state.get("data") or {}).items():
            arrays[f"data/{name}"] = np.asarray(buf)
        dtypes: Dict[str, str] = {}
        for k, v in arrays.items():
            if v.dtype.kind not in "biufc":
                dtypes[k] = str(v.dtype)
                arrays[k] = v.view(f"u{v.dtype.itemsize}")
            elif k in bf16:
                dtypes[k] = "bfloat16"
                arrays[k] = v.view(np.uint16)
        if dtypes:
            meta["dtypes"] = dtypes
        return arrays

    def _restore_dtype(self, key: str, arr: np.ndarray) -> np.ndarray:
        name = (self.meta.get("dtypes") or {}).get(key)
        if name is None or name == "bfloat16":
            # bf16 stays the uint16 pattern: state.tensor_of turns it
            # into a bf16 tensor bit for bit.
            return arr.copy()
        return arr.view(np.dtype(name)).copy()

    def state(self) -> Dict[str, Any]:
        """The resumable state dict (what ``Megakernel.resume`` takes)."""
        st: Dict[str, Any] = {
            k: self._restore_dtype(k, self.arrays[k]) for k in _STATE_KEYS
        }
        for k in _OPT_KEYS:
            if k in self.arrays:
                st[k] = self.arrays[k].copy()
        st["data"] = {
            k.split("/", 1)[1]: self._restore_dtype(k, v)
            for k, v in self.arrays.items()
            if k.startswith("data/")
        }
        return st

    # ---- persistence ----

    def save(self, path: str, metrics=None, fsync: bool = False,
             fault_plan=None) -> Dict[str, Any]:
        """Write the bundle as a directory: ``state.npz`` +
        ``manifest.json``. Returns {bundle_bytes, save_s, sha256}.
        ``fsync=True`` flushes both members and the directory (the
        BundleStore publish discipline); ``fault_plan`` (any object with
        ``on_bundle_blob`` / ``on_manifest_text``, as the JAX package's
        FaultPlan) routes the bytes through its disk fault sites."""
        _no_metrics(metrics)
        t0 = time.monotonic()
        os.makedirs(path, exist_ok=True)
        buf = io.BytesIO()
        np.savez(buf, **self.arrays)
        blob = buf.getvalue()
        sha = hashlib.sha256(blob).hexdigest()
        if fault_plan is not None:
            blob = fault_plan.on_bundle_blob(blob)
        with open(os.path.join(path, "state.npz"), "wb") as f:
            f.write(blob)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        manifest = {
            "magic": MAGIC,
            "version": BUNDLE_VERSION,
            "kind": self.kind,
            "created_unix": time.time(),
            "sha256": sha,
            "meta": self.meta,
        }
        text = json.dumps(manifest, indent=1, sort_keys=True)
        if fault_plan is not None:
            text = fault_plan.on_manifest_text(text)
        if text is not None:  # a fault plan may drop the manifest
            with open(os.path.join(path, "manifest.json"), "w") as f:
                f.write(text)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
        if fsync:
            _fsync_dir(path)
        return {
            "bundle_bytes": len(blob),
            "save_s": round(time.monotonic() - t0, 6),
            "sha256": sha,
        }

    @classmethod
    def load(cls, path: str,
             generation: Optional[int] = None) -> "CheckpointBundle":
        """Load and integrity-check a saved bundle. Raises CheckpointError
        on a missing or foreign manifest, another version, or an npz
        whose sha256 disagrees with the manifest; every error names the
        file (and ``generation`` when given)."""
        gen = "" if generation is None else f" (generation {generation})"
        man_path = os.path.join(path, "manifest.json")
        npz_path = os.path.join(path, "state.npz")
        try:
            with open(man_path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"unreadable checkpoint manifest {man_path}{gen}: {e}"
            )
        if manifest.get("magic") != MAGIC:
            raise CheckpointError(
                f"{man_path}{gen} is not a {MAGIC} bundle "
                f"(magic={manifest.get('magic')!r})"
            )
        try:
            version = int(manifest.get("version", -1))
        except (TypeError, ValueError):
            version = -1  # a mangled field is a corrupt manifest
        if version != BUNDLE_VERSION:
            raise CheckpointError(
                f"bundle version {manifest.get('version')!r} in "
                f"{man_path}{gen} != supported {BUNDLE_VERSION}: "
                "re-checkpoint with this build or restore with the "
                "build that wrote it"
            )
        try:
            with open(npz_path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise CheckpointError(
                f"unreadable checkpoint state {npz_path}{gen}: {e}"
            )
        sha = hashlib.sha256(blob).hexdigest()
        if sha != manifest.get("sha256"):
            raise CheckpointError(
                f"checkpoint state corrupt: sha256 {sha[:12]}... != "
                f"manifest {str(manifest.get('sha256'))[:12]}... "
                f"({npz_path}{gen})"
            )
        try:
            with np.load(io.BytesIO(blob)) as z:
                arrays = {k: z[k] for k in z.files}
        except (OSError, ValueError, KeyError) as e:
            raise CheckpointError(
                f"unparseable checkpoint state {npz_path}{gen}: {e}"
            )
        b = cls(manifest["kind"], manifest.get("meta", {}), arrays)
        b.source_path = path
        b.generation = generation
        return b

    def reshard(self, ndev_new: int) -> "CheckpointBundle":
        """Re-home a resident-mesh bundle's per-device queues onto
        ``ndev_new`` devices (JAX ``CheckpointBundle.reshard``, :451):
        only ready link-free rows move (whole, conserving the pending
        total), dealt round-robin; per-device accumulator value slots and
        executed counters fold by sum mod ``ndev_new``. Refused with a
        diagnostic when a live row carries successor links, a home link
        or a dynamic out slot, or when the kernel has per-device data
        buffers. Exported wait tables re-home: a wait-parked row (one
        dependency bump a parked wait) moves as one unit with its waits,
        allocated past the ready ring, its entries rewritten to the new
        (device, row); refused when a wait's satisfier sits in unexported
        host residue (``meta['host_residue']``). Injection-ring residue
        deals round-robin; the tenant blocks pass through."""
        from ..device.megakernel import (
            C_ALLOC, C_EXECUTED, C_HEAD, C_PENDING, C_TAIL, C_VALLOC,
        )

        if self.kind != "resident":
            raise CheckpointError(
                f"reshard applies to resident-mesh bundles, not {self.kind}"
            )
        try:
            ndev_new = int(ndev_new)
        except (TypeError, ValueError):
            raise CheckpointError(
                f"reshard wants an integer device count, got {ndev_new!r}"
            )
        tasks = self.arrays["tasks"]
        counts = self.arrays["counts"]
        ivalues = self.arrays["ivalues"]
        ndev, cap, _ = tasks.shape
        if ndev_new < 1 or (ndev_new & (ndev_new - 1)):
            raise CheckpointError(
                f"reshard wants a power-of-two device count >= 1, got "
                f"{ndev_new} (the resident mesh's hypercube hop schedule "
                "is pof2-only; an evacuation drops to the next pof2 "
                "below the survivor count)"
            )
        if self.meta.get("dyngraph"):
            # A dynamic-graph bundle re-homes through its own merge.
            from ..device.dyngraph import reshard_dyngraph

            return reshard_dyngraph(self, ndev_new)
        if any(k.startswith("data/") for k in self.arrays):
            raise CheckpointError(
                "reshard cannot re-home per-device data buffers: restore "
                "onto the original mesh size, or drain and re-partition "
                "at the application level"
            )
        waits = self.arrays.get("waits")
        # parked[(d, row)] -> [(chan, need), ...]; needs stay rebased.
        parked: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        if waits is not None:
            warr = np.asarray(waits)
            chan_names = list(self.meta.get("channels") or [])

            def _chan(ch: int) -> str:
                return (repr(chan_names[ch])
                        if 0 <= ch < len(chan_names) else f"id {ch}")

            residue = {
                str(k): int(v)
                for k, v in dict(self.meta.get("host_residue") or {}).items()
                if int(v) > 0
            }
            stranded: Dict[int, List[Tuple[int, int, int]]] = {}
            for d in range(warr.shape[0]):
                for i in range(int(warr[d, 0, 0])):
                    ch, need, row = (int(x) for x in warr[d, 1 + i])
                    name = (chan_names[ch]
                            if 0 <= ch < len(chan_names) else None)
                    if need > 0 and name is not None and name in residue:
                        stranded.setdefault(ch, []).append((d, row, need))
                    parked.setdefault((d, row), []).append((ch, need))
            if stranded:
                # One error names every stranded channel and the fix.
                per_chan = [
                    f"channel {_chan(ch)}: {len(ws)} wait(s) needing "
                    f"{sum(n for _d, _r, n in ws)} more arrival(s) vs "
                    f"{residue[chan_names[ch]]} unexported host put(s)"
                    for ch, ws in sorted(stranded.items())
                ]
                d0, r0, n0 = stranded[min(stranded)][0]
                raise CheckpointError(
                    f"reshard: "
                    f"{sum(len(ws) for ws in stranded.values())} pending "
                    f"wait(s) on {len(stranded)} channel(s) have their "
                    f"satisfier in unexported host residue "
                    f"({'; '.join(per_chan)}); e.g. device {d0} row {r0} "
                    f"still needs {n0} arrival(s) - the outstanding puts "
                    "target the original (device, row) coordinates, so "
                    "resume on the original mesh size and re-issue (or "
                    "drain) the residue before resizing"
                )
        V = ivalues.shape[1]
        va = int(counts[:, C_VALLOC].max())
        # Every violation at once, folded per kernel kind (with the
        # build-time kind classes when the bundle carries them).
        kind_names = list(self.meta.get("kernel_names") or [])
        kind_classes = dict(self.meta.get("kind_classes") or {})
        violations: List[Tuple[int, int, int, str]] = []
        live_rows: List[np.ndarray] = []
        parked_rows: List[Tuple[int, int, np.ndarray]] = []
        for d in range(ndev):
            for i in range(int(counts[d][C_ALLOC])):
                row = tasks[d, i]
                if int(row[F_DEP]) == -1:
                    continue  # tombstone (completed or exported)
                bad = None
                nwaits = len(parked.get((d, i), ()))
                dep = int(row[F_DEP])
                if dep != nwaits:
                    # A parked row carries exactly one bump a parked wait.
                    bad = (
                        f"a dependency counter {dep} != its "
                        f"{nwaits} parked wait(s)"
                        if nwaits else "a nonzero dependency counter"
                    )
                elif (int(row[F_SUCC0]) != NO_TASK
                      or int(row[F_SUCC1]) != NO_TASK
                      or int(row[F_CSR_N]) != 0):
                    bad = "successor links"
                elif int(row[F_HOME]) >= 0:
                    bad = "a migration home-link"
                elif int(row[F_OUT]) >= va:
                    bad = f"a dynamic out slot ({int(row[F_OUT])} >= {va})"
                if bad is not None:
                    violations.append((d, i, int(row[F_FN]), bad))
                    continue
                if nwaits:
                    parked_rows.append((d, i, row.copy()))
                else:
                    live_rows.append(row.copy())
        if violations:
            by_kind: Dict[int, int] = {}
            for _d, _i, fn, _bad in violations:
                by_kind[fn] = by_kind.get(fn, 0) + 1
            kinds = []
            for fn, n in sorted(by_kind.items()):
                name = (kind_names[fn]
                        if 0 <= fn < len(kind_names) else f"id {fn}")
                cls = kind_classes.get(str(name))
                kinds.append(f"{name!r}" + (f" [{cls}]" if cls else "")
                             + f": {n} row(s)")
            d0, i0, _fn0, bad0 = violations[0]
            raise CheckpointError(
                f"reshard: {len(violations)} live row(s) across "
                f"{ndev} device(s) are not link-free "
                f"({'; '.join(kinds)}); e.g. device {d0} row {i0} "
                f"carries {bad0}; only ready link-free rows re-home "
                "across mesh sizes (quiesce drains dependent subgraphs "
                "first, or restore onto the original mesh size)"
            )
        pend_total = int(counts[:, C_PENDING].sum())
        if pend_total != len(live_rows) + len(parked_rows):
            raise CheckpointError(
                f"reshard conservation check failed: {pend_total} pending "
                f"!= {len(live_rows)} live + {len(parked_rows)} "
                "wait-parked rows - the bundle is not a clean quiesce "
                "snapshot"
            )
        parts: List[List[np.ndarray]] = [[] for _ in range(ndev_new)]
        for i, row in enumerate(live_rows):
            parts[i % ndev_new].append(row)
        # Parked rows re-home as units, ordered by their first wait's
        # channel and then their old coordinates, dealt round-robin.
        park_parts: List[List[Tuple[int, int, np.ndarray]]] = [
            [] for _ in range(ndev_new)]
        park_order = sorted(
            parked_rows,
            key=lambda e: (min(ch for ch, _n in parked[(e[0], e[1])]),
                           e[0], e[1]),
        )
        for k, entry in enumerate(park_order):
            park_parts[k % ndev_new].append(entry)
        for j, p in enumerate(parts):
            if len(p) + len(park_parts[j]) > cap:
                total = len(live_rows) + len(parked_rows)
                raise CheckpointError(
                    f"reshard {ndev} -> {ndev_new}: device {j} would "
                    f"hold {len(p) + len(park_parts[j])} rows > capacity "
                    f"{cap} ({total} live+parked rows total); scale in "
                    f"less aggressively (>= {-(-total // cap)} "
                    "devices) or rebuild with a larger capacity"
                )
        tasks_new = np.zeros((ndev_new, cap, DESC_WORDS), np.int32)
        ready_new = np.full((ndev_new, cap), NO_TASK, np.int32)
        counts_new = np.zeros((ndev_new, 8), np.int32)
        ivalues_new = np.zeros((ndev_new, V), np.int32)
        waits_new = None
        if waits is not None:
            warr = np.asarray(waits)
            max_w = warr.shape[1] - 1
            waits_new = np.zeros((ndev_new,) + warr.shape[1:], np.int32)
        for j, p in enumerate(parts):
            for i, row in enumerate(p):
                tasks_new[j, i] = row
                ready_new[j, i] = i
            n = len(p)
            # Parked rows land after the ready rows: allocated and pending
            # but not in the ready ring, their bumps kept.
            for k, (od, orow, row) in enumerate(park_parts[j]):
                slot = n + k
                tasks_new[j, slot] = row
                if waits_new is not None:
                    for ch, need in parked[(od, orow)]:
                        w = int(waits_new[j, 0, 0])
                        if w >= max_w:
                            raise CheckpointError(
                                f"reshard {ndev} -> {ndev_new}: device "
                                f"{j} would park > {max_w} wait(s); "
                                "scale in less aggressively or raise "
                                "max_waits"
                            )
                        waits_new[j, 1 + w] = (ch, need, slot)
                        waits_new[j, 0, 0] = w + 1
            total_j = n + len(park_parts[j])
            counts_new[j][C_HEAD] = 0
            counts_new[j][C_TAIL] = n  # the ready ring: live rows only
            counts_new[j][C_ALLOC] = total_j
            counts_new[j][C_PENDING] = total_j
            counts_new[j][C_VALLOC] = va
        # The old devices' host regions and executed counters fold mod M.
        for d in range(ndev):
            j = d % ndev_new
            ivalues_new[j][:va] += ivalues[d][:va]
            counts_new[j][C_EXECUTED] += int(counts[d][C_EXECUTED])
        scap = self.arrays["succ"].shape[1]
        succ_new = np.full((ndev_new, scap), NO_TASK, np.int32)
        arrays = {
            "tasks": tasks_new, "succ": succ_new, "ready": ready_new,
            "counts": counts_new, "ivalues": ivalues_new,
        }
        if waits_new is not None:
            warr = np.asarray(waits)
            # The wait count and each channel's need sum are conserved.
            if int(waits_new[:, 0, 0].sum()) != int(warr[:, 0, 0].sum()):
                raise CheckpointError(
                    "reshard wait conservation check failed: "
                    f"{int(waits_new[:, 0, 0].sum())} re-homed wait(s) "
                    f"!= {int(warr[:, 0, 0].sum())} exported"
                )
            need_old: Dict[int, int] = {}
            need_new: Dict[int, int] = {}
            for arr, acc in ((warr, need_old), (waits_new, need_new)):
                for d in range(arr.shape[0]):
                    for i in range(int(arr[d, 0, 0])):
                        ch, need, _row = (int(x) for x in arr[d, 1 + i])
                        acc[ch] = acc.get(ch, 0) + need
            if need_old != need_new:
                raise CheckpointError(
                    "reshard wait conservation check failed: per-channel "
                    f"need sums diverged ({need_old} -> {need_new})"
                )
            arrays["waits"] = waits_new
        if "ring_rows" in self.arrays:
            # Injected rows are link-free: the residue deals round-robin.
            rr = np.asarray(self.arrays["ring_rows"])
            ic = np.asarray(self.arrays["ictl"])
            R = rr.shape[1]
            residue = [rr[d, i] for d in range(rr.shape[0])
                       for i in range(int(ic[d, 0]))]
            rr_new = np.zeros((ndev_new, R) + rr.shape[2:], np.int32)
            ic_new = np.zeros((ndev_new, 8), np.int32)
            ic_new[:, 1] = ic[:, 1].max() if ic.size else 0  # close flag
            for i, row in enumerate(residue):
                j = i % ndev_new
                slot = ic_new[j, 0]
                if slot >= R:
                    raise CheckpointError(
                        f"reshard {ndev} -> {ndev_new}: device {j} would "
                        f"hold > {R} inject-ring residue rows "
                        f"({len(residue)} total); scale in less "
                        "aggressively or raise ring_capacity"
                    )
                rr_new[j, slot] = row
                ic_new[j, 0] = slot + 1
            if int(ic_new[:, 0].sum()) != len(residue):
                raise CheckpointError("reshard ring conservation check failed")
            arrays["ring_rows"] = rr_new
            arrays["ictl"] = ic_new
        # The tenant blocks (aggregate (T, 8) tctl / tstats) hold no
        # device count: they pass through.
        for k in ("tctl", "tstats"):
            if k in self.arrays:
                arrays[k] = np.asarray(self.arrays[k]).copy()
        meta = dict(self.meta)
        meta["ndev"] = ndev_new
        meta["resharded_from"] = int(ndev)
        return CheckpointBundle("resident", meta, arrays)

    def diff(self, other: "CheckpointBundle") -> Dict[str, Any]:
        """Structural comparison of two bundles: ``{'equal': bool,
        'kind': ..., 'only_self': [...], 'only_other': [...],
        'mismatched': {key: {n, max_abs}}}``; arrays compare bit-exactly
        (shape, dtype and values)."""
        only_self = sorted(set(self.arrays) - set(other.arrays))
        only_other = sorted(set(other.arrays) - set(self.arrays))
        mismatched: Dict[str, Any] = {}
        for k in sorted(set(self.arrays) & set(other.arrays)):
            a, b = self.arrays[k], other.arrays[k]
            if a.shape != b.shape or a.dtype != b.dtype:
                mismatched[k] = {
                    "shape": [list(a.shape), list(b.shape)],
                    "dtype": [str(a.dtype), str(b.dtype)],
                }
                continue
            if not np.array_equal(a, b):
                av = a.astype(np.int64) if a.dtype.kind in "biu" else a
                bv = b.astype(np.int64) if b.dtype.kind in "biu" else b
                d = np.abs(av - bv)
                mismatched[k] = {
                    "n": int((av != bv).sum()),
                    "max_abs": float(d.max()),
                }
        return {
            "equal": not (only_self or only_other or mismatched)
            and self.kind == other.kind,
            "kind": [self.kind, other.kind],
            "only_self": only_self,
            "only_other": only_other,
            "mismatched": mismatched,
        }


# ---------------------------------------------------------- durable store

@dataclass
class BundleFault:
    """One generation ``BundleStore.load_latest`` could not use.
    ``reason``: ``torn`` (manifest missing or unparseable), ``corrupt``
    (sha256 or payload mismatch), ``version`` (another format version),
    ``foreign`` (not a bundle)."""

    generation: int
    path: str
    reason: str
    error: str


def _classify_fault(msg: str) -> str:
    low = msg.lower()
    if "magic" in low:
        return "foreign"
    if "sha256" in low or "unparseable" in low:
        return "corrupt"
    if "version" in low:
        return "version"
    if "manifest" in low or "missing" in low:
        return "torn"
    return "corrupt"


class BundleStore:
    """Generational on-disk store of ``CheckpointBundle``s with
    crash-safe publish and self-healing restore (the JAX package's
    layout: ``gen-NNNNNN/`` generations, a ``CURRENT`` hint,
    ``quarantine/``).

    ``save`` stages the bundle into ``.tmp-gen-N`` (members flushed when
    ``fsync``), renames it to ``gen-N``, and writes ``CURRENT`` last, so
    an interruption anywhere leaves the previous store state.
    ``load_latest`` walks generations newest-first, moves one that does
    not validate to ``quarantine/`` with a typed ``BundleFault`` in
    ``self.faults``, and returns the newest that validates; with none it
    raises ``CheckpointError`` naming every fault. Host records of these
    events (TR_CKPT with a negative ``a`` word, ``tracebuf.CK_*``) go to
    ``self.events`` and ``trace_info()``.

    ``keep`` (default ``HCLIB_TPU_CKPT_KEEP``, 3) bounds retention;
    ``fsync`` (default ``HCLIB_TPU_CKPT_FSYNC``, on); ``fault_plan`` (any
    object with ``on_store_publish`` / ``on_store_restore`` and the
    bundle sites, as the JAX package's FaultPlan) injects faults.
    """

    def __init__(self, root: str, keep: Optional[int] = None,
                 fsync: Optional[bool] = None, metrics=None,
                 fault_plan=None) -> None:
        _no_metrics(metrics)
        self.root = str(root)
        if keep is None:
            keep = _env.env_int("HCLIB_TPU_CKPT_KEEP", 3)
        self.keep = int(keep)
        if self.keep < 1:
            raise CheckpointError(
                f"BundleStore keep={self.keep} must be >= 1 (retention "
                "of zero generations would unpublish every save)"
            )
        if fsync is None:
            fsync = _env.env_bool("HCLIB_TPU_CKPT_FSYNC", True)
        self.fsync = bool(fsync)
        self.fault_plan = fault_plan
        self.faults: List[BundleFault] = []
        # Host-emitted TR_CKPT records ([tag, ordinal, -(1+CK_*), gen]).
        self.events: List[List[int]] = []
        self._t0_ns = time.monotonic_ns()
        os.makedirs(self.root, exist_ok=True)

    def _trace(self, code: int, generation: int) -> None:
        self.events.append(
            [tb.TR_CKPT, len(self.events), -(1 + code), int(generation)]
        )

    def path_of(self, generation: int) -> str:
        return os.path.join(self.root, f"gen-{int(generation):06d}")

    def generations(self) -> List[int]:
        """Published generation numbers, ascending (staging and
        quarantine dirs excluded)."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for n in names:
            if n.startswith("gen-"):
                try:
                    out.append(int(n[4:]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, bundle: CheckpointBundle) -> int:
        """Publish ``bundle`` as the next generation; returns its
        number."""
        gens = self.generations()
        gen = (gens[-1] + 1) if gens else 1
        tmp = os.path.join(self.root, f".tmp-gen-{gen}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        bundle.save(tmp, fsync=self.fsync, fault_plan=self.fault_plan)
        if self.fault_plan is not None:
            # The preempt-mid-save site fires before the rename.
            self.fault_plan.on_store_publish()
        os.rename(tmp, self.path_of(gen))
        if self.fsync:
            _fsync_dir(self.root)
        cur_tmp = os.path.join(self.root, ".tmp-CURRENT")
        with open(cur_tmp, "w") as f:
            f.write(f"{gen}\n")
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.rename(cur_tmp, os.path.join(self.root, "CURRENT"))
        if self.fsync:
            _fsync_dir(self.root)
        for old in self.generations()[:-self.keep]:
            shutil.rmtree(self.path_of(old), ignore_errors=True)
        self._trace(tb.CK_SAVE, gen)
        return gen

    def _quarantine(self, gen: int, err: CheckpointError) -> BundleFault:
        qdir = os.path.join(self.root, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        src = self.path_of(gen)
        dst = os.path.join(qdir, f"gen-{gen:06d}")
        if os.path.exists(dst):
            shutil.rmtree(dst, ignore_errors=True)
        try:
            shutil.move(src, dst)
        except OSError:
            dst = src  # refuse-to-move is not refuse-to-heal
        fault = BundleFault(
            generation=gen, path=dst,
            reason=_classify_fault(str(err)), error=str(err),
        )
        self.faults.append(fault)
        self._trace(tb.CK_QUARANTINE, gen)
        return fault

    def load_latest(self) -> CheckpointBundle:
        """Newest generation that validates, quarantining the ones that
        don't; raises ``CheckpointError`` naming every fault when none
        does."""
        if self.fault_plan is not None:
            self.fault_plan.on_store_restore()
        gens = self.generations()
        walked: List[BundleFault] = []
        newest = gens[-1] if gens else 0
        for gen in reversed(gens):
            try:
                b = CheckpointBundle.load(self.path_of(gen),
                                          generation=gen)
            except CheckpointError as e:
                walked.append(self._quarantine(gen, e))
                continue
            if gen != newest:
                self._trace(tb.CK_FALLBACK, gen)
            self._trace(tb.CK_LOAD, gen)
            return b
        self._trace(tb.CK_POISON, newest)
        detail = "; ".join(
            f"gen {f.generation}: {f.reason} ({f.error})" for f in walked
        ) or "the store holds no generations"
        raise CheckpointError(
            f"BundleStore at {self.root!r} is unrecoverable - no "
            f"generation validates ({detail}); poison outstanding "
            "futures through the degradation ladder and cold-start"
        )

    def trace_info(self) -> Dict[str, Any]:
        """trace_info-shaped dict of the store's host-emitted TR_CKPT
        records, mergeable by ``tools/timeline.py``."""
        return tb.host_trace_info(
            self.events or np.zeros((0, 4), np.int64),
            self._t0_ns, time.monotonic_ns(),
        )


def default_store(**kw) -> Optional[BundleStore]:
    """The store rooted at ``HCLIB_TPU_CKPT_DIR``, or None when unset."""
    root = _env.env_str("HCLIB_TPU_CKPT_DIR")
    if not root:
        return None
    return BundleStore(root, **kw)


# --------------------------------------------------------------- snapshot

def _require_quiesced(info: Dict[str, Any], what: str) -> Dict[str, Any]:
    if not info.get("quiesced") or "state" not in info:
        raise CheckpointError(
            f"{what}: the run info carries no quiesced state - pass "
            "quiesce= so the kernel exports its scheduler state at a "
            "round boundary"
        )
    return info["state"]


def snapshot_megakernel(mk, info: Dict[str, Any],
                        meta: Optional[Dict[str, Any]] = None
                        ) -> CheckpointBundle:
    """Bundle a quiesced ``Megakernel.run/resume`` info dict."""
    state = _require_quiesced(info, "snapshot_megakernel")
    m = _kernel_meta(mk)
    m.update(info.get("quiesce") or {})
    m.update(meta or {})
    bf16 = {f"data/{k}" for k, spec in m["data_specs"].items()
            if spec["dtype"] == "bfloat16"}
    return CheckpointBundle(
        "megakernel", m, CheckpointBundle._flatten_state(state, m, bf16)
    )


def snapshot_stream(sm, info: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None
                    ) -> CheckpointBundle:
    """Bundle a quiesced ``StreamingMegakernel.run_stream`` return."""
    state = _require_quiesced(info, "snapshot_stream")
    m = _kernel_meta(sm.mk)
    m["ring_capacity"] = int(sm.ring_capacity)
    m["quiesce_latency_s"] = info.get("quiesce_latency_s")
    m["quiesce_round"] = info.get("quiesce_observed_round")
    m.update(meta or {})
    # After the user meta: the roster is what restore_stream validates.
    if getattr(sm, "tenants", None) is not None:
        m["tenants"] = list(sm.tenants.ids)
    else:
        m.pop("tenants", None)
    bf16 = {f"data/{k}" for k, spec in m["data_specs"].items()
            if spec["dtype"] == "bfloat16"}
    return CheckpointBundle(
        "stream", m, CheckpointBundle._flatten_state(state, m, bf16)
    )


# The migratability classes of the built-in bodies (JAX hclib_tpu/analysis
# classify.py, read off their bodies): fib spawns successor-linked children
# (home-linked); sum and the UTS node spawn none with links (link-free).
_BODY_CLASSES = {"fib": "home-linked", "fib_batch": "home-linked",
                 "sum": "link-free", "uts_node": "link-free",
                 "uts_node_batch": "link-free"}


def _kind_classes(mk) -> Dict[str, str]:
    """The build-time migratability class of each kernel kind that the
    bundle manifest carries for ``reshard``'s diagnostics (JAX
    ``_kind_classes``, :187): the built-in bodies' classes; a kind whose
    class the port cannot tell (a user body: JAX reads it off a recording
    pass over the body, which the port has not, ROADMAP A13) is
    ``unknown``."""
    return {name: _BODY_CLASSES.get(mk.fn_bodies[i], "unknown")
            for i, name in enumerate(mk.kernel_names)}


def snapshot_resident(rk, info: Dict[str, Any],
                      meta: Optional[Dict[str, Any]] = None
                      ) -> CheckpointBundle:
    """Bundle a quiesced ``ResidentKernel.run`` info dict."""
    state = _require_quiesced(info, "snapshot_resident")
    m = _kernel_meta(rk.mk)
    m["kind_classes"] = _kind_classes(rk.mk)
    m["ndev"] = int(rk.ndev)
    m["dims"] = [int(d) for d in rk.dims]
    m["quiesce_round"] = max(
        f["quiesce_round"] for f in info["fault_stats"]
    )
    m.update(meta or {})
    # After the user meta: the roster (restore_resident's guard) and the
    # channel names (reshard's wait diagnostics) are the mesh's own.
    if getattr(rk, "chan_id", None):
        m["channels"] = [
            name for name, _cid in
            sorted(rk.chan_id.items(), key=lambda kv: kv[1])
        ]
    if getattr(rk, "tenant_specs", None):
        m["tenants"] = [s.id for s in rk.tenant_specs]
    else:
        m.pop("tenants", None)
    bf16 = {f"data/{k}" for k, spec in m["data_specs"].items()
            if spec["dtype"] == "bfloat16"}
    return CheckpointBundle(
        "resident", m, CheckpointBundle._flatten_state(state, m, bf16)
    )


# ---------------------------------------------------------------- restore

def _as_bundle(bundle_or_path) -> CheckpointBundle:
    if isinstance(bundle_or_path, CheckpointBundle):
        return bundle_or_path
    return CheckpointBundle.load(bundle_or_path)


def restore_megakernel(bundle_or_path, mk, fuel: int = 1 << 22,
                       quiesce=None):
    """Validate and relaunch a megakernel bundle mid-graph on ``mk``
    (built exactly as checkpointed; ``checkpoint=True`` is needed only to
    pass ``quiesce=`` again). Returns (ivalues, data, info) of the
    continued run."""
    b = _as_bundle(bundle_or_path)
    if b.kind != "megakernel":
        raise CheckpointError(
            f"restore_megakernel got a {b.kind!r} bundle"
        )
    _check_kernel_meta(mk, b.meta, where=_where(b))
    return mk.resume(b.state(), fuel=fuel, quiesce=quiesce)


def restore_stream(bundle_or_path, sm, **run_stream_kw):
    """Validate and resume a stream bundle on ``sm`` (a
    StreamingMegakernel whose Megakernel matches the manifest). The
    residue rows re-publish on the fresh ring; the stream starts OPEN -
    inject()/close() as usual, or close() first to drain and exit."""
    b = _as_bundle(bundle_or_path)
    if b.kind != "stream":
        raise CheckpointError(f"restore_stream got a {b.kind!r} bundle")
    _check_kernel_meta(sm.mk, b.meta, where=_where(b))
    # The roster must match exactly (ids AND order): lane state is keyed
    # by index.
    want = b.meta.get("tenants")
    have = None if getattr(sm, "tenants", None) is None else sm.tenants.ids
    if (want or None) != (have or None):
        raise CheckpointError(
            f"tenant roster mismatch: bundle carries {want!r}, the "
            f"target stream has {have!r} (ids and order must match - "
            "lane state is keyed by index)"
        )
    return sm.run_stream(resume_state=b.state(), **run_stream_kw)


def restore_resident(bundle_or_path, rk, quantum: int = 64,
                     max_rounds: int = 1 << 14, quiesce=None,
                     tenant_table=None):
    """Validate and relaunch a resident-mesh bundle on ``rk``. A mesh-size
    mismatch re-homes the queues (``reshard``). A tenant-enabled bundle
    needs a fresh ``tenant_table`` matching the roster; the residue
    re-deals into its lanes. Returns (ivalues, data, info) of the
    continued run."""
    b = _as_bundle(bundle_or_path)
    if b.kind != "resident":
        raise CheckpointError(f"restore_resident got a {b.kind!r} bundle")
    _check_kernel_meta(rk.mk, b.meta, where=_where(b))
    # The roster must match exactly (ids AND order): lane state is keyed
    # by index.
    want = b.meta.get("tenants")
    have = ([s.id for s in rk.tenant_specs]
            if getattr(rk, "tenant_specs", None) else None)
    if (want or None) != (have or None):
        raise CheckpointError(
            f"tenant roster mismatch: bundle carries {want!r}, the "
            f"target mesh has {have!r} (ids and order must match - "
            "lane state is keyed by index)"
        )
    if int(b.meta.get("ndev", rk.ndev)) != rk.ndev:
        b = b.reshard(rk.ndev)
    kw = {} if tenant_table is None else {"tenant_table": tenant_table}
    return rk.run(resume_state=b.state(), quantum=quantum,
                  max_rounds=max_rounds, quiesce=quiesce, **kw)


def checkpoint_on_preempt(stream, after_executed: int = 0):
    """Bind a running stream's checkpoint trigger to process preemption:
    SIGTERM (after ``resilience.install_preempt_handler()``) or the
    ``HCLIB_TPU_PREEMPT`` env quiesce the stream, and the driving
    run_stream returns ``info['quiesced']=True`` for the caller to save
    (checkpoint, then stop). A preemption that fired before the binding
    still checkpoints. Refuses, at once, a stream whose megakernel was
    not built with ``checkpoint=True`` (its quiesce could never land)::

        with checkpoint_on_preempt(sm):
            iv, info = sm.run_stream(b, ...)
        if info.get("quiesced"):
            snapshot_stream(sm, info).save(path)
    """
    if not stream.mk.checkpoint:
        raise ValueError(
            "checkpoint_on_preempt needs a stream over "
            "Megakernel(checkpoint=True): the quiesce word is compiled "
            "into the round loop only then")
    return _preempt_binding(stream, after_executed)


@contextlib.contextmanager
def _preempt_binding(stream, after_executed: int):
    def hook() -> None:
        stream.quiesce(after_executed)

    resilience.register_preempt_hook(hook)
    try:
        yield
    finally:
        resilience.unregister_preempt_hook(hook)
