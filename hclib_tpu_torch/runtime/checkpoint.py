"""Checkpoint/restore of the single-device megakernel: versioned bundles of
its quiesced scheduler state and a crash-safe store of them.

Port of the single-device part of ``hclib_tpu/runtime/checkpoint.py``,
with its on-disk format unchanged, so a bundle written by either package
loads in the other:

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

Left out, each raising ``NotImplementedError`` naming its ROADMAP item:
``CheckpointBundle.reshard`` and ``snapshot_resident`` /
``restore_resident`` (A11c: the port's mesh runners,
device/{sharded,ici_steal,resident}.py, run to completion or abort but
do not quiesce yet) and ``metrics=`` (no metrics registry in the port
yet, A13).
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
from typing import Any, Dict, List, Optional

import numpy as np

from ..device import tracebuf as tb
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
        """Re-home a resident-mesh bundle onto another device count."""
        raise _later("CheckpointBundle.reshard (re-homing a quiesced "
                     "mesh; the port's ResidentKernel runs steal-only and "
                     "does not quiesce yet)", "A11c")

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


def snapshot_resident(rk, info, meta=None):
    """Bundle a quiesced resident-mesh run."""
    raise _later("snapshot_resident (a quiesced mesh; the port's "
                 "ResidentKernel runs steal-only and does not quiesce "
                 "yet)", "A11c")


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


def restore_resident(bundle_or_path, rk, **kw):
    """Relaunch a resident-mesh bundle."""
    raise _later("restore_resident (a quiesced mesh; the port's "
                 "ResidentKernel runs steal-only and does not quiesce "
                 "yet)", "A11c")


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
