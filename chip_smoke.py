#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA card, and hold every kernel
of it against its plain version.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build   - compile every ``hclib_tpu_torch/csrc/*.cu`` with nvcc.
2. check   - each kernel against its plain version on the same inputs:
             the megakernel (K1) on fib(11) and the CSR fan-out DAG, its
             whole output state word for word; POTRF (K2), TRSMCOL (K3) and
             UPDROW (K4) at tile 512 on make_spd(8192) tiles, within 1e-5 of
             the largest magnitude. Kernel, plain and library times (CUDA
             events, after a warm-up) and each kernel's bound.
3. fib     - device_fib(24): 46,368 with 225,073 tasks executed.
4. uts     - device_uts_mk at max_depth=20: the plain scheduler's count.
5. cholesky- device_cholesky at n=8192, tile 512 (151 tasks), residual
             ||LL^T - A||_max / ||A||_max < 1e-6 in float64 on the card.

Then one ``{"kernels": [...]}`` line (launch counts of phases 3-5, zeroed
just before phase 3, with every kernel's times and bound), the card's name
and power limit from nvidia-smi, and last ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before that last line; without a
card, or outside a checkout of the repo, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_F32 = 67e12    # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12  # H100 SXM device memory bytes/s
TOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "hclib_tpu_torch", "csrc")):
        print("chip_smoke.py: run it from a checkout of the repo "
              "(hclib_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from hclib_tpu_torch import _build
    from hclib_tpu_torch.device import cholesky as tc
    from hclib_tpu_torch.device import workloads as tw
    from hclib_tpu_torch.device.descriptor import TaskGraphBuilder
    from hclib_tpu_torch.models.cholesky import make_spd
    from hclib_tpu_torch.ops.tiles import split_bf16, unsplit

    dev = torch.device("cuda")

    def events_ms(fn, reps, before=None):
        """Median ms of ``fn`` by CUDA events; ``before`` restores inputs
        outside the timed window."""
        times = []
        for _ in range(reps):
            if before is not None:
                before()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    # 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    per_source = _build.build_all()
    _build.library("megakernel")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": per_source})

    kernels = {}

    # 2. check: K1 on fib(11) and the CSR fan-out DAG ------------------
    def fib_graph(n):
        b = TaskGraphBuilder()
        b.add(tw.FIB, args=[n], out=0)
        return b, None

    def csr_graph():
        b = TaskGraphBuilder()
        a = b.add(tw.SUM, args=[0, 1], out=2)
        bs = [b.add(tw.SUM, args=[2, 0], out=4 + i, deps=[a])
              for i in range(5)]
        b.add(tw.SUM, args=[4, 5], out=3, deps=bs)
        iv = np.zeros(tw.VBLOCK * 64 + 16, np.int32)
        iv[0], iv[1] = 1, 2
        return b, iv

    k1_err = 0
    for name, cap, (b, iv) in (("fib11", 768, fib_graph(11)),
                               ("csr_fanout", 64, csr_graph())):
        out = {}
        for d in ("cuda", "cpu"):
            mk = tw.make_fib_megakernel(cap, device=d)
            st = mk.state(b, ivalues=iv)
            mk.launch(st)
            out[d] = {k: st[k].cpu() for k in
                      ("tasks", "ready", "counts", "ivalues")}
        for k in out["cpu"]:
            diff = int((out["cuda"][k].long() - out["cpu"][k].long())
                       .abs().max())
            k1_err = max(k1_err, diff)
            check(diff == 0, f"megakernel {name} {k} differs from plain")
        emit({"phase": "check", "kernel": "megakernel", "graph": name,
              "equal": True, "executed": int(out["cuda"]["counts"][5])})

    # K1 times: the UTS tree at max_depth=20 (main-path shape).
    uts_mk = {d: tw.make_uts_megakernel(max_depth=20, device=d)
              for d in ("cuda", "cpu")}
    ub = TaskGraphBuilder()
    ub.add(tw.UTS_NODE, args=[1, 0])
    t0 = time.perf_counter()
    st_cpu = uts_mk["cpu"].state(ub)
    uts_mk["cpu"].launch(st_cpu)
    uts_plain_ms = (time.perf_counter() - t0) * 1e3
    uts_plain_nodes = int(st_cpu["ivalues"][0])
    uts_plain_exec = int(st_cpu["counts"][5])
    holder = {}

    def uts_fresh():
        holder["st"] = uts_mk["cuda"].state(ub)

    uts_fresh()
    uts_mk["cuda"].launch(holder["st"])  # warm-up
    uts_ms = events_ms(lambda: uts_mk["cuda"].launch(holder["st"]), 3,
                       before=uts_fresh)
    check(int(holder["st"]["ivalues"][0]) == uts_plain_nodes,
          "megakernel UTS count differs from plain")
    # Each task's 16-word descriptor is written once (spawn) and read once
    # (dispatch), plus one ring push and pop: 136 bytes a task.
    kb = bound(0.0, uts_plain_exec * 136.0)
    kernels["megakernel"] = {
        "name": "megakernel", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/megakernel.cu",
        "replaces": "hclib_tpu/device/megakernel.py:2165",
        "max_abs_err": float(k1_err), "ms": uts_ms, "plain_ms": uts_plain_ms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": None,
    }
    emit({"phase": "check", "kernel": "megakernel", "graph": "uts_depth20",
          "kernel_ms": uts_ms, "plain_host_ms": uts_plain_ms,
          "nodes": uts_plain_nodes})

    # 2. check: K2-K4 at tile 512 on make_spd(8192) tiles --------------
    n, ts, fb = 8192, 512, 128
    nt = n // ts
    t0 = time.perf_counter()
    a = make_spd(n).astype(np.float32)
    emit({"phase": "inputs", "make_spd_seconds": time.perf_counter() - t0})
    base = tc.cholesky_buffers(a, nt, ts, device="cuda")

    def clone(bufs):
        return {k: v.clone() for k, v in bufs.items()}

    def rel(x, y):
        x, y = x.double(), y.double()
        return float((x - y).abs().max() / y.abs().max()), float(
            (x - y).abs().max())

    tt = ts * ts
    # K2: POTRF(0)
    kb_, pb_ = clone(base), clone(base)
    tc.potrf(kb_["tiles"], kb_["linvsp"], 0, fb)
    tc.potrf_plain(pb_["tiles"], pb_["linvsp"], 0, fb)
    torch.cuda.synchronize()
    r_l, e_l = rel(kb_["tiles"][0, 0], pb_["tiles"][0, 0])
    r_i, e_i = rel(unsplit(*kb_["linvsp"][0]), unsplit(*pb_["linvsp"][0]))
    check(max(r_l, r_i) < TOL, f"potrf differs from plain ({r_l}, {r_i})")
    a00 = base["tiles"][0, 0].clone()
    scratch = clone(base)

    def restore_potrf():
        scratch["tiles"][0, 0].copy_(a00)

    ms = events_ms(lambda: tc.potrf(scratch["tiles"], scratch["linvsp"], 0,
                                    fb), 3, restore_potrf)
    pms = events_ms(lambda: tc.potrf_plain(scratch["tiles"],
                                           scratch["linvsp"], 0, fb), 2,
                    restore_potrf)
    lms = events_ms(lambda: torch.linalg.inv(torch.linalg.cholesky(a00)), 3)
    kb = bound(2.0 * ts ** 3 / 3.0, 4 * tt + 4 * tt + 4 * tt)
    kernels["potrf"] = {
        "name": "potrf", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/tiles.cuh",
        "replaces": "hclib_tpu/device/cholesky.py:77",
        "max_abs_err": max(e_l, e_i), "ms": ms, "plain_ms": pms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": lms,
    }
    emit({"phase": "check", "kernel": "potrf", "rel_err": max(r_l, r_i),
          "kernel_ms": ms, "plain_ms": pms, "library_ms": lms})

    # K3: TRSMCOL(0) on the kernel's POTRF output
    after2 = kb_
    kb_, pb_ = clone(after2), clone(after2)
    tc.trsmcol(kb_["tiles"], kb_["linvsp"], kb_["lsp"], 0)
    tc.trsmcol_plain(pb_["tiles"], pb_["linvsp"], pb_["lsp"], 0)
    torch.cuda.synchronize()
    # S in f32 against the plain S; the kernel's stored split must be
    # split_bf16 of its own S bit for bit (comparing two splits instead
    # would count a one-ulp f32 difference that moves a bf16 rounding).
    r_t, e_t = rel(kb_["tiles"][1:, 0], pb_["tiles"][1:, 0])
    check(r_t < TOL, f"trsmcol differs from plain ({r_t})")
    hi, lo = split_bf16(kb_["tiles"][1:, 0])
    check(torch.equal(hi, kb_["lsp"][1:, 0, 0])
          and torch.equal(lo, kb_["lsp"][1:, 0, 1]),
          "trsmcol's stored split is not split_bf16 of its result")
    col0 = after2["tiles"][1:, 0].clone()
    scratch = clone(after2)

    def restore_col():
        scratch["tiles"][1:, 0].copy_(col0)

    ms = events_ms(lambda: tc.trsmcol(scratch["tiles"], scratch["linvsp"],
                                      scratch["lsp"], 0), 3, restore_col)
    pms = events_ms(lambda: tc.trsmcol_plain(
        scratch["tiles"], scratch["linvsp"], scratch["lsp"], 0), 3,
        restore_col)
    inv_t = unsplit(*after2["linvsp"][0]).transpose(0, 1).contiguous()
    lms = events_ms(lambda: torch.matmul(col0, inv_t), 3)
    m = nt - 1
    kb = bound(2.0 * m * ts ** 3, 4 * m * tt + 4 * tt + 4 * m * tt
               + 4 * m * tt)
    kernels["trsmcol"] = {
        "name": "trsmcol", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/tiles.cuh",
        "replaces": "hclib_tpu/device/cholesky.py:121",
        "max_abs_err": e_t, "ms": ms, "plain_ms": pms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": lms,
    }
    emit({"phase": "check", "kernel": "trsmcol", "rel_err": r_t,
          "split_bit_exact": True,
          "kernel_ms": ms, "plain_ms": pms, "library_ms": lms})

    # K4: UPDROW(i=nt-1, k=0) on the kernel's TRSMCOL output
    after3 = kb_
    i = nt - 1
    kb_, pb_ = clone(after3), clone(after3)
    tc.updrow(kb_["tiles"], kb_["lsp"], i, 0)
    tc.updrow_plain(pb_["tiles"], pb_["lsp"], i, 0)
    torch.cuda.synchronize()
    r_u, e_u = rel(kb_["tiles"][i, 1:], pb_["tiles"][i, 1:])
    check(r_u < TOL, f"updrow differs from plain ({r_u})")
    row0 = after3["tiles"][i, 1:].clone()
    scratch = clone(after3)

    def restore_row():
        scratch["tiles"][i, 1:].copy_(row0)

    ms = events_ms(lambda: tc.updrow(scratch["tiles"], scratch["lsp"], i, 0),
                   3, restore_row)
    pms = events_ms(lambda: tc.updrow_plain(scratch["tiles"], scratch["lsp"],
                                            i, 0), 3, restore_row)
    lik = unsplit(after3["lsp"][i, 0, 0], after3["lsp"][i, 0, 1])
    ljk_t = unsplit(after3["lsp"][1:, 0, 0], after3["lsp"][1:, 0, 1]
                    ).transpose(1, 2).contiguous()
    lik_b = lik.expand(m, ts, ts)
    lms = events_ms(lambda: torch.baddbmm(row0, lik_b, ljk_t, alpha=-1.0), 3)
    kb = bound(2.0 * m * ts ** 3, 4 * tt + 4 * m * tt + 4 * m * tt
               + 4 * m * tt)
    kernels["updrow"] = {
        "name": "updrow", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/tiles.cuh",
        "replaces": "hclib_tpu/device/cholesky.py:271",
        "max_abs_err": e_u, "ms": ms, "plain_ms": pms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": lms,
    }
    emit({"phase": "check", "kernel": "updrow", "rel_err": r_u,
          "kernel_ms": ms, "plain_ms": pms, "library_ms": lms})
    del kb_, pb_, scratch, after2, after3, base
    torch.cuda.synchronize()

    # The main path: launch counts from here to the end of phase 5 -----
    _build.reset_launches()

    # 3. fib(24)
    t0 = time.perf_counter()
    v, info = tw.device_fib(24, capacity=768, device="cuda")
    dt = time.perf_counter() - t0
    check(v == 46368, f"fib(24) = {v}")
    check(info["executed"] == 225073, f"fib(24) executed {info['executed']}")
    emit({"phase": "fib", "n": 24, "value": v, "executed": info["executed"],
          "allocated": info["allocated"], "seconds": dt,
          "tasks_per_s": info["executed"] / dt})

    # 4. UTS at max_depth=20
    t0 = time.perf_counter()
    nodes, info = tw.device_uts_mk(max_depth=20, device="cuda")
    dt = time.perf_counter() - t0
    check(nodes == uts_plain_nodes, f"UTS nodes {nodes} != plain "
          f"{uts_plain_nodes}")
    check(nodes == 498965, f"UTS nodes {nodes} != 498965")
    emit({"phase": "uts", "max_depth": 20, "nodes": nodes,
          "plain_nodes": uts_plain_nodes, "seconds": dt,
          "nodes_per_s": nodes / dt})

    # 5. Cholesky n=8192, tile 512
    mk = tc.make_cholesky_megakernel(nt, tile=ts, fused_only=True,
                                     device="cuda")
    L, info = tc.device_cholesky(a, mk=mk, tile=ts, device="cuda")
    check(info["executed"] == 151, f"cholesky executed {info['executed']}")
    A = torch.from_numpy(a).to(dev, torch.float64)
    Ld = L.double()
    resid = float((Ld @ Ld.T - A).abs().max() / A.abs().max())
    check(resid < 1e-6, f"cholesky residual {resid}")
    # Where the time goes, estimated: each body's tile products at the
    # per-tile time of its standalone entry measured in phase 2.
    trsm_tiles = nt * (nt - 1) // 2
    upd_tiles = sum(m * (m + 1) // 2 for m in range(1, nt))
    est = {
        "potrf": info["dispatch"]["potrf"] * kernels["potrf"]["ms"],
        "trsmcol": trsm_tiles * kernels["trsmcol"]["ms"] / (nt - 1),
        "updrow": upd_tiles * kernels["updrow"]["ms"] / (nt - 1),
    }
    emit({"phase": "cholesky", "n": n, "tile": ts, "tasks": info["executed"],
          "dispatch": info["dispatch"], "residual": resid,
          "seconds": info["seconds"],
          "gflops": (n ** 3 / 3.0) / info["seconds"] / 1e9,
          "estimated_body_ms": est})
    del A, Ld, L

    # Launches of the main path ----------------------------------------
    for name, k in kernels.items():
        k["launches"] = _build.LAUNCHES[name]
        check(k["launches"] > 0, f"{name} was not launched on the main path")
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    emit({"kernels": [{f: k[f] for f in order} for k in kernels.values()]})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
