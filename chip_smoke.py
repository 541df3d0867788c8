#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA card, and hold every kernel
of it against its plain version.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build   - compile every ``hclib_tpu_torch/csrc/*.cu`` with nvcc.
2. check   - each kernel against its plain version on the same inputs:
             the megakernel (K1) on fib(11) and the CSR fan-out DAG, its
             whole output state word for word; POTRF (K2), TRSMCOL (K3),
             TRSM (K5) and UPDROW (K4) at tile 512 on make_spd(8192) tiles,
             within 1e-5 of the largest magnitude; the UTS engine (K6) on
             three small trees at lanes (8, 128) and on T1 and T5 at the
             card's lanes, counts equal. Kernel, plain and library times
             (CUDA events, after a warm-up) and each kernel's bound; the
             UTS bound counts one SHA-1 child's instructions in the built
             library's SASS (cuobjdump), printed as the ``sass`` line.
3. fib     - device_fib(24): 46,368 with 225,073 tasks executed.
4. uts     - device_uts_mk at max_depth=20: the plain scheduler's count.
5. cholesky- device_cholesky at n=8192, tile 512 (151 tasks), residual
             ||LL^T - A||_max / ||A||_max < 1e-6 in float64 on the card.
6. uts_canonical - uts_fused on T1, T5, T2 and T1L (at two root
             targets) at the card's lanes: their exact (nodes, leaves,
             max depth), T1L's the same at both targets.
7. cholesky_unfused - device_cholesky(fused_trsm=False) at n=8192, tile
             512 (256 tasks), the same residual bound, and its largest
             difference from phase 5's L.

Phases 3-7 are the main path: launch counts are zeroed just before each
and read just after it. Then one ``{"kernels": [...]}`` line (each
kernel's launches summed over the main path, its times and its bound),
the card's name and power limit from nvidia-smi, and last
``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before that last line; without a
card, or outside a checkout of the repo, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_F32 = 67e12    # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12  # H100 SXM device memory bytes/s
SMS = 132  # H100 SXM
# Thread operations an SM issues a clock (4 schedulers x 32 lanes), and of
# those, the most on the ALU pipe (logic, shifts, IADD3, compares) and on
# the FMA pipe's integer half (IMAD, IMUL): 64 each (NVIDIA H100 white
# paper: 64 INT32 and 128 FP32 lanes an SM).
ISSUE_PER_CLK, ALU_PER_CLK, IMAD_PER_CLK = 128, 64, 64
ALU_OPS = {"LOP3", "LOP", "SHF", "SHL", "SHR", "IADD3", "IADD", "ISETP",
           "SEL", "LEA", "PRMT", "IMNMX", "VIMNMX", "IABS", "FLO", "POPC",
           "BMSK", "BREV", "PLOP3", "ISCADD", "SGXT"}
IMAD_OPS = {"IMAD", "IMUL", "IDP"}
TOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` reading of the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_ops(lib_path, kernels) -> dict:
    """{kernel: {"alu", "imad", "all": instruction counts}} of every
    kernel in a built library's SASS (cuobjdump; the padding NOPs left
    out); fails unless the named ``kernels`` are among them."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = {"alu": 0, "imad": 0, "all": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if cur is None or m is None or m.group(1) == "NOP":
            continue
        op = m.group(1)
        c = counts[cur]
        c["all"] += 1
        c["alu"] += op in ALU_OPS
        c["imad"] += op in IMAD_OPS
    check(set(kernels) <= set(counts), f"SASS of {sorted(kernels)} not all "
          f"found in {lib_path} (found {sorted(counts)})")
    return counts


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
    from hclib_tpu_torch.device import uts_vec as tuv
    from hclib_tpu_torch.device import workloads as tw
    from hclib_tpu_torch.device.descriptor import TaskGraphBuilder
    from hclib_tpu_torch.device.uts_fused import CARD_LANES, UtsLaunch, uts_fused
    from hclib_tpu_torch.models import uts as tm
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
    _build.library("uts")
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

    # K5: TRSM(1, 0) on the kernel's POTRF output (the unfused graph's
    # body: one tile of TRSMCOL's column)
    kt_, pt_ = clone(after2), clone(after2)
    tc.trsm(kt_["tiles"], kt_["linvsp"], kt_["lsp"], 1, 0)
    tc.trsm_plain(pt_["tiles"], pt_["linvsp"], pt_["lsp"], 1, 0)
    torch.cuda.synchronize()
    r_s, e_s = rel(kt_["tiles"][1, 0], pt_["tiles"][1, 0])
    check(r_s < TOL, f"trsm differs from plain ({r_s})")
    hi, lo = split_bf16(kt_["tiles"][1, 0])
    check(torch.equal(hi, kt_["lsp"][1, 0, 0])
          and torch.equal(lo, kt_["lsp"][1, 0, 1]),
          "trsm's stored split is not split_bf16 of its result")
    del kt_, pt_
    t10 = after2["tiles"][1, 0].clone()
    scratch = clone(after2)

    def restore_t10():
        scratch["tiles"][1, 0].copy_(t10)

    ms = events_ms(lambda: tc.trsm(scratch["tiles"], scratch["linvsp"],
                                   scratch["lsp"], 1, 0), 3, restore_t10)
    pms = events_ms(lambda: tc.trsm_plain(
        scratch["tiles"], scratch["linvsp"], scratch["lsp"], 1, 0), 3,
        restore_t10)
    lms = events_ms(lambda: torch.matmul(t10, inv_t), 3)
    kb = bound(2.0 * ts ** 3, 4 * tt + 4 * tt + 4 * tt + 4 * tt)
    kernels["trsm"] = {
        "name": "trsm", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/tiles.cuh",
        "replaces": "hclib_tpu/device/cholesky.py:95",
        "max_abs_err": e_s, "ms": ms, "plain_ms": pms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": lms,
    }
    emit({"phase": "check", "kernel": "trsm", "tile": [1, 0],
          "rel_err": r_s, "split_bit_exact": True,
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

    # 2. check: the UTS engine (K6) ------------------------------------
    # Its bound: every node is one SHA-1 child. Its instructions are read
    # from the built library's SASS (uts_sha1_ops less uts_copy_ops, see
    # csrc/uts.cu); a node takes at least the largest of ALU ops / 64,
    # IMAD ops / 64 and all ops / 128 SM clocks, over 132 SMs at the SM's
    # maximum clock. The child count and stack traffic are left out, so
    # this is a floor.
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    ops = sass_ops(_build.lib_path("uts"), {"uts_sha1_ops", "uts_copy_ops"})
    sha1 = {k: ops["uts_sha1_ops"][k] - ops["uts_copy_ops"][k]
            for k in ("alu", "imad", "all")}
    check(sha1["all"] > 80 * 3 and sha1["alu"] > 0,
          f"SHA-1 child SASS counts {sha1} are implausible")
    node_clocks = max(sha1["alu"] / ALU_PER_CLK, sha1["imad"] / IMAD_PER_CLK,
                      sha1["all"] / ISSUE_PER_CLK)
    node_by = ("ALU pipe" if node_clocks == sha1["alu"] / ALU_PER_CLK
               else "FMA pipe" if node_clocks == sha1["imad"] / IMAD_PER_CLK
               else "issue")

    def uts_bound_ms(nodes):
        return nodes * node_clocks / (SMS * clock_hz) * 1e3

    emit({"phase": "sass", "kernel": "uts", "sha1_child_ops": sha1,
          "sass": ops, "sm_clocks_a_node": node_clocks, "bound_by": node_by,
          "sm_clock_hz": clock_hz})

    def uts_totals(seed, outs):
        check(not outs[4], "uts engine left work undone")
        return (seed[0] + int(outs[0].sum(dtype=torch.int64)),
                seed[1] + int(outs[1].sum(dtype=torch.int64)),
                max(seed[2], int(outs[2].max())))

    def uts_pair(params, target, lanes):
        """The kernel (staged once on the card) and the plain lockstep
        engine on the same staged roots: (kernel triple, plain triple,
        kernel ms, plain ms, device nodes)."""
        seed = tuv._host_seed(params, target)
        sg = tuv.stage_roots(params, seed[3], seed[4], seed[5], lanes)
        args, kw = sg.engine_args(dev, (1 << 31) - 1, lanes)
        run = UtsLaunch(*args, **kw)
        run.launch()
        got = uts_totals(seed, run.collect())
        t0 = time.perf_counter()
        want = uts_totals(seed, tuv._uts_dfs(*args, **kw))
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        ms = run.time_ms(3)
        check(uts_totals(seed, run.collect()) == got,
              "uts kernel counts differ between launches")
        return got, want, ms, pms, got[0] - seed[0]

    small = (
        ("fixed", tm.UTSParams(shape=tm.FIXED, gen_mx=7, b0=4.0,
                               root_seed=19), 256),
        ("linear", tm.UTSParams(shape=tm.LINEAR, gen_mx=8, b0=4.0,
                                root_seed=34), 128),
        ("cyclic", tm.UTSParams(shape=tm.CYCLIC, gen_mx=1, b0=6.0,
                                root_seed=502), 8),
    )
    for name, params, target in small:
        got, want, ms, pms, _ = uts_pair(params, target, (8, 128))
        spec = tm.count_seq(params)
        check(got == want == spec,
              f"uts {name}: kernel {got}, plain {want}, count_seq {spec}")
        emit({"phase": "check", "kernel": "uts", "tree": name,
              "lanes": [8, 128], "nodes_leaves_maxd": list(got),
              "equal": True, "kernel_ms": ms, "plain_ms": pms})
    # At the card's lanes (the main path's shape): T1 (FIXED, 16-level
    # stack) gives the kernels line; T5 (LINEAR: the per-depth table in
    # shared memory, 32-level stack) is held to the plain engine too.
    nlanes = CARD_LANES[0] * CARD_LANES[1]
    for name, params, want_triple in (
            ("T1", tm.T1, (4130071, 3305118, 10)),
            ("T5", tm.T5, (4147582, 2181318, 20))):
        got, want, ms, pms, dnodes = uts_pair(params, nlanes // 2,
                                              CARD_LANES)
        check(got == want == want_triple,
              f"uts {name} at the card's lanes: kernel {got}, plain {want}")
        emit({"phase": "check", "kernel": "uts", "tree": name,
              "lanes": list(CARD_LANES), "target_roots": nlanes // 2,
              "nodes_leaves_maxd": list(got), "equal": True,
              "device_nodes": dnodes, "kernel_ms": ms, "plain_ms": pms,
              "bound_ms": uts_bound_ms(dnodes),
              "library": "none: no PyTorch call counts SHA-1 trees"})
        if name == "T1":
            kb = (uts_bound_ms(dnodes), "operations")
            kernels["uts"] = {
                "name": "uts", "route": "cuda",
                "source": "hclib_tpu_torch/csrc/uts.cu",
                "replaces": "hclib_tpu/device/uts_pallas.py:208",
                "max_abs_err": 0.0, "ms": ms, "plain_ms": pms,
                "bound_ms": kb[0], "bound_by": kb[1], "library_ms": None,
            }

    # The main path: each phase's launches, zeroed just before it ------
    path_launches = {}

    def path_done(name) -> dict:
        path_launches[name] = dict(_build.LAUNCHES)
        return {k: v for k, v in _build.LAUNCHES.items() if v}

    # 3. fib(24)
    _build.reset_launches()
    t0 = time.perf_counter()
    v, info = tw.device_fib(24, capacity=768, device="cuda")
    dt = time.perf_counter() - t0
    check(v == 46368, f"fib(24) = {v}")
    check(info["executed"] == 225073, f"fib(24) executed {info['executed']}")
    launches = path_done("fib")
    t0 = time.perf_counter()
    check(tw.device_fib(24, capacity=768, device="cpu")[0] == v,
          "plain fib(24) differs")
    emit({"phase": "fib", "n": 24, "value": v, "executed": info["executed"],
          "allocated": info["allocated"], "seconds": dt,
          "tasks_per_s": info["executed"] / dt,
          "plain_host_seconds": time.perf_counter() - t0,
          "bound_ms": bound(0.0, info["executed"] * 136.0)[0],
          "launches": launches})

    # 4. UTS at max_depth=20
    _build.reset_launches()
    t0 = time.perf_counter()
    nodes, info = tw.device_uts_mk(max_depth=20, device="cuda")
    dt = time.perf_counter() - t0
    check(nodes == uts_plain_nodes, f"UTS nodes {nodes} != plain "
          f"{uts_plain_nodes}")
    check(nodes == 498965, f"UTS nodes {nodes} != 498965")
    emit({"phase": "uts", "max_depth": 20, "nodes": nodes,
          "plain_nodes": uts_plain_nodes, "seconds": dt,
          "nodes_per_s": nodes / dt,
          "bound_ms": bound(0.0, info["executed"] * 136.0)[0],
          "launches": path_done("uts")})

    # 5. Cholesky n=8192, tile 512
    _build.reset_launches()
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
          "estimated_body_ms": est, "launches": path_done("cholesky")})
    del Ld

    # 6. UTS on the canonical trees at the card's lanes. T1L at the
    # default target (16 roots a lane) and at one a lane (less host
    # seeding, a longer tail on the card); the 4M-node trees at half a
    # root a lane, where the default would leave the host BFS the whole
    # tree.
    _build.reset_launches()
    canonical = (
        ("T1", tm.T1, nlanes // 2, (4130071, 3305118, 10)),
        ("T5", tm.T5, nlanes // 2, (4147582, 2181318, 20)),
        ("T2", tm.T2, nlanes // 2, (4117769, 2342762, 81)),
        ("T1L", tm.T1L, None, (102181082, 81746377, 13)),
        ("T1L_1_root_a_lane", tm.T1L, nlanes, (102181082, 81746377, 13)),
    )
    trees = {}
    for name, params, target, want in canonical:
        r = uts_fused(params, target_roots=target)
        triple = (r["nodes"], r["leaves"], r["max_depth"])
        check(triple == want, f"uts {name}: {triple} != {want}")
        check(r["roots"] > 0, f"uts {name}: the host consumed the tree")
        trees[name] = {k: r[k] for k in (
            "nodes", "leaves", "max_depth", "roots", "host_seed_nodes",
            "device_nodes", "steps", "seed_seconds", "device_seconds",
            "nodes_per_sec", "lane_efficiency")}
        trees[name]["target_roots"] = target or 16 * nlanes
        trees[name]["bound_ms"] = uts_bound_ms(r["device_nodes"])
    emit({"phase": "uts_canonical", "lanes": list(CARD_LANES),
          "trees": trees, "launches": path_done("uts_canonical")})

    # 7. Cholesky n=8192, tile 512, unfused graph (tile TRSM tasks)
    _build.reset_launches()
    L2, info = tc.device_cholesky(a, tile=ts, fused_trsm=False,
                                  device="cuda")
    check(info["executed"] == nt + nt * (nt - 1),
          f"unfused cholesky executed {info['executed']}")
    Ld = L2.double()
    resid = float((Ld @ Ld.T - A).abs().max() / A.abs().max())
    check(resid < 1e-6, f"unfused cholesky residual {resid}")
    emit({"phase": "cholesky_unfused", "n": n, "tile": ts,
          "tasks": info["executed"], "dispatch": info["dispatch"],
          "residual": resid, "max_abs_diff_vs_fused": float(
              (L2 - L).abs().max()),
          "seconds": info["seconds"],
          "gflops": (n ** 3 / 3.0) / info["seconds"] / 1e9,
          "launches": path_done("cholesky_unfused")})
    del A, Ld, L, L2

    # Launches of the main path ----------------------------------------
    for name, k in kernels.items():
        k["launches"] = sum(p[name] for p in path_launches.values())
        check(k["launches"] > 0, f"{name} was not launched on the main path")
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    emit({"kernels": [{f: k[f] for f in order} for k in kernels.values()]})

    print(smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
