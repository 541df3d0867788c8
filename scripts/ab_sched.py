"""Same-card A/B of the scalar scheduler megakernel across source trees.

Times the two scheduler main-path graphs of the port, fib(24) (capacity
768) and the UTS tree at max_depth=20, scalar and, where the tree has the
batch tier, at batch_width=8, and, where it has the graph frontier, the
static SSSP arms of chip_smoke.py's graph_bench phase (bench.py --graph's
rmat_edges(9, efactor=8, seed=7), capacity 4096, width 0 and 8, the
policy instance), and, where the tree has the flight recorder and the
quiesce poll, fib(24) and UTS with the trace ring on (1,024 records) and
with checkpoint on at stride 1 (``*_trace``, ``*_ckpt``), on each given
checkout of the repo, in
fresh processes that alternate between the trees (A B B A, ``--rounds``
times), so that two versions of ``csrc/megakernel.cu`` are compared within
one call on one card. Each process builds (or reuses) its tree's
libraries, warms up, and times ``--reps`` launches by CUDA events, the
graph staged anew outside the timed window. Prints one JSON line per
process, ``ptxas`` register and stack figures of each ``mk_kernel``
instance per tree,
the card's name and power limit, and a summary line of medians per tree.
Beside the scheduler, the resident kernel's steal-only configuration
(ICIStealMegakernel on FOREST_STEAL_BENCH at 8 CTAs and on 2,048 x
fib(12) at 128 CTAs, ``resident8`` and ``resident128``: each launch's
CUDA-event time), and, where the tree has them, the same runs of its
observed instance traced (4,096 records a device; ``resident8_trace``,
``resident128_trace``) and traced and checkpoint-built (``resident8_obs``,
``resident128_obs``), each with its rounds, rows exported, stat words
sent and port header (``p_inbox`` words); these cells are launched
interleaved, one launch of each per rep. Also the ptxas figures of
every stream and mesh kernel instance, those of the injecting user
libraries included.

    python3 scripts/ab_sched.py --tree parent=chipcheck/parent --tree change=.

Needs the card (and ``nvcc`` for the ``ptxas`` figures).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile


def worker(root: str, reps: int, only) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from hclib_tpu_torch import _build
    from hclib_tpu_torch.device import workloads as tw
    from hclib_tpu_torch.device.descriptor import TaskGraphBuilder

    _build.build_all()
    graphs = [
        ("fib24", lambda **kw: tw.make_fib_megakernel(768, device="cuda",
                                                      **kw),
         tw.FIB, [24], 0, 225073),
        ("uts20", lambda **kw: tw.make_uts_megakernel(
            max_depth=20, device="cuda", **kw), tw.UTS_NODE, [1, 0], None,
         None),
    ]
    # The batched forms, where the tree has the batch tier.
    graphs += [(name + "_b8", lambda make=make: make(batch_width=8), *rest)
               for name, make, *rest in graphs[:2]]
    # The observed instances, where the tree has them.
    graphs += [(name + suffix, lambda make=make, kw=kw: make(**kw), *rest)
               for name, make, *rest in graphs[:2]
               for suffix, kw in (("_trace", {"trace": 1024}),
                                  ("_ckpt", {"checkpoint": True}))]
    staged = []
    for name, make, fn, args, slot, want in graphs:
        def setup(make=make, fn=fn, args=args, slot=slot):
            mk = make()
            b = TaskGraphBuilder()
            b.add(fn, args=args, **({} if slot is None else {"out": slot}))
            return mk, b, None, None
        staged.append((name, setup, want))
    try:
        from hclib_tpu_torch.device import frontier as tf
    except ImportError:
        tf = None
    if tf is not None:
        g9 = tf.Graph(*tw.rmat_edges(9, efactor=8, seed=7))
        for width in (0, 8):
            def setup(width=width):
                mk = tf.make_frontier_megakernel(
                    tf.sssp_kernel(), g9, width=width, capacity=4096,
                    device="cuda")
                b, iv, data = tf.frontier_state("sssp", g9, mk)
                return mk, b, data, iv
            staged.append((f"sssp9_w{width}", setup, None))
    out = {}
    # The steal kernels (the resident kernel steal-only, ICIStealMegakernel
    # on a power-of-two mesh): FOREST_STEAL_BENCH at 8 CTAs and 2,048 x
    # fib(12) at 128 CTAs, each launch's CUDA-event time.
    from hclib_tpu_torch.device import resident as rs
    from hclib_tpu_torch.device import stress
    from hclib_tpu_torch.device.ici_steal import ICIStealMegakernel
    from hclib_tpu_torch.parallel.mesh import CtaMesh

    fb = stress.FOREST_STEAL_BENCH
    obs = {"trace": 4096, "checkpoint": True}
    steal = {}
    for name, ndev, roots, kw in (
            ("resident8", 8, fb["roots"], {}),
            ("resident128", 128, 2048, {}),
            ("resident8_trace", 8, fb["roots"], {"trace": 4096}),
            ("resident128_trace", 128, 2048, {"trace": 4096}),
            ("resident8_obs", 8, fb["roots"], obs),
            ("resident128_obs", 128, 2048, obs)):
        if only and name not in only:
            continue
        try:
            mk = stress.forest_megakernel(roots, fb["capacity"], 0, "cuda",
                                          **kw)
            m = ICIStealMegakernel(mk, CtaMesh((ndev,), ("q",)),
                                   migratable_fns=[tw.FIB], window=8)
        except (NotImplementedError, TypeError):
            continue  # an arm this tree does not have
        m.run(stress.forest_builders(ndev, roots, fb["n"]), quantum=64)
        # The port header of this launch (resident.run_mesh_kernel's
        # rule): P_INBOX words, or in a checkpoint build the stat slab
        # with the quiesce sum rounded up to 8 words.
        p_inbox = (rs.P_STAT + -(-(rs.STAT_WORDS + 1) // 8) * 8
                   if kw.get("checkpoint") else rs.P_INBOX)
        steal[name] = (m, ndev, roots, p_inbox)
    # Interleaved: each rep launches every cell once, forwards on even
    # reps and backwards on odd ones, so no cell always runs first.
    names = list(steal)
    for i in range(reps):
        for name in names if i % 2 == 0 else names[::-1]:
            m, ndev, roots, p_inbox = steal[name]
            iv, _, info = m.run(stress.forest_builders(ndev, roots, fb["n"]),
                                quantum=64)
            stress.check_forest(iv, info, roots, fb["n"])
            cell = out.setdefault(name, {"ms": []})
            cell["ms"].append(info["exchange"]["kernel_ms"])
            cell.update(executed=info["executed"],
                        rounds=info["steal_rounds"],
                        rows=sum(info["exchange"]["rows"]),
                        stat_words=sum(info["exchange"]["stat_words"]),
                        p_inbox=p_inbox)
    for name, setup, want in staged:
        if only and name not in only:
            continue
        try:
            mk, b, data, iv = setup()
        except (NotImplementedError, TypeError):
            continue  # an arm this tree does not have
        mk.launch(mk.state(b, data=data, ivalues=iv))  # warm-up
        times = []
        for _ in range(reps):
            st = mk.state(b, data=data, ivalues=iv)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            mk.launch(st)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        executed = int(st["counts"][5])
        if want is not None and executed != want:
            raise SystemExit(f"{root}: {name} executed {executed} != {want}")
        out[name] = {"ms": times, "executed": executed}
    return out


def user_sources(root: str) -> dict:
    """The generated sources, in tree ``root``, of the injecting user
    libraries (the fib forest's steal-only, the PGAS exchange's, the bump
    table's that tenancy runs): their resident kernel polls the ring."""
    sys.path.insert(0, os.path.abspath(root))
    from hclib_tpu_torch.device import stress
    from hclib_tpu_torch.device.workloads import make_fib_megakernel

    return {"fib_inject": make_fib_megakernel(16, device="cpu").user_source(
                False, inject=True),
            "pgas_inject": stress.pgas_megakernel(device="cpu").user_source(
                True, inject=True),
            "bump_inject": stress.bump_megakernel("cpu").user_source(
                False, inject=True)}


def _parse_ptxas(lines, prefix: str = "") -> dict:
    """Registers, stack frame and spills of each kernel instance that
    ptxas -v compiled (see ``ptxas``), under ``prefix`` + its key."""
    out = {}
    for i, line in enumerate(lines):
        if "Compiling" not in line:
            continue
        m = re.search(r"mk_kernelILi(\d)E(?:Lb(\d)E)?", line)
        if m:
            key = m.group(1) + ("+obs" if m.group(2) == "1" else "")
        else:
            m = re.search(r"\d((?:mk_grid|ici_ring|resident_steal|resident|"
                          r"stream)_kernel)I(.*?)Ev", line)
            if not m:
                continue
            # Every flag of the template, the body table's class skipped;
            # trailing false flags past the first (the ring) or the third
            # dropped, so an instance keeps its key when a later flag
            # (default false) is added.
            flags = re.findall(r"L[bi](\d+)E", m.group(2))
            keep = 1 if m.group(1) == "ici_ring_kernel" else 3
            while len(flags) > keep and flags[-1] == "0":
                flags.pop()
            key = m.group(1) + "<" + ",".join(flags) + ">"
        text = " ".join(lines[i:i + 4])
        out[prefix + key] = {k: int(v) for v, k in re.findall(
            r"(\d+) (bytes stack frame|bytes spill stores|registers)",
            text)}
    return out


def ptxas(root: str) -> dict:
    """Each ``mk_kernel`` instance's registers, stack frame and spills
    from ptxas -v, by its kMode ("+obs": the observed instance), each
    instance of the stream kernel and the mesh kernels (the grid launch,
    the ring, the resident kernel) by its name and template flags, and
    those of the injecting user libraries (``user_sources``) under
    ``<library>:``; the sources compiled at once, one nvcc each."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    csrc = os.path.join(root, "hclib_tpu_torch", "csrc")
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-c", "-o", os.devnull, "-Xptxas", "-v", "-I", csrc]
    srcs = {"": os.path.join(csrc, "megakernel.cu")}
    tmp = tempfile.mkdtemp(prefix="ab-ptxas-")
    try:
        gen = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--sources", root], capture_output=True,
                             text=True)
        if gen.returncode == 0:
            for name, text in json.loads(gen.stdout).items():
                srcs[name + ":"] = os.path.join(tmp, name + ".cu")
                with open(srcs[name + ":"], "w") as f:
                    f.write(text)
        procs = {k: subprocess.Popen([nvcc, *flags, src],
                                     stderr=subprocess.PIPE, text=True)
                 for k, src in srcs.items()}
        out = {}
        for prefix, p in procs.items():
            err = p.communicate()[1]
            out.update(_parse_ptxas(err.splitlines(), prefix) or {
                prefix + "error": err[-400:]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a checkout (two or more)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--graphs", default="",
                    help="comma-separated subset of fib24, uts20, fib24_b8, "
                    "uts20_b8, fib24_trace, uts20_trace, fib24_ckpt, "
                    "uts20_ckpt, sssp9_w0, sssp9_w8, resident8, "
                    "resident128, resident8_trace, resident128_trace, "
                    "resident8_obs, resident128_obs (default: all)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--sources", help=argparse.SUPPRESS)
    ns = ap.parse_args()
    if ns.sources:
        print(json.dumps(user_sources(ns.sources)))
        return 0
    if ns.worker:
        print(json.dumps(worker(ns.worker, ns.reps,
                                set(filter(None, ns.graphs.split(","))))))
        return 0
    trees = dict(t.split("=", 1) for t in ns.tree)
    if len(trees) < 2:
        ap.error("give two or more --tree name=path")
    import torch

    if not torch.cuda.is_available():
        print("ab_sched.py: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0])
    for name, root in trees.items():
        print(json.dumps({"tree": name, "ptxas_mk_kernel": ptxas(root)}))
    names = list(trees)
    order = []
    for r in range(ns.rounds):
        order += names if r % 2 == 0 else names[::-1]
        order += names[::-1] if r % 2 == 0 else names
    runs = {n: {} for n in names}
    for name in order:
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             trees[name], "--reps", str(ns.reps), "--graphs", ns.graphs],
            capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stderr[-2000:], file=sys.stderr)
            return 1
        res = json.loads(p.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, **res}))
        for g, r in res.items():
            runs[name].setdefault(g, []).extend(r["ms"])
    summary = {n: {g: {"median_ms": statistics.median(v), "min_ms": min(v),
                       "max_ms": max(v), "n": len(v)}
                   for g, v in runs[n].items()} for n in names}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
