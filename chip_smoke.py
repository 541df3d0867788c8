#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA card, and hold every kernel
of it against its plain version.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build   - compile every ``hclib_tpu_torch/csrc/*.cu`` with nvcc.
2. check   - each kernel against its plain version on the same inputs:
             the megakernel (K1) on fib(11) and the CSR fan-out DAG, its
             whole output state word for word; POTRF (K2), TRSMCOL (K3),
             TRSM (K5), UPDROW (K4) and the batched UPDROW (updrow_batch,
             on the last 4 rows of step 0) at tile 512 on make_spd(8192)
             tiles, within 1e-5 of the largest magnitude; the UTS engine
             (K6) on three small trees at lanes (8, 128) and on T1 and T5
             at the card's lanes, counts equal; the batch tier
             (``batch_tier``: fib(11) and UTS depth 12 at batch_width=8,
             Cholesky n=1024 tile 256 batched: integer state and tstats
             word for word, tiles within 1e-5); the SW bodies (``sw``:
             sw_wave_batch at 512^2 chunk=1 width=2, where the prefetch
             engages, and 1280^2 at the default chunk and width, every
             output buffer and tstats equal, H = sw_seq; sw_tile through
             device_sw at both). Kernel, plain and library times (CUDA
             events, after a warm-up) and each kernel's bound; the UTS and
             SW bounds count one SHA-1 child's / one DP row's instructions
             in the built library's SASS (cuobjdump), the ``sass`` lines.
             The subtree engine (``vector``: its standalone entry against
             the plain runner at lanes (8, 128) on vfib(16) and
             nqueens(8), max_steps 3, 50 and unbounded, nodes, sums,
             overflow flag and steps equal; device_vfib(20) and
             device_nqueens(8) and a routed fib graph on their whole
             output state) and the batched SW score kernel
             (``sw_scores``: against its plain version and sw_seq at
             small shapes, an m that is no multiple of 32 among them).
3. fib     - device_fib(24): 46,368 with 225,073 tasks executed.
4. uts     - device_uts_mk at max_depth=20: the plain scheduler's count.
5. cholesky- device_cholesky at n=8192, tile 512 (151 tasks), UPDROW
             batched (the default): residual ||LL^T - A||_max / ||A||_max
             < 1e-6 in float64 on the card; tiers 120 batched / 120 routed
             / 31 scalar / 0 spilled.
5b. cholesky_scalar_updrow - the same with batch_updrow=False: L equal
             to phase 5's bit for bit.
6. uts_canonical - uts_fused on T1, T5, T2 and T1L (at two root
             targets) at the card's lanes: their exact (nodes, leaves,
             max depth), T1L's the same at both targets.
7. cholesky_unfused - device_cholesky(fused_trsm=False) at n=8192, tile
             512 (256 tasks), the same residual bound, and its largest
             difference from phase 5's L.
8. fib_batch - device_fib(24, batch_width=8): 46,368 / 225,073.
9. uts_batch - device_uts_mk(max_depth=20, batch_width=8): 498,965.
10. sw_wave - device_sw_wave at n = m = 8192, with_h=False, 64 x 64
             tiles (bench.py's configuration): score = the torch sw_vec
             score on the card; GCUPS over the launch's CUDA-event time.
11. sw_engines - device_sw, device_sw_batched and device_sw_wave at
             2048 x 2048 with H: the three H and scores equal.
12. vfib   - device_vfib(30) on the vector tier: 832,040 with 2,692,537
             executed; CUDA-event ms the mean of 3 launches after a
             warm-up, tasks/s; then (outside the launch counts) the
             engine's standalone entry on the same subtree, equal to the
             plain runner, its lock-step steps and lane efficiency.
13. nqueens - device_nqueens(12): 14,200, executed = the sequential count
             of safe placements + 1; the standalone entry as in 12.
14. sw_scores - sw_scores_pallas at B = 1024 pairs, m = 1024, n = 256
             and 2048 (bench.py's bench_device_sw): equal to the plain
             version on the card; ms a launch and the GCUPS slope.
15. forasync_stencil - run_forasync_device on the 5-point stencil at
             H = W = 4096 (16,384 tiles of 8 x 128; PolyBench jacobi-2d
             EXTRALARGE's N = 4000 rounded up to the tile) at width 0 and
             at width 8 with the prefetch: gout (halo included) equal to
             the numpy reference bit for bit; tiles/s, the tiers, the
             bound; then (outside the launch counts) the plain core's
             time at full size and the tile body's standalone entry (the
             same rounds without the scheduler; at width 8 also without
             the prefetch).
16. forasync_map - the same for the map loop at T = 16,384 blocks of
             8 x 128; the library call is torch.add(7, x, alpha=3).
17. arrayadd - device_arrayadd(16384) (16,384 add_tile tasks over
             (16384, 8, 128) f32 buffers): c = a + b bit for bit; the
             library call is torch.add(a, b).
18. graph_bench - run_frontier on bench.py --graph's graph
             (rmat_edges(9, efactor=8, seed=7), 512 vertices, 366 blocks;
             capacity 4096, m0 = 4096, reps = 64): BFS, SSSP and PageRank
             scalar and at width 8 (edge-slab prefetch, lane-age trigger
             at 4 x width), and SSSP at 8 priority buckets (delta-
             stepping): distances equal host_bfs / host_sssp, ranks equal
             host_pagerank_push, delta-SSSP equal to unordered SSSP; TEPS
             over each launch's CUDA-event time, the tiers, the EXPAND
             ratio bucketed / unordered, the bound, and (outside the
             launch counts) the standalone EXPAND entry's round time.
19. graph_scale16 - BFS, SSSP and delta-SSSP at width 8 on
             rmat_edges(16, efactor=16, seed=7) (Graph500's R-MAT and edge
             factor at scale 16: 65,536 vertices, 955,311 edges, 43,587
             blocks; capacity 2^17): equal host_bfs / host_sssp; TEPS,
             tiers, bound, standalone round time.
20. bnb     - run_bnb on bench.py --bnb's instance (make_knapsack(16,
             seed=5), width 4, capacity 2048) unordered and at 8 buckets:
             optimum 609 = host_knapsack_opt; nodes/s.
21. dyngraph_bench - run_dyngraph on bench.py --graph dyngraph's
             configuration uncut (rmat_edges(7, efactor=8, seed=7): 128
             vertices, 707 static edges, 108 static blocks; spare_blocks 2,
             upd_cap 24, capacity 1024; 24 updates and 4 queries drawn from
             default_rng(11) as bench.py draws them): BFS and SSSP at width
             0 and 8, SSSP at 8 buckets, each equal to host_dyngraph with
             24 updates applied, none dropped and spare_in_use =
             spare_needed(); PageRank at width 8 with the mass of
             host_incremental_pagerank; updates/s, query TEPS and
             queries/s as bench.py defines them over the CUDA-event time of
             the width-8 BFS and SSSP launches; then a QUERY stream alone
             (one query a vertex) on SSSP's converged state, equal to the
             host labels.
22. dyngraph_scale16 - phase 19's graph as a DynGraph (spare_blocks 2,
             upd_cap 32,768) with 32,768 updates (3.4% of its 955,311
             edges, bench.py's share and rule: default_rng(11), uniform
             endpoints, weights 1-7) and 64 queries: BFS, SSSP and SSSP at
             8 buckets at width 8, each equal to host_dyngraph with none
             dropped; then the incremental arm: the UPDATE stream alone
             against phase 19's converged SSSP labels laid out on the
             DynGraph, at width 8 and 0, equal to host_dyngraph; ms and
             us a splice, re-expansions included.
23. trace  - the flight recorder (row 1o) on fib(24) (ring 1,024, as
             bench.py traces it; also with the quiesce poll), UTS depth
             20 at width 8 (ring 2^17) and bench.py --graph's width-8 BFS
             (ring 4,096): each build untraced and traced, timed
             alternately in this process; the records reconcile exactly
             with the tier counters (one fire a scalar task between the
             begin and end records; one TR_FIRE_BATCH a batch round whose
             take and prefetched words sum to the tiers); ms a record.
24. checkpoint - quiesce at half the tasks, bundle to a temporary
             directory, restore_megakernel on a fresh build: UTS depth 20
             scalar and at width 8 (the state at the cut equal to the
             plain core's, resumed to 498,965), Cholesky n=8192 tile 512
             (the resumed L equal to phase 5's bit for bit; the bundle
             holds the whole tile buffers), the scale-16 DynGraph's SSSP
             at width 8 with phase 22's 32,768 updates (equal to
             host_dyngraph, none dropped); quiesce entry s, bundle bytes,
             save and restore s. Then the poll with no quiesce on fib(24)
             and UTS 20 (checkpoint off, stride 1, stride 64, timed
             alternately), and the bundle store: publish with and without
             fsync, a cold load_latest clean and past two corrupt
             generations.

The ``check`` phase also holds the tile bodies (``tiles``: fa_stencil
and fa_map at bench.py --forasync's sizes, stencil 64 x 1024 and map
T = 64, at width 0, 8 with and without the prefetch and cut by fuel;
arrayadd on 64 tiles; the standalone tile entry) against the plain core
on the whole output state, and the frontier and knapsack bodies with the
policy scheduler (``frontier``: BFS, SSSP and PageRank on phase 18's
graph scalar and at width 8, delta-SSSP at 8 buckets, and a width-8
PageRank cut by fuel with a prefetch in flight; the standalone EXPAND
entry; ``bnb``: the 12-item knapsack scalar, at width 4 and at 8
buckets), and the dynamic-graph bodies (``dyngraph``: the JAX tests'
graph rmat_edges(5, efactor=4, seed=9) with their 4 updates, spare_blocks
2, upd_cap 16: scalar SSSP with queries, BFS at width 4 unordered and at
2 buckets, PageRank scalar and at width 4, a width-4 SSSP cut by fuel;
and a stream that fills a vertex's spare row and drops, scalar and at
width 4; each with both edge buffers; the spare-exhaustion graph, which
raises on the card as on the CPU), word for word; and the flight
recorder and quiesce poll (``tracebuf``) in each of ``mk_kernel``'s
observed instances 0-5: fib(11), UTS depth 12 at width 8, batched
Cholesky n=1024, the SW wave at 512^2 (chunk 1, width 2), a fib graph
routed to vfib(15)/vfib(16), the stencil at 64 x 1024 width 8, SSSP at
scale 9 with 8 buckets and the scale-7 DynGraph's SSSP at width 8, each
traced and then quiesced at half its tasks: the decoded ring and its
header, qstat and the whole output state equal to the plain core's.

25. serve  - the streaming front door (row 4, csrc/stream.cuh) at real
             load. (a) bench.py --serve's three-lane roster (gold, silver,
             bronze at 4:2:1), egress depth 64, telemetry on, 4,096 SUM
             requests a lane (12,288) submitted into a running fib(20)
             tree on make_fib_megakernel's table (capacity 3 x 4,096 +
             64): every future resolves to its two preset slots' sum,
             fib(20) = 6,765, and every entry boundary while gold still
             holds rows shows installs at exactly 4:2:1; requests/s,
             host-stamped p50/p99 submit to result, the on-device
             histogram's p50/p99 through the entry epoch bracket, entries
             and the launch, entry and host pump/drain time an entry.
             (b) serve_dyngraph("sssp") at scale 16, scalar arm: phase
             22's graph and its 32,768 updates on the updates lane and 64
             queries on the queries lane, each lane's ring region holding
             its whole stream: equal to host_dyngraph, none dropped,
             query_results == query_values, every future RESULT;
             updates/s, query latency, entries and the peak allocated
             rows. Then (outside the launch counts) arm (a) on the plain
             stream: every entry's echoed block, the final state and the
             futures equal to the card's.
26. multichip - the mesh (rows 1 over a mesh, 5 and 7; csrc/mesh.cuh), a
             mesh device being one co-resident CTA: FOREST_STEAL_BENCH
             (8 devices, 160 x fib(12) seeded on device 0, 111,520
             tasks) through the sharded steal runner (stress.forest_steal)
             scalar and at width 8, through ICIStealMegakernel at 8
             devices (the resident steal-only kernel) and at 6 (the
             ring), each exact; the multi-chip dry run's per-device
             queues (8 fib trees, no steal); and the whole card: the
             resident kernel at 128 CTAs on 2,048 x fib(12) (1,427,456
             tasks, exact). Tasks/s, rounds, devices used, imbalance,
             kernel and exchange time and exchange volume an arm; then
             (outside the launch counts) the plain version of every
             timed arm, word for word (the sharded arms' kernel time is
             CUDA events around each round's launch call alone).
27. pgas     - user bodies and the resident kernel's PGAS configuration
             (csrc/user.cuh, csrc/mesh.cuh): first the user library's
             scheduler at full size, fib(24) written as user bodies
             (225,073 tasks, one device, Megakernel.run and timed
             launches: mk_user's ms) and 2,048 such fib(12) roots dealt
             over 128 CTAs through the sharded runner's grid launch
             (1,427,456 tasks); then the multi-chip dry run's
             phases 2, 3 and 4 literally at 8 devices (64 user-body
             BUMPs through the sharded steal at quantum 4, window 8 -
             the user library's scheduler - and through the ICI steal at
             window 32, quantum 16 - the resident kernel steal-only; the
             dry run's put / consume table through PGASMegakernel with
             waits), each held to the dry run's assertions; then the
             PGAS exchange across the whole card: 128 co-resident CTAs,
             every device first reads the landing words its consumer
             will read (so its SM may cache them) and AMs its left
             neighbour a SEND; each SEND AMs a BUMP at every device
             (16,384 messages, am_window 8) and puts its 16 source rows
             (512 B each) into its ring neighbour's heap, whose consumer
             waits on (c0, 16) and sums the landed words: a stale
             cached read would differ (stress.check_pgas: exact).
             Tasks/s, rounds, AMs and puts a second, rows and stat words
             exchanged, the kernel's ms; then (outside the launch counts)
             the plain version of every arm, word for word, data
             buffers included.
28. homed    - homed migration, value-arg rehydration and the remote
             atomics and locks (the resident kernel's migrating
             configuration, csrc/mesh.cuh resident_kernel<.., kHome>,
             and its built-in active messages): the dry run's phase 0
             at 8 CTAs (fib(9) home in slot 3, FADD 7 at its owner);
             stress.unified_load at 8 devices (fib(10) and 32 remote
             fetch-adds), scalar and width 8; the whole card, 128 CTAs:
             fib(24) on device 0 and 2,048 fetch-adds (slot 3 = 46,368,
             slot 2 = 2,098,176, 227,121 tasks); the lock workload on
             128 CTAs (X = Y = 128, the tripwire's TEAR 0, the lock
             released). The kernel's ms, rounds, the built-in messages
             by kind, the proxies' peak and the bound an arm; then
             (outside the launch counts) every arm's plain run, word
             for word.
29. inject   - the injection ring and mesh tenancy (the resident
             kernel's injecting instances, csrc/mesh.cuh
             resident_kernel<.., kInject>, from the tables' user
             libraries): JAX's composition of steal, a put with its
             parked consumer and three injected rows on 4 CTAs
             (compose_4); the two compositions JAX runs only on a TPU,
             on one CTA: the five-way one (steal, fetch-add, lock, put
             and an injected stream; slot 5 = 37, slot 6 = 42) and the
             volume stress (fib(14), 64 fetch-adds, 8 contending
             lockers with the compare-swap tripwire, 4 puts, a 64-row
             stream; executed 1,937); the whole card, 128 CTAs: 160 x
             fib(12) on device 0 steal-only plus 256 FIB(4) rows on
             every device's ring (32,768 rows, 32 MiB of ring; 537,504
             tasks, exact), and four tenant lanes gold / std / bg / late
             at 4:2:1:1 through a MeshTenantTable (3,072 / 2,048 /
             1,024 admissions installed once, late's 512 rows expired on
             the ring and dropped by the card, per-tenant conservation).
             Each arm warmed up (its library's first launch), then timed
             by CUDA events; then (outside the launch counts) each arm's
             plain run, word for word with the tctl echo.
30. faults - the resident kernel's fault plans (resident_kernel<..,
             kFault>, counter resident_fault; scripts/mesh_holds.py
             PHASE30): JAX's fault tests (tests/test_device_faults.py)
             at their shapes - 40 BUMPs on device 0 of 2 CTAs under
             homed migration with a credit dropped at (1, 0, 1), one
             duplicated there and delays at 50 %, and the
             credit_timeout=0 plan, which must raise its StallError
             naming hop 0 and granter device 1 (any other outcome
             fails); 6 BUMPs on each of 8 CTAs with device 3 dead at
             round 2 - then the widest mesh a plan allows (31 devices:
             16 CTAs): UTS depth 20 (498,965 nodes from its root on
             device 0) under homed migration, device 0 dead at round 2
             holding queued rows, credits dropped, doubled and delayed
             at 1, 1 and 10 per mille (stress.UTS_FAULT): exact, rows
             re-homed, device 0 quarantined, every dropped credit
             regenerated; and FOREST_STEAL_BENCH's forest steal-only
             through ICIStealMegakernel with device 0 dead from round 0
             (its whole queue re-homed; stress.FOREST_FAULT). Each arm
             warmed up, then timed by CUDA events; then (outside the
             launch counts) each arm's plain run, word for word with
             every device's fault stats.
31. mesh_ckpt - the resident kernel's quiesce, resume and flight
             recorder (resident_kernel<.., kObs>, counter resident_obs;
             ici_ring_kernel<.., kObs>, counter ici_ring_obs;
             scripts/mesh_holds.py ckpt_phase): UTS depth 20 (498,965
             nodes from one root) on 128 CTAs under homed migration
             (stress.uts_ckpt) without the quiesce word, checkpoint-built
             and traced (8,192 records a device, no wrap: every device's
             round records equal the rounds, the fire records sum to the
             tasks, the TR_XFER rows to the rows exported); quiesced at
             half its rounds, through snapshot_resident, save, load and
             restore_resident on 128 CTAs (seconds each), then
             reshard(64) and resumed on 64 CTAs, every path exact; the
             injected forest (32,768 ring rows on 128 CTAs) cut at round
             0 (every row residue) and at half its rounds, consumed plus
             residue equal to published on every device and the resume
             exact; FOREST_STEAL_BENCH's forest traced on the ring at 6
             CTAs. Each arm warmed up, timed by CUDA events; then
             (outside the counts) every run of the phase but the
             unobserved and uncut ones against its plain run word for
             word (state, wait table, ring residue, ictl and every
             device's decoded records): the tree's cut at 128, traced
             and not, its restore on 128 and its reshard onto 64 (from
             the card's bundle), both of the forest's cuts and their
             resumes, and the traced ring.
32. pgas_ring - PGASMegakernel on a mesh whose size is not a power of
             two (pgas_ring_kernel, counter pgas_ring; JAX's row 6): the
             PGAS exchange on 132 CTAs, every SM of the card
             (stress.pgas_builders(132, burst=True), am_window 8, outbox
             256: 17,562 active messages, 2,112 puts), five runs after a
             warm-up, by CUDA events; the dry run's phase 4 literally at
             3 and 6 CTAs; the exchange traced at 6; mesh_holds' fan (FIB
             roots sent as active messages, FIB at width 8) on 6. Each
             exact, then (outside the counts) held to its plain run word
             for word, records included; the card's name and power limit
             beside every number.

The ``user`` lines, before the main path, hold the user-body
scheduler on one device to the plain core (``scripts/mesh_holds.py``
USER_CASES, one table of user bodies: the alloc/free chain, the
built-in fib beside a user BUMP, fib written as user bodies), the whole
state word for word. The ``mesh`` lines hold the mesh
kernels (the sharded runner's grid launch, the ring, the resident
kernel steal-only and its PGAS configuration, the user library's
scheduler and resident kernel) to their plain versions word for word
on the cases of ``scripts/mesh_holds.py``: FOREST_STEAL_QUICK's forest
through the sharded runner with and without steal, at width 8 and with
a hop order, the ring at 1, 3 and 6 devices (with an abort, and at
width 8) and the resident kernel at 2, 4 and 8 (with a hop order, an
abort, at width 8):
every device's value slots and counts, the rounds, the tier counters,
the fault stats and the rows each device exported; and the dry run's
phases 2 and 3 and the PGAS exchange at 2, 4 and 8 devices (with steal
beside it at 8), data buffers and messages and puts sent included; and
the migrating configuration on JAX's homed fib tests (2 and 8 devices,
a 2x2x2 mesh, width 8 at 8) and the lock workload at 4 devices, their
proxies and built-in messages included; and the injecting instances on
the forest with injected FIB rows (8 devices), the PGAS exchange with
injected BUMPs (4 devices, and 8 with steal), JAX's three compositions
that inject, and four tenant lanes on 4 devices with a 16-row table,
the tctl echo included; and each instance with the fault layer (the
forest steal-only with a dead device and credit faults, scalar and at
width 8; the dry run's BUMPs steal-only and the PGAS exchange with
steal under credit faults; the two fixtures of
tests/test_torch_faults.py; the credit_timeout=0 plan's StallError); and
each observed instance (``OBS_CASES``: the flight recorder and the
quiesce word of the built-in steal-only instances, with lanes and with
the fault layer, of the ring, and of the user libraries' PGAS,
migrating, injecting, tenant and fault variants) on the CPU tests'
fixtures' shapes and at 8 CTAs, each quiesce's exported state and the
resumed run included; and PGASMegakernel's ring kernel
(``RING_CASES``: the PGAS exchange at 3 and 6 CTAs, traced and not and
cut by an abort, the dry run's phase 4 at 3 and 6, the fan at width 8),
records included.

The ``stream`` lines, before the main path, hold the stream kernel
(``csrc/stream.cuh``, instances 0, 4 and 5) to the plain stream word for
word on the cases of ``scripts/stream_holds.py``: a fib firehose with
rows found mid-entry, three lanes with a depth-4 mailbox that parks,
expiry and quarantine, an abort, a quiesce bundled and restored on a
fresh stream, serve_dyngraph on bench.py --graph dyngraph's scale-7
configuration and a static SSSP table streamed on bench.py --graph's
graph; each traced and untraced: every entry's echoed control block,
the final state, the futures, the info and the decoded trace records.

Phases 3-32 are the main path: launch counts are zeroed just before each
and read just after it. Then one ``{"kernels": [...]}`` line (each
kernel's launches summed over the main path, its times and its bound),
the card's name and power limit from nvidia-smi, and last
``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero before that last line; without a
card, or outside a checkout of the repo, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_F32 = 67e12    # H100 SXM f32 FLOP/s outside the tensor cores
# H100 SXM dense bf16 tensor-core FLOP/s (f32 accumulation). The Cholesky
# tile products take bf16 hi/lo split operands: three bf16 products each
# (hi*hi + hi*lo + lo*hi, ops/tiles.py mm_nt_split), bound at this rate.
PEAK_BF16 = 989e12
SPLIT_PASSES = 3
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
# Warp shuffles: 32 thread results an SM a clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0).
SHFL_PER_CLK = 32
SHFL_OPS = {"SHFL"}
TOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(flops: float, nbytes: float, peak: float = PEAK_F32):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` reading of the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_ops(lib_path, kernels) -> dict:
    """{kernel: {"alu", "imad", "shfl", "all": instruction counts}} of every
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
            counts[cur] = {"alu": 0, "imad": 0, "shfl": 0, "all": 0}
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
        c["shfl"] += op in SHFL_OPS
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
    from hclib_tpu_torch.device import bnb as tb
    from hclib_tpu_torch.device import cholesky as tc
    from hclib_tpu_torch.device import dyngraph as td
    from hclib_tpu_torch.device import frontier as tf
    from hclib_tpu_torch.device import forasync_tier as tfa
    from hclib_tpu_torch.device import smithwaterman as tsw
    from hclib_tpu_torch.device import sw_pallas as tsp
    from hclib_tpu_torch.device import tracebuf as ttb
    from hclib_tpu_torch.device import vector_engine as tv
    from hclib_tpu_torch.device import uts_vec as tuv
    from hclib_tpu_torch.device import workloads as tw
    from hclib_tpu_torch.device import megakernel as tmk
    from hclib_tpu_torch.device.descriptor import TaskGraphBuilder
    from hclib_tpu_torch.device.state import numpy_of
    from hclib_tpu_torch.device.uts_fused import CARD_LANES, UtsLaunch, uts_fused
    from hclib_tpu_torch.models import uts as tm
    from hclib_tpu_torch.device.sw_vec import sw_score_one
    from hclib_tpu_torch.models.cholesky import make_spd
    from hclib_tpu_torch.models.nqueens import count_seq as nq_count
    from hclib_tpu_torch.models.smithwaterman import random_seq, sw_seq
    from hclib_tpu_torch.ops.tiles import split_bf16, unsplit
    from hclib_tpu_torch.runtime import checkpoint as tck

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

    def timed_launch(mk, b, data=None, reps=3, agg=np.median, ivalues=None):
        """Median (or ``agg``) CUDA-event ms of ``mk.launch`` on ``b``'s
        state, staged anew before each launch outside the timed window,
        after a warm-up; every launch's bodies are folded into the launch
        counts. Returns (ms, the last launch's state)."""
        st = mk.state(b, data=data, ivalues=ivalues)
        mk.fold_dispatches(mk.launch(st))
        times = []
        for _ in range(reps):
            st = mk.state(b, data=data, ivalues=ivalues)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            d = mk.launch(st)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
            mk.fold_dispatches(d)
        return float(agg(times)), st

    def raw_state(mk, b, data=None, fuel=1 << 22, ivalues=None,
                  quiesce=None):
        """Every output of one launch on ``b`` (state, tstats, data; an
        observed build's qstat, ring header and decoded records)."""
        st = mk.state(b, data=data, ivalues=ivalues)
        mk.launch(st, fuel, quiesce=quiesce)
        out = {k: st[k].cpu() for k in ("tasks", "ready", "counts",
                                         "ivalues", "tstats", "qstat")
               if k in st}
        out.update({"data." + k: v.cpu() for k, v in st["data"].items()})
        if "trace" in st:
            ring = st["trace"].cpu()
            out["trace.header"] = ring[:ttb.HDR].clone()
            out["trace.records"] = torch.from_numpy(
                ttb.decode_ring(ring.numpy())["records"])
        return out

    def ints_equal(got, want, what):
        """Check every integer output against the plain version's; the
        largest absolute difference (0 when they agree)."""
        err = 0
        for k, v in want.items():
            if not v.is_floating_point():
                check(torch.equal(got[k], v), f"{what}: {k} differs from "
                      "the plain version")
                err = max(err, int((got[k].long() - v.long()).abs().max())
                          if v.numel() else 0)
        return float(err)

    def plain_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out

    # 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import mesh_holds

    # Every library at once, one nvcc each, but USER_TABLE's user
    # library, built alone after them: one user library's own build time.
    alone = mesh_holds.user_megakernel(16, "cpu").user_source()
    per_source = _build.build_all(user_sources=[
        src for src in mesh_holds.user_sources() if src != alone])
    _build.library("megakernel")
    _build.library("uts")
    _build.library("sw_scores")
    t1 = time.perf_counter()
    alone_s = {k: v for k, v in _build.build_all(
        user_sources=[alone]).items() if k.startswith("user-") and v}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": per_source, "user_library_alone": alone_s,
          "user_library_alone_wall_s": time.perf_counter() - t1})

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
    kb = bound(SPLIT_PASSES * 2.0 * m * ts ** 3,
               4 * m * tt + 4 * tt + 4 * m * tt + 4 * m * tt, PEAK_BF16)
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
    kb = bound(SPLIT_PASSES * 2.0 * ts ** 3,
               4 * tt + 4 * tt + 4 * tt + 4 * tt, PEAK_BF16)
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
    kb = bound(SPLIT_PASSES * 2.0 * m * ts ** 3,
               4 * tt + 4 * m * tt + 4 * m * tt + 4 * m * tt, PEAK_BF16)
    kernels["updrow"] = {
        "name": "updrow", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/tiles.cuh",
        "replaces": "hclib_tpu/device/cholesky.py:271",
        "max_abs_err": e_u, "ms": ms, "plain_ms": pms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": lms,
    }
    emit({"phase": "check", "kernel": "updrow", "rel_err": r_u,
          "kernel_ms": ms, "plain_ms": pms, "library_ms": lms})

    # K9: the batched UPDROW body on the last UPD_B rows of step 0, on the
    # kernel's TRSMCOL output: against its plain version, and bit for bit
    # against UPD_B standalone UPDROW launches (the same device function)
    rows = [(nt - 1 - r, 0) for r in range(tc.UPD_B)]
    lo_row = nt - tc.UPD_B
    lsp3 = after3["lsp"]
    kt, pt, st_ = (after3["tiles"].clone() for _ in range(3))
    tc.updrow_batch(kt, lsp3, rows)
    tc.updrow_batch_plain(pt, lsp3, rows)
    for i_, k_ in rows:
        tc.updrow(st_, lsp3, i_, k_)
    torch.cuda.synchronize()
    r_b, e_b = rel(kt[lo_row:], pt[lo_row:])
    check(r_b < TOL, f"updrow_batch differs from plain ({r_b})")
    check(torch.equal(kt, st_), "updrow_batch differs from UPDROW launches")
    rows0 = after3["tiles"][lo_row:].clone()

    def restore_rows():
        kt[lo_row:].copy_(rows0)

    ms = events_ms(lambda: tc.updrow_batch(kt, lsp3, rows), 3, restore_rows)
    pms = events_ms(lambda: tc.updrow_batch_plain(kt, lsp3, rows), 3,
                    restore_rows)
    # The library: one baddbmm over every tile product of the UPD_B rows.
    ii = [i_ for i_, _ in rows for _j in range(1, i_ + 1)]
    jj = [j for i_, _ in rows for j in range(1, i_ + 1)]
    l0 = unsplit(lsp3[:, 0, 0], lsp3[:, 0, 1])
    lhs, rhs = l0[ii], l0[jj].transpose(1, 2).contiguous()
    acc = after3["tiles"][ii, jj].clone()
    lms = events_ms(lambda: torch.baddbmm(acc, lhs, rhs, alpha=-1.0), 3)
    kb = bound(SPLIT_PASSES * 2.0 * len(ii) * ts ** 3,
               4 * tt * (len(rows) + nt - 1) + 8 * len(ii) * tt, PEAK_BF16)
    kernels["updrow_batch"] = {
        "name": "updrow_batch", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/megakernel.cu",
        "replaces": "hclib_tpu/device/cholesky.py:285",
        "max_abs_err": e_b, "ms": ms, "plain_ms": pms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": lms,
    }
    emit({"phase": "check", "kernel": "updrow_batch", "rows": rows,
          "tile_products": len(ii), "rel_err": r_b,
          "equal_to_updrow_launches": True, "kernel_ms": ms,
          "plain_ms": pms, "library_ms": lms})
    del kt, pt, st_, l0, lhs, rhs, acc, rows0
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

    # 2. check: the batch tier (K7) with its batched bodies inside the
    # megakernel, the card's whole output state against the plain core's
    for name, make, b in (
            ("fib11_b8", lambda d: tw.make_fib_megakernel(
                768, batch_width=8, device=d), fib_graph(11)[0]),
            ("uts_depth12_b8", lambda d: tw.make_uts_megakernel(
                max_depth=12, batch_width=8, device=d), ub)):
        got, want = raw_state(make("cuda"), b), raw_state(make("cpu"), b)
        ints_equal(got, want, f"batch tier {name}")
        emit({"phase": "check", "kernel": "batch_tier", "graph": name,
              "equal": True,
              "tiers": make("cpu").decode_tier_stats(want["tstats"])})
    a1 = make_spd(1024).astype(np.float32)
    got, want = (raw_state(
        tc.make_cholesky_megakernel(4, tile=256, device=d),
        tc.build_cholesky_graph(4),
        tc.cholesky_buffers(a1, 4, 256, device=d)) for d in ("cuda", "cpu"))
    ints_equal(got, want, "batch tier cholesky n=1024")
    r_c, e_c = rel(got["data.tiles"], want["data.tiles"])
    check(r_c < TOL, f"batched cholesky tiles differ from plain ({r_c})")
    emit({"phase": "check", "kernel": "batch_tier", "graph":
          "cholesky_n1024_t256", "ints_equal": True, "tiles_rel_err": r_c,
          "tstats": want["tstats"].tolist()})

    # 2. check: the SW bodies (K10), sw_wave_batch against the plain core
    # on every output, sw_tile through device_sw, both against sw_seq
    for n_sw, chunk, width in ((512, 1, 2), (1280, tsw.WAVE_R, tsw.WAVE_B)):
        sa, sb = random_seq(n_sw, 5), random_seq(n_sw, 6)
        nts = n_sw // tsw.T
        ref = torch.from_numpy(sw_seq(sa, sb)[1:, 1:])
        graph = tsw.build_sw_wave_graph(nts, nts, chunk)
        data = tsw.sw_wave_buffers(sa, sb)
        data["htiles"] = np.zeros((nts, nts, tsw.T, tsw.T), np.int32)
        mkw = {d: tsw.make_sw_wave_megakernel(nts, nts, chunk=chunk,
                                             width=width, device=d)
               for d in ("cuda", "cpu")}
        got, want = (raw_state(mkw[d], graph, data) for d in ("cuda", "cpu"))
        ints_equal(got, want, f"sw_wave_batch {n_sw}^2")
        hw = got["data.htiles"].transpose(1, 2).reshape(n_sw, n_sw)
        check(torch.equal(hw, ref), f"sw_wave_batch {n_sw}^2: H != sw_seq")
        tiers = mkw["cpu"].decode_tier_stats(want["tstats"])
        check(chunk > 1 or tiers["prefetch_hits"] > 0,
              "the prefetch did not engage at chunk=1, width=2")
        s_c, h_c, _ = tsw.device_sw(sa, sb, device="cuda")
        s_p, h_p, _ = tsw.device_sw(sa, sb, device="cpu")
        check(torch.equal(h_c.cpu(), ref) and torch.equal(h_p, ref)
              and s_c == s_p == int(ref.max()) == int(got["ivalues"][0]),
              f"sw_tile {n_sw}^2: H or score differ")
        emit({"phase": "check", "kernel": "sw", "n": n_sw, "chunk": chunk,
              "width": width, "equal": True, "h_equals_sw_seq": True,
              "score": s_c, "tiers": tiers})
    # The SW bound: one DP row of a lane's 4 cells (sw_row_ops less
    # sw_row_copy_ops in the built library's SASS), charged to each pipe
    # at its own rate, over the whole card.
    sw_sass = sass_ops(_build.lib_path("megakernel"),
                       {"sw_row_ops", "sw_row_copy_ops"})
    sw_row = {k: sw_sass["sw_row_ops"][k] - sw_sass["sw_row_copy_ops"][k]
              for k in ("alu", "imad", "shfl", "all")}
    check(sw_row["shfl"] >= 7 and sw_row["all"] > 20,
          f"SW row SASS counts {sw_row} are implausible")
    cell_clocks = max(sw_row["alu"] / ALU_PER_CLK,
                      sw_row["imad"] / IMAD_PER_CLK,
                      sw_row["shfl"] / SHFL_PER_CLK,
                      sw_row["all"] / ISSUE_PER_CLK) / 4

    def sw_bound_ms(cells):
        return cells * cell_clocks / (SMS * clock_hz) * 1e3

    emit({"phase": "sass", "kernel": "sw", "row_ops": sw_row,
          "sass": {k: sw_sass[k] for k in ("sw_row_ops", "sw_row_copy_ops")},
          "sm_clocks_a_cell": cell_clocks})

    # 2. check: the subtree engine (row 1i) against the plain runner, its
    # standalone entry at the main path's lanes, truncated and complete
    vspecs = (("vfib16", tv.fib_spec(18), (16,), 2),
              ("nqueens8", tv.nqueens_spec(8), (0, 0, 0), 8))
    for name, spec, frame, count in vspecs:
        for steps in (3, 50, tv.NO_LIMIT):
            got = tv.subtree_run(spec, frame, count, steps, device="cuda")
            want = tv.subtree_run(spec, frame, count, steps, device="cpu")
            check(got == want, f"vector {name} max_steps={steps}: kernel "
                  f"{got} != plain {want}")
            emit({"phase": "check", "kernel": "vector", "family": name,
                  "lanes": list(spec.lanes), "max_steps": steps,
                  "nodes_acc_over_steps": [got[0], got[1], got[2], got[3]],
                  "equal": True})
    vgraphs = (
        ("device_vfib20", lambda d: tw.make_vfib_megakernel(22, device=d),
         tw.VFIB, [20]),
        ("device_nqueens8", lambda d: tmk.Megakernel(
            [("vnqueens", tv.nqueens_spec(8))], capacity=64, num_values=16,
            succ_capacity=8, device=d), tw.VNQUEENS, [0]),
    )
    for name, make, fn, args in vgraphs:
        b = TaskGraphBuilder()
        b.add(fn, args=args, out=0)
        got, want = raw_state(make("cuda"), b), raw_state(make("cpu"), b)
        ints_equal(got, want, f"vector table {name}")
        emit({"phase": "check", "kernel": "vector", "graph": name,
              "equal": True, "value": int(got["ivalues"][0]),
              "executed": int(got["counts"][5])})
    rb = TaskGraphBuilder()
    r0 = rb.add(tw.FIB, args=[9], out=0)
    r1 = rb.add(tw.FIB, args=[10], out=1)
    rb.add(tw.SUM, args=[0, 1], deps=[r0, r1], out=2)
    rb.reserve_values(3)
    got, want = (raw_state(tmk.Megakernel(
        ["fib", "sum"], route={"fib": tv.fib_spec(14, (1, 8))}, capacity=16,
        num_values=16, succ_capacity=8, device=d), rb)
        for d in ("cuda", "cpu"))
    ints_equal(got, want, "routed fib graph")
    check(got["ivalues"][:3].tolist() == [34, 55, 89]
          and int(got["counts"][5]) == 109 + 177 + 1, "routed fib results")
    emit({"phase": "check", "kernel": "vector", "graph": "routed_fib_9_10",
          "equal": True, "executed": int(got["counts"][5])})
    # Its bound: every expanded node is one lane step of its family
    # (vfib_step_ops / vnqueens_step_ops less the copies of the same
    # words), each pipe at its rate over the whole card.
    vsass = sass_ops(_build.lib_path("megakernel"), {
        "vfib_step_ops", "vfib_copy_ops", "vnqueens_step_ops",
        "vnqueens_copy_ops"})
    node_clocks_of = {}
    for fam in ("vfib", "vnqueens"):
        d = {k: vsass[fam + "_step_ops"][k] - vsass[fam + "_copy_ops"][k]
             for k in ("alu", "imad", "all")}
        check(d["all"] > 5, f"{fam} step SASS counts {d} are implausible")
        node_clocks_of[fam] = max(d["alu"] / ALU_PER_CLK,
                                  d["imad"] / IMAD_PER_CLK,
                                  d["all"] / ISSUE_PER_CLK)
        emit({"phase": "sass", "kernel": "vector", "family": fam,
              "step_ops": d, "sm_clocks_a_node": node_clocks_of[fam]})

    def vector_bound_ms(fam, nodes):
        return nodes * node_clocks_of[fam] / (SMS * clock_hz) * 1e3

    # 2. check: the batched SW score kernel (row 3) against its plain
    # version and the sequential DP
    for B_, n_, m_ in ((9, 64, 256), (6, 97, 128), (5, 50, 45),
                       (3, 33, 300)):
        rng = np.random.default_rng(B_)
        sa = rng.integers(0, 4, (B_, n_)).astype(np.int32)
        sb = rng.integers(0, 4, (B_, m_)).astype(np.int32)
        got = tsp.sw_scores_pallas(sa, sb, device="cuda").cpu()
        at, bt_ = (torch.from_numpy(x).to(dev) for x in (sa, sb))
        want = tsp.sw_scores_plain(at.T.contiguous(), bt_.T.contiguous())
        seq = [int(sw_seq(sa[i], sb[i]).max()) for i in range(B_)]
        check(torch.equal(got, want.cpu()) and got.tolist() == seq,
              f"sw_scores {B_}x{n_}x{m_}: kernel {got.tolist()}, plain "
              f"{want.tolist()}, sw_seq {seq}")
        emit({"phase": "check", "kernel": "sw_scores", "B": B_, "n": n_,
              "m": m_, "equal": True, "equal_to_sw_seq": True})
    swc = sass_ops(_build.lib_path("sw_scores"),
                   {"sw_chunk_ops", "sw_chunk_copy_ops"})
    chunk_row = {k: swc["sw_chunk_ops"][k] - swc["sw_chunk_copy_ops"][k]
                 for k in ("alu", "imad", "shfl", "all")}
    check(chunk_row["shfl"] >= 7 and chunk_row["all"] > 20,
          f"SW chunk SASS counts {chunk_row} are implausible")
    score_cell_clocks = max(chunk_row["alu"] / ALU_PER_CLK,
                            chunk_row["imad"] / IMAD_PER_CLK,
                            chunk_row["shfl"] / SHFL_PER_CLK,
                            chunk_row["all"] / ISSUE_PER_CLK) / 4
    emit({"phase": "sass", "kernel": "sw_scores", "chunk_row_ops": chunk_row,
          "sm_clocks_a_cell": score_cell_clocks})

    # 2. check: the tile bodies (rows 1k, 1h') against the plain core at
    # bench.py --forasync's sizes: every output, data buffers included
    def fa_graph(bounds, tile):
        b = TaskGraphBuilder()
        return b, tfa.seed_tiles(b, bounds, tile)

    def fa_reference(tk, src):
        return (tw.stencil_reference(src) if tk.name == "fa_stencil"
                else tw.map_reference(src))

    fa_small = (("stencil", tw.stencil_loop(64, 1024),
                 tw.stencil_data(64, 1024)),
                ("map", tw.map_loop(64), tw.map_data(64)))
    for loop, (tk, bounds, tile), arrays in fa_small:
        b, total = fa_graph(bounds, tile)
        data = dict(zip(tk.data_specs, arrays))
        ref = torch.from_numpy(fa_reference(tk, arrays[0]))
        dst = "data." + tk.out_names[0]
        for width, prefetch, fuel in ((0, True, 1 << 22), (8, True, 1 << 22),
                                      (8, False, 1 << 22), (8, True, 20)):
            got, want = (raw_state(tfa.make_forasync_megakernel(
                tk, width=width, prefetch=prefetch, capacity=total + 8,
                device=d), b, data, fuel) for d in ("cuda", "cpu"))
            ints_equal(got, want, f"{loop} width {width} prefetch "
                       f"{prefetch} fuel {fuel}")
            check(fuel < total or torch.equal(got[dst], ref),
                  f"{loop} width {width}: output != numpy reference")
            emit({"phase": "check", "kernel": "tiles", "loop": loop,
                  "tiles": total, "width": width, "prefetch": prefetch,
                  "fuel": fuel, "equal": True,
                  "executed": int(got["counts"][5]),
                  "tiers": None if not width else
                  tfa.make_forasync_megakernel(
                      tk, width=width, prefetch=prefetch,
                      device="cpu").decode_tier_stats(want["tstats"])})
        for width in (0, 8):
            outs = {}
            for d in ("cuda", "cpu"):
                mk = tfa.make_forasync_megakernel(tk, width=width, device=d)
                bufs = {k: torch.from_numpy(v).to(d)
                        for k, v in data.items()}
                tfa.tile_rounds(mk, tfa.tile_arg_table(bounds, tile), bufs)
                outs[d] = bufs[tk.out_names[0]].cpu()
            check(torch.equal(outs["cuda"], outs["cpu"])
                  and torch.equal(outs["cpu"], ref),
                  f"{loop} standalone tile entry width {width} differs")
        emit({"phase": "check", "kernel": "tiles", "loop": loop,
              "standalone_entry": [0, 8], "equal": True})
    ab64 = TaskGraphBuilder()
    for t in range(64):
        ab64.add(tw.ADD_TILE, args=[t])
    rng = np.random.default_rng(2)
    add_data = {k: rng.standard_normal((64, 8, 128)).astype(np.float32)
                for k in ("a", "b")}
    add_data["c"] = np.zeros((64, 8, 128), np.float32)
    got, want = (raw_state(tw.make_arrayadd_megakernel(64, device=d), ab64,
                           add_data) for d in ("cuda", "cpu"))
    ints_equal(got, want, "arrayadd")
    check(torch.equal(got["data.c"], want["data.c"]) and torch.equal(
        got["data.c"], torch.from_numpy(add_data["a"] + add_data["b"])),
        "arrayadd differs from the plain version or a + b")
    emit({"phase": "check", "kernel": "tiles", "loop": "arrayadd",
          "tiles": 64, "equal": True, "equal_to_a_plus_b": True})

    # 2. check: the frontier bodies and the policy scheduler (kMode 4) on
    # bench.py --graph's graph, every arm, and the knapsack NODE bodies,
    # each on its whole output state against the plain core
    g9 = tf.Graph(*tw.rmat_edges(9, efactor=8, seed=7))
    GB = {"capacity": 4096, "m0": 4096, "reps": 64}

    def fr_mk(kind, g, width, nbk=0, capacity=GB["capacity"], device="cuda"):
        fk = (tf.pagerank_kernel(GB["reps"]) if kind == "pagerank"
              else tf._KINDS[kind]())
        return tf.make_frontier_megakernel(fk, g, width=width,
                                           capacity=capacity,
                                           priority_buckets=nbk,
                                           device=device)

    fr_plain_ms = {}
    for kind, width, nbk, fuel in (
            ("bfs", 0, 0, 1 << 22), ("bfs", 8, 0, 1 << 22),
            ("sssp", 0, 0, 1 << 22), ("sssp", 8, 0, 1 << 22),
            ("pagerank", 0, 0, 1 << 22), ("pagerank", 8, 0, 1 << 22),
            ("sssp", 8, 8, 1 << 22), ("pagerank", 8, 0, 300)):
        out = {}
        for d in ("cuda", "cpu"):
            mk = fr_mk(kind, g9, width, nbk, device=d)
            b, iv, data = tf.frontier_state(kind, g9, mk, m0=GB["m0"],
                                            reps=GB["reps"])
            t0 = time.perf_counter()
            out[d] = raw_state(mk, b, data, fuel, ivalues=iv)
            if d == "cpu" and fuel == 1 << 22:
                fr_plain_ms[kind, width, nbk] = (
                    time.perf_counter() - t0) * 1e3
        ints_equal(out["cuda"], out["cpu"], f"frontier {kind} width "
                   f"{width} buckets {nbk} fuel {fuel}")
        emit({"phase": "check", "kernel": "frontier", "graph": "rmat9",
              "kind": kind, "width": width, "buckets": nbk, "fuel": fuel,
              "equal": True, "executed": int(out["cpu"]["counts"][5]),
              "tiers": None if not width else mk.decode_tier_stats(
                  out["cpu"]["tstats"])})
    for width in (0, 8):
        out = {}
        for d in ("cuda", "cpu"):
            mk = fr_mk("sssp", g9, width, device=d)
            b, iv, data = tf.frontier_state("sssp", g9, mk)
            st = mk.state(b, data=data, ivalues=iv)
            tf.expand_rounds(mk, st, range(int(st["counts"][2])))
            out[d] = {k: st[k].cpu() for k in ("tasks", "ready", "counts",
                                                "ivalues")}
        ints_equal(out["cuda"], out["cpu"], f"expand_rounds width {width}")
    emit({"phase": "check", "kernel": "frontier", "standalone_entry": [0, 8],
          "equal": True})
    kp12 = tb.make_knapsack(12, seed=5)
    for width, nbk in ((0, 0), (4, 0), (4, 8)):
        out = {}
        for d in ("cuda", "cpu"):
            mk = tb.make_bnb_megakernel(kp12, width=width,
                                        priority_buckets=nbk, device=d)
            b, iv = tb.bnb_state(kp12, mk)
            out[d] = raw_state(mk, b, ivalues=iv)
        ints_equal(out["cuda"], out["cpu"], f"bnb width {width} buckets {nbk}")
        check(int(out["cuda"]["ivalues"][tb.V_BEST])
              == tb.host_knapsack_opt(kp12), "bnb 12 items: optimum")
        emit({"phase": "check", "kernel": "bnb", "items": 12, "width": width,
              "buckets": nbk, "equal": True,
              "executed": int(out["cpu"]["counts"][5])})

    # 2. check: the dynamic-graph bodies (UPDATE, QUERY, the clamped and
    # spare-aware EXPAND) on the JAX tests' graph and stream, a stream that
    # fills a vertex's spare row and then drops, and the spare-exhaustion
    # graph, each arm on its whole output state, both edge buffers
    # included, against the plain core
    full = (8, np.concatenate([np.zeros(128, np.int64), [1]]),
            np.concatenate([1 + np.arange(128) % 7, [2]]).astype(np.int64))

    def dg_small(name):
        """(graph, updates, queries) of a check arm."""
        if name == "rmat5":
            return (td.DynGraph(*tw.rmat_edges(5, efactor=4, seed=9),
                                spare_blocks=2, upd_cap=16),
                    [(1, 5, 3), (2, 7, 1), (0, 9, 2), (4, 3, 6)], [0, 5, 9])
        ups = ([(0, 7, 1), (1, 3, 1)] if name == "exhaustion" else
               [(0, 1 + i % 7, 1 + i % 3) for i in range(130)] + [(1, 3, 1)])
        return (td.DynGraph(*full, np.ones(129, np.int64),
                            spare_blocks=int(name == "spares"), upd_cap=160),
                ups, [0])

    for name, kind, width, nbk, fuel in (
            ("rmat5", "sssp", 0, 0, 1 << 22), ("rmat5", "bfs", 4, 0, 1 << 22),
            ("rmat5", "bfs", 4, 2, 1 << 22),
            ("rmat5", "pagerank", 0, 0, 1 << 22),
            ("rmat5", "pagerank", 4, 0, 1 << 22), ("rmat5", "sssp", 4, 0, 40),
            ("spares", "sssp", 0, 0, 1 << 22), ("spares", "sssp", 4, 0, 1 << 22),
            ("exhaustion", "bfs", 0, 0, 1 << 22)):
        out = {}
        for d in ("cuda", "cpu"):
            g, ups, qs = dg_small(name)
            for up in ups:
                g.add_update(*up)
            mk = td.make_dyngraph_megakernel(
                kind, g, width=width, priority_buckets=nbk, update_priority=0,
                capacity=768 if kind == "pagerank" else 512, device=d)
            b, iv, data = td.dyngraph_state(kind, g, mk, queries=qs,
                                            m0=GB["m0"], reps=GB["reps"])
            out[d] = raw_state(mk, b, data, fuel, ivalues=iv)
        ints_equal(out["cuda"], out["cpu"], f"dyngraph {name} {kind} width "
                   f"{width} buckets {nbk} fuel {fuel}")
        iv = out["cpu"]["ivalues"]
        emit({"phase": "check", "kernel": "dyngraph", "graph": name,
              "kind": kind, "width": width, "buckets": nbk, "fuel": fuel,
              "equal": True, "executed": int(out["cpu"]["counts"][5]),
              "updates_applied": int(iv[td.V_UPDATES]),
              "spare_in_use": int(iv[td.V_FREE]),
              "dropped": int(iv[td.V_DROPPED]),
              "overflow": int(out["cpu"]["counts"][6])})
    for d in ("cuda", "cpu"):
        g, ups, _ = dg_small("exhaustion")
        try:
            td.run_dyngraph("bfs", g, 0, updates=ups, width=0, device=d)
        except RuntimeError as e:
            check("overflow" in str(e), f"exhaustion on {d}: {e}")
        else:
            check(False, f"spare exhaustion did not raise on {d}")
    emit({"phase": "check", "kernel": "dyngraph", "graph": "exhaustion",
          "raises_on": ["cuda", "cpu"]})

    # 2. check: the flight recorder and the quiesce poll (row 1o), in each
    # of mk_kernel's observed instances 0-5: a traced, checkpoint-built
    # run with every record kept, then one quiesced at half its tasks on
    # a ring of a quarter of the full run's records (so its cursor wraps),
    # on the card and on the plain core; the decoded ring and its header,
    # qstat and the whole output state word for word (Cholesky's f32 tiles
    # within TOL, as in the batch-tier check)
    obs_err = 0.0
    fib16 = TaskGraphBuilder()
    v0 = fib16.add(tw.FIB, args=[15], out=0)
    v1 = fib16.add(tw.FIB, args=[16], out=1)
    fib16.add(tw.SUM, args=[0, 1], deps=[v0, v1], out=2)
    fib16.reserve_values(3)
    sw4 = tsw.sw_wave_buffers(random_seq(512, 5), random_seq(512, 6))
    sw4["htiles"] = np.zeros((4, 4, tsw.T, tsw.T), np.int32)
    stk, sbounds, stile = tw.stencil_loop(64, 1024)
    sb, stotal = fa_graph(sbounds, stile)
    g7c = td.DynGraph(*tw.rmat_edges(7, efactor=8, seed=7), spare_blocks=2,
                      upd_cap=24)
    rng7 = np.random.default_rng(11)
    for u, v, w in zip(rng7.integers(0, g7c.n, 24),
                       rng7.integers(0, g7c.n, 24), rng7.integers(1, 8, 24)):
        g7c.add_update(int(u), int(v), int(w))

    def obs(cap):
        return dict(trace=cap, checkpoint=True)

    def obs_sssp9(d, cap):
        return tf.make_frontier_megakernel(
            tf.sssp_kernel(), g9, width=8, capacity=GB["capacity"],
            priority_buckets=8, device=d, **obs(cap))

    def obs_dg7(d, cap):
        mk = td.make_dyngraph_megakernel("sssp", g7c, width=8,
                                         capacity=1024, device=d,
                                         **obs(cap))
        td._bind_updates(mk, g7c)
        return mk

    fb9, fiv9, fdata9 = tf.frontier_state("sssp", g9, obs_sssp9("cpu", 8))
    db7, div7, ddata7 = td.dyngraph_state("sssp", g7c, obs_dg7("cpu", 8), 0,
                                          [1, 5, 9, 17])
    obs_cases = (
        ("fib11", 0, lambda d, c: tw.make_fib_megakernel(
            768, device=d, **obs(c)), fib_graph(11)[0], None, None),
        ("uts12_b8", 1, lambda d, c: tw.make_uts_megakernel(
            max_depth=12, batch_width=8, device=d, **obs(c)), ub, None,
         None),
        ("cholesky_n1024_t256", 1, lambda d, c: tc.make_cholesky_megakernel(
            4, tile=256, device=d, **obs(c)), tc.build_cholesky_graph(4),
         {k: numpy_of(v) for k, v in tc.cholesky_buffers(
             a1, 4, 256, device="cpu").items()}, None),
        ("sw512_c1_w2", 1, lambda d, c: tsw.make_sw_wave_megakernel(
            4, 4, chunk=1, width=2, device=d, **obs(c)),
         tsw.build_sw_wave_graph(4, 4, 1), sw4, None),
        ("vfib16_routed", 2, lambda d, c: tmk.Megakernel(
            ["fib", "sum"], route={"fib": tv.fib_spec(18, (8, 128))},
            capacity=16, num_values=16, succ_capacity=8, device=d,
            **obs(c)), fib16, None, None),
        ("stencil_64x1024_w8", 3, lambda d, c: tfa.make_forasync_megakernel(
            stk, width=8, capacity=stotal + 8, device=d, **obs(c)), sb,
         dict(zip(stk.data_specs, tw.stencil_data(64, 1024))), None),
        ("sssp9_w8_b8", 4, obs_sssp9, fb9, fdata9, fiv9),
        ("dyngraph7_sssp_w8", 5, obs_dg7, db7, ddata7, div7))
    for name, inst, make, b, data, iv in obs_cases:
        res = {}
        for d in ("cuda", "cpu"):
            full = raw_state(make(d, 4096), b, data, ivalues=iv)
            written = int(full["trace.header"][0])
            q = max(1, int(full["counts"][tmk.C_EXECUTED]) // 2)
            wrap = max(1, written // 4)
            res[d] = (full, raw_state(make(d, wrap), b, data, ivalues=iv,
                                      quiesce=q))
        for i, what in enumerate(("traced", "quiesced")):
            got, want = res["cuda"][i], res["cpu"][i]
            obs_err = max(obs_err, ints_equal(got, want,
                                              f"observed {name} {what}"))
            if "data.tiles" in want:  # the bf16 splits derive from it
                r_o, _ = rel(got["data.tiles"], want["data.tiles"])
                check(r_o < TOL, f"observed {name} {what} tiles: {r_o}")
        full, cut = res["cpu"]
        cut_written = int(cut["trace.header"][0])
        check(int(cut["qstat"][tmk.QS_QUIESCED]) == 1
              and int(cut["counts"][tmk.C_PENDING]) > 0
              and int(full["qstat"][tmk.QS_QUIESCED]) == 0,
              f"observed {name}: no quiesce mid-graph")
        check(cut_written > len(cut["trace.records"]) == wrap
              and full["trace.records"].shape[0] == written,
              f"observed {name}: the quiesced ring did not wrap")
        emit({"phase": "check", "kernel": "tracebuf", "graph": name,
              "instance": inst, "equal": True, "records": written,
              "quiesced_records": cut_written, "wrap_capacity": wrap,
              "quiesced_at": int(cut["qstat"][tmk.QS_AT]),
              "polls": int(cut["qstat"][tmk.QS_POLLS])})
    del res, fdata9, ddata7

    # The stream kernel against the plain stream, word for word ---------
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import stream_holds

    for name in stream_holds.CASES:
        for trace in (None, 256):
            t0 = time.perf_counter()
            got = stream_holds.run_case(name, "cuda", trace)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = stream_holds.run_case(name, "cpu", trace)
            plain_s = time.perf_counter() - t0
            err = stream_holds.compare(got, want, f"stream {name}")
            emit({"phase": "stream", "case": name, "traced": bool(trace),
                  "equal": True, "max_abs_err": err,
                  "entries": len(got.get("entries") or []),
                  "card_s": card_s, "plain_host_s": plain_s})
    del got, want

    # The user-body scheduler on one device against the plain core ------
    user_err = 0.0  # the largest value-slot difference of the holds
    for name in mesh_holds.USER_CASES:
        got = mesh_holds.run_user_case(name, "cuda")
        want = mesh_holds.run_user_case(name, "cpu")
        for k, v in want.items():
            check(np.array_equal(got[k], v),
                  f"user table {name}: {k} differs from the plain core")
        err = float(np.abs(got["ivalues"].astype(np.int64)
                           - want["ivalues"].astype(np.int64)).max())
        user_err = max(user_err, err)
        emit({"phase": "user", "case": name, "equal": True,
              "max_abs_err": err, "counts": got["counts"].tolist()})

    # The mesh kernels against their plain versions, word for word ------
    mesh_hold_err = {}  # kernel: the largest value error of its holds
    for name in mesh_holds.CASES:
        got = mesh_holds.run_case(name, "cuda")
        want = mesh_holds.run_case(name, "cpu")
        err = mesh_holds.compare(got, want, name)
        kn = mesh_holds.kernel_of(name)
        mesh_hold_err[kn] = max(mesh_hold_err.get(kn, 0.0), err)
        emit({"phase": "mesh", "case": name, "equal": True,
              "max_abs_err": err, "executed": got["executed"],
              "rounds": got["rounds"], "rows_exported": got["rows"],
              "card_kernel_ms": got["kernel_ms"],
              "card_exchange_ms": got["exchange_ms"],
              "plain_host_ms": want["kernel_ms"]})
    for name in mesh_holds.OBS_CASES:
        got = mesh_holds.run_obs_case(name, "cuda")
        want = mesh_holds.run_obs_case(name, "cpu")
        err = mesh_holds.compare(got, want, name)
        kn = ("ici_ring_obs" if mesh_holds.OBS_CASES[name][0] == "ring"
              else "resident_obs")
        mesh_hold_err[kn] = max(mesh_hold_err.get(kn, 0.0), err)
        emit({"phase": "mesh", "case": name, "equal": True,
              "max_abs_err": err, "executed": got["executed"],
              "rounds": got["rounds"], "quiesced": got.get("quiesced"),
              "records": [got[k] for k in sorted(got)
                          if k.startswith("trace/") and
                          k.endswith("/written")],
              "card_kernel_ms": got["kernel_ms"],
              "plain_host_ms": want["kernel_ms"]})
    for name in mesh_holds.RING_CASES:
        got = mesh_holds.run_ring_case(name, "cuda")
        want = mesh_holds.run_ring_case(name, "cpu")
        err = mesh_holds.compare(got, want, name)
        mesh_hold_err["pgas_ring"] = max(mesh_hold_err.get("pgas_ring", 0.0),
                                         err)
        emit({"phase": "mesh", "case": name, "equal": True,
              "max_abs_err": err, "executed": got["executed"],
              "rounds": got["rounds"], "aborted": got["aborted"],
              "card_kernel_ms": got["kernel_ms"],
              "plain_host_ms": want["kernel_ms"]})
    del got, want

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
    fib_plain_s = time.perf_counter() - t0
    fib_tasks_per_s = info["executed"] / dt
    emit({"phase": "fib", "n": 24, "value": v, "executed": info["executed"],
          "allocated": info["allocated"], "seconds": dt,
          "tasks_per_s": fib_tasks_per_s,
          "plain_host_seconds": fib_plain_s,
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
    tiers = info["tiers"]
    check((tiers["batch_tasks"], tiers["routed"], tiers["scalar_tasks"],
           tiers["spilled"]) == (120, 120, 31, 0), f"cholesky tiers {tiers}")
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
          "dispatch": info["dispatch"], "residual": resid, "tiers": tiers,
          "seconds": info["seconds"],
          "gflops": (n ** 3 / 3.0) / info["seconds"] / 1e9,
          "estimated_body_ms": est, "launches": path_done("cholesky")})
    del Ld
    chol_seconds = info["seconds"]

    # 5b. the same graph with scalar UPDROW dispatch
    _build.reset_launches()
    Ls, info = tc.device_cholesky(a, tile=ts, batch_updrow=False,
                                  device="cuda")
    check(info["executed"] == 151 and "tiers" not in info,
          f"scalar-UPDROW cholesky executed {info['executed']}")
    check(torch.equal(Ls, L), "batched and scalar-UPDROW factors differ")
    emit({"phase": "cholesky_scalar_updrow", "n": n, "tile": ts,
          "dispatch": info["dispatch"], "bit_identical_to_batched": True,
          "seconds": info["seconds"], "batched_seconds": chol_seconds,
          "launches": path_done("cholesky_scalar_updrow")})
    del Ls

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
    L5 = L.clone()  # phase 24's restored factor is held to it
    del A, Ld, L, L2

    # 8. fib(24) through the batch tier
    _build.reset_launches()
    t0 = time.perf_counter()
    v, info = tw.device_fib(24, capacity=768, batch_width=8, device="cuda")
    dt = time.perf_counter() - t0
    check(v == 46368, f"batched fib(24) = {v}")
    check(info["executed"] == 225073,
          f"batched fib(24) executed {info['executed']}")
    fib_b = fib_graph(24)[0]
    fib_ms, _ = timed_launch(
        tw.make_fib_megakernel(768, batch_width=8, device="cuda"), fib_b)
    launches = path_done("fib_batch")
    fib_pms, (pv, pinfo) = plain_ms(
        lambda: tw.device_fib(24, capacity=768, batch_width=8, device="cpu"))
    check(pv == v and pinfo["tiers"] == info["tiers"],
          "plain batched fib(24) differs")
    kb = bound(0.0, info["executed"] * 136.0)
    kernels["fib_batch"] = {
        "name": "fib_batch", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/megakernel.cu",
        "replaces": "hclib_tpu/device/workloads.py:86",
        "max_abs_err": 0.0, "ms": fib_ms, "plain_ms": fib_pms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": None,
    }
    emit({"phase": "fib_batch", "n": 24, "batch_width": 8, "value": v,
          "executed": info["executed"], "allocated": info["allocated"],
          "seconds": dt, "tasks_per_s": info["executed"] / dt,
          "kernel_ms": fib_ms,
          "kernel_tasks_per_s": info["executed"] / (fib_ms * 1e-3),
          "scalar_fib_tasks_per_s": fib_tasks_per_s, "tiers": info["tiers"],
          "plain_host_ms": fib_pms, "bound_ms": kb[0],
          "library": "none: no PyTorch call runs a task graph",
          "launches": launches})

    # 9. UTS at max_depth=20 through the batch tier
    _build.reset_launches()
    t0 = time.perf_counter()
    nodes, info = tw.device_uts_mk(max_depth=20, batch_width=8,
                                   device="cuda")
    dt = time.perf_counter() - t0
    check(nodes == 498965, f"batched UTS nodes {nodes} != 498965")
    uts_b_ms, _ = timed_launch(
        tw.make_uts_megakernel(max_depth=20, batch_width=8, device="cuda"),
        ub)
    launches = path_done("uts_batch")
    uts_pms, (pn, pinfo) = plain_ms(lambda: tw.device_uts_mk(
        max_depth=20, batch_width=8, device="cpu"))
    check(pn == nodes and pinfo["tiers"] == info["tiers"],
          "plain batched UTS differs")
    kb = bound(0.0, info["executed"] * 136.0)
    kernels["uts_node_batch"] = {
        "name": "uts_node_batch", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/megakernel.cu",
        "replaces": "hclib_tpu/device/workloads.py:86",
        "max_abs_err": 0.0, "ms": uts_b_ms, "plain_ms": uts_pms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": None,
    }
    emit({"phase": "uts_batch", "max_depth": 20, "batch_width": 8,
          "nodes": nodes, "seconds": dt, "nodes_per_s": nodes / dt,
          "kernel_ms": uts_b_ms,
          "kernel_nodes_per_s": nodes / (uts_b_ms * 1e-3),
          "scalar_uts_kernel_ms": uts_ms, "tiers": info["tiers"],
          "plain_host_ms": uts_pms, "bound_ms": kb[0],
          "launches": launches})

    # 10. SW wave engine at bench.py's configuration
    _build.reset_launches()
    n_sw = 8192
    nts = n_sw // tsw.T
    sa, sb = random_seq(n_sw, 5), random_seq(n_sw, 6)
    t0 = time.perf_counter()
    score, h, info = tsw.device_sw_wave(sa, sb, with_h=False, device="cuda")
    dt = time.perf_counter() - t0
    check(h is None and info["executed"] == nts * nts,
          f"sw_wave executed {info['executed']} tiles")
    wave_graph = tsw.build_sw_wave_graph(nts, nts)
    wmk = tsw.make_sw_wave_megakernel(nts, nts, with_h=False, device="cuda")
    wave_ms, wst = timed_launch(wmk, wave_graph, tsw.sw_wave_buffers(sa, sb))
    check(int(wst["ivalues"][0]) == score, "sw_wave timed launch score")
    t0 = time.perf_counter()
    vec_score = sw_score_one(sa, sb, device="cuda")
    vec_s = time.perf_counter() - t0
    check(score == vec_score, f"sw_wave score {score} != sw_vec {vec_score}")
    launches = path_done("sw_wave")
    tiers = info["tiers"]
    cells = n_sw * n_sw
    wave_pms, (ps, _, pinfo) = plain_ms(lambda: tsw.device_sw_wave(
        sa, sb, with_h=False, device="cpu"))
    check(ps == score and pinfo["tiers"] == tiers, "plain sw_wave differs")
    kernels["sw_wave_batch"] = {
        "name": "sw_wave_batch", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/megakernel.cu",
        "replaces": "hclib_tpu/device/smithwaterman.py:234",
        "max_abs_err": 0.0, "ms": wave_ms, "plain_ms": wave_pms,
        "bound_ms": sw_bound_ms(cells), "bound_by": "operations",
        "library_ms": None,
    }
    emit({"phase": "sw_wave", "n": n_sw, "m": n_sw, "tiles": nts * nts,
          "with_h": False, "score": score, "sw_vec_score": vec_score,
          "kernel_ms": wave_ms, "gcups": cells / (wave_ms * 1e-3) / 1e9,
          "entry_seconds": dt, "occupancy": tiers["batch_occupancy"],
          "prefetch_hits": tiers["prefetch_hits"], "tiers": tiers,
          "sw_vec_seconds": vec_s, "plain_host_ms": wave_pms,
          "bound_ms": sw_bound_ms(cells),
          "library": "none: no PyTorch call computes Smith-Waterman",
          "launches": launches})

    # 11. the three SW engines at 2048 x 2048 with H
    _build.reset_launches()
    n_e = 2048
    nte = n_e // tsw.T
    sa, sb = random_seq(n_e, 7), random_seq(n_e, 8)
    engines = {}
    for name, fn in (("device_sw", tsw.device_sw),
                     ("device_sw_batched", tsw.device_sw_batched),
                     ("device_sw_wave", tsw.device_sw_wave)):
        score, h, info = fn(sa, sb, device="cuda")
        engines[name] = (score, h, info)
    s0, h0, _ = engines["device_sw"]
    for name, (score, h, info) in engines.items():
        check(score == s0 and torch.equal(h, h0),
              f"{name} differs from device_sw at {n_e}^2")
        check(info["executed"] == nte * nte, f"{name} executed")
    check(s0 == int(h0.max()), "sw_engines score != max(H)")
    tile_ms, _ = timed_launch(
        tsw.make_sw_megakernel(nte, nte, device="cuda"),
        tsw.build_sw_graph(nte, nte),
        dict(tsw.sw_wave_buffers(sa, sb),
             htiles=np.zeros((nte, nte, tsw.T, tsw.T), np.int32)))
    launches = path_done("sw_engines")
    tile_pms, (ps, ph, _) = plain_ms(lambda: tsw.device_sw(sa, sb,
                                                          device="cpu"))
    check(ps == s0 and torch.equal(ph, h0.cpu()), "plain device_sw differs")
    cells = n_e * n_e
    kernels["sw_tile"] = {
        "name": "sw_tile", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/megakernel.cu",
        "replaces": "hclib_tpu/device/smithwaterman.py:59",
        "max_abs_err": 0.0, "ms": tile_ms, "plain_ms": tile_pms,
        "bound_ms": sw_bound_ms(cells), "bound_by": "operations",
        "library_ms": None,
    }
    emit({"phase": "sw_engines", "n": n_e, "with_h": True, "score": s0,
          "equal": True, "seconds": {k: v[2]["seconds"]
                                     for k, v in engines.items()},
          "gcups": {k: v[2]["cells_per_sec"] / 1e9
                    for k, v in engines.items()},
          "tiers": {k: v[2]["tiers"] for k, v in engines.items()
                    if "tiers" in v[2]},
          "sw_tile_kernel_ms": tile_ms, "plain_host_ms": tile_pms,
          "bound_ms": sw_bound_ms(cells), "launches": launches})
    del engines, h0, ph

    # 12. fib(30) on the vector tier
    _build.reset_launches()
    t0 = time.perf_counter()
    v, info = tw.device_vfib(30, device="cuda")
    dt = time.perf_counter() - t0
    check(v == 832040, f"vfib(30) = {v}")
    check(info["executed"] == 2692537, f"vfib(30) executed {info['executed']}")
    vb = TaskGraphBuilder()
    vb.add(tw.VFIB, args=[30], out=0)
    vfib_ms, vst = timed_launch(tw.make_vfib_megakernel(32, device="cuda"),
                                vb, agg=np.mean)
    check(int(vst["ivalues"][0]) == v, "vfib(30) timed launch value")
    launches = path_done("vfib")
    vfib_pms, (pv, pinfo) = plain_ms(lambda: tw.device_vfib(30, device="cpu"))
    check(pv == v and pinfo["executed"] == info["executed"],
          "plain vfib(30) differs")
    nodes = info["executed"] - 1

    def standalone(spec, frame, count):
        """The engine's standalone entry on the phase's subtree: equal to
        the plain runner (steps included); its steps, lane efficiency
        and CUDA-event ms (median of 3 after a warm-up)."""
        got = tv.subtree_run(spec, frame, count, device="cuda")
        check(got == tv.subtree_run(spec, frame, count, device="cpu"),
              f"standalone {spec.name} differs from the plain runner")
        ms = events_ms(lambda: tv.subtree_run(spec, frame, count,
                                              device="cuda"), 3)
        nl = spec.lanes[0] * spec.lanes[1]
        return {"steps": got[3], "lane_efficiency": got[0] / (got[3] * nl),
                "standalone_ms": ms, "equal_to_plain": True}
    kernels["vector"] = {
        "name": "vector", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/vector.cuh",
        "replaces": "hclib_tpu/device/vector_engine.py:136",
        "max_abs_err": 0.0, "ms": vfib_ms, "plain_ms": vfib_pms,
        "bound_ms": vector_bound_ms("vfib", nodes), "bound_by": "operations",
        "library_ms": None,
    }
    emit({"phase": "vfib", "n": 30, "lanes": [8, 128], "value": v,
          "executed": info["executed"], "entry_seconds": dt,
          "kernel_ms": vfib_ms,
          "kernel_tasks_per_s": info["executed"] / (vfib_ms * 1e-3),
          "plain_host_ms": vfib_pms,
          "bound_ms": vector_bound_ms("vfib", nodes),
          "library": "none: no PyTorch call runs a task subtree",
          "launches": launches,
          "engine": standalone(tv.fib_spec(32), (30,), 2)})

    # 13. n-queens(12) on the vector tier
    _build.reset_launches()
    t0 = time.perf_counter()
    v, info = tw.device_nqueens(12, device="cuda")
    dt = time.perf_counter() - t0
    nb = TaskGraphBuilder()
    nb.add(tw.VNQUEENS, args=[0], out=0)
    nq_ms, _ = timed_launch(tmk.Megakernel(
        [("vnqueens", tv.nqueens_spec(12))], capacity=64, num_values=16,
        succ_capacity=8, device="cuda"), nb, agg=np.mean)
    launches = path_done("nqueens")
    sols, placements = nq_count(12)
    check(v == sols == 14200, f"nqueens(12) = {v} (sequential {sols})")
    check(info["executed"] == placements + 1,
          f"nqueens(12) executed {info['executed']} != {placements} + 1")
    nq_pms, (pv, _) = plain_ms(lambda: tw.device_nqueens(12, device="cpu"))
    check(pv == v, "plain nqueens(12) differs")
    emit({"phase": "nqueens", "n": 12, "lanes": [8, 128], "value": v,
          "executed": info["executed"], "entry_seconds": dt,
          "kernel_ms": nq_ms,
          "kernel_tasks_per_s": info["executed"] / (nq_ms * 1e-3),
          "plain_host_ms": nq_pms,
          "bound_ms": vector_bound_ms("vnqueens", placements),
          "launches": launches,
          "engine": standalone(tv.nqueens_spec(12), (0, 0, 0), 12)})

    # 14. batched SW scores at bench_device_sw's shapes
    _build.reset_launches()
    rng = np.random.default_rng(1)
    B_, m_ = 1024, 1024
    bseq = torch.from_numpy(rng.integers(0, 4, (m_, B_)).astype(np.int32)
                            ).T.contiguous().to(dev)
    aseq = {n_: torch.from_numpy(rng.integers(0, 4, (n_, B_)).astype(
        np.int32)).T.contiguous().to(dev) for n_ in (256, 2048)}
    score_ms, scores = {}, {}
    for n_, a_ in aseq.items():
        scores[n_] = tsp.sw_scores_pallas(a_, bseq, device="cuda")
        score_ms[n_] = events_ms(
            lambda a_=a_: tsp.sw_scores_pallas(a_, bseq, device="cuda"), 5)
    launches = path_done("sw_scores")
    plain_score_ms = {}
    for n_, a_ in aseq.items():
        t0 = time.perf_counter()
        want = tsp.sw_scores_plain(a_.T.contiguous(), bseq.T.contiguous())
        torch.cuda.synchronize()
        plain_score_ms[n_] = (time.perf_counter() - t0) * 1e3
        check(torch.equal(scores[n_], want),
              f"sw_scores n={n_}: kernel differs from plain")
    cells = {n_: B_ * n_ * m_ for n_ in aseq}
    slope = (cells[2048] - cells[256]) / (
        (score_ms[2048] - score_ms[256]) * 1e-3) / 1e9
    # Its bound: the cells at one 4-cell lane chunk's SASS over the card,
    # or its bytes (a, b read once, the scores written), the larger.
    score_bound = {n_: max(
        (c * score_cell_clocks / (SMS * clock_hz) * 1e3, "operations"),
        (B_ * (n_ + m_ + 1) * 4 / HBM_BYTES * 1e3, "bytes"))
        for n_, c in cells.items()}
    kernels["sw_scores"] = {
        "name": "sw_scores", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/sw_scores.cu",
        "replaces": "hclib_tpu/device/sw_pallas.py:86",
        "max_abs_err": 0.0, "ms": score_ms[2048],
        "plain_ms": plain_score_ms[2048], "bound_ms": score_bound[2048][0],
        "bound_by": score_bound[2048][1], "library_ms": None,
    }
    emit({"phase": "sw_scores", "B": B_, "m": m_, "kernel_ms": score_ms,
          "gcups": {n_: cells[n_] / (score_ms[n_] * 1e-3) / 1e9
                    for n_ in aseq},
          "gcups_slope": slope, "plain_ms_on_card": plain_score_ms,
          "bound_ms": {n_: b[0] for n_, b in score_bound.items()},
          "equal_to_plain": True,
          "library": "none: no PyTorch call computes Smith-Waterman",
          "launches": launches})

    # 15, 16. the forasync loops at full size, each arm through the entry
    # point and timed on its megakernel; the bound is the unique bytes
    # (each input element read once, each output written once) plus
    # 136 bytes a descriptor, over the card's memory rate.
    def forasync_phase(phase, tk, bounds, tile, arrays, library):
        src_name, dst_name = tk.data_specs
        ref = torch.from_numpy(fa_reference(tk, arrays[0])).to(dev)
        bufs = {k: torch.from_numpy(v).to(dev)
                for k, v in zip(tk.data_specs, arrays)}
        b, total = fa_graph(bounds, tile)
        out_bytes = math.prod(tile) * total * 4
        nbytes = arrays[0].nbytes + out_bytes + 136.0 * total
        kb = bound(0.0, nbytes)
        _build.reset_launches()
        arms = {}
        for width in (0, 8):
            bufs[dst_name].zero_()
            t0 = time.perf_counter()
            out, info = tfa.run_forasync_device(tk, bounds, tile, bufs,
                                                width=width, device="cuda")
            torch.cuda.synchronize()
            entry_s = time.perf_counter() - t0
            check(torch.equal(out[dst_name], ref) and info["executed"]
                  == total, f"{phase} width {width}: output != reference")
            mk = tfa.make_forasync_megakernel(tk, width=width,
                                              capacity=total + 8,
                                              device="cuda")
            bufs[dst_name].zero_()
            ms, st = timed_launch(mk, b, bufs)
            check(torch.equal(st["data"][dst_name], ref),
                  f"{phase} width {width}: timed launch output")
            arms[width] = {"kernel_ms": ms, "tiles_per_s": total / (
                ms * 1e-3), "entry_seconds": entry_s,
                "tiers": info.get("tiers")}
        launches = path_done(phase)
        host = {k: v for k, v in zip(tk.data_specs, arrays)}
        for width in (0, 8):
            mkc = tfa.make_forasync_megakernel(tk, width=width,
                                               capacity=total + 8,
                                               device="cpu")
            stc = mkc.state(b, data=host)
            arms[width]["plain_host_ms"], _ = plain_ms(
                lambda: mkc.launch(stc))
            check(torch.equal(stc["data"][dst_name], ref.cpu()),
                  f"{phase} width {width}: plain output != reference")
            # The same rounds without the scheduler (at width 8 also
            # without the prefetch: what overlapping the loads buys).
            args = torch.from_numpy(tfa.tile_arg_table(bounds, tile)).to(
                dev, torch.int32)
            for key, prefetch in (("standalone_ms", True),
                                  ("standalone_no_prefetch_ms", False)):
                if key != "standalone_ms" and not width:
                    continue
                mks = tfa.make_forasync_megakernel(
                    tk, width=width, prefetch=prefetch, device="cuda")
                bufs[dst_name].zero_()
                arms[width][key] = events_ms(
                    lambda: tfa.tile_rounds(mks, args, bufs), 3)
                check(torch.equal(bufs[dst_name], ref),
                      f"{phase} width {width}: standalone output")
        lib_ms = None
        if library is not None:
            got = library(bufs[src_name])
            check(torch.equal(got.view(-1), ref.view(-1)),
                  f"{phase}: the library call's output")
            lib_ms = events_ms(lambda: library(bufs[src_name]), 5)
        for width, body in ((0, tk.name), (8, tk.name + "_batch")):
            kernels[body] = {
                "name": body, "route": "cuda",
                "source": "hclib_tpu_torch/csrc/forasync.cuh",
                "replaces": "hclib_tpu/device/forasync_tier.py:"
                            + ("267" if width == 0 else "326"),
                "max_abs_err": 0.0, "ms": arms[width]["kernel_ms"],
                "plain_ms": arms[width]["plain_host_ms"],
                "bound_ms": kb[0], "bound_by": kb[1], "library_ms": lib_ms,
            }
        emit({"phase": phase, "tiles": total, "tile": list(tile),
              "equal_to_reference": True, "arms": arms,
              "bound_ms": kb[0], "bound_bytes": nbytes,
              "library_ms": lib_ms, "launches": launches})
        del bufs, ref

    forasync_phase("forasync_stencil", *tw.stencil_loop(4096, 4096),
                   tw.stencil_data(4096, 4096), None)
    c7 = torch.tensor(tw.MAP_ADD, dtype=torch.int32, device=dev)
    forasync_phase("forasync_map", *tw.map_loop(16384), tw.map_data(16384),
                   lambda x: torch.add(c7, x, alpha=tw.MAP_MUL))

    # 17. arrayadd, 16,384 add_tile tasks
    _build.reset_launches()
    nta = 16384
    t0 = time.perf_counter()
    a_, b_, c_, info = tw.device_arrayadd(nta, device="cuda")
    entry_s = time.perf_counter() - t0
    want_c = torch.from_numpy(a_ + b_).to(dev)
    check(torch.equal(c_, want_c) and info["executed"] == nta,
          "arrayadd: c != a + b")
    ab = TaskGraphBuilder()
    for t in range(nta):
        ab.add(tw.ADD_TILE, args=[t])
    add_bufs = {"a": torch.from_numpy(a_).to(dev),
                "b": torch.from_numpy(b_).to(dev),
                "c": torch.zeros_like(want_c)}
    add_ms, st = timed_launch(tw.make_arrayadd_megakernel(nta, device="cuda"),
                              ab, add_bufs)
    check(torch.equal(st["data"]["c"], want_c), "arrayadd timed launch")
    launches = path_done("arrayadd")
    mkc = tw.make_arrayadd_megakernel(nta, device="cpu")
    stc = mkc.state(ab, data={"a": a_, "b": b_, "c": np.zeros_like(a_)})
    add_pms, _ = plain_ms(lambda: mkc.launch(stc))
    check(torch.equal(stc["data"]["c"], want_c.cpu()), "plain arrayadd")
    add_lms = events_ms(lambda: torch.add(add_bufs["a"], add_bufs["b"]), 5)
    kb = bound(0.0, 3 * a_.nbytes + 136.0 * nta)
    kernels["add_tile"] = {
        "name": "add_tile", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/forasync.cuh",
        "replaces": "hclib_tpu/device/workloads.py:515",
        "max_abs_err": 0.0, "ms": add_ms, "plain_ms": add_pms,
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": add_lms,
    }
    emit({"phase": "arrayadd", "tiles": nta, "equal_to_a_plus_b": True,
          "kernel_ms": add_ms, "tiles_per_s": nta / (add_ms * 1e-3),
          "entry_seconds": entry_s, "plain_host_ms": add_pms,
          "bound_ms": kb[0], "library_ms": add_lms, "launches": launches})
    del add_bufs, want_c, c_

    # 18-19. the graph frontier. The bound: each traversed edge's index
    # (and weight) read once and its state word read once, and 136 bytes
    # a descriptor, over the card's memory rate.
    def fr_bound(info, kind):
        return bound(0.0, info["edges"] * (8 + 4 * (kind == "sssp"))
                     + 136.0 * info["executed"])

    fr_results = {}

    def graph_arm(g, kind, width, nbk, ref, capacity, reps=3):
        """One arm through run_frontier (equal to ``ref``; kept in
        ``fr_results``), then timed on its megakernel: TEPS over the
        launch's CUDA-event ms."""
        mk = fr_mk(kind, g, width, nbk, capacity)
        t0 = time.perf_counter()
        r, info = tf.run_frontier(kind, g, 0, m0=GB["m0"], reps=GB["reps"],
                                  mk=mk, device="cuda")
        entry_s = time.perf_counter() - t0
        check(np.array_equal(r, ref), f"{kind} width {width} buckets "
              f"{nbk}: result differs from the host reference")
        fr_results[g.n, kind, width, nbk] = r
        b, iv, data = tf.frontier_state(kind, g, mk, m0=GB["m0"],
                                        reps=GB["reps"])
        ms, st = timed_launch(mk, b, data, reps=reps, ivalues=iv)
        check(int(st["ivalues"][0]) == info["edges"],
              f"{kind} width {width}: timed launch edges")
        kb = fr_bound(info, kind)
        return mk, {"kernel_ms": ms, "teps": info["edges"] / (ms * 1e-3),
                    "edges": info["edges"], "executed": info["executed"],
                    "allocated": info["allocated"],
                    "relaxations": info["relaxations"],
                    "entry_seconds": entry_s, "tiers": info.get("tiers"),
                    "bound_ms": kb[0], "bound_by": kb[1]}

    def fr_round_ms(mk, kind, g):
        """The standalone EXPAND entry on the seed rows (staged anew
        outside the timed window): CUDA-event ms a round."""
        b, iv, data = tf.frontier_state(kind, g, mk, m0=GB["m0"],
                                        reps=GB["reps"])
        hold = {}

        def fresh():
            hold["st"] = mk.state(b, data=data, ivalues=iv)

        fresh()
        rows = range(int(hold["st"]["counts"][2]))
        tf.expand_rounds(mk, hold["st"], rows)
        ms = events_ms(lambda: tf.expand_rounds(mk, hold["st"], rows), 3,
                       before=fresh)
        width = mk.batch_specs[0][1].width if mk.batch_specs else 1
        return ms / -(-len(rows) // width)

    # 18. bench.py --graph's graph, every arm
    _build.reset_launches()
    t0 = time.perf_counter()
    refs = {"bfs": tf.host_bfs(g9), "sssp": tf.host_sssp(g9),
            "pagerank": tf.host_pagerank_push(g9, m0=GB["m0"],
                                              reps=GB["reps"])[0]}
    host_s = time.perf_counter() - t0
    arms, mks = {}, {}
    for kind, width, nbk in (("bfs", 0, 0), ("bfs", 8, 0), ("sssp", 0, 0),
                             ("sssp", 8, 0), ("pagerank", 0, 0),
                             ("pagerank", 8, 0), ("sssp", 8, 8)):
        key = f"{kind}_w{width}" + (f"_b{nbk}" if nbk else "")
        mks[key], arms[key] = graph_arm(g9, kind, width, nbk, refs[kind],
                                        GB["capacity"])
    launches = path_done("graph_bench")
    ratio = arms["sssp_w8_b8"]["executed"] / arms["sssp_w8"]["executed"]
    round_ms = {k: fr_round_ms(mks[k], "sssp", g9)
                for k in ("sssp_w0", "sssp_w8")}
    for key, body, kind, width in (("sssp_w0", "fr_expand", "sssp", 0),
                                   ("sssp_w8", "fr_expand_batch", "sssp", 8)):
        kernels[body] = {
            "name": body, "route": "cuda",
            "source": "hclib_tpu_torch/csrc/frontier.cuh",
            "replaces": "hclib_tpu/device/frontier.py:"
                        + ("347" if width == 0 else "407"),
            "max_abs_err": 0.0, "ms": arms[key]["kernel_ms"],
            "plain_ms": fr_plain_ms[kind, width, 0],
            "bound_ms": arms[key]["bound_ms"],
            "bound_by": arms[key]["bound_by"], "library_ms": None,
        }
    emit({"phase": "graph_bench", "graph": "rmat_edges(9, efactor=8, "
          "seed=7)", "vertices": g9.n, "edges": g9.m, "blocks": g9.nblocks,
          **GB, "equal_to_host_references": True,
          "delta_sssp_equal_to_unordered": True,
          "sssp_delta_expand_ratio": ratio, "arms": arms,
          "standalone_round_ms": round_ms, "host_reference_seconds": host_s,
          "library": "none: no PyTorch call runs a label-correcting "
                     "traversal", "launches": launches})

    # 19. Graph500's R-MAT at scale 16, width 8
    _build.reset_launches()
    t0 = time.perf_counter()
    e16 = tw.rmat_edges(16, efactor=16, seed=7)
    g16 = tf.Graph(*e16)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs16 = {"bfs": tf.host_bfs(g16), "sssp": tf.host_sssp(g16)}
    host_s = time.perf_counter() - t0
    arms16, mks16 = {}, {}
    for kind, nbk in (("bfs", 0), ("sssp", 0), ("sssp", 8)):
        key = f"{kind}_w8" + (f"_b{nbk}" if nbk else "")
        mks16[key], arms16[key] = graph_arm(g16, kind, 8, nbk, refs16[kind],
                                            1 << 17, reps=2)
    launches = path_done("graph_scale16")
    emit({"phase": "graph_scale16", "graph": "rmat_edges(16, efactor=16, "
          "seed=7)", "vertices": g16.n, "edges": g16.m,
          "blocks": g16.nblocks, "capacity": 1 << 17,
          "delta": tf.default_delta(g16), "equal_to_host_references": True,
          "sssp_delta_expand_ratio": arms16["sssp_w8_b8"]["executed"]
          / arms16["sssp_w8"]["executed"], "arms": arms16,
          "standalone_round_ms": fr_round_ms(mks16["sssp_w8"], "sssp", g16),
          "graph_build_seconds": build_s, "host_reference_seconds": host_s,
          "launches": launches})
    del g16, refs16, mks16

    # 20. bench.py --bnb's knapsack, unordered and best-first
    _build.reset_launches()
    kp16 = tb.make_knapsack(16, seed=5)
    opt = tb.host_knapsack_opt(kp16)
    check(opt == 609, f"host_knapsack_opt = {opt}")
    bnb_arms = {}
    for nbk in (0, 8):
        mk = tb.make_bnb_megakernel(kp16, width=4, priority_buckets=nbk,
                                    capacity=2048, device="cuda")
        best, info = tb.run_bnb(kp16, mk=mk, device="cuda")
        check(best == opt, f"bnb buckets {nbk}: optimum {best} != {opt}")
        b, iv = tb.bnb_state(kp16, mk)
        ms, st = timed_launch(mk, b, ivalues=iv)
        check(int(st["ivalues"][tb.V_BEST]) == opt, "bnb timed launch")
        kb = bound(0.0, 136.0 * info["executed"])
        bnb_arms[f"b{nbk}"] = {
            "best": best, "executed": info["executed"],
            "pruned": info["pruned"], "leaves": info["leaves"],
            "allocated": info["allocated"], "kernel_ms": ms,
            "nodes_per_s": info["executed"] / (ms * 1e-3),
            "tiers": info["tiers"], "bound_ms": kb[0], "bound_by": kb[1]}
    launches = path_done("bnb")
    for nbk in (0, 8):
        mkc = tb.make_bnb_megakernel(kp16, width=4, priority_buckets=nbk,
                                     capacity=2048, device="cpu")
        bnb_arms[f"b{nbk}"]["plain_host_ms"], (pb, _) = plain_ms(
            lambda: tb.run_bnb(kp16, mk=mkc, device="cpu"))
        check(pb == opt, "plain bnb optimum")
    kernels["bnb_node"] = {
        "name": "bnb_node", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/frontier.cuh",
        "replaces": "hclib_tpu/device/bnb.py:195",
        "max_abs_err": 0.0, "ms": bnb_arms["b0"]["kernel_ms"],
        "plain_ms": bnb_arms["b0"]["plain_host_ms"],
        "bound_ms": bnb_arms["b0"]["bound_ms"],
        "bound_by": bnb_arms["b0"]["bound_by"], "library_ms": None,
    }
    emit({"phase": "bnb", "items": 16, "seed": 5, "width": 4,
          "capacity": 2048, "optimum": opt, "arms": bnb_arms,
          "library": "none: no PyTorch call runs a branch-and-bound",
          "launches": launches})

    # 21-22. the dynamic-graph tier. The bound: bytes over the memory
    # rate, 136 B a descriptor, each splice's five ledger and flag words
    # read and the index (and weight) word it writes, or its whole fresh
    # row, and the EXPAND edges as fr_bound counts them.
    def dg_bound(info, kind, nsplice):
        wt = 1 + (kind == "sssp")
        fresh = info["spare_in_use"]
        return bound(0.0, 136.0 * info["executed"] + 20.0 * nsplice
                     + 4.0 * wt * (info["updates_applied"] - fresh)
                     + 512.0 * wt * fresh
                     + info["edges"] * (8 + 4 * (kind == "sssp")))

    def dg_draw(g, nup, nq):
        """bench.py's stream: default_rng(11), uniform endpoints, weights
        1-7, then the queries."""
        rng = np.random.default_rng(11)
        for u, v, w in zip(rng.integers(0, g.n, nup), rng.integers(0, g.n, nup),
                           rng.integers(1, 8, nup)):
            g.add_update(int(u), int(v), int(w))
        return [int(q) for q in rng.integers(0, g.n, nq)]

    def dg_arm(g, kind, width, nbk, capacity, queries, reps=3,
               num_values=None):
        """One arm through run_dyngraph, then timed on its megakernel,
        staged from the numpy buffers before each launch."""
        mk = td.make_dyngraph_megakernel(
            kind, g, width=width, priority_buckets=nbk, capacity=capacity,
            num_values=num_values, reps=GB["reps"], device="cuda")
        t0 = time.perf_counter()
        r, info = td.run_dyngraph(kind, g, 0, queries=queries, m0=GB["m0"],
                                  reps=GB["reps"], mk=mk, device="cuda")
        entry_s = time.perf_counter() - t0
        check(info["updates_applied"] == len(g.updates)
              and info["dropped"] == 0
              and info["spare_in_use"] == g.spare_needed(),
              f"dyngraph {kind} width {width}: {info['updates_applied']} "
              f"applied, {info['dropped']} dropped, {info['spare_in_use']} "
              "spare blocks")
        b, iv, data = td.dyngraph_state(kind, g, mk, 0, queries, m0=GB["m0"],
                                        reps=GB["reps"])
        ms, st = timed_launch(mk, b, data, reps=reps, ivalues=iv)
        check(int(st["ivalues"][tf.V_EDGES]) == info["edges"],
              f"dyngraph {kind} width {width}: timed launch edges")
        kb = dg_bound(info, kind, len(g.updates))
        return r, st, {
            "kernel_ms": ms, "edges": info["edges"],
            "executed": info["executed"], "allocated": info["allocated"],
            "relaxations": info["relaxations"],
            "updates_applied": info["updates_applied"],
            "spare_in_use": info["spare_in_use"], "queries": info["queries"],
            "query_values": info["query_values"][:8],
            "entry_seconds": entry_s, "tiers": info.get("tiers"),
            "bound_ms": kb[0], "bound_by": kb[1]}

    # 21. bench.py --graph dyngraph's configuration, uncut
    _build.reset_launches()
    g7 = td.DynGraph(*tw.rmat_edges(7, efactor=8, seed=7), spare_blocks=2,
                     upd_cap=24)
    qs7 = dg_draw(g7, 24, 4)
    DG = {"capacity": 1024, "updates": 24, "queries": qs7}
    t0 = time.perf_counter()
    refs7 = {k: td.host_dyngraph(k, g7, 0) for k in ("bfs", "sssp")}
    pr_mass = int(td.host_incremental_pagerank(g7, m0=GB["m0"],
                                               reps=GB["reps"])[0].sum())
    host_s = time.perf_counter() - t0
    arms7, st7 = {}, {}
    cfg7 = (("bfs", 0, 0), ("bfs", 8, 0), ("sssp", 0, 0), ("sssp", 8, 0),
            ("sssp", 8, 8), ("pagerank", 8, 0))
    for kind, width, nbk in cfg7:
        key = f"{kind}_w{width}" + (f"_b{nbk}" if nbk else "")
        r, st7[key], arms7[key] = dg_arm(g7, kind, width, nbk,
                                         DG["capacity"], qs7)
        if kind == "pagerank":
            check(int(r.sum()) == pr_mass, f"dyngraph pagerank mass "
                  f"{int(r.sum())} != {pr_mass}")
        else:
            check(np.array_equal(r, refs7[kind]), f"dyngraph {key} differs "
                  "from host_dyngraph")
    # A QUERY stream alone (one query a vertex) on SSSP's converged state.
    nvq = g7.num_value_slots + g7.n
    conv = st7["sssp_w0"]["ivalues"].cpu().numpy()[:g7.num_value_slots]
    ivq = np.zeros(nvq, np.int32)
    ivq[:len(conv)] = conv
    bq = TaskGraphBuilder()
    bq.reserve_values(g7.num_value_slots)
    qbase = g7.st_base + g7.n
    for v in range(g7.n):
        bq.add(td.DG_QUERY, args=[v], out=qbase + v)
    mkq = {d: td.make_dyngraph_megakernel("sssp", g7, width=0,
                                          capacity=DG["capacity"],
                                          num_values=nvq, device=d)
           for d in ("cuda", "cpu")}
    q_ms, stq = timed_launch(mkq["cuda"], bq, td.fk_data(g7, mkq["cuda"]),
                             ivalues=ivq)
    check(np.array_equal(stq["ivalues"][qbase:qbase + g7.n].cpu().numpy(),
                         refs7["sssp"]), "query stream differs from the "
          "host labels")
    launches = path_done("dyngraph_bench")
    q_plain_ms, stq_plain = plain_ms(lambda: raw_state(
        mkq["cpu"], bq, td.fk_data(g7, mkq["cpu"]), ivalues=ivq))
    q_err = ints_equal(raw_state(mkq["cuda"], bq, td.fk_data(
        g7, mkq["cuda"]), ivalues=ivq), stq_plain, "query stream")
    # Every arm on the card against the plain core, word for word on the
    # whole state: the rows the splices wrote, the counters, the tiers.
    for kind, width, nbk in cfg7:
        key = f"{kind}_w{width}" + (f"_b{nbk}" if nbk else "")
        out = {}
        for d in ("cuda", "cpu"):
            mk = td.make_dyngraph_megakernel(
                kind, g7, width=width, priority_buckets=nbk,
                capacity=DG["capacity"], reps=GB["reps"], device=d)
            b, iv, data = td.dyngraph_state(kind, g7, mk, 0, qs7,
                                            m0=GB["m0"], reps=GB["reps"])
            # (the plain run goes last: its time is the one kept)
            ms, out[d] = plain_ms(lambda: raw_state(mk, b, data,
                                                    ivalues=iv))
        if kind != "pagerank":
            check(np.array_equal(out["cuda"]["ivalues"][
                g7.st_base:g7.st_base + g7.n].numpy(), refs7[kind]),
                f"dyngraph {key}: compared launch differs from "
                "host_dyngraph")
        arms7[key]["plain_host_ms"] = ms
        arms7[key]["max_abs_err"] = ints_equal(out["cuda"], out["cpu"],
                                               f"dyngraph {key}")
    q_bound = bound(0.0, g7.n * (136.0 + 8.0))
    w8 = (arms7["bfs_w8"], arms7["sssp_w8"])
    wall_s = sum(a["kernel_ms"] for a in w8) * 1e-3
    emit({"phase": "dyngraph_bench", "graph": "rmat_edges(7, efactor=8, "
          "seed=7)", "vertices": g7.n, "static_edges": g7.m,
          "static_blocks": g7.static_nblocks, "spare_blocks": g7.spare,
          "upd_cap": g7.upd_cap, **DG, "spare_needed": g7.spare_needed(),
          "equal_to_host_dyngraph": True, "pagerank_mass": pr_mass,
          "updates_per_s": sum(a["updates_applied"] for a in w8) / wall_s,
          "query_teps": sum(a["edges"] for a in w8) / wall_s,
          "queries_per_s": sum(a["queries"] for a in w8) / wall_s,
          "arms": arms7, "host_reference_seconds": host_s,
          "query_stream": {"queries": g7.n, "kernel_ms": q_ms,
                           "plain_host_ms": q_plain_ms,
                           "max_abs_err": q_err, "bound_ms": q_bound[0],
                           "equal_to_host_labels": True},
          "equal_to_plain_core": True,
          "library": "none: no PyTorch call splices a blocked CSR",
          "launches": launches})

    # 22. phase 19's graph with 32,768 updates, width 8; then the
    # incremental arm from phase 19's converged SSSP labels
    _build.reset_launches()
    t0 = time.perf_counter()
    g16d = td.DynGraph(*e16, spare_blocks=2, upd_cap=1 << 15)
    qs16 = dg_draw(g16d, 1 << 15, 64)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gm = g16d.mutated()  # host_dyngraph's graph, built once for both
    refs16d = {"bfs": tf.host_bfs(gm), "sssp": tf.host_sssp(gm)}
    host_s = time.perf_counter() - t0
    del gm
    # 2^17 rows do not hold it: SSSP's run peaks at 201,241 (its 32,768
    # UPDATE rows wait in their lane while the traversal runs).
    cap16 = 1 << 18
    nv16 = g16d.num_value_slots + 64
    serve16 = {"updates": list(g16d.updates), "queries": qs16,
               "ref": refs16d["sssp"]}
    arms22 = {}
    for kind, nbk in (("bfs", 0), ("sssp", 0), ("sssp", 8)):
        key = f"{kind}_w8" + (f"_b{nbk}" if nbk else "")
        r, _, arms22[key] = dg_arm(g16d, kind, 8, nbk, cap16, qs16,
                                   reps=2, num_values=nv16)
        check(np.array_equal(r, refs16d[kind]), f"dyngraph scale 16 {key} "
              "differs from host_dyngraph")
    st = g16d.st_base
    iv_inc = g16d.preset_values(nv16, tf.INF)
    iv_inc[st:st + g16d.n] = fr_results[g16d.n, "sssp", 8, 0]
    bu = TaskGraphBuilder()
    bu.reserve_values(g16d.num_value_slots)
    for uid, (u, v, w) in enumerate(g16d.updates):
        bu.add(td.DG_UPDATE, args=[u, v, w, uid])
    incr, mki = {}, {}
    for width in (8, 0):
        mki[width] = td.make_dyngraph_megakernel(
            "sssp", g16d, width=width, capacity=cap16, num_values=nv16,
            device="cuda")
        ms, sti = timed_launch(mki[width], bu, td.fk_data(g16d, mki[width]),
                               reps=2, ivalues=iv_inc)
        ivo = sti["ivalues"].cpu().numpy()
        check(np.array_equal(ivo[st:st + g16d.n], refs16d["sssp"]),
              f"incremental arm width {width} differs from host_dyngraph")
        flags = ivo[g16d.flag_base:g16d.flag_base + g16d.upd_cap]
        info = {"executed": int(sti["counts"][5]),
                "edges": int(ivo[tf.V_EDGES]),
                "relaxations": int(ivo[tf.V_RELAX]),
                "updates_applied": int((flags != 0).sum()),
                "spare_in_use": int(ivo[td.V_FREE]),
                "dropped": int(ivo[td.V_DROPPED])}
        check(info["dropped"] == 0 and info["updates_applied"] == 1 << 15,
              f"incremental arm width {width}: {info}")
        kb = dg_bound(info, "sssp", 1 << 15)
        incr[f"w{width}"] = {**info, "kernel_ms": ms,
                             "us_per_splice": ms * 1e3 / (1 << 15),
                             "bound_ms": kb[0], "bound_by": kb[1]}
    launches = path_done("dyngraph_scale16")
    for width in (8, 0):
        mkc = td.make_dyngraph_megakernel(
            "sssp", g16d, width=width, capacity=cap16, num_values=nv16,
            device="cpu")
        incr[f"w{width}"]["plain_host_ms"], want = plain_ms(
            lambda: raw_state(mkc, bu, td.fk_data(g16d, mkc),
                              ivalues=iv_inc))
        got = raw_state(mki[width], bu, td.fk_data(g16d, mki[width]),
                        ivalues=iv_inc)
        check(np.array_equal(got["ivalues"][st:st + g16d.n].numpy(),
                             refs16d["sssp"]), f"incremental arm width "
              f"{width}: compared launch differs from host_dyngraph")
        incr[f"w{width}"]["max_abs_err"] = ints_equal(
            got, want, f"incremental arm width {width}")
        del got, want
    emit({"phase": "dyngraph_scale16", "graph": "rmat_edges(16, efactor=16, "
          "seed=7)", "vertices": g16d.n, "static_edges": g16d.m,
          "static_blocks": g16d.static_nblocks, "spare_blocks": g16d.spare,
          "updates": 1 << 15, "queries": len(qs16), "capacity": cap16,
          "spare_needed": g16d.spare_needed(),
          "equal_to_host_dyngraph": True, "arms": arms22,
          "incremental": incr, "incremental_equal_to_plain_core": True,
          "from_scratch_ms": arms22["sssp_w8"]["kernel_ms"],
          "graph_build_seconds": build_s, "host_reference_seconds": host_s,
          "launches": launches})
    for key, src_line, arm in (
            ("dg_splice", "508", incr["w0"]),
            ("dg_splice_batch", "512", incr["w8"]),
            ("dg_query", "523", {"kernel_ms": q_ms, "bound_ms": q_bound[0],
                                 "bound_by": q_bound[1],
                                 "plain_host_ms": q_plain_ms,
                                 "max_abs_err": q_err}),
            ("dg_expand", "279", arms7["sssp_w8"])):
        kernels[key] = {
            "name": key, "route": "cuda",
            "source": "hclib_tpu_torch/csrc/frontier.cuh",
            "replaces": "hclib_tpu/device/dyngraph.py:" + src_line,
            "max_abs_err": arm["max_abs_err"], "ms": arm["kernel_ms"],
            "plain_ms": arm["plain_host_ms"],
            "bound_ms": arm["bound_ms"], "bound_by": arm["bound_by"],
            "library_ms": None,
        }
    del mki

    # 23. the flight recorder on the main path. Each arm untraced and
    # traced, timed alternately in this process (CUDA events, the graph
    # staged anew outside the window; fib(24) also with the quiesce poll
    # at stride 1), then the traced run's records reconciled with its
    # counters: a scalar table records one fire a task between its begin
    # and end records; a routed one one TR_FIRE_BATCH a batch round
    # (take and prefetched words summing to the tiers), one
    # TR_FIRE_SCALAR a scalar task, one TR_FIRE_AGE an age fire
    _build.reset_launches()
    tr_arms = {}

    def alternate(mks, b, data=None, iv=None, rounds=2, reps=3):
        """Median CUDA-event ms of each build in ``mks``, timed in turn
        (A B .. B A) ``rounds`` times."""
        times = {k: [] for k in mks}
        for r in range(rounds):
            for k in (list(mks) if r % 2 == 0 else list(mks)[::-1]):
                times[k].append(timed_launch(mks[k], b, data, reps=reps,
                                             ivalues=iv)[0])
        return {k: float(np.median(v)) for k, v in times.items()}

    def reconcile(info, what):
        ring = info["trace"]["rings"][0]
        recs = ring["records"]
        check(int(recs[-1, 0]) == ttb.TR_ROUND_END
              and int(recs[-1, 2]) == info["executed"],
              f"{what}: the last record is not the closing round_end")
        if "tiers" not in info:
            check(ring["written"] == info["executed"] + 2,
                  f"{what}: {ring['written']} records for "
                  f"{info['executed']} scalar tasks")
            return
        t = info["tiers"]
        check(ring["dropped"] == 0, f"{what}: the ring wrapped")

        def tag(k):
            return recs[recs[:, 0] == k]
        bat = tag(ttb.TR_FIRE_BATCH)
        check(len(bat) == t["batch_rounds"]
              and int((bat[:, 2] & 0xFFFF).sum()) == t["batch_tasks"]
              and int(bat[:, 3].sum()) == t["prefetch_hits"]
              and len(tag(ttb.TR_FIRE_SCALAR)) == t["scalar_tasks"]
              and len(tag(ttb.TR_FIRE_AGE)) == t["age_fires"]
              and int(tag(ttb.TR_SPILL)[:, 3].sum()) == t["spilled"]
              and len(tag(ttb.TR_ROUND_BEGIN)) == 1,
              f"{what}: records do not reconcile with the tiers {t}")

    held = []

    def traced_arm(name, make, cap, b, data=None, iv=None, extra=None,
                   hold="traced"):
        """Time ``make(None, d)`` against ``make(cap, d)`` (and ``extra``'s
        builds) on the card, reconcile the traced run's records with its
        counters, and queue build ``hold`` for ``hold_plain``."""
        makes = {"untraced": lambda d: make(None, d),
                 "traced": lambda d: make(cap, d), **(extra or {})}
        mks = {k: m("cuda") for k, m in makes.items()}
        ms = alternate(mks, b, data, iv)
        _, _, info = mks["traced"].run(b, data=data, ivalues=iv)
        reconcile(info, name)
        held.append((name, hold, mks[hold], makes[hold]("cpu"), b, data, iv))
        ring = info["trace"]["rings"][0]
        over = ms["traced"] - ms["untraced"]
        tr_arms[name] = {
            "executed": info["executed"], "capacity": cap,
            "written": ring["written"], "dropped": ring["dropped"],
            **{f"{k}_ms": v for k, v in ms.items()},
            "overhead_ms": over,
            "overhead_ns_a_record": over * 1e6 / ring["written"],
            "reconciled": True}

    def hold_plain():
        """Each queued card build's whole output, its decoded ring and the
        ring's header included (the wrap of fib(24)'s 1,024-record ring
        with them), word for word against the same build on the plain
        core; outside the main path's launch counts. The largest
        difference."""
        err = 0.0
        for name, hold, card, plain, b, data, iv in held:
            got = raw_state(card, b, data, ivalues=iv)
            t0 = time.perf_counter()
            want = raw_state(plain, b, data, ivalues=iv)
            tr_arms[name]["plain_host_s"] = time.perf_counter() - t0
            err = max(err, ints_equal(got, want, f"traced {name} ({hold})"))
            tr_arms[name]["equal_to_plain_core"] = hold
        return err

    fib24 = fib_graph(24)[0]

    def fib_tc(d):
        return tw.make_fib_megakernel(768, trace=1024, checkpoint=True,
                                      device=d)
    traced_arm(
        "fib24", lambda c, d: tw.make_fib_megakernel(768, trace=c, device=d),
        1024, fib24, extra={"traced_checkpoint": fib_tc},
        hold="traced_checkpoint")
    uts20 = TaskGraphBuilder()
    uts20.add(tw.UTS_NODE, args=[1, 0])
    traced_arm("uts20_b8", lambda c, d: tw.make_uts_megakernel(
        max_depth=20, batch_width=8, trace=c, device=d), 1 << 17, uts20)

    def bfs9(c, d):
        return tf.make_frontier_megakernel(
            tf.bfs_kernel(), g9, width=8, capacity=GB["capacity"], trace=c,
            device=d)
    fbb, fbiv, fbdata = tf.frontier_state("bfs", g9, bfs9(None, "cpu"))
    traced_arm("bfs9_w8", bfs9, 4096, fbb, fbdata, fbiv)
    launches = path_done("trace")
    tr_err = hold_plain()
    # The row's plain time: the plain core's fib(24) traced and polled
    # less its untraced run, timed alternately (medians of three each).
    pmk = {"untraced": tw.make_fib_megakernel(768, device="cpu"),
           "traced_checkpoint": fib_tc("cpu")}
    ptimes = {k: [] for k in pmk}
    for r in range(3):
        for k in (list(pmk) if r % 2 == 0 else list(pmk)[::-1]):
            ptimes[k].append(plain_ms(lambda: pmk[k].run(fib24))[0])
    pmed = {k: float(np.median(v)) for k, v in ptimes.items()}
    tr_plain_ms = pmed["traced_checkpoint"] - pmed["untraced"]
    f24 = tr_arms["fib24"]
    f24.update({f"plain_{k}_ms": v for k, v in pmed.items()})
    polls = f24["executed"] + 1  # a poll a round: a task each, then exit
    tr_bound = bound(0.0, 16.0 * f24["written"] + 8.0 * polls)
    kernels["tracebuf"] = {
        "name": "tracebuf", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/megakernel.cu",
        "replaces": "hclib_tpu/device/tracebuf.py:336",
        "max_abs_err": max(obs_err, tr_err),
        "ms": f24["traced_checkpoint_ms"] - f24["untraced_ms"],
        "plain_ms": tr_plain_ms,
        "bound_ms": tr_bound[0], "bound_by": tr_bound[1],
        "library_ms": None,
    }
    emit({"phase": "trace", "arms": tr_arms,
          "fib24_traced_checkpoint_overhead_ms": kernels["tracebuf"]["ms"],
          "fib24_plain_overhead_ms": tr_plain_ms,
          "bound_ms": tr_bound[0], "bound_by": tr_bound[1],
          "library": "none: no PyTorch call records a scheduler trace",
          "launches": launches})

    # 24. checkpoint: quiesce at half the tasks, bundle to a temporary
    # directory, restore_megakernel on a fresh build; then the poll's
    # cost with no quiesce, and the bundle store
    _build.reset_launches()
    ck_dir = tempfile.mkdtemp(prefix="hclib-smoke-ckpt-")
    ck_arms, bundles = {}, {}

    def ckpt_arm(name, make, b, total, data_fn=lambda: None, iv=None,
                 exact=True):
        """Quiesce at total // 2, save, restore on a fresh build; returns
        (quiesced info, restored (ivalues, data, info)). ``exact``: the
        resumed run executes the uninterrupted run's task count (a
        spawn tree or a static DAG; a label-correcting traversal's count
        follows its pop order, which the cut's spill changes)."""
        mk = make()
        t0 = time.perf_counter()
        _, _, iq = mk.run(b, data=data_fn(), ivalues=iv, quiesce=total // 2)
        quiesce_s = time.perf_counter() - t0
        check(iq["quiesced"] and iq["pending"] > 0,
              f"checkpoint {name}: no quiesce mid-graph")
        bundle = bundles[name] = tck.snapshot_megakernel(mk, iq)
        path = os.path.join(ck_dir, name)
        stats = bundle.save(path)
        t0 = time.perf_counter()
        out = tck.restore_megakernel(path, make())
        restore_s = time.perf_counter() - t0
        shutil.rmtree(path, ignore_errors=True)
        check(out[2]["pending"] == 0
              and (out[2]["executed"] == total or not exact),
              f"checkpoint {name}: resumed to {out[2]['executed']} of "
              f"{total}")
        ck_arms[name] = {
            "executed": total, "resumed_executed": out[2]["executed"],
            "checkpoint_at": iq["quiesce"]["executed_at"],
            "pending_at_cut": iq["pending"], "quiesce_entry_s": quiesce_s,
            "bundle_bytes": stats["bundle_bytes"], "save_s": stats["save_s"],
            "restore_s": restore_s}
        return iq, out

    for width in (0, 8):
        name = f"uts20_b{width}"
        iq, (ivr, _, _) = ckpt_arm(
            name, lambda w=width: tw.make_uts_megakernel(
                max_depth=20, batch_width=w or None, checkpoint=True,
                device="cuda"), uts20, 498965)
        check(int(ivr[0]) == 498965, f"{name}: resumed count {int(ivr[0])}")
        mkc = tw.make_uts_megakernel(max_depth=20, batch_width=width or None,
                                     checkpoint=True, device="cpu")
        ic = mkc.run(uts20, quiesce=498965 // 2)[2]
        check(ic["quiesce"] == iq["quiesce"] and all(
            np.array_equal(ic["state"][k], iq["state"][k])
            for k in ("tasks", "ready", "counts", "ivalues")),
            f"{name}: the state at the cut differs from the plain core's")
        ck_arms[name]["state_equal_to_plain_core"] = True
    _, (_, dr, _) = ckpt_arm(
        "cholesky_n8192_t512", lambda: tc.make_cholesky_megakernel(
            nt, tile=ts, fused_only=True, checkpoint=True, device="cuda"),
        tc.build_cholesky_graph(nt), 151,
        lambda: tc.cholesky_buffers(a, nt, ts, device="cuda"))
    check(torch.equal(torch.tril(tc._from_tiles(dr["tiles"], nt, ts))
                      .view(torch.int32), L5.view(torch.int32)),
          "cholesky: the resumed L differs from phase 5's")
    ck_arms["cholesky_n8192_t512"]["L_equal_to_phase5"] = True
    del dr, L5

    def dg16_mk():
        mk = td.make_dyngraph_megakernel(
            "sssp", g16d, width=8, capacity=cap16, num_values=nv16,
            checkpoint=True, device="cuda")
        td._bind_updates(mk, g16d)
        return mk

    db16, div16, ddata16 = td.dyngraph_state("sssp", g16d, dg16_mk(), 0,
                                             qs16, m0=GB["m0"],
                                             reps=GB["reps"])
    _, (ivr, _, _) = ckpt_arm(
        "dyngraph16_sssp_w8", dg16_mk, db16, arms22["sssp_w8"]["executed"],
        lambda: ddata16, div16, exact=False)
    ivr = np.asarray(ivr)
    flags = ivr[g16d.flag_base:g16d.flag_base + g16d.upd_cap]
    check(np.array_equal(ivr[g16d.st_base:g16d.st_base + g16d.n],
                         refs16d["sssp"])
          and int((flags != 0).sum()) == 1 << 15
          and int(ivr[td.V_DROPPED]) == 0,
          "dyngraph scale 16: the resumed run differs from host_dyngraph")
    ck_arms["dyngraph16_sssp_w8"]["equal_to_host_dyngraph"] = True
    del g16d, refs16d, ddata16
    # The poll with no quiesce: fib(24) and UTS 20, checkpoint off and on
    # at stride 1 and 64.
    poll_arms = {}
    for name, make, b in (
            ("fib24", lambda **kw: tw.make_fib_megakernel(
                768, device="cuda", **kw), fib24),
            ("uts20", lambda **kw: tw.make_uts_megakernel(
                max_depth=20, device="cuda", **kw), uts20)):
        mks = {"off": make(), "stride1": make(checkpoint=True),
               "stride64": make(checkpoint=True, quiesce_stride=64)}
        ms = alternate(mks, b)
        st = mks["stride1"].state(b)
        mks["stride1"].launch(st)
        rounds = int(st["qstat"][tmk.QS_POLLS])
        poll_arms[name] = {
            **{f"{k}_ms": v for k, v in ms.items()}, "rounds": rounds,
            **{f"{k}_overhead": ms[k] / ms["off"] - 1
               for k in ("stride1", "stride64")},
            "stride1_ns_a_round": (ms["stride1"] - ms["off"]) * 1e6 / rounds}
    launches = path_done("checkpoint")
    # The store: publish with and without fsync, and a cold load_latest
    # clean and past two corrupt generations, on the UTS bundle.
    sb = bundles["uts20_b0"]

    def publish(fsync, trials=5):
        times = []
        for _ in range(trials):
            d = tempfile.mkdtemp(dir=ck_dir)
            t0 = time.perf_counter()
            tck.BundleStore(d, keep=3, fsync=fsync).save(sb)
            times.append(time.perf_counter() - t0)
            shutil.rmtree(d, ignore_errors=True)
        return float(np.median(times))

    def cold_load(corrupt):
        d = tempfile.mkdtemp(dir=ck_dir)
        st = tck.BundleStore(d, keep=3, fsync=False)
        for _ in range(3):
            st.save(sb)
        for g in st.generations()[len(st.generations()) - corrupt:]:
            npz = os.path.join(st.path_of(g), "state.npz")
            blob = open(npz, "rb").read()
            with open(npz, "wb") as f:
                f.write(blob[:-4] + b"\xff" * 4)
        reader = tck.BundleStore(d, fsync=False)
        t0 = time.perf_counter()
        got = reader.load_latest()
        dt = time.perf_counter() - t0
        check(len(reader.faults) == corrupt and got.diff(sb)["equal"],
              f"store cold load past {corrupt} corrupt generations")
        shutil.rmtree(d, ignore_errors=True)
        return dt

    store = {"publish_fsync_s": publish(True),
             "publish_nofsync_s": publish(False),
             "cold_load_clean_s": cold_load(0),
             "cold_load_healing_s": cold_load(2),
             "bundle_bytes": ck_arms["uts20_b0"]["bundle_bytes"]}
    shutil.rmtree(ck_dir, ignore_errors=True)
    emit({"phase": "checkpoint", "arms": ck_arms, "poll": poll_arms,
          "store": store, "launches": launches})

    # 25. the streaming front door at real load: (a) three lanes at
    # 4:2:1, 4,096 SUM requests a lane into a running fib(20); (b)
    # serve_dyngraph at scale 16 with phase 22's stream
    from hclib_tpu_torch.device.egress import EgressSpec
    from hclib_tpu_torch.device.inject import (EntryBlocks,
                                               StreamingMegakernel)
    from hclib_tpu_torch.device.telemetry import TelemetryBlock
    from hclib_tpu_torch.device.tenants import (TC_INSTALLED, TenantSpec,
                                                TenantTable)

    _build.reset_launches()
    PER, lanes_a = 4096, (("gold", 4), ("silver", 2), ("bronze", 1))
    cap_a = 3 * PER + 64  # bench.py --serve's rule
    host_a = 64 + 3 * PER  # presets, then one out slot a request
    nv_a = tw.VBLOCK * cap_a + host_a
    iv_a = np.zeros(nv_a, np.int32)
    iv_a[1:9] = np.random.default_rng(0).integers(-1000, 1000, 8)

    def serve_a(device):
        # Every request is submitted before the run: each lane's host
        # backlog holds its 4,096 (TenantSpec's default holds 1,024).
        table = TenantTable([TenantSpec(t, weight=w, queue_capacity=PER)
                             for t, w in lanes_a],
                            PER, egress=EgressSpec(depth=64))
        sm = StreamingMegakernel(
            tw.make_fib_megakernel(cap_a, num_values=nv_a, device=device),
            ring_capacity=3 * PER, tenants=table, telemetry=True)
        sm.entry_log = []
        futs, want = [], []
        t0 = time.perf_counter()
        for lane, (tid, _) in enumerate(lanes_a):
            for i in range(PER):
                a_, b_ = 1 + i % 8, 1 + (3 * i + lane) % 8
                adm = sm.submit(tid, tw.SUM, args=[a_, b_],
                                out=64 + lane * PER + i)
                check(bool(adm), f"serve (a): {tid} request {i}: {adm}")
                futs.append(adm.future)
                want.append(int(iv_a[a_]) + int(iv_a[b_]))
        submit_s = time.perf_counter() - t0
        sm.close()
        b = TaskGraphBuilder()
        b.add(tw.FIB, args=[20], out=0)
        b.reserve_values(host_a)
        t0 = time.perf_counter()
        iv, info = sm.run_stream(b, ivalues=iv_a)
        run_s = time.perf_counter() - t0
        check(int(iv[0]) == 6765, f"serve (a): fib(20) = {int(iv[0])}")
        check([f.state for f in futs] == ["RESULT"] * len(futs)
              and [f.value for f in futs] == want,
              "serve (a): a future did not resolve to its sum")
        cons = table.futures.conservation()
        check(cons["ok"] and cons["resolved"] == 3 * PER, f"serve (a) {cons}")
        return sm, futs, iv, info, submit_s, run_s

    sm_a, futs_a, iv_a_out, info_a, submit_s, run_s = serve_a("cuda")
    # WRR shares: in every entry that ended with every lane still holding
    # rows, the installs are whole rounds of 4:2:1 plus at most one
    # partial round (the egress credit gate: a 64-row mailbox and park
    # ring hold 128 results an entry, and the round that fills them is
    # cut in lane order).
    shares, prev = [], [0, 0, 0]
    blocks = EntryBlocks(3, 64, True)
    for blk in sm_a.entry_log:
        blocks.arr[:] = blk
        inst = blocks.v["tctl"][:, TC_INSTALLED].tolist()
        if max(inst) < PER and min(inst) > 0:
            shares.append([x - p for x, p in zip(inst, prev)])
        prev = inst
    whole = [min(g // 4, s_ // 2, b_) for g, s_, b_ in shares]
    check(shares and all(
        0 <= g - 4 * k <= 4 and 0 <= s_ - 2 * k <= 2 and 0 <= b_ - k <= 1
        for (g, s_, b_), k in zip(shares, whole)),
        f"serve (a): installs not at 4:2:1 while all lanes held rows: "
        f"{shares[:4]}")
    lat = sorted(f.latency_s() for f in futs_a)
    snap = sm_a.telemetry_snapshot()
    tb_ = TelemetryBlock(snap["tele"], snap["ns_per_round"])
    ta = sm_a.timing
    arm_a = {
        "requests": 3 * PER, "lanes": dict(lanes_a), "egress_depth": 64,
        "capacity": cap_a, "executed": info_a["executed"],
        "submit_s": submit_s, "run_s": run_s,
        "req_per_s": 3 * PER / (submit_s + run_s),
        "req_per_s_run": 3 * PER / run_s,
        "p50_latency_s": lat[len(lat) // 2],
        "p99_latency_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "hist_requests": tb_.total(), "hist_rounds": snap["rounds"],
        "hist_p50_rounds": tb_.quantile(0.5),
        "hist_p99_rounds": tb_.quantile(0.99),
        "hist_p50_latency_s": tb_.quantile_s(0.5),
        "hist_p99_latency_s": tb_.quantile_s(0.99),
        "ns_per_round": snap["ns_per_round"],
        "entries": ta["entries"],
        "launch_us_per_entry": ta["kernel_ms"] * 1e3 / ta["entries"],
        "entry_us_per_entry": ta["entry_ms"] * 1e3 / ta["entries"],
        "host_pump_drain_us_per_entry":
            (run_s * 1e3 - ta["entry_ms"]) * 1e3 / ta["entries"],
        "kernel_ms": ta["kernel_ms"], "wrr_entries_checked": len(shares),
        "wrr_installs_first_entries": shares[:3],
        "installs_4_2_1": True, "futures_resolved": True,
    }
    # (b) serve_dyngraph at scale 16, scalar arm, 32,768 updates on the
    # updates lane and 64 queries on the queries lane.
    g16s = td.DynGraph(*e16, spare_blocks=2, upd_cap=1 << 15)
    cap_b = 1 << 19
    t0 = time.perf_counter()
    res16, info16 = td.serve_dyngraph(
        "sssp", g16s, 0, updates=serve16["updates"],
        queries=serve16["queries"], capacity=cap_b,
        num_values=g16s.num_value_slots + 64, ring_capacity=2 << 15,
        egress_depth=64, device="cuda")
    serve_s = time.perf_counter() - t0
    check(np.array_equal(res16, serve16["ref"]),
          "serve (b): scale 16 differs from host_dyngraph")
    check(info16["dropped"] == 0 and info16["updates_applied"] == 1 << 15,
          f"serve (b): applied {info16['updates_applied']}, dropped "
          f"{info16['dropped']}")
    check(info16["query_results"] == info16["query_values"],
          "serve (b): query futures differ from the published labels")
    futs_b = info16["update_futures"] + info16["query_futures"]
    check(all(f.state == "RESULT" for f in futs_b),
          "serve (b): a future did not resolve")
    qlat = sorted(f.latency_s() for f in info16["query_futures"])
    peak_alloc = info16["allocated"]
    arm_b = {
        "graph": "rmat_edges(16, efactor=16, seed=7)", "vertices": g16s.n,
        "static_edges": g16s.m, "updates": 1 << 15,
        "queries": len(serve16["queries"]), "capacity": cap_b,
        "peak_allocated": peak_alloc, "executed": info16["executed"],
        "entries": info16["entries"], "serve_s": serve_s,
        "updates_per_s": (1 << 15) / serve_s,
        "query_p50_latency_s": qlat[len(qlat) // 2],
        "query_p99_latency_s": qlat[min(len(qlat) - 1,
                                        int(0.99 * len(qlat)))],
        "edges": info16["edges"], "relaxations": info16["relaxations"],
        "spare_in_use": info16["spare_in_use"],
        "equal_to_host_dyngraph": True, "futures_resolved": True,
    }
    del g16s, res16, info16, futs_b
    launches = path_done("serve")
    # Outside the counts: arm (a) on the plain stream, every entry's
    # echoed block, the final state and the futures against the card's.
    sm_p, futs_p, iv_p, _, _, run_p = serve_a("cpu")
    a_err = stream_holds.compare(
        stream_holds.clean({"iv": iv_p, "entries": sm_p.entry_log,
                             "final": sm_p.final_state, "futs": futs_p}),
        stream_holds.clean({"iv": iv_a_out, "entries": sm_a.entry_log,
                             "final": sm_a.final_state, "futs": futs_a}),
        "serve (a) plain")
    arm_a["plain_entry_ms"] = sm_p.timing["entry_ms"]
    arm_a["plain_run_s"] = run_p
    # The bound: every task executed, the installed requests included,
    # moves row 1's 136 bytes (its descriptor written once, at install in
    # place of spawn, and read once at the pop, and one ring push and
    # pop). Each installed request moves besides: 80 bytes of its ring
    # row read (20 of its 21 words: all but TEN_DEADLINE_MS); 16 bytes
    # written at install and fire (its etok word and the admit, install
    # and fire stamps); 16 bytes at its retirement (the etok word and the
    # admit and install stamps read, the etok word zeroed); its 32-byte
    # mailbox row written. The tenant histograms (16 words a lane) and
    # the body's value words are left out, as row 1 leaves out a body's
    # data.
    sb = bound(0.0, 3 * PER * (20 * 4 + 16 + 16 + 32)
               + info_a["executed"] * 136.0)
    kernels["stream"] = {
        "name": "stream", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/stream.cuh",
        "replaces": "hclib_tpu/device/inject.py:1048",
        "max_abs_err": a_err, "ms": ta["kernel_ms"],
        "plain_ms": sm_p.timing["entry_ms"],
        "bound_ms": sb[0], "bound_by": sb[1], "library_ms": None,
    }
    del sm_p, futs_p
    emit({"phase": "serve", "tenants": arm_a, "dyngraph16": arm_b,
          "bound_ms": sb[0], "bound_by": sb[1],
          "library": "none: no PyTorch call runs a streaming scheduler",
          "launches": launches})

    # 26. the mesh (bench.py --multichip and the multi-chip dry run's
    # phases 1-3): a mesh device is one co-resident CTA. FOREST_STEAL_BENCH
    # (8 devices, 160 x fib(12) on device 0, 111,520 tasks) through the
    # sharded runner scalar and at width 8, through ICIStealMegakernel at
    # 8 devices (the resident steal-only kernel) and at 6 (the ring); the
    # dry run's per-device queues; the whole card: the resident kernel at
    # 128 CTAs on 2,048 x fib(12). Each forest arm is held to its exact
    # totals; the plain versions run every forest arm too (outside the
    # launch counts), and each arm is held to its plain run word for word.
    from hclib_tpu_torch.device import stress as tst
    from hclib_tpu_torch.device.ici_steal import ICIStealMegakernel
    from hclib_tpu_torch.device.sharded import ShardedMegakernel
    from hclib_tpu_torch.parallel.mesh import CtaMesh

    _build.reset_launches()
    FB = tst.FOREST_STEAL_BENCH
    mesh_arms, mesh_out = {}, {}

    def forest_arm(name, info, seconds, ndev):
        per_dev = np.asarray(info["per_device_counts"])[:, 5]
        ex = info.get("exchange", {})
        arm = {
            "tasks": info["executed"], "seconds": seconds,
            "tasks_per_s": info["executed"] / seconds,
            "rounds": info.get("steal_rounds", info.get("rounds")),
            "devices_used": int((per_dev > 0).sum()),
            "imbalance": float(per_dev.max() * ndev / max(per_dev.sum(), 1)),
            "kernel_ms": ex.get("kernel_ms", info.get("kernel_ms")),
            "exchange_ms": info.get("exchange_ms"),
            "rows_exported": sum(ex["rows"]) if ex else None,
            "stat_words": sum(ex["stat_words"]) if ex else None,
        }
        if "tiers" in info:
            occ = [t["batch_occupancy"] for t in info["tiers"]
                   if t["batch_rounds"]]
            arm["mean_occupancy"] = sum(occ) / len(occ)
        mesh_arms[name] = arm
        emit({"phase": "multichip", "arm": name, **arm})

    for bw in (0, 8):
        info = tst.forest_steal(**FB, batch_width=bw, device="cuda")
        forest_arm(f"sharded_b{bw}", info, info["seconds"], FB["ndev"])
        mesh_out[f"sharded_b{bw}"] = (info["ivalues"], info)

    def ici_forest(ndev, roots, device, warm=True):
        mk = tst.forest_megakernel(roots, FB["capacity"], 0, device)
        m = ICIStealMegakernel(mk, CtaMesh((ndev,), ("q",), device=device),
                               migratable_fns=[tw.FIB], window=8)
        if warm:
            m.run(tst.forest_builders(ndev, roots, FB["n"]), quantum=64)
        t0 = time.perf_counter()
        iv, _, info = m.run(tst.forest_builders(ndev, roots, FB["n"]),
                            quantum=64)
        dt = time.perf_counter() - t0
        tst.check_forest(iv, info, roots, FB["n"])
        return iv, info, dt

    for name, ndev in (("resident_8", 8), ("ring_6", 6)):
        iv, info, dt = ici_forest(ndev, FB["roots"], "cuda")
        forest_arm(name, info, dt, ndev)
        mesh_out[name] = (iv, info)
    # The dry run's phase 1: per-device fib trees, no steal.
    mk1 = tw.make_fib_megakernel(512, device="cuda")
    bs1 = [TaskGraphBuilder() for _ in range(8)]
    for d, b in enumerate(bs1):
        b.add(tw.FIB, args=[8 + d % 3], out=0)
    iv1, _, info1 = ShardedMegakernel(mk1, CtaMesh((8,), ("q",))).run(
        bs1, fuel=1 << 16)
    check([int(x) for x in iv1[:, 0]] == [{8: 21, 9: 34, 10: 55}[8 + d % 3]
                                           for d in range(8)],
          f"per-device queues: {iv1[:, 0].tolist()}")
    mesh_arms["per_device_queues"] = {"values": iv1[:, 0].tolist(),
                                      "executed": info1["executed"]}
    # The whole card: 128 co-resident CTAs.
    iv, info, dt = ici_forest(128, 2048, "cuda")
    check(info["executed"] == 1427456, f"128 CTAs: {info['executed']}")
    forest_arm("resident_128", info, dt, 128)
    mesh_out["resident_128"] = (iv, info)
    launches = path_done("multichip")
    # Outside the counts: the plain version of every timed arm on the same
    # inputs, word for word: every device's value slots and counts row,
    # the rounds, the tier counters, the fault stats and the rows and stat
    # words each device sent.

    def same_words(name, card, plain):
        (iv_c, ic), (iv_p, ip) = card, plain
        check(np.array_equal(ic["per_device_counts"],
                             ip["per_device_counts"]),
              f"multichip {name}: per_device_counts differ from the plain "
              "version")
        for k in ("steal_rounds", "tiers", "fault_stats", "aborted"):
            check(ic.get(k) == ip.get(k),
                  f"multichip {name}: {k} differs from the plain version")
        for k in ("rows", "stat_words"):
            check(ic.get("exchange", {}).get(k)
                  == ip.get("exchange", {}).get(k),
                  f"multichip {name}: exchange {k} differs from the plain "
                  "version")
        check(np.array_equal(iv_c, iv_p),
              f"multichip {name}: ivalues differ from the plain version")
        return float(np.abs(np.asarray(iv_p, np.int64) - iv_c).max())

    plain, errs = {}, {}
    for name, ndev, roots in (("resident_8", 8, FB["roots"]),
                              ("ring_6", 6, FB["roots"]),
                              ("resident_128", 128, 2048)):
        iv_p, info_p, _ = ici_forest(ndev, roots, "cpu", warm=False)
        errs[name] = same_words(name, mesh_out[name], (iv_p, info_p))
        plain[name] = info_p["exchange"]["kernel_ms"]
    for bw in (0, 8):
        name = f"sharded_b{bw}"
        mk_p = tst.forest_megakernel(FB["roots"], FB["capacity"], bw, "cpu")
        iv_p, _, info_p = ShardedMegakernel(
            mk_p, CtaMesh((FB["ndev"],), ("q",), device="cpu"),
            migratable_fns=[tw.FIB]).run(
                tst.forest_builders(FB["ndev"], FB["roots"], FB["n"]),
                steal=True, quantum=256, window=16)
        errs[name] = same_words(name, mesh_out[name], (iv_p, info_p))
        plain[name] = info_p["kernel_ms"]
    emit({"phase": "multichip", "plain_equal": sorted(errs),
          "max_abs_err": errs, "plain_ms": plain})
    # Bounds: row 1's 136 bytes a task, and for the steal kernels the
    # exchange: 4 bytes a stat word sent and 64 bytes a descriptor row
    # moved, both sums over every round and device of the run.
    # A kernel's max_abs_err is the largest over its mesh holds and every
    # forest arm that ran it.
    for key, arm, others, src, rep_ in (
            ("mesh_round", "sharded_b0", ("sharded_b8",), "csrc/mesh.cuh",
             "hclib_tpu/device/megakernel.py:2165"),
            ("resident_steal", "resident_8", ("resident_128",),
             "csrc/mesh.cuh", "hclib_tpu/device/resident.py:2222"),
            ("ici_ring", "ring_6", (), "csrc/mesh.cuh",
             "hclib_tpu/device/ici_steal.py:765")):
        a = mesh_arms[arm]
        nbytes = a["tasks"] * 136.0 + 4.0 * (a["stat_words"] or 0) \
            + 64.0 * (a["rows_exported"] or 0)
        kb = bound(0.0, nbytes)
        kernels[key] = {
            "name": key, "route": "cuda",
            "source": "hclib_tpu_torch/" + src, "replaces": rep_,
            "max_abs_err": max([errs[arm], mesh_hold_err[key]]
                               + [errs[o] for o in others]),
            "ms": a["kernel_ms"],
            "plain_ms": plain[arm], "bound_ms": kb[0], "bound_by": kb[1],
            "library_ms": None,
        }
    emit({"phase": "multichip", "arms": mesh_arms, "plain_ms": plain,
          "library": "none: no PyTorch call runs a task scheduler",
          "launches": launches})

    # 27. user bodies and the resident kernel's PGAS configuration: the
    # user library's scheduler at full size (below); the
    # multi-chip dry run's phases 2, 3 and 4 literally at 8 devices (its
    # user-body tables through the sharded steal, the ICI steal - the
    # resident kernel steal-only - and PGASMegakernel), then the PGAS
    # exchange across the whole card, 128 co-resident CTAs: every device
    # reads its landing words, then starts its left neighbour's SEND,
    # which AMs a BUMP at every device (16,384 messages, am_window 8) and
    # puts its 16 source rows into its ring neighbour's heap, whose
    # consumer waits on (c0, 16) and reads the landed words. Each is
    # held to its
    # assertions; outside the launch counts each runs on the plain
    # version too, word for word (value slots, counts, rounds, aborted,
    # fault stats, exchange volume, data buffers).
    from hclib_tpu_torch.device.pgas_kernel import PGASMegakernel

    _build.reset_launches()
    pgas_arms, pgas_out = {}, {}
    # The user library's scheduler at full size: fib(24) written as user
    # bodies (mesh_holds.USER_TABLE's UFIB / USUM, 225,073 tasks) on one
    # device through Megakernel.run, then timed launch by launch; and a
    # forest of 2,048 UFIB(12) roots dealt over 128 CTAs (1,427,456
    # tasks) through the sharded runner's grid launch.
    umk = mesh_holds.user_megakernel(768, "cuda")
    ub = mesh_holds.user_builder("ufib", 24)
    t0 = time.perf_counter()
    iv, _, info = umk.run(ub)
    dt = time.perf_counter() - t0
    check(int(iv[0]) == 46368 and info["executed"] == 225073,
          f"user fib(24): {int(iv[0])}, executed {info['executed']}")
    ufib_ms, ust = timed_launch(umk, ub)
    pgas_arms["user_fib_24"] = {
        "executed": info["executed"], "seconds": dt, "kernel_ms": ufib_ms,
        "tasks_per_s": info["executed"] / (ufib_ms * 1e-3)}
    emit({"phase": "pgas", "arm": "user_fib_24",
          **pgas_arms["user_fib_24"]})
    t0 = time.perf_counter()
    fiv, finfo = mesh_holds.user_forest(128, 2048, 12, "cuda")
    dt = time.perf_counter() - t0
    pgas_arms["user_forest_128"] = {
        "executed": finfo["executed"], "seconds": dt,
        "kernel_ms": finfo["kernel_ms"],
        "tasks_per_s": finfo["executed"] / (finfo["kernel_ms"] * 1e-3)}
    emit({"phase": "pgas", "arm": "user_forest_128",
          **pgas_arms["user_forest_128"]})

    def dryrun(phase, device):
        mesh = CtaMesh((8,), ("queues",), device=device)
        if phase == 2:
            return ShardedMegakernel(
                tst.bump_megakernel(device), mesh, migratable_fns=[0]).run(
                    tst.dryrun_builders(2, 8), steal=True, quantum=4,
                    window=8)
        if phase == 3:
            return ICIStealMegakernel(
                tst.bump_megakernel(device), mesh, migratable_fns=[0],
                window=32).run(tst.dryrun_builders(3, 8), quantum=16)
        bs, waits, heap4 = tst.dryrun_builders(4, 8)
        return PGASMegakernel(tst.put_consume_megakernel(device), mesh,
                              channels={"c0": ("heap", 1)}).run(
            bs, data={"heap": heap4}, waits=waits)

    for phase in (2, 3, 4):
        t0 = time.perf_counter()
        iv, data, info = dryrun(phase, "cuda")
        dt = time.perf_counter() - t0
        check(info["pending"] == 0, f"dry run phase {phase}: pending")
        if phase < 4:
            check(int(iv[:, 0].sum()) == 64 * 65 // 2,
                  f"dry run phase {phase}: total {int(iv[:, 0].sum())}")
        else:
            check(all(int(iv[d, 0]) >= 1 for d in range(8)),
                  f"dry run phase 4: {iv[:, 0].tolist()}")
        pgas_out[f"dryrun_{phase}"] = (iv, data, info)
        ex = info.get("exchange", {})
        pgas_arms[f"dryrun_{phase}"] = {
            "seconds": dt, "executed": info["executed"],
            "rounds": info.get("steal_rounds", info.get("rounds")),
            "devices_used": int((np.asarray(info["per_device_counts"])[:, 5]
                                 > 0).sum()),
            "kernel_ms": ex.get("kernel_ms", info.get("kernel_ms")),
            "rows_exported": sum(ex.get("rows", [])) if ex else None,
            "stat_words": sum(ex.get("stat_words", [])) if ex else None}
        emit({"phase": "pgas", "arm": f"dryrun_{phase}",
              **pgas_arms[f"dryrun_{phase}"]})

    def pgas_card(device, warm=False):
        mk = tst.pgas_megakernel(capacity=1024, device=device)
        pg = PGASMegakernel(mk, CtaMesh((128,), ("q",), device=device),
                            channels={"c0": ("heap", 1)}, am_window=8,
                            outbox=256)
        if warm:
            bs, waits, heap = tst.pgas_builders(128, True)
            pg.run(bs, data={"heap": heap}, waits=waits)
        bs, waits, heap = tst.pgas_builders(128, True)
        t0 = time.perf_counter()
        iv, data, info = pg.run(bs, data={"heap": heap}, waits=waits)
        dt = time.perf_counter() - t0
        tst.check_pgas(iv, data["heap"].cpu().numpy(), info, 128, True)
        return iv, data, info, dt

    iv, data, info, dt = pgas_card("cuda", warm=True)
    ex = info["exchange"]
    kms = ex["kernel_ms"]
    pgas_out["pgas_128"] = (iv, data, info)
    pgas_arms["pgas_128"] = {
        "tasks": info["executed"], "seconds": dt, "kernel_ms": kms,
        "tasks_per_s": info["executed"] / (kms / 1e3),
        "rounds": info["rounds"], "ams": sum(ex["ams"]),
        "puts": sum(ex["puts"]),
        "ams_per_s": sum(ex["ams"]) / (kms / 1e3),
        "puts_per_s": sum(ex["puts"]) / (kms / 1e3),
        "rows_exported": sum(ex["rows"]), "stat_words": sum(ex["stat_words"]),
    }
    emit({"phase": "pgas", "arm": "pgas_128", **pgas_arms["pgas_128"]})
    launches = path_done("pgas")
    # Outside the counts: the plain version of every arm, word for word.

    def same_pgas(name, card, plain):
        (iv_c, d_c, ic), (iv_p, d_p, ip) = card, plain
        check(np.array_equal(iv_c, iv_p),
              f"pgas {name}: ivalues differ from the plain version")
        check(np.array_equal(ic["per_device_counts"], ip["per_device_counts"]),
              f"pgas {name}: per_device_counts differ from the plain version")
        for k in ("steal_rounds", "rounds", "fault_stats", "aborted"):
            check(ic.get(k) == ip.get(k),
                  f"pgas {name}: {k} differs from the plain version")
        for k in ("rows", "stat_words", "ams", "puts"):
            check(ic.get("exchange", {}).get(k)
                  == ip.get("exchange", {}).get(k),
                  f"pgas {name}: exchange {k} differs from the plain version")
        for k in d_p:
            check(torch.equal(d_c[k].cpu(), d_p[k].cpu()),
                  f"pgas {name}: data {k} differs from the plain version")
        return float(np.abs(np.asarray(iv_p, np.int64) - iv_c).max())

    pgas_plain, pgas_err = {}, {}
    pmk = mesh_holds.user_megakernel(768, "cpu")
    pst = pmk.state(ub)
    pgas_plain["user_fib_24"], _ = plain_ms(lambda: pmk.launch(pst))
    for k in ("tasks", "ready", "counts", "ivalues"):
        check(torch.equal(ust[k].cpu(), pst[k]),
              f"user fib(24): {k} differs from the plain core")
    pgas_err["user_fib_24"] = float(
        (ust["ivalues"].cpu().long() - pst["ivalues"].long()).abs().max())
    fiv_p, finfo_p = mesh_holds.user_forest(128, 2048, 12, "cpu")
    check(np.array_equal(fiv, fiv_p) and np.array_equal(
        finfo["per_device_counts"], finfo_p["per_device_counts"]),
        "user forest: differs from the plain version")
    pgas_err["user_forest_128"] = float(np.abs(
        np.asarray(fiv, np.int64) - fiv_p).max())
    pgas_plain["user_forest_128"] = finfo_p["kernel_ms"]
    for phase in (2, 3, 4):
        name = f"dryrun_{phase}"
        out_p = dryrun(phase, "cpu")
        pgas_err[name] = same_pgas(name, pgas_out[name], out_p)
        pgas_plain[name] = out_p[2].get("exchange", {}).get(
            "kernel_ms", out_p[2].get("kernel_ms"))
    iv_p, data_p, info_p, _ = pgas_card("cpu")
    pgas_err["pgas_128"] = same_pgas("pgas_128", pgas_out["pgas_128"],
                                     (iv_p, data_p, info_p))
    pgas_plain["pgas_128"] = info_p["exchange"]["kernel_ms"]
    emit({"phase": "pgas", "plain_equal": sorted(pgas_err),
          "max_abs_err": pgas_err, "plain_ms": pgas_plain})
    # Bounds (bytes): 136 B a task; 64 B an active message's descriptor
    # row moved (written into the inbox once, read once: 16 words each
    # way counted as the row), 4 B a stat word sent, and each put's rows
    # x cols x 4 B read once and written once. The user scheduler's
    # one-device run (user fib(24)): 136 B a task.
    a = pgas_arms["pgas_128"]
    put_bytes = tst.PGAS_COLS * 4
    kb = bound(0.0, a["tasks"] * 136.0 + 64.0 * a["ams"]
               + 4.0 * a["stat_words"] + 2.0 * put_bytes * a["puts"])
    kernels["resident_pgas"] = {
        "name": "resident_pgas", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/mesh.cuh",
        "replaces": "hclib_tpu/device/resident.py:2222",
        "max_abs_err": max([pgas_err["pgas_128"], pgas_err["dryrun_4"],
                            mesh_hold_err["resident_pgas"]]),
        "ms": kms, "plain_ms": pgas_plain["pgas_128"],
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": None,
    }
    a2 = pgas_arms["user_fib_24"]
    kb = bound(0.0, a2["executed"] * 136.0)
    kernels["mk_user"] = {
        "name": "mk_user", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/user.cuh",
        "replaces": "hclib_tpu/device/megakernel.py:2165",
        "max_abs_err": max([pgas_err["dryrun_2"], mesh_hold_err["mk_user"],
                            user_err, pgas_err["user_fib_24"],
                            pgas_err["user_forest_128"]]),
        "ms": a2["kernel_ms"], "plain_ms": pgas_plain["user_fib_24"],
        "bound_ms": kb[0], "bound_by": kb[1], "library_ms": None,
    }
    kernels["resident_steal"]["max_abs_err"] = max(
        kernels["resident_steal"]["max_abs_err"], pgas_err["dryrun_3"])
    emit({"phase": "pgas", "arms": pgas_arms, "plain_ms": pgas_plain,
          "library": "none: no PyTorch call runs a task scheduler or its "
                     "one-sided messages",
          "launches": launches})

    # 28. homed migration, value-arg rehydration and the remote atomics
    # and locks (the resident kernel's migrating configuration,
    # resident_homed, and the built-in active messages): the dry run's
    # phase 0 literally at 8 CTAs; mc-unified-resident as
    # tools/perf_regression.py runs it (stress.unified_load: 8 devices,
    # fib(10), 32 fetch-adds, capacity 1024, quantum 32, window 8), scalar
    # and width 8; the whole card, 128 CTAs: fib(24) on device 0 (225,073
    # tasks) and 2,048 fetch-adds, 16 a device, into device 0's slot 2;
    # and the lock workload on 128 CTAs (a LOCKER a device on device 0's
    # lock, qcap 128; each critical section's compare-swap tripwire, two
    # fetch-adds, the release; a fetch-add and a compare-swap with their
    # replies), through the PGAS configuration. Each arm is held to JAX's
    # exact totals, and outside the counts to its plain run word for word
    # (value slots, counts rows, rounds, fault stats, exchange volume,
    # proxies and their peak, the built-in messages each device applied).
    from hclib_tpu_torch.device.resident import ResidentKernel

    _build.reset_launches()
    homed_arms, homed_out = {}, {}

    def homed_run(name, device):
        """Arm ``name`` on ``device``: (ivalues, info, host seconds)."""
        t0 = time.perf_counter()
        if name == "dryrun_0":
            iv, info = tst.dryrun0(8, device)
        elif name.startswith("unified"):
            size = (dict(ndev=128, n=24, fadds=2048) if name ==
                    "unified_128" else {})
            info = tst.unified_load(batch_width=8 if name.endswith("b8")
                                    else 0, device=device, **size)
            iv = info["ivalues"]
        else:
            def locks():
                bs, iv0 = tst.lock_builders(128)
                rk = ResidentKernel(tst.lock_megakernel(device=device),
                                    CtaMesh((128,), ("q",), device=device),
                                    steal=False)
                return rk.run(bs, ivalues=iv0, quantum=8)
            if device == "cuda":
                locks()  # warm-up: the first launch of its library
                t0 = time.perf_counter()
            iv, _, info = locks()
            tst.check_locks(iv, info, 128)
        return np.asarray(iv), info, time.perf_counter() - t0

    HOMED = ("dryrun_0", "unified_8", "unified_8_b8", "unified_128",
             "locks_128")
    for name in HOMED:
        iv, info, dt = homed_run(name, "cuda")
        ex = info["exchange"]
        arm = {"seconds": dt, "kernel_ms": ex["kernel_ms"],
               "tasks": info["executed"], "rounds": info["rounds"],
               "devices_used": int((np.asarray(
                   info["per_device_counts"])[:, 5] > 0).sum()),
               "rows_exported": sum(ex["rows"]),
               "stat_words": sum(ex["stat_words"]), "ams": sum(ex["ams"]),
               "builtin_ams": {k: sum(v)
                               for k, v in info["builtin_ams"].items()},
               "proxies_peak": max(info["proxies_peak"])}
        arm["bound_ms"] = bound(0.0, 136.0 * arm["tasks"] + 64.0 * (
            arm["ams"] + arm["rows_exported"]) + 4.0 * arm["stat_words"])[0]
        homed_arms[name] = arm
        homed_out[name] = (iv, info)
        emit({"phase": "homed", "arm": name, **arm})
    iv, info = homed_out["unified_128"]
    check(int(iv[0, 3]) == 46368 and int(iv[0, 2]) == 2098176
          and info["executed"] == 225073 + 2048
          and homed_arms["unified_128"]["devices_used"] > 1,
          f"unified_128: slot 3 {int(iv[0, 3])}, slot 2 {int(iv[0, 2])}, "
          f"executed {info['executed']}")
    launches = path_done("homed")

    def same_homed(name, card, plain):
        (iv_c, ic), (iv_p, ip) = card, plain
        check(np.array_equal(iv_c, iv_p),
              f"homed {name}: ivalues differ from the plain version")
        check(np.array_equal(ic["per_device_counts"],
                             ip["per_device_counts"]),
              f"homed {name}: per_device_counts differ from the plain "
              "version")
        for k in ("rounds", "fault_stats", "aborted", "tiers", "proxies",
                  "proxies_peak", "builtin_ams"):
            check(ic.get(k) == ip.get(k),
                  f"homed {name}: {k} differs from the plain version")
        for k in ("rows", "stat_words", "ams", "puts"):
            check(ic["exchange"][k] == ip["exchange"][k],
                  f"homed {name}: exchange {k} differs from the plain "
                  "version")
        return float(np.abs(np.asarray(iv_p, np.int64) - iv_c).max())

    # Outside the counts: every arm's plain run, word for word.
    homed_plain, homed_err = {}, {}
    for name in HOMED:
        iv_p, info_p, dt = homed_run(name, "cpu")
        homed_err[name] = same_homed(name, homed_out[name], (iv_p, info_p))
        homed_plain[name] = info_p["exchange"]["kernel_ms"]
    emit({"phase": "homed", "plain_equal": sorted(homed_err),
          "max_abs_err": homed_err, "plain_ms": homed_plain})
    # The bound (bytes): 136 B a task, 64 B an active message or a
    # descriptor row moved, 4 B a stat word sent, over the memory rate.
    a = homed_arms["unified_128"]
    kernels["resident_homed"] = {
        "name": "resident_homed", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/mesh.cuh",
        "replaces": "hclib_tpu/device/resident.py:2222",
        "max_abs_err": max([homed_err[n] for n in HOMED if n != "locks_128"]
                           + [mesh_hold_err["resident_homed"]]),
        "ms": a["kernel_ms"], "plain_ms": homed_plain["unified_128"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes", "library_ms": None,
    }
    kernels["resident_pgas"]["max_abs_err"] = max(
        kernels["resident_pgas"]["max_abs_err"], homed_err["locks_128"])
    emit({"phase": "homed", "arms": homed_arms, "plain_ms": homed_plain,
          "library": "none: no PyTorch call runs a task scheduler, its "
                     "migration protocol or its remote atomics",
          "launches": launches})

    # 29. the injection ring and mesh tenancy (the resident kernel's
    # injecting instances, resident_inject): scripts/mesh_holds.py's
    # PHASE29 arms - JAX's three resident compositions that inject
    # (tests/test_resident.py :238 on 4 CTAs, and the TPU-only :420 and
    # :472 on one), 160 x fib(12) with 256 FIB(4) rows on each of 128
    # rings, and four tenant lanes through a MeshTenantTable on 128 CTAs.
    # Each arm runs twice on the card (the first launch of its library
    # is the warm-up), exact by JAX's assertions; then, outside the
    # counts, its plain run word for word (value slots, counts rows,
    # rounds, fault stats, exchange volume, heap, the tctl echo and the
    # table's stats).
    from hclib_tpu_torch.device.tenants import TC_CONSUMED

    _build.reset_launches()
    inj_arms, inj_out = {}, {}
    for name in mesh_holds.PHASE29:
        mesh_holds.run_arm(name, "cuda")  # warm-up
        t0 = time.perf_counter()
        got = mesh_holds.run_arm(name, "cuda")
        dt = time.perf_counter() - t0
        inj_out[name] = got
        # Rows the polls consumed: installed or dropped expired.
        ring_rows = (int(got["tenant_ctl"][:, :, TC_CONSUMED].sum())
                     if got["tenant_ctl"] is not None else
                     {"compose_4": 3, "five_way_1": 2, "volume_1": 64,
                      "inject_128": 128 * 256}[name])
        arm = {"seconds": dt, "kernel_ms": got["kernel_ms"],
               "tasks": got["executed"], "rounds": got["rounds"],
               "ring_rows": ring_rows,
               "expired_on_card": sum(f["tenant_expired"]
                                      for f in got["fault_stats"]),
               "devices_used": int((got["counts"][:, 5] > 0).sum()),
               "rows_exported": sum(got["rows"]),
               "stat_words": sum(got["stat_words"]), "ams": sum(got["ams"])}
        if got["tenants"] is not None:
            arm["tenants"] = {t: {k: v[k] for k in (
                "accepted", "completed", "expired", "dropped", "backlog")}
                for t, v in got["tenants"].items()}
        # The bound (bytes): row 7's 136 B a task, 64 B an active message
        # or a descriptor row moved, 4 B a stat word sent, and 64 B a
        # descriptor read from a ring row.
        arm["bound_ms"] = bound(0.0, 136.0 * arm["tasks"] + 64.0 * (
            arm["ams"] + arm["rows_exported"] + ring_rows)
            + 4.0 * arm["stat_words"])[0]
        inj_arms[name] = arm
        emit({"phase": "inject", "arm": name, **arm})
    check(inj_arms["inject_128"]["tasks"] == 537504
          and inj_arms["inject_128"]["devices_used"] == 128,
          f"inject_128: {inj_arms['inject_128']}")
    check(inj_arms["tenants_128"]["expired_on_card"] == 512,
          f"tenants_128: {inj_arms['tenants_128']}")
    launches = path_done("inject")
    # Outside the counts: every arm's plain run, word for word.
    inj_plain, inj_err = {}, {}
    for name in mesh_holds.PHASE29:
        want = mesh_holds.run_arm(name, "cpu")
        inj_err[name] = mesh_holds.compare(inj_out[name], want, name)
        inj_plain[name] = want["kernel_ms"]
    emit({"phase": "inject", "plain_equal": sorted(inj_err),
          "max_abs_err": inj_err, "plain_ms": inj_plain})
    a = inj_arms["inject_128"]
    kernels["resident_inject"] = {
        "name": "resident_inject", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/mesh.cuh",
        "replaces": "hclib_tpu/device/resident.py:2222",
        "max_abs_err": max(list(inj_err.values())
                           + [mesh_hold_err["resident_inject"]]),
        "ms": a["kernel_ms"], "plain_ms": inj_plain["inject_128"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes", "library_ms": None,
    }
    emit({"phase": "inject", "arms": inj_arms, "plain_ms": inj_plain,
          "library": "none: no PyTorch call runs a task scheduler or its "
                     "injection ring",
          "launches": launches})

    # 30. fault plans (the resident kernel's instances with the fault
    # layer, resident_fault): scripts/mesh_holds.py's PHASE30 arms - JAX's
    # fault tests at their shapes (the dropped, duplicated and delayed
    # credit plans and the credit_timeout=0 plan on 2 CTAs, the dead chip
    # on 8), UTS depth 20 on 16 CTAs with a dead device and credit
    # faults, and the forest steal-only on 16 CTAs with its whole queue
    # re-homed. Each arm runs twice on the card (the first launch of its
    # library is the warm-up), exact by JAX's assertions (the wedge: its
    # StallError, raised within max_rounds, never a spin deadline); then,
    # outside the counts, its plain run word for word, fault stats and
    # the StallError's message included.
    _build.reset_launches()
    flt_arms, flt_out = {}, {}
    for name in mesh_holds.PHASE30:
        mesh_holds.run_fault_arm(name, "cuda")  # warm-up
        t0 = time.perf_counter()
        got = mesh_holds.run_fault_arm(name, "cuda")
        dt = time.perf_counter() - t0
        flt_out[name] = got
        fs = got["fault_stats"]
        arm = {"seconds": dt, "kernel_ms": got["kernel_ms"],
               "tasks": got["executed"], "pending": got["pending"],
               "rounds": got["rounds"],
               "rows_exported": sum(got["rows"]),
               "stat_words": sum(got["stat_words"]), "ams": sum(got["ams"]),
               "faults": {k: sum(f[k] for f in fs) for k in (
                   "credits_dropped", "credits_regenerated",
                   "credits_duplicated", "xfers_delayed", "rehomed_rows")},
               "quarantined": sorted({q for f in fs
                                      for q in f["quarantined"]}),
               "detected_round": max(f["dead_detected_round"] for f in fs)}
        if "stall" in got:
            arm["stall"] = got["stall"]
        # The bound (bytes): row 7's 136 B a task, 64 B an active message
        # or a descriptor row moved, 4 B a stat word sent (the routed
        # heartbeats, ndev words a hop, among them).
        arm["bound_ms"] = bound(0.0, 136.0 * arm["tasks"] + 64.0 * (
            arm["ams"] + arm["rows_exported"])
            + 4.0 * arm["stat_words"])[0]
        flt_arms[name] = arm
        emit({"phase": "faults", "arm": name, **arm})
    f = {n: a["faults"] for n, a in flt_arms.items()}
    check(f["drop_2"]["credits_dropped"] == 1
          and f["drop_2"]["credits_regenerated"] == 1
          and f["dup_2"]["credits_duplicated"] == 1
          and f["delay_2"]["xfers_delayed"] > 0
          and flt_arms["wedge_2"]["pending"] > 0
          and f["dead_8"]["rehomed_rows"] > 0
          and flt_arms["dead_8"]["quarantined"] == [3],
          f"faults: JAX's shapes {f}")
    for name in ("uts_16", "forest_16"):
        a = flt_arms[name]
        check(a["faults"]["rehomed_rows"] > 0 and a["quarantined"] == [0]
              and a["faults"]["credits_dropped"] > 0
              and a["faults"]["credits_regenerated"]
              == a["faults"]["credits_dropped"],
              f"faults {name}: {a}")
    check(flt_arms["uts_16"]["tasks"] == 498965,
          f"uts_16: {flt_arms['uts_16']['tasks']} nodes")
    # What the fault layer costs: the same UTS run with no plan (the
    # migrating instance without kFault), warmed up, by CUDA events.
    tst.uts_fault(plan={})
    iv, info = tst.uts_fault(plan={})
    check(int(iv[:, 0].sum()) == 498965, "uts_16 without a plan: nodes")
    emit({"phase": "faults", "arm": "uts_16_noplan",
          "kernel_ms": info["exchange"]["kernel_ms"],
          "rounds": info["rounds"],
          "stat_words": sum(info["exchange"]["stat_words"]),
          "rows_exported": sum(info["exchange"]["rows"])})
    launches = path_done("faults")
    # Outside the counts: every arm's plain run, word for word.
    flt_plain, flt_err = {}, {}
    for name in mesh_holds.PHASE30:
        want = mesh_holds.run_fault_arm(name, "cpu")
        flt_err[name] = mesh_holds.compare(flt_out[name], want, name)
        check(flt_out[name].get("stall") == want.get("stall"),
              f"faults {name}: the StallError differs from the plain one")
        flt_plain[name] = want["kernel_ms"]
    emit({"phase": "faults", "plain_equal": sorted(flt_err),
          "max_abs_err": flt_err, "plain_ms": flt_plain})
    a = flt_arms["uts_16"]
    kernels["resident_fault"] = {
        "name": "resident_fault", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/mesh.cuh",
        "replaces": "hclib_tpu/device/resident.py:2222",
        "max_abs_err": max(list(flt_err.values())
                           + [mesh_hold_err["resident_fault"]]),
        "ms": a["kernel_ms"], "plain_ms": flt_plain["uts_16"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes", "library_ms": None,
    }
    emit({"phase": "faults", "arms": flt_arms, "plain_ms": flt_plain,
          "library": "none: no PyTorch call runs a task scheduler or its "
                     "fault-tolerant steal exchange",
          "launches": launches})

    # 31. the resident kernel's quiesce, resume and flight recorder (its
    # observed instances, resident_obs and ici_ring_obs):
    # scripts/mesh_holds.py's ckpt_phase - UTS depth 20 on 128 CTAs under
    # homed migration without the quiesce word, checkpoint-built, traced,
    # quiesced at half its rounds and bundled, saved, loaded, restored on
    # 128 and resharded onto 64; the injected forest cut at round 0 and at
    # half its rounds; the forest traced on the ring at 6. Then, outside
    # the counts, each observed run against its plain run word for word.
    _build.reset_launches()
    ck_dir = tempfile.mkdtemp(prefix="mesh-ckpt-")
    try:
        ck = mesh_holds.ckpt_phase("cuda", ck_dir)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    ck_arms = ck["arms"]
    check(ck_arms["uts_noobs"]["tasks"] == 498965,
          f"mesh_ckpt: {ck_arms['uts_noobs']['tasks']} UTS nodes")
    for name, a in ck_arms.items():
        # The bound (bytes): row 7's 136 B a task, 16 B a record, 64 B a
        # row exported, and the exported state written once and read once.
        a["bound_ms"] = bound(0.0, 136.0 * a.get("tasks", a.get(
            "executed", 0)) + 16.0 * a.get("records", 0) + 64.0 * a.get(
            "rows_exported", 0) + 2.0 * a.get("state_bytes", 0))[0]
        emit({"phase": "mesh_ckpt", "arm": name, **a})
    launches = path_done("mesh_ckpt")
    t0 = time.perf_counter()
    plain = mesh_holds.ckpt_plain_holds(ck)
    ck_err = {name: mesh_holds.compare(ck["holds"][name], want, name)
              for name, want in plain["holds"].items()}
    del ck
    emit({"phase": "mesh_ckpt", "plain_equal": sorted(ck_err),
          "max_abs_err": ck_err, "plain_ms": plain["plain_ms"],
          "plain_wall_s": time.perf_counter() - t0})
    a = ck_arms["uts_traced"]
    kernels["resident_obs"] = {
        "name": "resident_obs", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/mesh.cuh",
        "replaces": "hclib_tpu/device/resident.py:2222",
        "max_abs_err": max(max(v for k, v in ck_err.items()
                               if k != "ring_6_traced"),
                           mesh_hold_err["resident_obs"]),
        "ms": a["kernel_ms"],
        "plain_ms": plain["plain_ms"]["uts_traced_quiesce"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes", "library_ms": None,
    }
    a = ck_arms["ring_6_traced"]
    kernels["ici_ring_obs"] = {
        "name": "ici_ring_obs", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/mesh.cuh",
        "replaces": "hclib_tpu/device/ici_steal.py:765",
        "max_abs_err": max(ck_err["ring_6_traced"],
                           mesh_hold_err["ici_ring_obs"]),
        "ms": a["kernel_ms"], "plain_ms": plain["plain_ms"]["ring_6_traced"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes", "library_ms": None,
    }
    emit({"phase": "mesh_ckpt", "arms": ck_arms,
          "plain_ms": plain["plain_ms"],
          "library": "none: no PyTorch call runs a task scheduler, its "
                     "quiesce or its flight recorder",
          "launches": launches})

    # 32. PGASMegakernel on a mesh whose size is not a power of two (its
    # ring kernel, pgas_ring_kernel, counter pgas_ring; JAX's row 6): the
    # PGAS exchange across the whole card, 132 co-resident CTAs
    # (stress.pgas_builders(132, burst=True), am_window 8, outbox 256:
    # 17,562 active messages and 2,112 puts), warmed up, five runs timed
    # by CUDA events; the multi-chip dry run's phase 4 literally at 3 and
    # 6 CTAs; the exchange traced at 6; mesh_holds' fan at width 8 on 6.
    # Each exact (mesh_holds.ring_run); then, outside the counts, each
    # against its plain run word for word (value slots, counts, rounds,
    # tiers, messages, puts and stat words sent, the heap, the records).
    _build.reset_launches()
    card = smi("name,power.limit")
    ring_runs = {
        "pgas_132": ("pgas", 132, dict(am_window=8, outbox=256,
                                       capacity=1024)),
        "dryrun4_3": ("dryrun4", 3, {}), "dryrun4_6": ("dryrun4", 6, {}),
        "pgas_6_traced": ("pgas", 6, dict(trace=256)),
        "fan_6_b8": ("fan", 6, {})}
    ring_arms, ring_out = {}, {}
    for name, (load, ndev, kw) in ring_runs.items():
        mesh_holds.ring_run(load, ndev, "cuda", **kw)  # warm-up
        times = []
        for _ in range(5 if name == "pgas_132" else 1):
            t0 = time.perf_counter()
            iv, data, info = mesh_holds.ring_run(load, ndev, "cuda", **kw)
            dt = time.perf_counter() - t0
            times.append(info["exchange"]["kernel_ms"])
        ring_out[name] = mesh_holds.ring_result(iv, data, info)
        ex = info["exchange"]
        arm = {"ctas": ndev, "tasks": info["executed"],
               "rounds": info["rounds"], "ams": sum(ex["ams"]),
               "puts": sum(ex["puts"]), "stat_words": sum(ex["stat_words"]),
               "kernel_ms": float(np.median(times)), "kernel_ms_all": times,
               "seconds": dt, "card": card}
        # The bound (bytes): 136 B a task, 64 B an active message's row,
        # a put's row (PGAS_COLS x 4 B) read once and written once, and 4
        # B a stat word: each device's slot written once a round, and
        # read a round by every device (its five totals, the column of
        # messages and the put counts addressed to the reader).
        nchan = 1
        read = arm["rounds"] * ndev * ndev * (5 + 1 + nchan)
        kb = bound(0.0, 136.0 * arm["tasks"] + 64.0 * arm["ams"]
                   + 2.0 * 4 * tst.PGAS_COLS * arm["puts"]
                   + 4.0 * (arm["stat_words"] + read))
        arm["bound_ms"], arm["bound_by"] = kb
        if name == "pgas_132":
            check(arm["ams"] == 132 * 132 + 132 + 6
                  and arm["puts"] == 132 * tst.PGAS_ROWS,
                  f"pgas_132: {arm['ams']} messages, {arm['puts']} puts")
        ring_arms[name] = arm
        emit({"phase": "pgas_ring", "arm": name, **arm})
    launches = path_done("pgas_ring")
    # Outside the counts: every arm's plain run, word for word.
    ring_plain, ring_err = {}, {}
    for name, (load, ndev, kw) in ring_runs.items():
        want = mesh_holds.ring_result(*mesh_holds.ring_run(load, ndev, "cpu",
                                                           **kw))
        ring_err[name] = mesh_holds.compare(ring_out[name], want, name)
        ring_plain[name] = want["kernel_ms"]
    emit({"phase": "pgas_ring", "plain_equal": sorted(ring_err),
          "max_abs_err": ring_err, "plain_ms": ring_plain, "card": card})
    a = ring_arms["pgas_132"]
    kernels["pgas_ring"] = {
        "name": "pgas_ring", "route": "cuda",
        "source": "hclib_tpu_torch/csrc/mesh.cuh",
        "replaces": "hclib_tpu/device/pgas_kernel.py:665",
        "max_abs_err": max(list(ring_err.values())
                           + [mesh_hold_err["pgas_ring"]]),
        "ms": a["kernel_ms"], "plain_ms": ring_plain["pgas_132"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "library_ms": None,
    }
    emit({"phase": "pgas_ring", "arms": ring_arms, "plain_ms": ring_plain,
          "library": "none: no PyTorch call runs a task scheduler or its "
                     "one-sided messages",
          "launches": launches, "card": card})

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
