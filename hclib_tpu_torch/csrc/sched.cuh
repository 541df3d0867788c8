// The scheduler core of the megakernel (CUDA C++, sm_90a): the
// descriptor and counts words, the launch arguments, the flight recorder
// and quiesce poll (Obs), the scheduler closures (Sched), the thread-0
// bodies fib, sum and uts_node, and the rounds of the batch tier
// (prepare_batch, finish_batch, schedule, spill). csrc/megakernel.cu
// includes it for mk_kernel and its built-in bodies; a user-body library
// (csrc/user.cuh) includes it for its own scheduler instances, so a table
// of user bodies runs the same rounds without building megakernel.cu's
// bodies. What each piece replaces and why it is shaped so: megakernel.cu's
// header.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "layout.cuh"

namespace {

using namespace hc;

constexpr int DESC = 16;
constexpr int F_FN = 0, F_DEP = 1, F_SUCC0 = 2, F_SUCC1 = 3, F_CSR_OFF = 4,
              F_CSR_N = 5, F_A0 = 6, F_OUT = 12, F_HOME = 13, F_HROW = 14;
constexpr int NO_TASK = -1;
constexpr int C_HEAD = 0, C_TAIL = 1, C_ALLOC = 2, C_PENDING = 3,
              C_VALLOC = 4, C_EXECUTED = 5, C_OVERFLOW = 6, C_VBASE = 7;
constexpr int OVF_ROWS = 1, OVF_ENGINE = 4;
constexpr int VBLOCK = 4;

// Body ids: hclib_tpu_torch/device/megakernel.py BODIES.
enum {
  B_FIB, B_SUM, B_UTS, B_POTRF, B_TRSMCOL, B_UPDROW, B_TRSM, B_SW_TILE,
  B_SW_WAVE, B_FIB_BATCH, B_UTS_BATCH, B_UPDROW_BATCH, B_SW_WAVE_BATCH,
  B_VFIB, B_VNQUEENS, B_ADD_TILE, B_FA_STENCIL, B_FA_MAP, B_FA_STENCIL_BATCH,
  B_FA_MAP_BATCH, B_FR_BFS, B_FR_SSSP, B_FR_PAGERANK, B_FR_BFS_BATCH,
  B_FR_SSSP_BATCH, B_FR_PAGERANK_BATCH, B_BNB_NODE, B_BNB_NODE_BATCH,
  B_DG_UPDATE, B_DG_UPDATE_BATCH, B_DG_QUERY, B_DG_QUERY_BATCH, NBODY
};
// Meta words (layout.cuh): the static body parameters at these indices,
// then the table maps, the batch lanes, the vector words, the slab words
// and the priority rules, each section where MAX_BODIES puts it.
enum {
  P_SEED, P_QMILLIS, P_MCHILD, P_MAXDEPTH, P_TILE, P_FBASE, P_NT, P_NTJ,
  P_CHUNK, P_STBASE, P_NBLOCKS, P_REPS, P_KN, P_KCAP, P_SPARE_BASE, P_SPARE,
  P_BCS_BASE, P_FLAG_BASE, P_DYN
};
// The priority rule of routed kind li at META_PRIO + 4 li (bucketed
// tables): rule (megakernel.py PRIORITY_RULES), arg word, two parameters.
constexpr int PRIO_WORDS = 4;
enum { PR_NONE, PR_DIV, PR_BAND, PR_LINEAR_DESC, PR_CONST };
constexpr int BK_MAX = 8;
static_assert(P_DYN < MAX_PARAMS, "parameter words");
static_assert(NBODY <= MAX_BODIES, "body ids");
// Tier counters (megakernel.py TS_*) and lane-state words (LS_*).
constexpr int TS_BATCH_ROUNDS = 0, TS_BATCH_TASKS = 1, TS_SCALAR_ROUNDS = 2,
              TS_ROUTED = 3, TS_PREFETCH = 4, TS_FULL_ROUNDS = 5,
              TS_SPILLED = 6, TS_OFFERED = 7, TS_AGE_FIRES = 8,
              TS_MAX_AGE = 9, TS_BUCKET_FIRES = 10, TS_INVERSIONS = 11,
              TS_WORDS = 12;
constexpr int LS_HEAD = 0, LS_TAIL = 1, LS_PF_BASE = 2, LS_PF_N = 3,
              LS_PF_BUF = 4, LS_AGE = 5, LS_WORDS = 8;
// The flight recorder (tracebuf.py): HDR header words (the write cursor,
// the round cursor, six zeros), then 4-word [tag, t, a, b] records; the
// record tags this scheduler, the stream (stream.cuh) and the mesh
// kernels (mesh.cuh) emit, and the codes of the credit and fault records.
// The quiesce words (megakernel.py QC_*, QS_*): qctl in, qstat out.
constexpr int TR_HDR = 8;
enum {
  TR_ROUND_BEGIN = 1, TR_ROUND_END = 2, TR_FIRE_SCALAR = 3,
  TR_FIRE_BATCH = 4, TR_PREFETCH_ISSUE = 5, TR_PREFETCH_DRAIN = 6,
  TR_SPILL = 7, TR_CREDIT = 8, TR_XFER = 9, TR_ABORT = 10, TR_FAULT = 11,
  TR_INJECT = 12, TR_QUIESCE = 13, TR_CKPT = 14, TR_TENANT = 16,
  TR_FIRE_AGE = 17, TR_FIRE_BUCKET = 18, TR_EGRESS = 19, TR_LATENCY = 20
};
enum { CR_DROPPED = 1, CR_DUPED = 2, CR_REGENERATED = 3 };
enum { FLT_DEAD_QUARANTINE = 1, FLT_DELAY = 3 };
constexpr int QC_FLAG = 0, QC_AFTER = 1;
constexpr int QS_QUIESCED = 0, QS_AT = 1, QS_POLLS = 2;
constexpr int MAX_WIDTH = 8;      // slot rows of a batch round
constexpr int MAX_SW_SLOTS = 16;  // tile slots of an sw_wave_batch round
constexpr int MAX_DATA = 8;
// Smith-Waterman scoring (hclib_tpu/models/smithwaterman.py).
constexpr int SW_T = 128, MATCH = 2, MISMATCH = -1, GAP = 1;
constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// hclib_tpu/device/megakernel.py fault_mix (:74), bit for bit.
__device__ int fault_mix(int seed, int site, int r, int k, int g) {
  const unsigned long long c =
      static_cast<unsigned long long>(static_cast<long long>(k)) * 40503ull +
      static_cast<unsigned long long>(static_cast<long long>(site)) *
          2654435761ull +
      static_cast<unsigned long long>(static_cast<long long>(seed)) *
          2246822519ull;
  const uint32_t ux = static_cast<uint32_t>(r) * 2654435769u  // = -1640531527
                      + static_cast<uint32_t>(g) * 69069u +
                      static_cast<uint32_t>(c & 0x7FFFFFFFull);
  int32_t x = static_cast<int32_t>(ux);
  x ^= x >> 13;
  x = static_cast<int32_t>(static_cast<uint32_t>(x) * 1274126177u);
  x ^= x >> 16;
  return (x & 0x7FFFFFFF) % 1000;
}

struct Args {
  int32_t* tasks;
  const int32_t* tasks_in;
  const int32_t* succ;
  int32_t* ready;
  const int32_t* ready_in;
  int32_t* counts;
  const int32_t* counts_in;
  int32_t* ivalues;
  const int32_t* ivalues_in;
  int32_t* freestk;  // [0] = count, [1..cap] = rows
  const int32_t* meta;
  int32_t* dispatch;  // per-body dispatch counts (a batch counts one)
  // Data buffers in data_specs order: tiles, linvsp, lsp (Cholesky) or
  // aseq, bseq, bot, right[, htiles] (Smith-Waterman).
  void* data[MAX_DATA];
  float* work;      // ts*ts f32 scratch of the tile bodies
  int32_t* lanes;   // (nrows, cap) lane rows: nbk bucket rings a kind
  int32_t* lstate;  // (nrows, LS_WORDS)
  int32_t* tstats;  // (TS_WORDS,) tier counters, or null
  int32_t* vstack;  // the subtree engine's lane stacks, or null
  // Observed instances only: the trace ring (TR_HDR + 4 tr_cap words, or
  // null when untraced), the quiesce words (null when not checkpointing)
  // and the poll stride.
  int32_t* ring;
  const int32_t* qctl;
  int32_t* qstat;
  int tr_cap, qstride;
  int nfn, nbatch, nrows, nbk, max_age, cap, num_values, fuel, reps,
      stage_all_values;
};

// The recorder's and the poll's state, thread 0's registers (the
// scheduler functions it is passed to are inlined): the ring's cursors
// (written to its header at exit), the qctl words of the last poll and
// the qstat words. Cursors wrap by compare, not by a division a record.
struct Obs {
  int32_t* ring;
  const int32_t* qctl;
  int cap, stride;
  int n, slot, r;     // records written, n % cap, round cursor
  int left;           // rounds until the next qctl read
  int qflag, qafter;  // qctl as last read
  int qs[3];          // QS_QUIESCED, QS_AT, QS_POLLS

  // Tracer.emit: one record at slot n % cap (a traced launch only).
  __device__ __forceinline__ void emit(int tag, int t, int a, int b) {
    if (!ring) return;
    *reinterpret_cast<int4*>(ring + TR_HDR + 4 * slot) =
        make_int4(tag, t, a, b);
    ++n;
    if (++slot == cap) slot = 0;
  }
  // Tracer.tick; r is Tracer.now.
  __device__ __forceinline__ int tick() { return r++; }

  // quiesce_hook: re-read qctl (one 8-byte relaxed load at device scope,
  // past L1) every `stride` rounds of the launch (every round at stride
  // 1; round 0 always), count the round, and report a quiesce once
  // QC_AFTER tasks ran this rep; the first observation records
  // TR_QUIESCE.
  __device__ __forceinline__ bool poll(int since) {
    if (!qctl) return false;
    ++qs[QS_POLLS];
    if (--left <= 0) {
      left = stride;
      asm volatile("ld.relaxed.gpu.global.v2.s32 {%0, %1}, [%2];"
                   : "=r"(qflag), "=r"(qafter)
                   : "l"(qctl + QC_FLAG));
    }
    const bool q = qflag != 0 && since >= qafter;
    if (q && qs[QS_QUIESCED] == 0) {
      qs[QS_QUIESCED] = 1;
      qs[QS_AT] = since;
      emit(TR_QUIESCE, r, since, 0);
    }
    return q;
  }
};

// The scheduler closures of _make_core over one state (thread 0 only).
struct Sched {
  int32_t* tasks;
  const int32_t* succ;
  int32_t* ready;
  int32_t* counts;  // shared-memory copy during a rep
  int32_t* iv;
  int32_t* freestk;
  int cap;

  __device__ int32_t& w(int row, int word) {
    return tasks[static_cast<size_t>(row) * DESC + word];
  }

  __device__ void push_ready(int t) {
    const int tail = counts[C_TAIL];
    ready[floor_mod(tail, cap)] = t;
    counts[C_TAIL] = tail + 1;
  }

  // KernelContext.spawn: args[0..nargs) then zeros up to ndecl words.
  __device__ int spawn(int fn, const int* args, int nargs, int ndecl, int dep,
                       int s0, int s1, int out) {
    return spawn_t<false>(fn, args, nargs, ndecl, dep, s0, s1, out, false);
  }

  // spawn's row path. kHome: an instance that hosts migrated rows (the
  // resident kernel's homed configuration, csrc/mesh.cuh HomeSched),
  // where `track` (JAX's tracks_home) clears a fresh row's home link: a
  // recycled row may carry a migrated occupant's. Every other instance
  // compiles without these writes.
  template <bool kHome>
  __device__ int spawn_t(int fn, const int* args, int nargs, int ndecl,
                         int dep, int s0, int s1, int out, bool track) {
    const int nfree = freestk[0];
    const bool use_free = nfree > 0;
    const int a_free = freestk[nfree > 1 ? nfree : 1];
    const int a_new = counts[C_ALLOC];
    const bool ok = use_free || a_new < cap;
    const int a = use_free ? a_free : min(a_new, cap - 1);
    if (use_free) freestk[0] = nfree - 1;
    if (!use_free && a_new < cap) counts[C_ALLOC] = a_new + 1;
    if (ok) {
      counts[C_PENDING] += 1;
      w(a, F_FN) = fn;
      w(a, F_DEP) = dep;
      w(a, F_SUCC0) = s0;
      w(a, F_SUCC1) = s1;
      w(a, F_CSR_N) = 0;
      for (int i = 0; i < ndecl; ++i) w(a, F_A0 + i) = i < nargs ? args[i] : 0;
      w(a, F_OUT) = out;
      if constexpr (kHome) {
        if (track) w(a, F_HOME) = NO_TASK;
      }
      if (dep == 0) push_ready(a);
    } else {
      counts[C_OVERFLOW] |= OVF_ROWS;
    }
    return a;
  }

  // _make_core's install_descriptor: adopt one externally produced row
  // (an injected stream row) through spawn's row path - free stack first,
  // then the bump cursor, OVF_ROWS when neither has a row - copying its
  // 16 words from src, counted pending and pushed ready only at F_DEP 0.
  // Returns the row (clamped to cap - 1 on overflow).
  __device__ int install_descriptor(const int32_t* src) {
    const int nf = freestk[0];
    const bool use_free = nf > 0;
    const int row_free = freestk[nf > 1 ? nf : 1];
    const int a = counts[C_ALLOC];
    const bool ok = use_free || a < cap;
    const int row = use_free ? row_free : min(a, cap - 1);
    if (use_free) freestk[0] = nf - 1;
    if (!use_free && a < cap) counts[C_ALLOC] = a + 1;
    if (ok) {
      for (int k = 0; k < DESC; ++k) w(row, k) = src[k];
      counts[C_PENDING] += 1;
      if (w(row, F_DEP) == 0) push_ready(row);
    } else {
      counts[C_OVERFLOW] |= OVF_ROWS;
    }
    return row;
  }

  // _make_core's headroom: rows free for external rows right now.
  __device__ int headroom() const {
    return freestk[0] + (cap - counts[C_ALLOC]);
  }

  // KernelContext.flag_overflow: the host raises after the run.
  __device__ void flag_overflow() { counts[C_OVERFLOW] |= OVF_ENGINE; }

  __device__ void take_continuation(int idx, int nidx) {
    take_continuation_t<false>(idx, nidx, false);
  }

  // kHome with `track`: the continuation also inherits the home link,
  // so whoever ends a migrated chain forwards its result home.
  template <bool kHome>
  __device__ void take_continuation_t(int idx, int nidx, bool track) {
    w(nidx, F_SUCC0) = w(idx, F_SUCC0);
    w(nidx, F_SUCC1) = w(idx, F_SUCC1);
    w(nidx, F_CSR_OFF) = w(idx, F_CSR_OFF);
    w(nidx, F_CSR_N) = w(idx, F_CSR_N);
    w(idx, F_SUCC0) = NO_TASK;
    w(idx, F_SUCC1) = NO_TASK;
    w(idx, F_CSR_N) = 0;
    if constexpr (kHome) {
      if (track) {
        w(nidx, F_HOME) = w(idx, F_HOME);
        w(nidx, F_HROW) = w(idx, F_HROW);
        w(idx, F_HOME) = NO_TASK;
      }
    }
  }

  __device__ void dec(int s) {
    if (s != NO_TASK) {
      const int d = w(s, F_DEP) - 1;
      w(s, F_DEP) = d;
      if (d == 0) push_ready(s);
    }
  }

  __device__ void complete(int idx) {
    dec(w(idx, F_SUCC0));
    dec(w(idx, F_SUCC1));
    const int n = w(idx, F_CSR_N), off = w(idx, F_CSR_OFF);
    for (int i = 0; i < n; ++i) dec(succ[off + i]);
    counts[C_PENDING] -= 1;
    counts[C_EXECUTED] += 1;
    w(idx, F_DEP) = -1;  // tombstone: stage() rebuilds the free stack
    const int nf = freestk[0] + 1;
    freestk[0] = nf;
    freestk[nf] = idx;
  }

  // stage(): copy the live input state into the working state.
  __device__ void stage(const Args& a) {
    freestk[0] = 0;
    for (int i = 0; i < 8; ++i) counts[i] = a.counts_in[i];
    counts[C_VBASE] = a.counts_in[C_VALLOC];
    const int alloc = a.counts_in[C_ALLOC];
    for (int i = 0; i < alloc; ++i) {
      const int32_t* src = a.tasks_in + static_cast<size_t>(i) * DESC;
      if (src != &w(i, 0))
        for (int k = 0; k < DESC; ++k) w(i, k) = src[k];
      if (src[F_DEP] == -1) {
        const int nf = freestk[0] + 1;
        freestk[nf] = i;
        freestk[0] = nf;
      }
    }
    const int nready = a.counts_in[C_HEAD] < 0
                           ? cap
                           : min(a.counts_in[C_TAIL], cap);
    if (a.ready_in != ready)
      for (int i = 0; i < nready; ++i) ready[i] = a.ready_in[i];
    const int nval = a.stage_all_values ? a.num_values : a.counts_in[C_VALLOC];
    if (a.ivalues_in != iv)
      for (int i = 0; i < nval; ++i) iv[i] = a.ivalues_in[i];
    // Lanes are per-entry scratch; tstats describe the last rep.
    for (int i = 0; i < a.nrows * LS_WORDS; ++i) a.lstate[i] = 0;
    if (a.nbatch)
      for (int i = 0; i < TS_WORDS; ++i) a.tstats[i] = 0;
  }
};

// workloads.py _fib_kernel: spawn SUM (the continuation), hand it our
// successors, point its args at its own row's value block, then spawn
// FIB(n-1) and FIB(n-2) into that block. SS is Sched, or the homed
// configuration's HomeSched (its spawn and take_continuation keep the
// home links).
template <class SS>
__device__ void fib_body(SS& S, const int32_t* meta, int idx) {
  const int n = S.w(idx, F_A0);
  if (n < 2) {
    S.iv[S.w(idx, F_OUT)] = n;
    return;
  }
  const int fib = meta[META_FN_OF_BODY + B_FIB];
  const int sum = meta[META_FN_OF_BODY + B_SUM];
  const int sidx = S.spawn(sum, nullptr, 0, 0, 2, NO_TASK, NO_TASK,
                           S.w(idx, F_OUT));
  S.take_continuation(idx, sidx);
  const int base = S.counts[C_VBASE] + sidx * VBLOCK;
  S.w(sidx, F_A0) = base;
  S.w(sidx, F_A0 + 1) = base + 1;
  int a = n - 1;
  S.spawn(fib, &a, 1, 1, 0, sidx, NO_TASK, base);
  a = n - 2;
  S.spawn(fib, &a, 1, 1, 0, sidx, NO_TASK, base + 1);
}

__device__ void sum_body(Sched& S, int idx) {
  S.iv[S.w(idx, F_OUT)] =
      wrap_add(S.iv[S.w(idx, F_A0)], S.iv[S.w(idx, F_A0 + 1)]);
}

// make_uts_megakernel.node: count into slot 0, spawn child c iff
// fault_mix(seed, c, node, 0, depth) < q_millis (all children at the root).
template <class SS>
__device__ void uts_body(SS& S, const int32_t* meta, int idx) {
  S.iv[0] = wrap_add(S.iv[0], 1);
  const int node = S.w(idx, F_A0);
  const int depth = S.w(idx, F_A0 + 1);
  if (depth >= meta[P_MAXDEPTH]) return;
  const int uts = meta[META_FN_OF_BODY + B_UTS];
  for (int c = 0; c < meta[P_MCHILD]; ++c) {
    const int h = fault_mix(meta[P_SEED], c, node, 0, depth);
    if (depth == 0 || h < meta[P_QMILLIS]) {
      int args[2];
      args[0] = static_cast<int>(static_cast<uint32_t>(node) * 31u +
                                 static_cast<uint32_t>(7 * c + 1) +
                                 static_cast<uint32_t>(depth));
      args[1] = depth + 1;
      S.spawn(uts, args, 2, 2, 0, NO_TASK, NO_TASK, 0);
    }
  }
}

// What thread 0 publishes for one round.
enum { ACT_EXIT, ACT_SCALAR, ACT_BATCH };
struct Round {
  int act, body, idx;                         // scalar: row and body
  int li, width, take, base, pre, buf, nxt;  // batch: lane and handshake
  int rows[MAX_WIDTH];                        // slot rows (clamped)
  int next_rows[MAX_WIDTH];                   // the next batch's first rows
  int ntiles;                                 // sw_wave_batch: live tiles
  int tile_slot[MAX_SW_SLOTS], tile_ti[MAX_SW_SLOTS], tile_tj[MAX_SW_SLOTS];
};


// ---------------------------------------------------------------------------
// The scheduler rounds (thread 0).

// batch_round's pop side for lane row li (in the policy instance, bucket
// ring li % nbk of kind li / nbk): take, base, the prefetch handshake and
// the nxt announce, and the slot rows the body reads. Bucket rings pop
// FIFO; a bucketed table has no prefetch lane (the host refuses one).
template <bool kPolicy, bool kObs>
__device__ void prepare_batch(Sched& S, const Args& a, int li, int e0,
                              Round& R, int rt, Obs& O) {
  const int nbk = kPolicy ? a.nbk : 1;
  const int32_t* bm = a.meta + META_BATCH + 4 * (li / nbk);
  const int B = bm[1], prefetch = bm[2], body = bm[3];
  const int32_t* L = a.lstate + li * LS_WORDS;
  const int32_t* lane = a.lanes + static_cast<size_t>(li) * a.cap;
  const int head = L[LS_HEAD], tail = L[LS_TAIL];
  const int avail = tail - head, take = min(avail, B);
  const int base = prefetch || nbk > 1 ? head : tail - take;
  R.act = ACT_BATCH;
  R.body = body;
  R.li = li;
  R.width = B;
  R.take = take;
  R.base = base;
  R.pre = L[LS_PF_BASE] == head + 1 ? min(L[LS_PF_N], take) : 0;
  R.buf = L[LS_PF_BUF];
  // Announce a prefetch only when the lane keeps entries AND fuel admits
  // another round, so the round that consumes it runs before exit.
  R.nxt = prefetch && avail - take > 0 &&
                  S.counts[C_EXECUTED] - e0 + take < a.fuel
              ? min(avail - take, B)
              : 0;
  if constexpr (kObs) {
    // One record a batch round (fid << 16 | take, prefetched), and the
    // announce of the next batch's prefetch.
    O.emit(TR_FIRE_BATCH, rt, (bm[0] << 16) | take, R.pre);
    if (prefetch && R.nxt > 0)
      O.emit(TR_PREFETCH_ISSUE, rt, bm[0], R.nxt);
  }
  for (int s = 0; s < take; ++s)
    R.rows[s] = min(max(lane[floor_mod(base + s, a.cap)], 0), a.cap - 1);
  for (int s = 0; s < R.nxt; ++s)
    R.next_rows[s] =
        min(max(lane[floor_mod(base + take + s, a.cap)], 0), a.cap - 1);
  R.ntiles = 0;
  if (body == B_SW_WAVE_BATCH) {
    const int chunk = a.meta[P_CHUNK];
    for (int b = 0; b < take; ++b) {
      const int row = R.rows[b];
      const int w = S.w(row, F_A0), lo = S.w(row, F_A0 + 1);
      const int cnt = min(S.w(row, F_A0 + 2), chunk);
      for (int s = 0; s < cnt; ++s) {
        R.tile_slot[R.ntiles] = b * chunk + s;
        R.tile_ti[R.ntiles] = lo + s;
        R.tile_tj[R.ntiles] = w - lo - s;
        ++R.ntiles;
      }
    }
  }
  if (body >= 0 && body < NDISPATCH) a.dispatch[body] += 1;
}

// batch_round's completion side: per-slot complete in slot order (SS's
// complete: HomeSched's forwards a migrated chain's result home first),
// the lane cursors and the prefetch words, the tstats updates.
template <bool kPolicy, class SS>
__device__ void finish_batch(SS& S, const Args& a, const Round& R,
                             const int* s_tmax) {
  const int nbk = kPolicy ? a.nbk : 1;
  if (R.body == B_SW_WAVE_BATCH) {
    // Each descriptor counts as cnt tiles (ctx.add_executed(cnt - 1)),
    // and every tile folds its max into the best score.
    for (int b = 0; b < R.take; ++b)
      S.counts[C_EXECUTED] += S.w(R.rows[b], F_A0 + 2) - 1;
    for (int t = 0; t < R.ntiles; ++t) S.iv[0] = max(S.iv[0], s_tmax[t]);
  }
  const int32_t* lane = a.lanes + static_cast<size_t>(R.li) * a.cap;
  for (int s = 0; s < R.take; ++s)
    S.complete(lane[floor_mod(R.base + s, a.cap)]);
  int32_t* L = a.lstate + R.li * LS_WORDS;
  if (a.meta[META_BATCH + 4 * (R.li / nbk) + 2]) {  // prefetch: FIFO pops
    const int head = L[LS_HEAD];
    L[LS_HEAD] = head + R.take;
    L[LS_PF_BASE] = R.nxt > 0 ? head + R.take + 1 : 0;
    L[LS_PF_N] = R.nxt;
    L[LS_PF_BUF] = 1 - R.buf;
  } else if (nbk > 1) {  // a bucket ring: FIFO pops, no prefetch
    L[LS_HEAD] += R.take;
  } else {  // LIFO pop: the block came off the tail
    L[LS_TAIL] = R.base;
  }
  int32_t* ts = a.tstats;
  ts[TS_BATCH_ROUNDS] += 1;
  ts[TS_BATCH_TASKS] += R.take;
  ts[TS_OFFERED] += R.width;
  ts[TS_PREFETCH] += R.pre;
  ts[TS_FULL_ROUNDS] += R.take == R.width;
}

// Run scheduling rounds until one has a body to run (or the loop ends):
// the while_loop of sched(), with routing-only rounds done inline. An
// observed instance ticks the round cursor and polls the quiesce word at
// the top of every round; a quiesce ends the loop before the round pops.
template <bool kObs>
__device__ void schedule(Sched& S, const Args& a, int e0, Round& R, Obs& O) {
  int32_t* c = S.counts;
  for (;;) {
    if (!(c[C_PENDING] > 0 && c[C_EXECUTED] - e0 < a.fuel)) break;
    const int tail = c[C_TAIL];
    const bool ring_work = c[C_HEAD] < tail;
    int rt = 0;
    if constexpr (kObs) {
      rt = O.tick();
      if (O.poll(c[C_EXECUTED] - e0)) break;
    }
    // Ring-drain-first: a lane fires only once the ring is empty; one
    // dispatch a round, the lowest F_FN (lane order) first.
    if (!ring_work) {
      for (int li = 0; li < a.nbatch; ++li) {
        const int32_t* L = a.lstate + li * LS_WORDS;
        if (L[LS_TAIL] - L[LS_HEAD] > 0) {
          prepare_batch<false, kObs>(S, a, li, e0, R, rt, O);
          return;
        }
      }
      break;  // neither ring nor lane work: stuck (or done)
    }
    const int idx = a.ready[floor_mod(tail - 1, a.cap)];
    c[C_TAIL] = tail - 1;
    // Pop-time routing: a batch-routed kind goes to its lane.
    const int fn = S.w(idx, F_FN);
    bool routed = false;
    for (int li = 0; li < a.nbatch && !routed; ++li) {
      if (fn == a.meta[META_BATCH + 4 * li]) {
        int32_t* L = a.lstate + li * LS_WORDS;
        const int lt = L[LS_TAIL];
        a.lanes[static_cast<size_t>(li) * a.cap + floor_mod(lt, a.cap)] = idx;
        L[LS_TAIL] = lt + 1;
        a.tstats[TS_ROUTED] += 1;
        routed = true;
      }
    }
    if (routed) continue;
    if constexpr (kObs) O.emit(TR_FIRE_SCALAR, rt, fn, idx);
    // lax.switch clamps an out-of-range index; so does this.
    const int body = a.meta[META_BODY_OF_FN + min(max(fn, 0), a.nfn - 1)];
    if (body >= 0 && body < NDISPATCH) a.dispatch[body] += 1;
    if (a.nbatch) a.tstats[TS_SCALAR_ROUNDS] += 1;
    R.act = ACT_SCALAR;
    R.idx = idx;
    R.body = body;
    return;
  }
  R.act = ACT_EXIT;
}

// Exit with unrun lane entries: spill them back to the ring HEAD (the
// cold end), oldest first at head0 - 1 (any prefetch was drained before),
// row by row. An observed instance records, a row, the prefetch it
// drained and the entries it spilled, at the round cursor.
template <bool kObs>
__device__ void spill(Sched& S, const Args& a, Obs& O) {
  for (int li = 0; li < a.nrows; ++li) {
    int32_t* L = a.lstate + li * LS_WORDS;
    const int32_t* lane = a.lanes + static_cast<size_t>(li) * a.cap;
    const int h = L[LS_HEAD], t = L[LS_TAIL];
    if constexpr (kObs) {
      const int32_t* bm = a.meta + META_BATCH + 4 * (li / a.nbk);
      const int pre = L[LS_PF_BASE] == h + 1 ? L[LS_PF_N] : 0;
      if (bm[2] && pre > 0)
        O.emit(TR_PREFETCH_DRAIN, O.r, bm[0], pre);
      if (t > h) O.emit(TR_SPILL, O.r, bm[0], t - h);
    }
    const int head0 = S.counts[C_HEAD];
    for (int s = 0; s < t - h; ++s)
      a.ready[floor_mod(head0 - 1 - s, a.cap)] = lane[floor_mod(h + s, a.cap)];
    S.counts[C_HEAD] = head0 - (t - h);
    L[LS_HEAD] = t;
    L[LS_PF_BASE] = 0;
    a.tstats[TS_SPILLED] += t - h;
  }
}

}  // namespace
