// The streaming front door's kernel (CUDA C++, sm_90a): one entry of the
// scheduler with the injection-ring poll, the tenant lanes' weighted
// round-robin poll, the completion-mailbox publish and the telemetry fold.
//
// Replaces hclib_tpu/device/inject.py StreamingMegakernel._kernel (:473;
// pallas_call at :1048): the round loop (:817-878) of sched(quantum)
// then a fresh read of ctl, the single-firehose poll (:665-695) or the
// tenant poll tpoll (:700-805), the abort word ctl[3] and, in checkpoint
// builds, the quiesce word ctl[5] against ctl[6]; the exit on idle and
// drained, abort, quiesce or max_rounds; the entry-start flush of parked
// rows (:913-938); the ctl echo and TR_CKPT at exit (:966-984). The three
// seams of _make_core it runs the scheduler with are egress_complete
// (:523-611) as complete_hook, tele_fire (:613) as fire_hook and
// tele_round (:619) as round_hook; install (:639-663) adds the telemetry
// stamps and the egress token to _make_core's install_descriptor.
//
// Design. One block, one launch an entry, as mk_kernel: thread 0 runs the
// serial scheduler over the same Sched (stage, pop, step, complete, spawn)
// and the same Obs recorder, so every pop, install and publish happens in
// the JAX order and the task table, the blocks and the trace records equal
// the plain version's (hclib_tpu_torch/device/inject.py _PlainStream) word
// for word. Its instances are apart from mk_kernel's: kMode 0 holds the
// fib, sum and UTS bodies, 4 adds the frontier EXPAND and knapsack NODE
// bodies (run by the whole block, as in mk_kernel), 5 the dynamic-graph
// layout (the UPDATE and QUERY bodies, the clamped spare-aware EXPAND);
// kObs adds the recorder. The stream embeds the scalar tier only (JAX
// refuses batch routes), so each scheduling round either pops the ring
// or ends the sched call, as mk_kernel's lean loop does. What the TPU
// needed and this does not: the 8-row DMA chunks of the ring (rows are
// read in place; the device ring keeps only a row's first RING_WORDS
// words, of which the kernel reads all but TEN_DEADLINE_MS, word 18) and
// the staging of every block into an output window (the blocks are
// updated in place; ectl and the gauge row are held in shared memory
// during the entry and written back at exit).
//
// What bounds it: like mk_kernel, a chain of dependent loads and stores by
// one thread (each install reads 20 words of its ring row and writes a
// 64-byte descriptor and its stamps; each tracked retirement reads the
// token and stamps back and writes a 32-byte mailbox row), so it is
// latency-bound, not bound by bytes or operations;
// the host's per-entry launch, upload and drain set the pace of a stream.

#pragma once

namespace {

using namespace hc;

constexpr int RING_WORDS = 21;  // descriptor + TEN_ID .. TEN_ADMIT_ROUND
constexpr int TEN_ID = 16, TEN_EXPIRED = 17, TEN_TOKEN = 19,
              TEN_ADMIT_ROUND = 20;
// device/tenants.py TC_*, device/egress.py EGR_* / EC_*, device/telemetry.py
// LAT_* / TG_*.
constexpr int TC_TAIL = 0, TC_CONSUMED = 1, TC_WEIGHT = 2, TC_PAUSE = 3,
              TC_EXPIRED = 4, TC_INSTALLED = 5, TC_DROPPED = 6;
constexpr int EGR_STATUS = 0, EGR_TOKEN = 1, EGR_TEN = 2, EGR_FN = 3,
              EGR_SLOT = 4, EGR_VALUE = 5, EGR_T_ADMIT = 6, EGR_T_SPANS = 7,
              EGR_WORDS = 8, EGR_OK = 1;
constexpr int EC_WRITE = 0, EC_CONSUMED = 1, EC_PARKED = 2,
              EC_PARK_COUNT = 3, EC_PARK_HEAD = 4, EC_INFLIGHT = 5;
constexpr int TOKEN_LIMIT = 1 << 24;
constexpr int LAT_BUCKETS = 16, LAT_ADMIT = 0, LAT_INSTALL = 1, LAT_FIRE = 2,
              LAT_WORDS = 4;
constexpr int TG_ROUNDS = 0, TG_INSTALLS = 1, TG_RETIRES = 2, TG_PARKED = 3,
              TG_BACKLOG = 4;

struct StreamArgs {
  const int32_t* ring;     // (R, RING_WORDS) device copy of the ring rows
  const int32_t* ctl_in;   // ctl[8], re-read every round
  int32_t* ctl_out;        // the ctl echo
  int32_t* tctl;           // (T, 8) lane cursors and counters, in place
  int32_t* egr;            // (depth, EGR_WORDS) mailbox
  int32_t* park;           // (depth, EGR_WORDS) park ring
  int32_t* ectl;           // ectl[8]
  int32_t* etok;           // (cap,) packed token + tenant * TOKEN_LIMIT
  int32_t* tele;           // (1 + T, LAT_BUCKETS) gauges and histograms
  int32_t* tlat;           // (cap, LAT_WORDS) lifecycle stamps
  int T, region, depth, telemetry, quantum, max_rounds, ckpt;
};

__device__ __forceinline__ int clamp16(int x) {
  return min(max(x, 0), 0xFFFF);
}

// Thread 0's front door over one entry: the hooks, the installs and the
// two polls. ectl and the telemetry gauge row g are the shared-memory
// copies of the entry.
template <bool kObs>
struct Front {
  Sched& S;
  Obs& O;
  const StreamArgs& s;
  int32_t* ectl;
  int32_t* g;

  __device__ __forceinline__ void emit(int tag, int a, int b) {
    if constexpr (kObs) O.emit(tag, O.r, a, b);
  }

  // egress_complete then complete (the complete_hook seam): a tracked
  // row publishes (token, tenant, fn, slot, value[, admit, spans]) into
  // the mailbox, or parks it when the mailbox is full; the telemetry fold
  // bumps the tenant's log2 bucket of (retire - admit).
  __device__ void complete(int idx) {
    const int packed = s.depth > 0 ? s.etok[idx] : 0;
    if (packed != 0) {
      const int token = packed % TOKEN_LIMIT;  // lax.rem
      const int ten = floor_div(packed, TOKEN_LIMIT);
      const int slot = S.w(idx, F_OUT);
      const int write = ectl[EC_WRITE];
      const int room = s.depth - (write - ectl[EC_CONSUMED]);
      int now = 0, admit = 0, spans = 0;
      if (s.telemetry) {
        const int32_t* L = s.tlat + static_cast<size_t>(idx) * LAT_WORDS;
        now = g[TG_ROUNDS];
        admit = L[LAT_ADMIT];
        spans = static_cast<int>(
            (static_cast<uint32_t>(clamp16(wsub(now, L[LAT_INSTALL]))) << 16) |
            static_cast<uint32_t>(clamp16(wsub(L[LAT_INSTALL], admit))));
      }
      int32_t* dst;
      if (room > 0) {
        dst = s.egr + (write % s.depth) * EGR_WORDS;
        ectl[EC_WRITE] = write + 1;
      } else {
        const int n = ectl[EC_PARK_COUNT];
        dst = s.park + ((ectl[EC_PARK_HEAD] + n) % s.depth) * EGR_WORDS;
        ectl[EC_PARK_COUNT] = n + 1;
        ectl[EC_PARKED] += 1;
        emit(TR_EGRESS, token, n + 1);
      }
      dst[EGR_STATUS] = EGR_OK;
      dst[EGR_TOKEN] = token;
      dst[EGR_TEN] = ten;
      dst[EGR_FN] = S.w(idx, F_FN);
      dst[EGR_SLOT] = slot;
      dst[EGR_VALUE] = S.iv[slot];
      if (s.telemetry) {
        dst[EGR_T_ADMIT] = admit;
        dst[EGR_T_SPANS] = spans;
        const int d = max(wsub(now, admit), 0);
        int b = 0;
        for (int k = 1; k < LAT_BUCKETS; ++k) b += d >= (1 << k);
        s.tele[(1 + ten) * LAT_BUCKETS + b] += 1;
        g[TG_RETIRES] += 1;
        emit(TR_LATENCY, (ten << 16) | b, d);
      }
      s.etok[idx] = 0;
      ectl[EC_INFLIGHT] -= 1;
    }
    S.complete(idx);
  }

  // tele_fire (the fire_hook seam): the fire-round stamp.
  __device__ __forceinline__ void fire(int idx) {
    if (s.telemetry)
      s.tlat[static_cast<size_t>(idx) * LAT_WORDS + LAT_FIRE] = g[TG_ROUNDS];
  }

  // tele_round (the round_hook seam): the cumulative round gauge, the
  // ready backlog and the parked count.
  __device__ __forceinline__ void round() {
    if (s.telemetry) {
      g[TG_ROUNDS] += 1;
      g[TG_BACKLOG] = S.counts[C_TAIL] - S.counts[C_HEAD];
      g[TG_PARKED] = ectl[EC_PARK_COUNT];
    }
  }

  // install: install_descriptor, then the admit and install stamps and the
  // packed submit token (counted in flight for the credit gate).
  __device__ void install(const int32_t* row) {
    const int idx = S.install_descriptor(row);
    if (s.telemetry) {
      int32_t* L = s.tlat + static_cast<size_t>(idx) * LAT_WORDS;
      L[LAT_ADMIT] = row[TEN_ADMIT_ROUND];
      L[LAT_INSTALL] = g[TG_ROUNDS];
      g[TG_INSTALLS] += 1;
    }
    if (s.depth > 0 && row[TEN_TOKEN] != 0) {
      s.etok[idx] = wadd(row[TEN_TOKEN], wmul(row[TEN_ID], TOKEN_LIMIT));
      ectl[EC_INFLIGHT] += 1;
    }
  }

  // tpoll(r): the weighted round-robin over the lanes from lane r mod T;
  // a lane takes min(weight, avail, headroom()) rows and, with egress,
  // no more than the park ring's credit; expired rows drop (counted),
  // paused lanes are swept. Returns the rows installed.
  __device__ int tpoll(int r) {
    int newly = 0;
    for (int k = 0; k < s.T; ++k) {
      const int lane = (r + k) % s.T;
      int32_t* tc = s.tctl + lane * 8;
      const int tail = tc[TC_TAIL], cons = tc[TC_CONSUMED];
      const bool paused = tc[TC_PAUSE] != 0;
      const int avail = tail - cons;
      int take = paused ? 0 : min(min(tc[TC_WEIGHT], avail), S.headroom());
      if (s.depth > 0)
        take = min(take, max(s.depth - ectl[EC_PARK_COUNT] -
                                 ectl[EC_INFLIGHT], 0));
      int c = cons, inst = 0, exp = 0;
      for (; c < cons + take; ++c) {
        const int32_t* row =
            s.ring + (static_cast<size_t>(lane) * s.region + c) * RING_WORDS;
        if (row[TEN_EXPIRED] != 0) {
          ++exp;
        } else {
          install(row);
          ++inst;
        }
      }
      tc[TC_CONSUMED] = paused ? tail : c;
      if (paused) tc[TC_DROPPED] += avail;
      tc[TC_INSTALLED] += inst;
      tc[TC_EXPIRED] += exp;
      if (inst > 0 || exp > 0) emit(TR_TENANT, (lane << 16) | inst, exp);
      newly += inst;
    }
    return newly;
  }

  // The entry-start flush: parked rows move into the mailbox, FIFO off
  // EC_PARK_HEAD, while there is room.
  __device__ void flush_parked() {
    for (int i = 0; i < s.depth; ++i) {
      const int cnt = ectl[EC_PARK_COUNT];
      const int room = s.depth - (ectl[EC_WRITE] - ectl[EC_CONSUMED]);
      if (cnt <= 0 || room <= 0) break;
      const int h = ectl[EC_PARK_HEAD];
      int32_t* src = s.park + h * EGR_WORDS;
      int32_t* dst = s.egr + (ectl[EC_WRITE] % s.depth) * EGR_WORDS;
      for (int w = 0; w < EGR_WORDS; ++w) {
        dst[w] = src[w];
        src[w] = 0;
      }
      ectl[EC_PARK_HEAD] = (h + 1) % s.depth;
      ectl[EC_PARK_COUNT] = cnt - 1;
      ectl[EC_WRITE] += 1;
    }
  }
};

__device__ __forceinline__ void read_ctl(const int32_t* src, int (&ctl)[8]) {
  // A real load every round (the host may publish between the rounds of
  // a producer that writes mapped memory; this driver writes between
  // entries).
  const volatile int32_t* v = src;
#pragma unroll
  for (int i = 0; i < 8; ++i) ctl[i] = v[i];
}

template <int kMode, bool kObs>
__global__ void __launch_bounds__(BT) stream_kernel(Args a, StreamArgs s) {
  constexpr bool kPolicy = kMode >= 4, kDyn = kMode == 5;
  extern __shared__ __align__(16) float dsm[];
  __shared__ int32_t s_counts[8];
  __shared__ int32_t s_ectl[8];
  __shared__ int32_t s_g[LAT_BUCKETS];
  __shared__ Round R;
  __shared__ int s_go;
  const int tid = threadIdx.x;
  Sched S{a.tasks, a.succ, a.ready, s_counts, a.ivalues, a.freestk, a.cap};
  Obs O{a.ring, nullptr, a.tr_cap, 1};
  O.n = O.slot = O.r = 0;  // Tracer.reset at stage
  Front<kObs> F{S, O, s, s_ectl, s_g};
  const int32_t* meta = a.meta;
  int32_t* swm = reinterpret_cast<int32_t*>(dsm);
  [[maybe_unused]] const FrGraph fg = fr_graph(meta, a.data[0], a.data[1]);
  [[maybe_unused]] const int dg_fam = meta[META_BODY_OF_FN] - B_FR_BFS;
  int ctl[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int consumed = 0, r = 0, abr = -1, qr = -1;
  if (tid == 0) {
    S.stage(a);
    for (int i = 0; i < 8; ++i) s_ectl[i] = s.ectl[i];
    if (s.telemetry)
      for (int i = 0; i < LAT_BUCKETS; ++i) s_g[i] = s.tele[i];
    F.flush_parked();
    read_ctl(s.ctl_in, ctl);
    consumed = ctl[2];
  }
  for (;;) {
    // sched(quantum), the rounds of mk_kernel's lean loop with the seams.
    int e0 = 0;
    if (tid == 0) {
      e0 = s_counts[C_EXECUTED];
      if constexpr (kObs)
        O.emit(TR_ROUND_BEGIN, O.tick(), s_counts[C_TAIL] - s_counts[C_HEAD],
               s_counts[C_PENDING]);
    }
    for (;;) {
      if (tid == 0) {
        R.act = ACT_EXIT;
        if (s_counts[C_PENDING] > 0 && s_counts[C_EXECUTED] - e0 < s.quantum) {
          const int tail = s_counts[C_TAIL];
          int rt = 0;
          if constexpr (kObs) rt = O.tick();
          F.round();
          if (s_counts[C_HEAD] < tail) {
            const int idx = a.ready[floor_mod(tail - 1, a.cap)];
            s_counts[C_TAIL] = tail - 1;
            if constexpr (kObs)
              O.emit(TR_FIRE_SCALAR, rt, S.w(idx, F_FN), idx);
            F.fire(idx);
            const int fn = min(max(S.w(idx, F_FN), 0), a.nfn - 1);
            const int body = meta[META_BODY_OF_FN + fn];
            if (body >= 0 && body < NDISPATCH) a.dispatch[body] += 1;
            R.idx = idx;
            R.body = body;
            R.act = ACT_SCALAR;
          }
        }
      }
      __syncthreads();
      if (R.act == ACT_EXIT) break;
      const int idx = R.idx;
      switch (R.body) {
        case B_FIB:
          if (tid == 0) fib_body(S, meta, idx);
          break;
        case B_SUM:
          if (tid == 0) sum_body(S, idx);
          break;
        case B_UTS:
          if (tid == 0) uts_body(S, meta, idx);
          break;
        case B_FR_BFS:
        case B_FR_SSSP:
        case B_FR_PAGERANK:
          if constexpr (kPolicy)
            fr_expand<kDyn>(S, R.body - B_FR_BFS, fg, swm, a.tasks, &R.idx);
          break;
        case B_BNB_NODE:
          if constexpr (kPolicy)
            if (tid == 0)
              bnb_node(S, &S.w(idx, F_A0), meta[P_KN], meta[P_KCAP]);
          break;
        case B_DG_UPDATE:
          if constexpr (kDyn)
            if (tid == 0) dg_splice(S, dg_fam, fg, &S.w(idx, F_A0));
          break;
        case B_DG_QUERY:
          if constexpr (kDyn)
            if (tid == 0) dg_query(S, fg, &S.w(idx, 0));
          break;
        default:  // the host refuses tables with other bodies
          break;
      }
      __syncthreads();
      if (tid == 0) F.complete(idx);
    }
    if (tid == 0) {
      if constexpr (kObs)
        O.emit(TR_ROUND_END, O.tick(), s_counts[C_EXECUTED] - e0,
               s_counts[C_PENDING]);
      read_ctl(s.ctl_in, ctl);
      bool drained = true;
      if (s.T > 0) {
        const int newly = F.tpoll(r);
        if (newly > 0) F.emit(TR_INJECT, newly, 0);
        for (int i = 0; i < s.T; ++i)
          drained &= s.tctl[i * 8 + TC_CONSUMED] == s.tctl[i * 8 + TC_TAIL];
      } else {
        const int c0 = consumed;
        for (; consumed < ctl[0]; ++consumed)
          F.install(s.ring + static_cast<size_t>(consumed) * RING_WORDS);
        if (consumed > c0) F.emit(TR_INJECT, consumed - c0, 0);
        drained = consumed == ctl[0];
      }
      const bool aborted = ctl[3] != 0;
      if (aborted && abr < 0) {
        F.emit(TR_ABORT, r, 0);
        abr = r;
      }
      bool qz = false;
      if (s.ckpt) {
        qz = ctl[5] != 0 && s_counts[C_EXECUTED] >= ctl[6];
        if (qz && qr < 0) {
          F.emit(TR_QUIESCE, r, 0);
          qr = r;
        }
      }
      const bool done =
          (s_counts[C_PENDING] == 0 && drained) || aborted || qz;
      ++r;
      s_go = !done && r < s.max_rounds;
    }
    __syncthreads();
    if (!s_go) break;
  }
  if (tid == 0) {
    const int out[8] = {ctl[0], ctl[1], consumed, ctl[3], abr,
                        s.ckpt ? qr : 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 8; ++i) s.ctl_out[i] = out[i];
    if (s.ckpt && qr >= 0)
      F.emit(TR_CKPT, s_counts[C_PENDING], ctl[0] - consumed);
    for (int i = 0; i < 8; ++i) a.counts[i] = s_counts[i];
    for (int i = 0; i < 8; ++i) s.ectl[i] = s_ectl[i];
    if (s.telemetry)
      for (int i = 0; i < LAT_BUCKETS; ++i) s.tele[i] = s_g[i];
    if constexpr (kObs)
      if (O.ring)
        for (int i = 0; i < TR_HDR; ++i)
          O.ring[i] = i == 0 ? O.n : i == 1 ? O.r : 0;
  }
}

}  // namespace
