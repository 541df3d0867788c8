// The mesh kernels (CUDA C++, sm_90a): a mesh device is one CTA, and the
// CTAs of a mesh are co-resident on one card.
//
// Replaces:
//   mk_grid_kernel   <- hclib_tpu/device/sharded.py: the megakernel (row 1,
//                       megakernel.py _build_raw :2114) run once per mesh
//                       device under shard_map, one entry without steal
//                       (:313) or one a steal round (:372)
//   ici_ring_kernel  <- hclib_tpu/device/ici_steal.py ICIStealMegakernel.
//                       _kernel (:278, pallas_call at :765) with the
//                       export / import closures of _make_xfer (:180): the
//                       ring allreduce of (pending, backlog, abort) in
//                       ndev - 1 credited hops, then one exchange at
//                       distance 2^(r mod nh) mod ndev
//   resident_steal_kernel <- hclib_tpu/device/resident.py ResidentKernel.
//                       _kernel (:626, pallas_call at :2222) in its
//                       steal-only configuration (steal=True, homed=False):
//                       stage_resident (:945), install_fixed (:993),
//                       elig_of (:1041), export (:1069), import_rows
//                       (:1178), fold_and_steal (:1562) and the round loop
//                       (:1890-2099)
//
// Design. mk_grid_kernel is mk_kernel's body (mk_body.cuh) with block b on
// mesh device b's slice of the stacked state: the CTAs do not talk, so an
// ordinary launch serves, and the bulk-synchronous exchange between its
// launches is torch ops (device/sharded.py). The two steal kernels keep
// the whole run in one launch: each CTA's thread 0 runs the serial
// scheduler of mk_kernel (Sched's stage, pop, spawn, complete; the lane
// tier's schedule, finish_batch and spill) for a quantum a round, then the
// exchange. Their CTAs wait on each other, so they are launched
// cooperatively (cudaLaunchCooperativeKernel), never more CTAs than the
// card holds at once: a spinning CTA whose partner is not resident would
// wait forever.
//
// A remote DMA with its semaphores becomes: thread 0 stores the rows into
// the partner's inbox slab (global memory), fences, and adds one to the
// partner's arrival counter with a release; the partner spins with
// acquire loads until the counter reaches the message's sequence number,
// then reads the slab past L1 (ld.global.cg). A credit (JAX's regular
// semaphore) is the same kind of monotonic counter: the writer of a 1-deep
// slab waits until its credits reach the count of messages it already
// sent there. Counting against sequence numbers leaves nothing to drain at
// exit (JAX's credit drain, ici_steal.py :442-458) and nothing to reset
// but the workspace, which each run zeroes. Every device runs the same hop
// schedule on its own data, so the card's task tables, counts, values and
// tier counters equal the plain versions' word for word.
//
// Every wait is bounded: past its deadline (the global timer, in
// nanoseconds: the SM clock that clock64 counts slows under a power cap)
// the CTA claims the error row, writes (device, round, hop, wait) into it
// and raises the stop word; every other CTA polls the stop word in its
// waits and leaves too, and the host raises with those words. A protocol
// fault shows as an error, never as a hung launch.
//
// What bounds it: as mk_kernel, a chain of dependent loads and stores by
// one thread a CTA, now on ndev SMs at once; an exchange hop adds the
// round trip of two flag handshakes through L2.

#pragma once

namespace {

using namespace hc;

constexpr int F_HOME = 13, F_VMASK = 15;  // descriptor.py
constexpr int MAX_HOPS = 16;
constexpr int MESH_MAX_FNS = 32;
constexpr int MAX_SCAN = 1024;
// A port: the slabs and counters one (device, hop) pair of the exchange
// owns (the ring uses one port a device). Counters first, each on its own
// 32-byte sector; then the stat slab; then the (W + 1, 16) row inbox
// whose row W word 0 is the row count.
constexpr int P_SARR = 0, P_SCRED = 8, P_RARR = 16, P_RCRED = 24;
constexpr int P_STAT = 32, STAT_WORDS = 8, P_INBOX = 64;
// Resident stat words (resident.py SF_*): the sums of [0, SX_AM), then
// the sender's ready backlog (S_BL). With no active messages, channels,
// injection or faults, the XOR all-to-all section is all zeros and is not
// sent.
constexpr int SF_PEND = 0, SF_ABORT = 5, SX_AM = 7, S_BL = 7;
// The error row: the stop word, the claim, then what timed out.
constexpr int ER_STOP = 0, ER_CLAIM = 1, ER_DEV = 2, ER_ROUND = 3,
              ER_HOP = 4, ER_WAIT = 5;
enum { W_STAT_CREDIT = 1, W_STAT_ARRIVAL, W_ROW_CREDIT, W_ROW_ARRIVAL };
// resident.py FS_*: the fault/abort stats row a device writes at exit.
constexpr int FS_DEAD_ROUND = 4, FS_ABORT_ROUND = 7, FS_QUIESCE_ROUND = 10,
              FS_WORDS = 16;
// The exchange's volume a device (both steal kernels): rows it exported,
// stat words it sent.
constexpr int XS_ROWS = 0, XS_STAT_WORDS = 1, XS_WORDS = 4;

struct MeshArgs {
  Args a;  // device 0's slice; the table words are shared
  long long s_tasks, s_succ, s_ready, s_counts, s_ivalues, s_freestk,
      s_dispatch, s_lanes, s_lstate, s_tstats, s_work;
  long long s_data[MAX_DATA];  // bytes
  int ndev;
  // The steal kernels only.
  const int32_t* abort;  // (ndev, 8): word 0 is device d's abort flag
  int32_t* ws;           // the ports, zeroed by the host each run
  int32_t* err;          // the error row (8 words, zeroed each run)
  const int32_t* wl;     // (MESH_MAX_FNS,) 1 for a migratable F_FN
  int32_t* fstats;       // resident: (ndev, FS_WORDS)
  int32_t* xstats;       // (ndev, XS_WORDS)
  int quantum, max_rounds, window, scan, nhops, port_words;
  int hops[MAX_HOPS];  // resident: the hop bits in scan order
  long long timeout_ns;
};

// Device d's slice of the stacked state (in place: tasks_in == tasks).
__device__ __forceinline__ Args mesh_slice(const MeshArgs& m, int d) {
  Args a = m.a;
  a.tasks += d * m.s_tasks;
  a.tasks_in = a.tasks;
  a.succ += d * m.s_succ;
  a.ready += d * m.s_ready;
  a.ready_in = a.ready;
  a.counts += d * m.s_counts;
  a.counts_in = a.counts;
  a.ivalues += d * m.s_ivalues;
  a.ivalues_in = a.ivalues;
  a.freestk += d * m.s_freestk;
  a.dispatch += d * m.s_dispatch;
  a.lanes += d * m.s_lanes;
  a.lstate += d * m.s_lstate;
  if (a.tstats) a.tstats += d * m.s_tstats;
  if (a.work) a.work += d * m.s_work;
  for (int i = 0; i < MAX_DATA; ++i)
    if (a.data[i]) a.data[i] = static_cast<char*>(a.data[i]) + d * m.s_data[i];
  return a;
}

// sharded.py's per-device entry: block b runs mk_kernel's body on mesh
// device b's slice (no recorder, no quiesce poll).
template <int kMode>
__global__ void __launch_bounds__(BT) mk_grid_kernel(MeshArgs mesh) {
  constexpr bool kObs = false;
  const Args a = mesh_slice(mesh, blockIdx.x);
#include "mk_body.cuh"
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int ld_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int ld_relaxed(const int32_t* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Publish what this thread stored before: fence, then a release add of
// one to the counter.
__device__ __forceinline__ void publish(int32_t* ctr) {
  __threadfence();
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;"
               :
               : "l"(ctr)
               : "memory");
}

// The exchange of one CTA (thread 0): its ports, the bounded waits, the
// export scan and the import.
struct Mesh {
  const MeshArgs& m;
  int me, nports;
  int32_t* cand;  // the export scan's candidates (shared memory)

  __device__ int32_t* port(int dev, int k) const {
    return m.ws + static_cast<size_t>(dev * nports + k) * m.port_words;
  }

  // Spin until *ctr >= want. False when the mesh was stopped or this wait
  // passed its deadline (then it stops the mesh, naming itself).
  __device__ bool wait(const int32_t* ctr, int want, int r, int hop,
                       int which) const {
    const unsigned long long deadline = now_ns() + m.timeout_ns;
    for (;;) {
      if (ld_acquire(ctr) >= want) return true;
      if (ld_relaxed(m.err + ER_STOP) != 0) return false;
      if (now_ns() > deadline) {
        if (atomicCAS(m.err + ER_CLAIM, 0, 1) == 0) {
          m.err[ER_DEV] = me;
          m.err[ER_ROUND] = r;
          m.err[ER_HOP] = hop;
          m.err[ER_WAIT] = which;
          __threadfence();
        }
        atomicExch(m.err + ER_STOP, 1);
        return false;
      }
    }
  }

  // ici_steal.py elig_of (kResident false) or resident.py elig_of with
  // homed=False (kResident true: migrate-once, and no row that a homed
  // export would have to leave a proxy for).
  template <bool kResident>
  __device__ bool elig(Sched& S, int cand) const {
    const int fn = S.w(cand, F_FN);
    bool ok = fn >= 0 && fn < MESH_MAX_FNS && m.wl[fn] != 0;
    if constexpr (kResident) {
      const bool homed = S.w(cand, F_SUCC0) != NO_TASK ||
                         S.w(cand, F_SUCC1) != NO_TASK ||
                         S.w(cand, F_CSR_N) > 0 ||
                         S.w(cand, F_OUT) >= S.counts[C_VBASE];
      return ok && S.w(cand, F_HOME) < 0 && !homed;
    } else {
      return ok && S.w(cand, F_SUCC0) == NO_TASK &&
             S.w(cand, F_SUCC1) == NO_TASK && S.w(cand, F_CSR_N) == 0;
    }
  }

  // export: scan up to `scan` entries behind the ring head, move up to
  // `quota` eligible rows into the partner's inbox `box` (tombstoned and
  // freed here), compact the kept candidates back against the new head.
  // Returns nsend.
  template <bool kResident>
  __device__ int export_rows(Sched& S, const Args& a, int quota,
                             int32_t* box) const {
    int32_t* c = S.counts;
    const int head = c[C_HEAD];
    const int n = min(c[C_TAIL] - head, m.scan);
    int nelig = 0;
    for (int j = 0; j < n; ++j) {
      cand[j] = a.ready[floor_mod(head + j, a.cap)];
      nelig += elig<kResident>(S, cand[j]);
    }
    const int nsend = min(quota, nelig);
    int se = 0, kp = 0;
    for (int j = 0; j < n; ++j) {
      const int row = cand[j];
      if (se < nsend && elig<kResident>(S, row)) {
        int32_t* dst = box + se * DESC;
        for (int w = 0; w < DESC; ++w) dst[w] = S.w(row, w);
        if constexpr (kResident) dst[F_VMASK] = 0;  // export owns the mask
        S.w(row, F_DEP) = -1;
        const int nf = S.freestk[0] + 1;
        S.freestk[0] = nf;
        S.freestk[nf] = row;
        ++se;
      } else {
        a.ready[floor_mod(head + nsend + kp, a.cap)] = row;
        ++kp;
      }
    }
    c[C_HEAD] = head + nsend;
    c[C_PENDING] -= nsend;
    return nsend;
  }

  // import_rows / install_fixed: adopt the inbox's rows through the
  // core's install_descriptor (the stolen rows were ready: F_DEP 0).
  __device__ void import_rows(Sched& S, const int32_t* box) const {
    const int n = __ldcg(box + m.window * DESC);
    for (int i = 0; i < n; ++i) {
      int32_t row[DESC];
      for (int w = 0; w < DESC; ++w) row[w] = __ldcg(box + i * DESC + w);
      S.install_descriptor(row);
    }
  }
};

// One sched(quantum) of a steal kernel's CTA, on thread 0: mk_kernel's
// rounds (schedule(), which pops the ring alone for a table with no lanes)
// with the thread-0 bodies of the lean and lanes instances (fib, sum, UTS
// node; their batch_of forms), spilling the lanes at exit.
template <bool kLanes>
__device__ void mesh_sched(Sched& S, const Args& a, Round& R, Obs& O) {
  const int e0 = S.counts[C_EXECUTED];
  const int32_t* meta = a.meta;
  for (;;) {
    schedule<false>(S, a, e0, R, O);
    if (R.act == ACT_EXIT) break;
    if (R.act == ACT_SCALAR) {
      switch (R.body) {
        case B_FIB:
          fib_body(S, meta, R.idx);
          break;
        case B_SUM:
          sum_body(S, R.idx);
          break;
        case B_UTS:
          uts_body(S, meta, R.idx);
          break;
        default:  // the host refuses tables with other bodies
          break;
      }
      S.complete(R.idx);
    } else if constexpr (kLanes) {
      for (int s = 0; s < R.take; ++s) {
        if (R.body == B_FIB_BATCH)
          fib_body(S, meta, R.rows[s]);
        else if (R.body == B_UTS_BATCH)
          uts_body(S, meta, R.rows[s]);
      }
      finish_batch<false>(S, a, R, nullptr);
    }
  }
  if constexpr (kLanes) spill<false>(S, a, O);
}

// ici_steal.py _kernel: sched(quantum); the abort word; the ring
// allreduce of (pending, backlog, abort) in ndev - 1 hops to the right
// neighbour, each credited by it; unless done, one exchange at distance
// d = 2^(r mod nh) mod ndev (onto this CTA's own inbox on a one-device
// ring), its credit to the device that targets this inbox next round.
template <bool kLanes>
__global__ void __launch_bounds__(1) ici_ring_kernel(MeshArgs m) {
  __shared__ int32_t s_counts[8];
  __shared__ Round R;
  __shared__ int32_t s_cand[MAX_SCAN];
  const int me = blockIdx.x, ndev = m.ndev, W = m.window;
  Args a = mesh_slice(m, me);
  a.fuel = m.quantum;
  a.stage_all_values = 1;
  Sched S{a.tasks, a.succ, a.ready, s_counts, a.ivalues, a.freestk, a.cap};
  Obs O{};
  const Mesh X{m, me, 1, s_cand};
  const int nh = ndev > 1 ? 32 - __clz(ndev - 1) : 1;
  const int right = (me + 1) % ndev, left = (me + ndev - 1) % ndev;
  int32_t* mine = X.port(me, 0);
  int xs[XS_WORDS] = {0, 0, 0, 0};
  S.stage(a);
  int r = 0;
  bool done = false, ok = true;
  while (!done && r < m.max_rounds) {
    mesh_sched<kLanes>(S, a, R, O);
    int cur_p = s_counts[C_PENDING], cur_b = s_counts[C_TAIL] - s_counts[C_HEAD];
    int cur_a = ld_relaxed(m.abort + 8 * me) != 0;
    int tot_p = cur_p, tot_b = cur_b, tot_a = cur_a;
    for (int k = 0; k < ndev - 1 && ok; ++k) {
      const int seq = r * (ndev - 1) + k + 1;
      ok = seq == 1 || X.wait(mine + P_SCRED, seq - 1, r, k, W_STAT_CREDIT);
      if (!ok) break;
      int32_t* dst = X.port(right, 0) + P_STAT;
      dst[0] = cur_p;
      dst[1] = cur_b;
      dst[2] = cur_a;
      xs[XS_STAT_WORDS] += 3;
      publish(X.port(right, 0) + P_SARR);
      ok = X.wait(mine + P_SARR, seq, r, k, W_STAT_ARRIVAL);
      if (!ok) break;
      cur_p = __ldcg(mine + P_STAT);
      cur_b = __ldcg(mine + P_STAT + 1);
      cur_a = __ldcg(mine + P_STAT + 2);
      publish(X.port(left, 0) + P_SCRED);
      tot_p = wrap_add(tot_p, cur_p);
      tot_b = wrap_add(tot_b, cur_b);
      tot_a = wrap_add(tot_a, cur_a);
    }
    if (!ok) break;
    done = tot_p == 0 || tot_a > 0;
    if (!done) {
      const int d = (1 << (r % nh)) % ndev;
      const int target = (me + d) % ndev;
      const int backlog = s_counts[C_TAIL] - s_counts[C_HEAD];
      const int quota = min(max(backlog - floor_div(tot_b, ndev), 0), W);
      ok = r == 0 || X.wait(mine + P_RCRED, r, r, 0, W_ROW_CREDIT);
      if (!ok) break;
      int32_t* box = X.port(target, 0) + P_INBOX;
      const int nsend = X.export_rows<false>(S, a, quota, box);
      box[W * DESC] = nsend;
      xs[XS_ROWS] += nsend;
      publish(X.port(target, 0) + P_RARR);
      ok = X.wait(mine + P_RARR, r + 1, r, 0, W_ROW_ARRIVAL);
      if (!ok) break;
      X.import_rows(S, mine + P_INBOX);
      const int dn = (1 << ((r + 1) % nh)) % ndev;
      publish(X.port((me + ndev - dn) % ndev, 0) + P_RCRED);
    }
    ++r;
  }
  s_counts[C_VBASE] = r;  // C_ROUNDS
  for (int i = 0; i < 8; ++i) a.counts[i] = s_counts[i];
  for (int i = 0; i < XS_WORDS; ++i) m.xstats[me * XS_WORDS + i] = xs[i];
}

// resident.py _kernel, steal-only: the abort word; sched(quantum); the
// fold over the XOR hops in hop order, each hop a credited stat exchange
// with me ^ (1 << k) (recursive-doubling sums of [0, SX_AM), the
// partner's backlog raw), then the demand-driven steal: rows go only to a
// partner whose backlog is under min(quantum, W), clip((mine - theirs +
// 1) // 2, 0, W) of them, into that hop's inbox with its credit; exit in
// lockstep once the folded pending is 0 or an abort was folded.
template <bool kLanes>
__global__ void __launch_bounds__(1) resident_steal_kernel(MeshArgs m) {
  __shared__ int32_t s_counts[8];
  __shared__ Round R;
  __shared__ int32_t s_cand[MAX_SCAN];
  const int me = blockIdx.x, W = m.window;
  Args a = mesh_slice(m, me);
  a.fuel = m.quantum;
  a.stage_all_values = 1;
  Sched S{a.tasks, a.succ, a.ready, s_counts, a.ivalues, a.freestk, a.cap};
  Obs O{};
  const Mesh X{m, me, max(m.nhops, 1), s_cand};
  const int starve_below = min(m.quantum, W);
  int xs[XS_WORDS] = {0, 0, 0, 0};
  S.stage(a);
  int r = 0, abort_round = -1;
  bool done = false, ok = true;
  while (!done && r < m.max_rounds) {
    const int local_abort = ld_relaxed(m.abort + 8 * me) != 0;
    mesh_sched<kLanes>(S, a, R, O);
    int acc[SX_AM] = {s_counts[C_PENDING], 0, 0, 0, 0, local_abort, 0};
    for (int h = 0; h < m.nhops && ok; ++h) {
      const int k = m.hops[h], partner = me ^ (1 << k);
      int32_t* mine = X.port(me, k);
      int32_t* theirs = X.port(partner, k);
      ok = r == 0 || X.wait(mine + P_SCRED, r, r, k, W_STAT_CREDIT);
      if (!ok) break;
      for (int i = 0; i < SX_AM; ++i) theirs[P_STAT + i] = acc[i];
      theirs[P_STAT + S_BL] = s_counts[C_TAIL] - s_counts[C_HEAD];
      xs[XS_STAT_WORDS] += STAT_WORDS;
      publish(theirs + P_SARR);
      ok = X.wait(mine + P_SARR, r + 1, r, k, W_STAT_ARRIVAL);
      if (!ok) break;
      for (int i = 0; i < SX_AM; ++i)
        acc[i] = wrap_add(acc[i], __ldcg(mine + P_STAT + i));
      const int peer_b = __ldcg(mine + P_STAT + S_BL);
      publish(theirs + P_SCRED);
      const int myb = s_counts[C_TAIL] - s_counts[C_HEAD];
      const int quota =
          peer_b < starve_below
              ? min(max(floor_div(myb - peer_b + 1, 2), 0), W)
              : 0;
      ok = r == 0 || X.wait(mine + P_RCRED, r, r, k, W_ROW_CREDIT);
      if (!ok) break;
      int32_t* box = theirs + P_INBOX;
      const int nsend =
          quota > 0 ? X.export_rows<true>(S, a, quota, box) : 0;
      box[W * DESC] = nsend;
      xs[XS_ROWS] += nsend;
      publish(theirs + P_RARR);
      ok = X.wait(mine + P_RARR, r + 1, r, k, W_ROW_ARRIVAL);
      if (!ok) break;
      X.import_rows(S, mine + P_INBOX);
      publish(theirs + P_RCRED);
    }
    if (!ok) break;
    const bool aborted = acc[SF_ABORT] > 0;
    if (aborted && abort_round < 0) abort_round = r;
    done = acc[SF_PEND] == 0 || aborted;
    ++r;
  }
  s_counts[C_VBASE] = r;  // C_ROUNDS
  for (int i = 0; i < 8; ++i) a.counts[i] = s_counts[i];
  for (int i = 0; i < XS_WORDS; ++i) m.xstats[me * XS_WORDS + i] = xs[i];
  int32_t* fs = m.fstats + me * FS_WORDS;
  for (int i = 0; i < FS_WORDS; ++i)
    fs[i] = i == FS_DEAD_ROUND || i == FS_QUIESCE_ROUND ? -1
            : i == FS_ABORT_ROUND                       ? abort_round
                                                        : 0;
}

}  // namespace

extern "C" {

// What the host passes (device/megakernel.py MeshHost): every field is 64
// bits wide, pointers included, so the layout is the same on both sides.
struct MeshHost {
  long long tasks, succ, ready, counts, ivalues, freestk, dispatch, lanes,
      lstate, tstats, work, meta;
  long long s_tasks, s_succ, s_ready, s_counts, s_ivalues, s_freestk,
      s_dispatch, s_lanes, s_lstate, s_tstats, s_work;
  long long data[MAX_DATA], s_data[MAX_DATA];
  long long nfn, nbatch, nrows, cap, num_values, fuel, stage_all_values,
      ndev;
  long long abort, ws, err, wl, fstats, xstats;
  long long quantum, max_rounds, window, scan, nhops, port_words,
      timeout_ns;
  long long hops[MAX_HOPS];
};

static void* mesh_kernel_of(int kind, int mode) {
  switch (kind) {
    case 0:
      return mode ? reinterpret_cast<void*>(mk_grid_kernel<1>)
                  : reinterpret_cast<void*>(mk_grid_kernel<0>);
    case 1:
      return mode ? reinterpret_cast<void*>(ici_ring_kernel<true>)
                  : reinterpret_cast<void*>(ici_ring_kernel<false>);
    default:
      return mode ? reinterpret_cast<void*>(resident_steal_kernel<true>)
                  : reinterpret_cast<void*>(resident_steal_kernel<false>);
  }
}

// The most CTAs of a steal kernel (kind 1 ring, 2 resident; mode 0 lean,
// 1 lanes) the card holds at once, at one CTA an SM at most: the
// occupancy API's blocks an SM times the SMs, capped at the SM count.
// Returns a CUDA error, the count in *out.
int hclib_mesh_coresident(int kind, int mode, int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mesh_kernel_of(kind, mode), 1, 0);
  if (e != cudaSuccess) return e;
  *out = !coop ? 0 : per_sm >= 1 ? sms : 0;
  return cudaSuccess;
}

// kind 0: mk_grid_kernel (an ordinary launch of ndev blocks of `threads`);
// 1: ici_ring_kernel, 2: resident_steal_kernel (cooperative launches of
// ndev one-thread CTAs, refused past hclib_mesh_coresident). mode: 0 lean,
// 1 lanes. Returns cudaGetLastError() (0 = launched).
int hclib_mesh_launch(const MeshHost* h, int kind, int mode, int threads,
                      int smem, void* stream) {
  if (kind < 0 || kind > 2 || mode < 0 || mode > 1 || h->ndev < 1 ||
      (kind > 0 && (h->nhops > MAX_HOPS || h->scan > MAX_SCAN ||
                    h->scan < 0 || h->window < 1 || !h->ws || !h->err ||
                    !h->xstats || (kind == 2 && !h->fstats))))
    return cudaErrorInvalidValue;
  MeshArgs m{};
  Args& a = m.a;
  a.tasks = reinterpret_cast<int32_t*>(h->tasks);
  a.succ = reinterpret_cast<const int32_t*>(h->succ);
  a.ready = reinterpret_cast<int32_t*>(h->ready);
  a.counts = reinterpret_cast<int32_t*>(h->counts);
  a.ivalues = reinterpret_cast<int32_t*>(h->ivalues);
  a.freestk = reinterpret_cast<int32_t*>(h->freestk);
  a.meta = reinterpret_cast<const int32_t*>(h->meta);
  a.dispatch = reinterpret_cast<int32_t*>(h->dispatch);
  for (int i = 0; i < MAX_DATA; ++i) {
    a.data[i] = reinterpret_cast<void*>(h->data[i]);
    m.s_data[i] = h->s_data[i];
  }
  a.work = reinterpret_cast<float*>(h->work);
  a.lanes = reinterpret_cast<int32_t*>(h->lanes);
  a.lstate = reinterpret_cast<int32_t*>(h->lstate);
  a.tstats = reinterpret_cast<int32_t*>(h->tstats);
  a.qstride = 1;
  a.nfn = static_cast<int>(h->nfn);
  a.nbatch = static_cast<int>(h->nbatch);
  a.nrows = static_cast<int>(h->nrows);
  a.nbk = 1;
  a.cap = static_cast<int>(h->cap);
  a.num_values = static_cast<int>(h->num_values);
  a.fuel = static_cast<int>(h->fuel);
  a.reps = 1;
  a.stage_all_values = static_cast<int>(h->stage_all_values);
  m.s_tasks = h->s_tasks;
  m.s_succ = h->s_succ;
  m.s_ready = h->s_ready;
  m.s_counts = h->s_counts;
  m.s_ivalues = h->s_ivalues;
  m.s_freestk = h->s_freestk;
  m.s_dispatch = h->s_dispatch;
  m.s_lanes = h->s_lanes;
  m.s_lstate = h->s_lstate;
  m.s_tstats = h->s_tstats;
  m.s_work = h->s_work;
  m.ndev = static_cast<int>(h->ndev);
  m.abort = reinterpret_cast<const int32_t*>(h->abort);
  m.ws = reinterpret_cast<int32_t*>(h->ws);
  m.err = reinterpret_cast<int32_t*>(h->err);
  m.wl = reinterpret_cast<const int32_t*>(h->wl);
  m.fstats = reinterpret_cast<int32_t*>(h->fstats);
  m.xstats = reinterpret_cast<int32_t*>(h->xstats);
  m.quantum = static_cast<int>(h->quantum);
  m.max_rounds = static_cast<int>(h->max_rounds);
  m.window = static_cast<int>(h->window);
  m.scan = static_cast<int>(h->scan);
  m.nhops = static_cast<int>(h->nhops);
  m.port_words = static_cast<int>(h->port_words);
  for (int i = 0; i < MAX_HOPS; ++i) m.hops[i] = static_cast<int>(h->hops[i]);
  m.timeout_ns = h->timeout_ns;
  const auto st = static_cast<cudaStream_t>(stream);
  void* kernel = mesh_kernel_of(kind, mode);
  if (kind == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (mode)
      mk_grid_kernel<1><<<m.ndev, threads, smem, st>>>(m);
    else
      mk_grid_kernel<0><<<m.ndev, threads, smem, st>>>(m);
    return cudaGetLastError();
  }
  int limit = 0;
  cudaError_t e = static_cast<cudaError_t>(
      hclib_mesh_coresident(kind, mode, &limit));
  if (e != cudaSuccess) return e;
  if (m.ndev > limit) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&m};
  e = cudaLaunchCooperativeKernel(kernel, dim3(m.ndev), dim3(1), args, 0, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
