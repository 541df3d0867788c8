// The mesh kernels (CUDA C++, sm_90a): a mesh device is one CTA, and the
// CTAs of a mesh are co-resident on one card.
//
// Replaces:
//   ici_ring_kernel  <- hclib_tpu/device/ici_steal.py ICIStealMegakernel.
//                       _kernel (:278, pallas_call at :765) with the
//                       export / import closures of _make_xfer (:180): the
//                       ring allreduce of (pending, backlog, abort) in
//                       ndev - 1 credited hops, then one exchange at
//                       distance 2^(r mod nh) mod ndev
//   resident_kernel  <- hclib_tpu/device/resident.py ResidentKernel.
//                       _kernel (:626, pallas_call at :2222), in four
//                       configurations: steal-only (kSteal, homed=False:
//                       stage_resident :945, elig_of :1041, export :1069,
//                       import_rows :1178, fold_and_steal :1562, the
//                       round loop :1890-2099), PGAS-only (kPgas: op_put
//                       :834, op_wait_until :862, op_count :878, op_am
//                       :801, the atomics and locks :881-907,
//                       drain_outbox :1189, handle_am :1231-1320 with the
//                       built-in kinds, drain_receives :1322, scan_waits
//                       :1381, the stat vector's XOR all-to-all section
//                       :497-536), both at once, and migrating (kHome:
//                       homed_elig_of :1025, the proxy budget, export's
//                       homed copies and value args, install_fixed :993,
//                       complete_hook :914 in HomeSched); each of them
//                       also with the injection ring (kInject: poll
//                       :1404, the tenant lanes' tpoll :1458, the ring
//                       backlog in the fold's SF_INJ and the exit,
//                       :1938-1988); and each steal configuration with
//                       the fault layer (kFault: the DeviceFaultPlan
//                       predicates :738-799, the faulty row exchange
//                       :1681-1834, heartbeat detection and quarantine
//                       :1836-1870, the dead device's round :1895-1937);
//                       and each of them observed (kObs: the quiesce word
//                       of checkpoint builds, the hold and the settled
//                       exit :1909-2018, the exit export :2035-2071, and
//                       the per-device flight recorder, the records of
//                       :1447-2042); ici_ring_kernel observed records its
//                       rounds, TR_XFER :393 and TR_ABORT :432
//   pgas_ring_kernel <- hclib_tpu/device/pgas_kernel.py PGASMegakernel.
//                       _kernel (:182, pallas_call at :665): a mesh whose
//                       size is not a power of two; stage_pgas :335,
//                       drain_outbox :358, the stat allreduce :407 as
//                       per-round stat slots, drain_receives :470,
//                       scan_waits :543, the round loop :579-611; observed
//                       (kObs), its records (TR_XFER :405, TR_ABORT :604)
// csrc/megakernel.cu adds mk_grid_kernel (sharded.py's per-device entry,
// mk_kernel's body a block) and instantiates these with the built-in
// thread-0 bodies; a user-body library (csrc/user.cuh) instantiates them
// with its own bodies, the PGAS and migrating configurations and the
// injecting instances only there (a table of built-in bodies alone
// builds one with no user body).
//
// Design. The steal kernels keep the whole run in one launch: each CTA's
// thread 0 runs the serial scheduler of mk_kernel (Sched's stage, pop,
// spawn, complete; the lane tier's schedule, finish_batch and spill) for a
// quantum a round, then the exchange. Their CTAs wait on each other, so
// they are launched cooperatively (cudaLaunchCooperativeKernel), never
// more CTAs than the card holds at once: a spinning CTA whose partner is
// not resident would wait forever.
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
// PGAS. A put is stores of the channel's rows into the partner's slice of
// the stacked data buffer, a fence, and a release add on the partner's
// per-(source, channel) arrival counter; an active message is a 16-word
// row stored into the target's per-(source) inbox ring of am_window rows
// and a release add on its per-source arrival counter. Senders count what
// they sent per (target, channel) and per target; the fold routes those
// counts with the XOR all-to-all, so each device learns how many puts and
// messages each source sent it, waits (acquire) until its arrival counters
// reach those counts, and only then adds them to chan_tot (what count()
// and wait_until see) and installs the messages. chan_tot grows only
// there, never when a store lands, so waits release in the round JAX's do.
// A put may land while the target's thread 0 runs bodies, as JAX's remote
// DMA does; no barrier is added. A body reads landed rows after the
// acquire in drain_receives (an acquire load invalidates the SM's L1).
// At most am_window / 2 messages leave for one target a round, the capped
// head waiting in the FIFO outbox (OVF_OUTBOX when it is full), so a slot
// is never rewritten before its target drained it (pgas_kernel.py's
// argument: the fold of round r + 1 orders after every drain of round r).
//
// Faults. Under kFault every fault decision is a pure function of (seed,
// site, round, hop, granter) (fault_mix), so both ends of a pair, and
// every bystander, take it alike. The credit counters stay monotonic: a
// dropped credit is not published, a duplicated one is published twice,
// and a writer waits until its credits reach the waits it has done plus
// one, which is JAX's semaphore_wait(1) on signals in less waits done. A
// credit owed (dropped) skips one wait instead (regeneration), after the
// pair has skipped its row exchange on that hop for credit_timeout rounds;
// the arrival counter is waited on against the exchanges the pair has
// done. So no writer ever waits for a credit that was dropped, and a run
// with credit_timeout 0 raises the wedge flag, skips every row exchange
// and exits at the next fold. The dead device keeps its exchange: fold,
// exports of its backlog, credits and arrivals; only its scheduler stops.
//
// Every wait is bounded: past its deadline (the global timer, in
// nanoseconds: the SM clock that clock64 counts slows under a power cap)
// the CTA claims the error row, writes (device, round, hop, wait) into it
// and raises the stop word; every other CTA polls the stop word in its
// waits and leaves too, and the host raises with those words. A protocol
// fault (a put on an undeclared channel or outside the buffer, a message
// to a device outside the mesh) stops the mesh the same way. A protocol
// fault shows as an error, never as a hung launch.
//
// Injection. Each device's ring (R rows of RING_ROW words, host-written
// before the launch) and its ictl row (tail, closed, consumed) are in
// global memory; the kernel re-reads the tail every round with a relaxed
// load, installs the published rows past its consumed cursor in order and
// folds the backlog it leaves into SF_INJ, so the mesh exits only when
// every ring is drained. On a tenant mesh the ring is T lane regions and
// each device's (T, 8) tctl rows are scanned and updated in place by its
// thread 0 (the host reads them back as the echo).
//
// Observed instances (kObs; a launch with neither a recorder nor a
// quiesce word runs the instances without it, whose code is what it was
// before). The recorder is mk_kernel's Obs over the device's slice of one
// ring buffer, its cursors in thread 0's registers, the header written at
// exit; the exchange's records are emitted in JAX's order on each device
// (a regenerated credit's record after the round's TR_XFER although the
// skipped wait came first). A checkpoint build re-reads words 1-2 of the
// device's abort row (flag, threshold round) with the abort word; from
// the threshold round on, the scheduler gets fuel 0 and the ring polls
// consume nothing, while every hop's handshakes, exports, drains and
// wait scans go on; the quiesce sum rides the stat slab after the backlog
// (and the heartbeats), so the mesh learns the cut in the same fold, and
// exits once it is quiesced with every outbox empty and sent equal to
// received. The wait table stays in the workspace (the host rebases its
// needs); the consumed cursor goes to the device's ictl word 2.
//
// What bounds it: as mk_kernel, a chain of dependent loads and stores by
// one thread a CTA, now on ndev SMs at once; an exchange hop adds the
// round trip of two flag handshakes through L2, and a put its row bytes.

#pragma once

#include "sched.cuh"

namespace {

using namespace hc;

constexpr int F_VMASK = 15;  // descriptor.py
constexpr int MAX_HOPS = 16;
constexpr int MESH_MAX_FNS = 32;
constexpr int MAX_SCAN = 1024;
constexpr int MAX_CHANS = 8;
constexpr int NUM_ARGS = 6;
// A port: the slabs and counters one (device, hop) pair of the exchange
// owns (the ring uses one port a device). Counters first, each on its own
// 32-byte sector; then the stat slab; then the (W + 1, 16) row inbox
// whose row W word 0 is the row count. The steal-only kernel sends the
// seven sums and the backlog (STAT_WORDS) and keeps its inbox at
// P_INBOX; the PGAS configurations send the whole stat vector of
// MeshArgs::stat_words and keep the inbox at MeshArgs::p_inbox.
constexpr int P_SARR = 0, P_SCRED = 8, P_RARR = 16, P_RCRED = 24;
constexpr int P_STAT = 32, STAT_WORDS = 8, P_INBOX = 64;
// Resident stat words (resident.py SF_*): the sums of [0, SX_AM), then
// the XOR all-to-all section (the PGAS configurations), then the sender's
// ready backlog. SF_INJ sums the injection rings' backlog (0 without
// kInject), SF_WEDGE the wedge flags (kFault). With no active messages or
// channels, the all-to-all section is all zeros and the steal-only kernel
// does not send it (S_BL is 7 there). Under kFault the ndev routed
// heartbeats follow the backlog.
constexpr int SF_PEND = 0, SF_RECV = 1, SF_OUTB = 2, SF_SENT = 3,
              SF_INJ = 4, SF_ABORT = 5, SF_WEDGE = 6, SX_AM = 7, S_BL = 7;
// The error row: the stop word, the claim, then what timed out (or the
// protocol fault).
constexpr int ER_STOP = 0, ER_CLAIM = 1, ER_DEV = 2, ER_ROUND = 3,
              ER_HOP = 4, ER_WAIT = 5;
enum {
  W_STAT_CREDIT = 1, W_STAT_ARRIVAL, W_ROW_CREDIT, W_ROW_ARRIVAL,
  W_PUT_ARRIVAL, W_AM_ARRIVAL, F_BAD_CHANNEL, F_BAD_ROWS, F_BAD_TARGET,
  F_RING_OP
};
// resident.py FS_*: the fault/abort stats row a device writes at exit.
constexpr int FS_DROPPED = 0, FS_REGEN = 1, FS_DUPED = 2, FS_DELAYED = 3,
              FS_DEAD_ROUND = 4, FS_QMASK = 5, FS_REHOMED = 6,
              FS_ABORT_ROUND = 7, FS_STARVED = 8, FS_HB = 9,
              FS_QUIESCE_ROUND = 10, FS_TEN_EXPIRED = 11, FS_WORDS = 16;
// The fault layer (kFault; device/resident.py FP_* and FW_*).
namespace flt {
// The plan's words, one copy for the mesh: the seed, the per-mille rates,
// the dead device (-1: none) and its round, both timeouts, the exact
// lists' lengths, whether a drop wedges the mesh (credit_timeout 0), then
// MAX_AT (round, hop, granter) entries a site, drops then duplicates.
constexpr int SEED = 0, DROP = 1, DUP = 2, DELAY = 3, DEAD_DEV = 4,
              DEAD_ROUND = 5, CREDIT_TIMEOUT = 6, HB_TIMEOUT = 7, NDROP = 8,
              NDUP = 9, WEDGES = 10, AT = 16, MAX_AT = 16;
// A device's fault workspace (resident.py's pair_down, owed, hb_seen,
// hb_round, deadmask, pstate's PS_HB and PS_WEDGE): its FS_* words; per
// hop bit the last round of the pair's down window, the credits owed,
// the credit waits done and the row exchanges done; per peer the
// heartbeat last seen, the round it last moved and the quarantine flag;
// the routed heartbeats (slot p: me ^ p's after the fold); my heartbeat;
// the wedge flag.
constexpr int PAIR_DOWN = 16, OWED = 32, WAITS = 48, XDONE = 64,
              HB_SEEN = 80, HB_ROUND = 112, DEAD = 144, HB_ACC = 176,
              HB = 208, WEDGE = 209, WS_WORDS = 216;
}  // namespace flt
// The injection ring's layout (descriptor.py RING_ROW, TEN_*; tenants.py
// TC_*): a row's words past the descriptor, and a lane's tctl row.
namespace inj {
constexpr int ROW = 256, TEN_ID = 16, TEN_EXPIRED = 17;
constexpr int TC_TAIL = 0, TC_CONSUMED = 1, TC_WEIGHT = 2, TC_PAUSE = 3,
              TC_EXPIRED = 4, TC_INSTALLED = 5, TC_DROPPED = 6;
}  // namespace inj
// The exchange's volume a device (both steal kernels): rows it exported,
// stat words it sent; and what the PGAS configurations sent: active
// messages and puts.
constexpr int XS_ROWS = 0, XS_STAT_WORDS = 1, XS_AMS = 2, XS_PUTS = 3,
              XS_WORDS = 4;
// resident.py pstate words (RECV, NWAIT, SENT, PROXIES), then the port's:
// the proxies' peak, the built-in messages applied (kind k at PS_AMS - 2 -
// k), and the words the host writes before a launch (device/resident.py
// ResidentKernel.pstate_words): the proxy budget, homed, rbase, whether
// spawn keeps home links, whether a kind declares value args.
constexpr int PS_RECV = 0, PS_NWAIT = 1, PS_SENT = 2, PS_PROXIES = 3,
              PS_PEAK = 7, PS_AMS = 8, PS_CAP = 16, PS_HOMED = 17,
              PS_RBASE = 18, PS_TRACK = 19, PS_VARGS = 20;
// C_OVERFLOW's bits of the PGAS ops and the lock FIFO.
constexpr int OVF_OUTBOX = 8, OVF_WAITS = 16, OVF_VALUES = 2, OVF_LOCKQ = 32;
// The built-in active-message kinds (resident.py RC_*): negative F_FN
// values the receiving scheduler applies in drain_receives.
enum {
  RC_GRANT = -9, RC_UNLOCK, RC_LOCK, RC_REPLY, RC_CSWAP, RC_FADD_R, RC_FADD,
  RC_COMPLETE
};
static_assert(RC_COMPLETE == -2, "built-in kinds");
// The sections of one device's PGAS workspace; the host lays them out
// (device/resident.py pgas_layout) and passes each one's word offset.
enum {
  PG_OBCTL, PG_PSTATE, PG_AM_SENT, PG_AM_RECV, PG_SENT_ROUND, PG_DATA_SENT,
  PG_CHAN_RECV, PG_CHAN_TOT, PG_OUTQ_TGT, PG_OUTQ_DESC, PG_WAITS,
  PG_STATACC, PG_AM_ARR, PG_CHAN_ARR, PG_INBOX, PG_SECTIONS
};

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
  // The user-body libraries: each device's value-block free stack.
  int32_t* vfree;
  long long s_vfree;
  // The PGAS configurations: each device's workspace (zeroed, its wait
  // table and PS_NWAIT set by the host), the channels and the sizes.
  int32_t* pg;
  long long s_pg;
  int nchan, amw, outq, maxw, stat_words, p_inbox;
  int chan_buf[MAX_CHANS], chan_rows[MAX_CHANS], chan_nrows[MAX_CHANS];
  long long chan_row_bytes[MAX_CHANS];
  int pg_off[PG_SECTIONS];
  // The injecting instances: each device's ring (ring_rows rows of
  // inj::ROW words), its ictl row (tail, closed, consumed) and, with
  // ntenants lanes of `region` rows, its (ntenants, 8) tctl rows.
  const int32_t* iring;
  int32_t* ictl;
  int32_t* tctl;
  int ring_rows, ntenants, region;
  // The instances with the fault layer: the plan (flt::) and each
  // device's fault workspace (flt::WS_WORDS words a device).
  const int32_t* fplan;
  int32_t* fws;
  // The observed instances: each device's recorder ring (TR_HDR + 4 tr_cap
  // words a device; null when untraced) and whether the quiesce word is
  // compiled in (a checkpoint build).
  int32_t* ring;
  int tr_cap, ckpt;
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

  // Stop the mesh naming (round, hop, what): a timed-out wait or a
  // protocol fault. The first CTA to claim the error row writes it.
  __device__ void fail(int r, int hop, int which) const {
    if (atomicCAS(m.err + ER_CLAIM, 0, 1) == 0) {
      m.err[ER_DEV] = me;
      m.err[ER_ROUND] = r;
      m.err[ER_HOP] = hop;
      m.err[ER_WAIT] = which;
      __threadfence();
    }
    atomicExch(m.err + ER_STOP, 1);
  }

  __device__ bool stopped() const { return ld_relaxed(m.err + ER_STOP) != 0; }

  // Spin until *ctr >= want. False when the mesh was stopped or this wait
  // passed its deadline (then it stops the mesh, naming itself).
  __device__ bool wait(const int32_t* ctr, int want, int r, int hop,
                       int which) const {
    const unsigned long long deadline = now_ns() + m.timeout_ns;
    for (;;) {
      if (ld_acquire(ctr) >= want) return true;
      if (ld_relaxed(m.err + ER_STOP) != 0) return false;
      if (now_ns() > deadline) {
        fail(r, hop, which);
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

  // resident.py homed_elig_of: the row carries links or writes a
  // dynamic value slot (valid only at home), so it leaves as a homed copy.
  __device__ static bool links(Sched& S, int cand) {
    return S.w(cand, F_SUCC0) != NO_TASK || S.w(cand, F_SUCC1) != NO_TASK ||
           S.w(cand, F_CSR_N) > 0 || S.w(cand, F_OUT) >= S.counts[C_VBASE];
  }

  // resident.py elig_of, the migrating configuration: a migratable kind,
  // migrate-once, and link-free unless homed with the proxy budget open
  // (`allow`, read once a scan).
  __device__ bool elig_home(Sched& S, int cand, bool homed,
                            bool allow) const {
    const int fn = S.w(cand, F_FN);
    if (!(fn >= 0 && fn < MESH_MAX_FNS && m.wl[fn] != 0) ||
        S.w(cand, F_HOME) >= 0)
      return false;
    return !links(S, cand) || (homed && allow);
  }

  // resident.py export, the migrating configuration: a row with links
  // (homed) ships a copy naming its proxy - F_HOME me, F_HROW the row,
  // links cleared on the wire - and stays pending at home off the ring;
  // a link-free row moves whole (tombstoned, freed, its pending handed
  // over). The kind's value args (bits 1.. of its whitelist word) are
  // dereferenced into the wire, F_VMASK naming them. ps: my pstate.
  __device__ int export_home(Sched& S, const Args& a, int quota,
                             int32_t* box, int32_t* ps) const {
    int32_t* c = S.counts;
    const int head = c[C_HEAD];
    const int n = min(c[C_TAIL] - head, m.scan);
    const bool homed = ps[PS_HOMED] != 0;
    const bool allow = ps[PS_PROXIES] < ps[PS_CAP];
    int nelig = 0;
    for (int j = 0; j < n; ++j) {
      cand[j] = a.ready[floor_mod(head + j, a.cap)];
      nelig += elig_home(S, cand[j], homed, allow);
    }
    const int nsend = min(quota, nelig);
    int se = 0, kp = 0, nwhole = 0;
    for (int j = 0; j < n; ++j) {
      const int row = cand[j];
      if (se < nsend && elig_home(S, row, homed, allow)) {
        int32_t* dst = box + se * DESC;
        for (int w = 0; w < DESC; ++w) dst[w] = S.w(row, w);
        dst[F_VMASK] = 0;  // export owns the wire's value mask
        if (homed && links(S, row)) {
          dst[F_SUCC0] = NO_TASK;
          dst[F_SUCC1] = NO_TASK;
          dst[F_CSR_OFF] = 0;
          dst[F_CSR_N] = 0;
          dst[F_HOME] = me;
          dst[F_HROW] = row;
          ps[PS_PROXIES] += 1;
          ps[PS_PEAK] = max(ps[PS_PEAK], ps[PS_PROXIES]);
        } else {
          S.w(row, F_DEP) = -1;
          const int nf = S.freestk[0] + 1;
          S.freestk[0] = nf;
          S.freestk[nf] = row;
          ++nwhole;
        }
        const int vm = m.wl[S.w(row, F_FN)] >> 1;
        if (vm) {
          for (int i = 0; i < NUM_ARGS; ++i)
            if ((vm >> i) & 1) dst[F_A0 + i] = S.iv[S.w(row, F_A0 + i)];
          dst[F_VMASK] = vm;
        }
        ++se;
      } else {
        a.ready[floor_mod(head + nsend + kp, a.cap)] = row;
        ++kp;
      }
    }
    c[C_HEAD] = head + nsend;
    c[C_PENDING] -= nwhole;
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

// One device's PGAS state (resident.py's scratch: the outbox, the AM and
// put counts, chan_tot, pstate, the wait table, the stat accumulator) in
// its slice of the workspace, and the ops a body calls (ctx.pgas): put,
// am, wait_until, count; plus the round's drains.
struct Pgas {
  const MeshArgs& m;
  const Mesh& X;
  int me;
  int r;              // the current round (for a fault's error row)
  bool ring = false;  // under pgas_ring_kernel: no atomics or locks

  __device__ int32_t* at(int dev, int sec) const {
    return m.pg + dev * m.s_pg + m.pg_off[sec];
  }
  __device__ int32_t* mine(int sec) const { return at(me, sec); }

  // op_put: copy channel `chan`'s rows from my slice of its buffer, rows
  // [src_row, src_row + rows), into device dev's slice at dst_row, then
  // publish them on dev's (me, chan) arrival counter.
  __device__ void put(int dev, int chan, int dst_row, int src_row) const {
    if (chan < 0 || chan >= m.nchan) return X.fail(r, -1, F_BAD_CHANNEL);
    if (dev < 0 || dev >= m.ndev) return X.fail(r, -1, F_BAD_TARGET);
    const int rows = m.chan_rows[chan], nrows = m.chan_nrows[chan];
    if (src_row < 0 || dst_row < 0 || src_row + rows > nrows ||
        dst_row + rows > nrows)
      return X.fail(r, -1, F_BAD_ROWS);
    const int b = m.chan_buf[chan];
    const long long rb = m.chan_row_bytes[chan];
    const char* src = static_cast<const char*>(m.a.data[b]) +
                      me * m.s_data[b] + src_row * rb;
    char* dst = static_cast<char*>(m.a.data[b]) + dev * m.s_data[b] +
                dst_row * rb;
    const long long n = rows * rb;
    if (n % 16 == 0) {
      for (long long i = 0; i < n; i += 16)
        *reinterpret_cast<int4*>(dst + i) =
            *reinterpret_cast<const int4*>(src + i);
    } else {
      for (long long i = 0; i < n; ++i) dst[i] = src[i];
    }
    publish(at(dev, PG_CHAN_ARR) + me * m.nchan + chan);
    mine(PG_DATA_SENT)[dev * m.nchan + chan] += 1;
    mine(PG_PSTATE)[PS_SENT] += 1;
  }

  // op_am: queue a user-kind descriptor for device dev's scheduler; the
  // round's drain_outbox sends it under the inbox window. The built-in
  // kinds (fn < 0) are sent only by the atomics and locks below.
  __device__ void am(Sched& S, int dev, int fn, const int* args, int nargs,
                     int out) const {
    if (dev < 0 || dev >= m.ndev || fn < 0)
      return X.fail(r, -1, F_BAD_TARGET);
    send(S, dev, fn, args, nargs, out);
  }

  // The row into the outbox, any kind (OVF_OUTBOX when it is full).
  __device__ void send(Sched& S, int dev, int fn, const int* args, int nargs,
                       int out = 0) const {
    int32_t* ob = mine(PG_OBCTL);
    const int h = ob[1];
    if (h - ob[0] >= m.outq) {
      S.counts[C_OVERFLOW] |= OVF_OUTBOX;
      return;
    }
    const int slot = h % m.outq;
    mine(PG_OUTQ_TGT)[slot] = dev;
    int32_t* d = mine(PG_OUTQ_DESC) + slot * DESC;
    d[F_FN] = fn;
    d[F_DEP] = 0;
    d[F_SUCC0] = NO_TASK;
    d[F_SUCC1] = NO_TASK;
    d[F_CSR_OFF] = 0;
    d[F_CSR_N] = 0;
    for (int i = 0; i < NUM_ARGS; ++i) d[F_A0 + i] = i < nargs ? args[i] : 0;
    d[F_OUT] = out;
    d[F_HOME] = NO_TASK;
    d[F_HROW] = 0;
    d[F_VMASK] = 0;
    ob[1] = h + 1;
  }

  // The atomics and locks (op_fadd, op_fadd_get, op_cswap, op_lock,
  // op_unlock): a built-in message to the owner, whose serial scheduler
  // applies it in drain_receives (that order is the atomicity) and
  // replies to (me, row, rslot) where the op has a reply. The ring kernel
  // has none of them (JAX's row 6): one stops the mesh.
  __device__ bool to_mesh(int dev) const {
    if (!ring && dev >= 0 && dev < m.ndev) return true;
    X.fail(r, -1, ring ? F_RING_OP : F_BAD_TARGET);
    return false;
  }
  __device__ void fadd(Sched& S, int dev, int slot, int delta) const {
    const int w[2] = {slot, delta};
    if (to_mesh(dev)) send(S, dev, RC_FADD, w, 2);
  }
  __device__ void fadd_get(Sched& S, int dev, int slot, int delta, int row,
                           int rslot) const {
    const int w[5] = {slot, delta, me, row, rslot};
    if (to_mesh(dev)) send(S, dev, RC_FADD_R, w, 5);
  }
  __device__ void cswap(Sched& S, int dev, int slot, int expected, int nv,
                        int row, int rslot) const {
    const int w[6] = {slot, expected, nv, me, row, rslot};
    if (to_mesh(dev)) send(S, dev, RC_CSWAP, w, 6);
  }
  __device__ void lock(Sched& S, int dev, int lbase, int row,
                       int qcap) const {
    const int w[4] = {lbase, me, row, qcap};
    if (to_mesh(dev)) send(S, dev, RC_LOCK, w, 4);
  }
  __device__ void unlock(Sched& S, int dev, int lbase, int qcap) const {
    const int w[2] = {lbase, qcap};
    if (to_mesh(dev)) send(S, dev, RC_UNLOCK, w, 2);
  }

  // install_fixed: adopt a row from the wire; a homed copy writes its
  // result into its reserved slot rbase + row, and (when a kind declares
  // value args) the dereferenced args rehydrate into the row's own value
  // block, F_VMASK cleared (the wire is its only writer).
  __device__ void install_fixed(Sched& S, const int32_t* src) const {
    const int32_t* ps = mine(PG_PSTATE);
    const int row = S.install_descriptor(src);
    if (S.w(row, F_HOME) >= 0) S.w(row, F_OUT) = ps[PS_RBASE] + row;
    if (ps[PS_VARGS]) {
      const int mask = S.w(row, F_VMASK);
      const int base = S.counts[C_VBASE] + row * VBLOCK;
      int jj = 0;
      for (int i = 0; i < NUM_ARGS; ++i) {
        if ((mask >> i) & 1) {
          S.iv[base + jj] = S.w(row, F_A0 + i);
          S.w(row, F_A0 + i) = base + jj;
          ++jj;
        }
      }
      S.w(row, F_VMASK) = 0;
    }
  }

  // import_rows of the migrating configuration: each inbox row through
  // install_fixed.
  __device__ void import_fixed(Sched& S, const int32_t* box) const {
    const int n = __ldcg(box + m.window * DESC);
    for (int i = 0; i < n; ++i) {
      int32_t row[DESC];
      for (int w = 0; w < DESC; ++w) row[w] = __ldcg(box + i * DESC + w);
      install_fixed(S, row);
    }
  }

  // resident.py dep_dec: one dependency of a parked row satisfied.
  __device__ static void dep_dec(Sched& S, int row) {
    const int d = S.w(row, F_DEP) - 1;
    S.w(row, F_DEP) = d;
    if (d == 0) S.push_ready(row);
  }

  // handle_am: a user kind installs; a built-in kind is applied here.
  template <class SS>
  __device__ void handle_am(SS& S, const int32_t* d) const {
    const int fn = d[F_FN];
    if (fn >= 0) return install_fixed(S, d);
    int32_t* ps = mine(PG_PSTATE);
    if (fn >= RC_GRANT) ps[PS_AMS - 2 - fn] += 1;
    const int* a = d + F_A0;
    int32_t* iv = S.iv;
    switch (fn) {
      case RC_COMPLETE:
        iv[S.w(a[0], F_OUT)] = a[1];
        S.complete(a[0]);
        S.counts[C_EXECUTED] -= 1;  // the execution was counted remotely
        ps[PS_PROXIES] -= 1;
        break;
      case RC_FADD:
        iv[a[0]] = wrap_add(iv[a[0]], a[1]);
        break;
      case RC_FADD_R: {
        const int old = iv[a[0]];
        iv[a[0]] = wrap_add(old, a[1]);
        const int w[3] = {a[3], old, a[4]};
        send(S, a[2], RC_REPLY, w, 3);
        break;
      }
      case RC_CSWAP: {
        const int old = iv[a[0]];
        iv[a[0]] = old == a[1] ? a[2] : old;
        const int w[3] = {a[4], old, a[5]};
        send(S, a[3], RC_REPLY, w, 3);
        break;
      }
      case RC_REPLY:
        iv[a[2]] = a[1];
        dep_dec(S, a[0]);
        break;
      case RC_LOCK: {
        const int lbase = a[0], qcap = a[3];
        if (iv[lbase] == 0) {
          iv[lbase] = 1;
          send(S, a[1], RC_GRANT, a + 2, 1);
        } else {
          const int qlen = iv[lbase + 1], hq = iv[lbase + 2];
          if (qlen < qcap) {
            const int pos = lbase + 3 + 2 * floor_mod(hq + qlen, qcap);
            iv[pos] = a[1];
            iv[pos + 1] = a[2];
            iv[lbase + 1] = qlen + 1;
          } else {
            S.counts[C_OVERFLOW] |= OVF_LOCKQ;
          }
        }
        break;
      }
      case RC_UNLOCK: {
        const int lbase = a[0], qcap = a[1], qlen = iv[lbase + 1];
        if (qlen == 0) {
          iv[lbase] = 0;
        } else if (qlen > 0) {
          const int hq = iv[lbase + 2];
          const int pos = lbase + 3 + 2 * floor_mod(hq, qcap);
          iv[lbase + 2] = floor_mod(hq + 1, qcap);
          iv[lbase + 1] = qlen - 1;
          send(S, iv[pos], RC_GRANT, iv + pos + 1, 1);  // still held
        }
        break;
      }
      case RC_GRANT:
        dep_dec(S, a[0]);
        break;
      default:
        break;
    }
  }

  // op_wait_until: park row until chan_tot[chan] >= need (scan_waits).
  __device__ void wait_until(Sched& S, int chan, int need, int row) const {
    int32_t* ps = mine(PG_PSTATE);
    const int n = ps[PS_NWAIT];
    if (n >= m.maxw) {
      S.counts[C_OVERFLOW] |= OVF_WAITS;
      return;
    }
    int32_t* w = mine(PG_WAITS) + 3 * n;
    w[0] = chan;
    w[1] = need;
    w[2] = row;
    ps[PS_NWAIT] = n + 1;
  }

  // op_count: the arrivals the fold announced on chan so far.
  __device__ int count(int chan) const {
    return chan >= 0 && chan < m.nchan ? mine(PG_CHAN_TOT)[chan] : 0;
  }

  // drain_outbox: send queued messages FIFO, at most amw / 2 a target a
  // round (a capped head stalls the rest until the next round).
  __device__ void drain_outbox() const {
    int32_t* sr = mine(PG_SENT_ROUND);
    int32_t* sent = mine(PG_AM_SENT);
    int32_t* ob = mine(PG_OBCTL);
    const int32_t* tgt = mine(PG_OUTQ_TGT);
    const int32_t* q = mine(PG_OUTQ_DESC);
    for (int i = 0; i < m.ndev; ++i) sr[i] = 0;
    int h = ob[0];
    const int tail = ob[1];
    while (h < tail) {
      const int slot_q = h % m.outq, t = tgt[slot_q];
      if (sr[t] >= m.amw / 2) break;
      const int slot = sent[t] % m.amw;
      int32_t* dst = at(t, PG_INBOX) + (me * m.amw + slot) * DESC;
      for (int w = 0; w < DESC; ++w) dst[w] = q[slot_q * DESC + w];
      publish(at(t, PG_AM_ARR) + me);
      sent[t] += 1;
      sr[t] += 1;
      mine(PG_PSTATE)[PS_SENT] += 1;
      ++h;
    }
    ob[0] = h;
  }

  // The fold's starting words of the all-to-all section: slot p holds
  // what I sent to me ^ p (messages, then puts a channel).
  __device__ void stat_init(int32_t* acc) const {
    int32_t* st = mine(PG_STATACC);
    const int32_t* sent = mine(PG_AM_SENT);
    const int32_t* ds = mine(PG_DATA_SENT);
    const int32_t* ps = mine(PG_PSTATE);
    acc[SF_RECV] = ps[PS_RECV];
    acc[SF_OUTB] = mine(PG_OBCTL)[1] - mine(PG_OBCTL)[0];
    acc[SF_SENT] = ps[PS_SENT];
    const int sx_data = SX_AM + m.ndev;
    for (int p = 0; p < m.ndev; ++p) {
      st[SX_AM + p] = sent[me ^ p];
      for (int c = 0; c < m.nchan; ++c)
        st[sx_data + p * m.nchan + c] = ds[(me ^ p) * m.nchan + c];
    }
  }

  // One hop's send of the all-to-all section into the partner's slab.
  __device__ void stat_send(int32_t* slab) const {
    const int32_t* st = mine(PG_STATACC);
    for (int i = SX_AM; i < m.stat_words - 1; ++i) slab[i] = st[i];
  }

  // One hop's merge (hop bit k): slot p takes the partner's word where
  // bit k of p is set.
  __device__ void stat_merge(const int32_t* slab, int k) const {
    int32_t* st = mine(PG_STATACC);
    const int sx_data = SX_AM + m.ndev;
    for (int p = 0; p < m.ndev; ++p) {
      if (((p >> k) & 1) == 0) continue;
      st[SX_AM + p] = __ldcg(slab + SX_AM + p);
      for (int c = 0; c < m.nchan; ++c)
        st[sx_data + p * m.nchan + c] =
            __ldcg(slab + sx_data + p * m.nchan + c);
    }
  }

  // drain_receives: take exactly the puts and messages the fold
  // announced from each source (waiting, bounded, until they landed),
  // channels first, then the messages, sources in me ^ p order, each
  // through handle_am.
  template <class SS>
  __device__ bool drain_receives(SS& S) const {
    const int32_t* st = mine(PG_STATACC);
    int32_t* ps = mine(PG_PSTATE);
    const int sx_data = SX_AM + m.ndev;
    for (int c = 0; c < m.nchan; ++c) {
      int32_t* recv = mine(PG_CHAN_RECV);
      for (int p = 0; p < m.ndev; ++p) {
        const int src = me ^ p;
        const int expected = st[sx_data + p * m.nchan + c];
        const int delta = expected - recv[src * m.nchan + c];
        if (delta <= 0) continue;
        if (!X.wait(mine(PG_CHAN_ARR) + src * m.nchan + c, expected, r, src,
                    W_PUT_ARRIVAL))
          return false;
        recv[src * m.nchan + c] = expected;
        mine(PG_CHAN_TOT)[c] += delta;
        ps[PS_RECV] += delta;
      }
    }
    int32_t* arecv = mine(PG_AM_RECV);
    const int32_t* inbox = mine(PG_INBOX);
    for (int p = 0; p < m.ndev; ++p) {
      const int src = me ^ p;
      const int expected = st[SX_AM + p], base = arecv[src];
      const int delta = expected - base;
      if (delta <= 0) continue;
      if (!X.wait(mine(PG_AM_ARR) + src, expected, r, src, W_AM_ARRIVAL))
        return false;
      for (int i = 0; i < delta; ++i) {
        const int32_t* row =
            inbox + (src * m.amw + (base + i) % m.amw) * DESC;
        int32_t d[DESC];
        for (int w = 0; w < DESC; ++w) d[w] = __ldcg(row + w);
        handle_am(S, d);
      }
      arecv[src] = expected;
      ps[PS_RECV] += delta;
    }
    return true;
  }

  // scan_waits: release every parked row whose channel reached its need
  // (a dependency decrement), compacting the rest in order.
  __device__ void scan_waits(Sched& S) const {
    int32_t* ps = mine(PG_PSTATE);
    int32_t* wt = mine(PG_WAITS);
    const int32_t* tot = mine(PG_CHAN_TOT);
    const int n = ps[PS_NWAIT];
    int kept = 0;
    for (int i = 0; i < n; ++i) {
      const int ch = wt[3 * i], need = wt[3 * i + 1], row = wt[3 * i + 2];
      if (tot[ch] >= need) {
        dep_dec(S, row);
      } else {
        wt[3 * kept] = ch;
        wt[3 * kept + 1] = need;
        wt[3 * kept + 2] = row;
        ++kept;
      }
    }
    ps[PS_NWAIT] = kept;
  }
};

// One device's injection ring and its poll, on thread 0 (resident.py
// poll :1404 and tpoll :1458): ring rows install in order through the
// PGAS configurations' install_fixed, or the core's install_descriptor in
// the steal-only one; a row the host marked TEN_EXPIRED is dropped and
// counted. Returns the backlog the poll leaves (the fold's SF_INJ).
template <bool kPgas>
struct Ring {
  const MeshArgs& m;
  const Pgas& P;
  int me;
  int consumed;  // the linear poll's cursor (starts at ictl word 2)
  int expired;   // rows dropped expired (FS_TEN_EXPIRED)

  template <class SS>
  __device__ bool take(SS& S, int slot) const {
    const int32_t* src =
        m.iring + (static_cast<size_t>(me) * m.ring_rows + slot) * inj::ROW;
    if (src[inj::TEN_EXPIRED] != 0) return false;
    int32_t d[DESC];
    for (int w = 0; w < DESC; ++w) d[w] = src[w];
    if constexpr (kPgas)
      P.install_fixed(S, d);
    else
      S.install_descriptor(d);
    return true;
  }

  // The poll. An observed instance (kObs) consumes nothing in a quiescing
  // round (the unread rows are the exported residue; a paused lane is not
  // swept), and records TR_TENANT for a row dropped expired (a lane with
  // work, on a tenant mesh) and TR_INJECT for rows installed; the
  // unobserved instances compile none of it.
  template <bool kObs, class SS>
  __device__ int poll(SS& S, int r, bool quiescing, Obs& O) {
    const bool q = kObs && quiescing;
    const int T = m.ntenants;
    if (T == 0) {
      const int tail = ld_relaxed(m.ictl + 8 * me);  // re-read every round
      const int c0 = consumed, upto = q ? c0 : tail;
      for (int c = c0; c < upto; ++c) {
        if (!take(S, c)) {
          ++expired;
          if constexpr (kObs)
            O.emit(TR_TENANT, O.r,
                   m.iring[(static_cast<size_t>(me) * m.ring_rows + c) *
                               inj::ROW + inj::TEN_ID] << 16,
                   1);
        }
      }
      consumed = max(c0, upto);
      if constexpr (kObs)
        if (consumed > c0) O.emit(TR_INJECT, O.r, consumed - c0, 0);
      return tail - consumed;
    }
    // The weighted round-robin over the lanes from lane r mod T: a lane
    // takes min(weight, avail, headroom()) rows, paused lanes are swept.
    int32_t* tc0 = m.tctl + static_cast<size_t>(me) * T * 8;
    int newly = 0;
    for (int k = 0; k < T; ++k) {
      const int lane = (r + k) % T;
      int32_t* tc = tc0 + lane * 8;
      const int tail = tc[inj::TC_TAIL], cons = tc[inj::TC_CONSUMED];
      const bool paused = tc[inj::TC_PAUSE] != 0;
      const int avail = tail - cons;
      const int n =
          paused || q ? 0 : min(min(tc[inj::TC_WEIGHT], avail), S.headroom());
      int c = cons, inst = 0, exp = 0;
      for (; c < cons + n; ++c) {
        if (take(S, lane * m.region + c))
          ++inst;
        else
          ++exp;
      }
      const bool sweep = paused && !q;
      tc[inj::TC_CONSUMED] = sweep ? tail : c;
      if (sweep) tc[inj::TC_DROPPED] += avail;
      tc[inj::TC_INSTALLED] += inst;
      tc[inj::TC_EXPIRED] += exp;
      expired += exp;
      if constexpr (kObs) {
        if (inst > 0 || exp > 0)
          O.emit(TR_TENANT, O.r, (lane << 16) | inst, exp);
        newly += inst;
      }
    }
    if constexpr (kObs)
      if (newly > 0) O.emit(TR_INJECT, O.r, newly, 0);
    int backlog = 0;
    for (int l = 0; l < T; ++l)
      backlog += tc0[l * 8 + inj::TC_TAIL] - tc0[l * 8 + inj::TC_CONSUMED];
    return backlog;
  }
};

// The fault plan's predicates (resident.py :738-799), pure in (seed, site,
// round r, hop k, granter g), and one device's fault workspace `f`.
struct Faults {
  const int32_t* p;
  int32_t* f;

  __device__ bool hit(int site, int millis, int n, const int32_t* at, int r,
                      int k, int g) const {
    bool h = millis > 0 && fault_mix(p[flt::SEED], site, r, k, g) < millis;
    for (int i = 0; i < n; ++i)
      h |= at[3 * i] == r && at[3 * i + 1] == k && at[3 * i + 2] == g;
    return h;
  }
  __device__ bool drop(int r, int k, int g) const {
    return hit(0, p[flt::DROP], p[flt::NDROP], p + flt::AT, r, k, g);
  }
  __device__ bool dup(int r, int k, int g) const {
    return hit(1, p[flt::DUP], p[flt::NDUP], p + flt::AT + 3 * flt::MAX_AT,
               r, k, g);
  }
  __device__ bool delay(int r, int k, int g) const {
    return hit(2, p[flt::DELAY], 0, p, r, k, g);
  }
  // Is device d the plan's dead chip at round r?
  __device__ bool dead(int d, int r) const {
    return p[flt::DEAD_DEV] == d && r >= p[flt::DEAD_ROUND];
  }
  // With regeneration off, does any credit of round r drop (every device
  // evaluates every pair, so all raise the wedge flag together)?
  __device__ bool wedges(int r, int nh, int ndev) const {
    if (!p[flt::WEDGES]) return false;
    for (int k = 0; k < nh; ++k)
      for (int g = 0; g < ndev; ++g)
        if (drop(r, k, g)) return true;
    return false;
  }

  // Heartbeat detection (resident.py :1836-1870): quarantine a peer whose
  // routed heartbeat has not moved for heartbeat_timeout rounds.
  // An observed instance records each quarantine (TR_FAULT).
  template <bool kObs = false>
  __device__ void detect(int me, int ndev, int r, Obs& O) const {
    for (int q = 0; q < ndev; ++q) {
      const int src = me ^ q, hb = f[flt::HB_ACC + q];
      if (hb != f[flt::HB_SEEN + src]) f[flt::HB_ROUND + src] = r;
      f[flt::HB_SEEN + src] = hb;
      if (src != me && f[flt::DEAD + src] == 0 &&
          r - f[flt::HB_ROUND + src] >= p[flt::HB_TIMEOUT]) {
        f[flt::DEAD + src] = 1;
        f[FS_QMASK] |= 1 << src;
        if (f[FS_DEAD_ROUND] < 0) f[FS_DEAD_ROUND] = r;
        if constexpr (kObs) O.emit(TR_FAULT, O.r, FLT_DEAD_QUARANTINE, src);
      }
    }
  }
};

// The scheduler of the resident kernel's homed configuration (JAX's
// _make_core with tracks_home and complete_hook): spawn and
// take_continuation keep the home links (when `track`), and a completing
// row that carries one (a migrated chain's last task) first forwards its
// result to the home proxy in an RC_COMPLETE message. Bodies and the
// batch tier reach these through their SS template parameter.
struct HomeSched : Sched {
  const Pgas* pg;
  bool track;

  __device__ int spawn(int fn, const int* args, int nargs, int ndecl, int dep,
                       int s0, int s1, int out) {
    return spawn_t<true>(fn, args, nargs, ndecl, dep, s0, s1, out, track);
  }
  __device__ void take_continuation(int idx, int nidx) {
    take_continuation_t<true>(idx, nidx, track);
  }
  __device__ void complete(int idx) {
    if (w(idx, F_HOME) >= 0) {
      const int v[2] = {w(idx, F_HROW), iv[w(idx, F_OUT)]};
      pg->send(*this, w(idx, F_HOME), RC_COMPLETE, v, 2);
    }
    Sched::complete(idx);
  }
};

// The scheduler a resident kernel instance runs: its plain one, or
// (kHome) a HomeSched over the same state.
template <bool kHome>
struct SchedOf {
  __device__ static Sched& of(Sched& s, const Pgas&, bool) { return s; }
};
template <>
struct SchedOf<true> {
  __device__ static HomeSched of(Sched& s, const Pgas& p, bool track) {
    return HomeSched{s, &p, track};
  }
};

// The thread-0 bodies of mk_kernel's lean and lanes instances (fib, sum,
// UTS node; their batch_of forms): the body table of the steal kernels in
// megakernel.cu's library. A user-body library passes its own (user.cuh).
struct BuiltinBodies {
  __device__ BuiltinBodies(const MeshArgs&, const Args&, Pgas*) {}

  template <class SS>
  __device__ void scalar(SS& S, const Args& a, int body, int idx) const {
    switch (body) {
      case B_FIB:
        fib_body(S, a.meta, idx);
        break;
      case B_SUM:
        sum_body(S, idx);
        break;
      case B_UTS:
        uts_body(S, a.meta, idx);
        break;
      default:  // the host refuses tables with other bodies
        break;
    }
  }

  template <class SS>
  __device__ void batch(SS& S, const Args& a, const Round& R) const {
    for (int s = 0; s < R.take; ++s) {
      if (R.body == B_FIB_BATCH)
        fib_body(S, a.meta, R.rows[s]);
      else if (R.body == B_UTS_BATCH)
        uts_body(S, a.meta, R.rows[s]);
    }
  }
};

// One sched(quantum) of a steal kernel's CTA, on thread 0: mk_kernel's
// rounds (schedule(), which pops the ring alone for a table with no lanes)
// with the body table B, spilling the lanes at exit. Observed (kObs), the
// core's records: TR_ROUND_BEGIN, each round's fire records, the spills
// and TR_ROUND_END, the round cursor ticking as in mk_kernel.
template <bool kLanes, bool kObs = false, class B, class SS>
__device__ void mesh_sched(SS& S, const Args& a, Round& R, Obs& O,
                           const B& bodies) {
  const int e0 = S.counts[C_EXECUTED];
  if constexpr (kObs)
    O.emit(TR_ROUND_BEGIN, O.tick(), S.counts[C_TAIL] - S.counts[C_HEAD],
           S.counts[C_PENDING]);
  for (;;) {
    schedule<kObs>(S, a, e0, R, O);
    if (R.act == ACT_EXIT) break;
    if (R.act == ACT_SCALAR) {
      bodies.scalar(S, a, R.body, R.idx);
      S.complete(R.idx);
    } else if constexpr (kLanes) {
      bodies.batch(S, a, R);
      finish_batch<false>(S, a, R, nullptr);
    }
  }
  if constexpr (kLanes) spill<kObs>(S, a, O);
  if constexpr (kObs)
    O.emit(TR_ROUND_END, O.tick(), S.counts[C_EXECUTED] - e0,
           S.counts[C_PENDING]);
}

// An observed CTA's recorder over its slice of the ring buffer (no ring:
// every emit is skipped) with no quiesce poll of the core's own; its
// header at exit.
__device__ __forceinline__ Obs mesh_obs(const MeshArgs& m, int me) {
  Obs O{};
  O.ring = m.ring ? m.ring + static_cast<size_t>(me) * (TR_HDR + 4 * m.tr_cap)
                  : nullptr;
  O.cap = m.tr_cap;
  O.stride = 1;
  O.left = 1;
  return O;
}
__device__ __forceinline__ void mesh_obs_exit(const Obs& O) {
  if (O.ring)
    for (int i = 0; i < TR_HDR; ++i) O.ring[i] = i == 0 ? O.n : i == 1 ? O.r : 0;
}

// ici_steal.py _kernel: sched(quantum); the abort word; the ring
// allreduce of (pending, backlog, abort) in ndev - 1 hops to the right
// neighbour, each credited by it; unless done, one exchange at distance
// d = 2^(r mod nh) mod ndev (onto this CTA's own inbox on a one-device
// ring), its credit to the device that targets this inbox next round.
// kObs: the recorder (the core's records, TR_ABORT, TR_XFER).
template <bool kLanes, class B, bool kObs = false>
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
  if constexpr (kObs) O = mesh_obs(m, me);
  const Mesh X{m, me, 1, s_cand};
  const B bodies(m, a, nullptr);
  const int nh = ndev > 1 ? 32 - __clz(ndev - 1) : 1;
  const int right = (me + 1) % ndev, left = (me + ndev - 1) % ndev;
  int32_t* mine = X.port(me, 0);
  int xs[XS_WORDS] = {0, 0, 0, 0};
  S.stage(a);
  int r = 0;
  bool done = false, ok = true;
  while (!done && r < m.max_rounds) {
    mesh_sched<kLanes, kObs>(S, a, R, O, bodies);
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
    if constexpr (kObs)
      if (tot_a > 0) O.emit(TR_ABORT, O.r, r, 0);
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
      if constexpr (kObs)
        if (nsend > 0) O.emit(TR_XFER, O.r, target, nsend);
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
  if constexpr (kObs) mesh_obs_exit(O);
}

// resident.py _kernel (homed=False): the abort word; sched(quantum);
// (kPgas) drain_outbox; the fold over the XOR hops in hop order, each hop
// a credited stat exchange with me ^ (1 << k) (recursive-doubling sums of
// [0, SX_AM), the all-to-all section routed under kPgas, the partner's
// backlog raw), then (kSteal) the demand-driven steal: rows go only to a
// partner whose backlog is under min(quantum, W), clip((mine - theirs +
// 1) // 2, 0, W) of them, into that hop's inbox with its credit; the exit
// test (the folded pending is 0 and, under kPgas, every outbox is empty
// and sent equals received; or an abort was folded); then (kPgas)
// drain_receives and scan_waits. The mesh exits in lockstep.
// kHome (with kSteal and kPgas): the migrating configuration - the export
// and install of homed copies and of value args, HomeSched's home links
// and completion messages (resident.py with migratable kinds and homed,
// or value args). kInject: after sched(quantum), the ring's poll (Ring);
// its backlog rides the fold's SF_INJ and the mesh exits only at 0.
// kFault (with kSteal, without kInject): the fault layer (Faults) - the
// dead device's fuel 0 and frozen heartbeat, the heartbeats routed after
// the backlog, the faulty row exchange, detection after the fold, the
// wedge flag in SF_WEDGE and the exit; the FS_* words at exit. kObs: the
// recorder and (a checkpoint build) the quiesce word, its hold and its
// settled exit, FS_QUIESCE_ROUND and the exit export.
template <bool kLanes, bool kSteal, bool kPgas, class B, bool kHome = false,
          bool kInject = false, bool kFault = false, bool kObs = false>
__global__ void __launch_bounds__(1) resident_kernel(MeshArgs m) {
  static_assert(!kHome || (kSteal && kPgas), "the migrating configuration");
  static_assert(!kFault || (kSteal && !kInject), "the fault layer");
  __shared__ int32_t s_counts[8];
  __shared__ Round R;
  __shared__ int32_t s_cand[kSteal ? MAX_SCAN : 1];
  const int me = blockIdx.x, W = m.window;
  Args a = mesh_slice(m, me);
  a.fuel = m.quantum;
  a.stage_all_values = 1;
  Sched S0{a.tasks, a.succ, a.ready, s_counts, a.ivalues, a.freestk, a.cap};
  Obs O{};
  if constexpr (kObs) O = mesh_obs(m, me);
  const Mesh X{m, me, max(m.nhops, 1), s_cand};
  Pgas P{m, X, me, 0};
  auto&& S = SchedOf<kHome>::of(
      S0, P, kHome && P.mine(PG_PSTATE)[PS_TRACK] != 0);
  Pgas* pp = nullptr;
  if constexpr (kPgas) pp = &P;
  const B bodies(m, a, pp);
  const int starve_below = min(m.quantum, W);
  const int sbl = kPgas ? m.stat_words - 1 : S_BL;
  const int p_inbox = kPgas || kFault || kObs ? m.p_inbox : P_INBOX;
  // kObs: the quiesce sum's slab word (after the backlog and the
  // heartbeats) and the words a hop sends beside the stat vector.
  const int s_q = sbl + 1 + (kFault ? m.ndev : 0);
  const int ckpt = kObs ? m.ckpt : 0;
  int xs[XS_WORDS] = {0, 0, 0, 0};
  Faults F{};
  if constexpr (kFault) F = Faults{m.fplan, m.fws + me * flt::WS_WORDS};
  Ring<kPgas> I{m, P, me, 0, 0};
  if constexpr (kInject) I.consumed = ld_relaxed(m.ictl + 8 * me + 2);
  S.stage(a);
  int r = 0, abort_round = -1, quiesce_round = -1;
  bool done = false, ok = true, held = false;
  while (!done && r < m.max_rounds) {
    const int local_abort = ld_relaxed(m.abort + 8 * me) != 0;
    // A checkpoint build's quiesce word (abort row words 1-2: flag,
    // threshold round), read with the abort word: every device compares
    // the same round, so the cut is lockstep.
    bool local_q = false;
    if constexpr (kObs) {
      if (ckpt)
        local_q = ld_relaxed(m.abort + 8 * me + 1) != 0 &&
                  r >= ld_relaxed(m.abort + 8 * me + 2);
    }
    const bool quiescing = local_q || held;
    if constexpr (kPgas) P.r = r;
    bool am_dead = false;
    if constexpr (kFault) {
      // The dead device's scheduler runs nothing; its wire stays up.
      am_dead = F.dead(me, r);
      a.fuel = am_dead ? 0 : m.quantum;
    }
    if constexpr (kObs) {
      // The hold: fuel 0 (lanes still spill at the sched exit), the
      // exchange going on.
      a.fuel = am_dead || quiescing ? 0 : m.quantum;
      mesh_sched<kLanes, true>(S, a, R, O, bodies);
    } else {
      mesh_sched<kLanes>(S, a, R, O, bodies);
    }
    if constexpr (kFault) {
      if (!am_dead) F.f[flt::HB] += 1;
      for (int q = 0; q < m.ndev; ++q) F.f[flt::HB_ACC + q] = F.f[flt::HB];
    }
    if constexpr (kPgas) {
      if (X.stopped()) break;  // a body's protocol fault
    }
    int inj_backlog = 0;
    if constexpr (kInject)
      inj_backlog = I.template poll<kObs>(S, r, quiescing, O);
    if constexpr (kPgas) P.drain_outbox();
    int acc[SX_AM] = {s_counts[C_PENDING], 0, 0, 0, inj_backlog, local_abort,
                      0};
    if constexpr (kPgas) P.stat_init(acc);
    if constexpr (kFault) acc[SF_WEDGE] = F.f[flt::WEDGE];
    int acc_q = local_q;  // the folded quiesce sum (kObs)
    for (int h = 0; h < m.nhops && ok; ++h) {
      const int k = m.hops[h], partner = me ^ (1 << k);
      int32_t* mine = X.port(me, k);
      int32_t* theirs = X.port(partner, k);
      ok = r == 0 || X.wait(mine + P_SCRED, r, r, k, W_STAT_CREDIT);
      if (!ok) break;
      for (int i = 0; i < SX_AM; ++i) theirs[P_STAT + i] = acc[i];
      if constexpr (kPgas) P.stat_send(theirs + P_STAT);
      theirs[P_STAT + sbl] = s_counts[C_TAIL] - s_counts[C_HEAD];
      xs[XS_STAT_WORDS] += kPgas ? m.stat_words : STAT_WORDS;
      if constexpr (kFault) {
        for (int q = 0; q < m.ndev; ++q)
          theirs[P_STAT + sbl + 1 + q] = F.f[flt::HB_ACC + q];
        xs[XS_STAT_WORDS] += m.ndev;
      }
      if constexpr (kObs) {
        if (ckpt) {
          theirs[P_STAT + s_q] = acc_q;
          xs[XS_STAT_WORDS] += 1;
        }
      }
      publish(theirs + P_SARR);
      ok = X.wait(mine + P_SARR, r + 1, r, k, W_STAT_ARRIVAL);
      if (!ok) break;
      for (int i = 0; i < SX_AM; ++i)
        acc[i] = wrap_add(acc[i], __ldcg(mine + P_STAT + i));
      if constexpr (kPgas) P.stat_merge(mine + P_STAT, k);
      if constexpr (kFault) {
        // Slot q takes the partner's where bit k of q is set.
        for (int q = 0; q < m.ndev; ++q)
          if ((q >> k) & 1)
            F.f[flt::HB_ACC + q] = __ldcg(mine + P_STAT + sbl + 1 + q);
      }
      if constexpr (kObs) {
        if (ckpt) acc_q += __ldcg(mine + P_STAT + s_q);
      }
      const int peer_b = __ldcg(mine + P_STAT + sbl);
      publish(theirs + P_SCRED);
      if constexpr (kFault) {
        // The faulty row exchange (resident.py :1681-1834). Granters are
        // absolute device ids: my partner grants my channel's credits,
        // I grant its.
        int32_t* f = F.f;
        const int32_t* plan = F.p;
        const int myb = s_counts[C_TAIL] - s_counts[C_HEAD];
        int quota = peer_b < starve_below
                        ? min(max(floor_div(myb - peer_b + 1, 2), 0), W)
                        : 0;
        const bool drop_mine = F.drop(r, k, partner);
        const bool drop_theirs = F.drop(r, k, me);
        const bool delay_me = F.delay(r, k, me);
        if (delay_me) quota = 0;
        if (plan[flt::DEAD_DEV] >= 0) {
          // Quarantine: no rows to a dead partner; the dead device
          // re-homes its backlog whatever the demand.
          if (f[flt::DEAD + partner] != 0) quota = 0;
          if (am_dead) quota = min(max(myb, 0), W);
        }
        // A starvation window (or the wedge) downs the pair's row
        // exchange on this hop, on both sides.
        if (r > f[flt::PAIR_DOWN + k] && f[flt::WEDGE] == 0) {
          f[FS_DELAYED] += delay_me;
          if constexpr (kObs)
            if (delay_me) O.emit(TR_FAULT, O.r, FLT_DELAY, k);
          bool regen = false;
          if (r > 0) {
            if (f[flt::OWED + k] > 0) {  // regeneration: skip one wait
              f[flt::OWED + k] -= 1;
              f[FS_REGEN] += 1;
              regen = true;
            } else {
              ok = X.wait(mine + P_RCRED, f[flt::WAITS + k] + 1, r, k,
                          W_ROW_CREDIT);
              if (!ok) break;
              f[flt::WAITS + k] += 1;
            }
          }
          int32_t* box = theirs + p_inbox;
          int nsend = 0;
          if constexpr (kHome)
            nsend = quota > 0 ? X.export_home(S, a, quota, box,
                                              P.mine(PG_PSTATE))
                              : 0;
          else
            nsend = quota > 0 ? X.export_rows<true>(S, a, quota, box) : 0;
          box[W * DESC] = nsend;
          xs[XS_ROWS] += nsend;
          if (am_dead) f[FS_REHOMED] += nsend;
          if constexpr (kObs) {
            // JAX's order: the transfer, then the skipped wait.
            if (nsend > 0) O.emit(TR_XFER, O.r, partner, nsend);
            if (regen)
              O.emit(TR_CREDIT, O.r, (k << 8) | partner, CR_REGENERATED);
          }
          publish(theirs + P_RARR);
          ok = X.wait(mine + P_RARR, f[flt::XDONE + k] + 1, r, k,
                      W_ROW_ARRIVAL);
          if (!ok) break;
          f[flt::XDONE + k] += 1;
          if constexpr (kHome)
            P.import_fixed(S, mine + p_inbox);
          else
            X.import_rows(S, mine + p_inbox);
          // The credit I owe my partner: dropped, or doubled.
          if (drop_theirs) {
            f[FS_DROPPED] += 1;
            if constexpr (kObs)
              O.emit(TR_CREDIT, O.r, (k << 8) | partner, CR_DROPPED);
          } else {
            publish(theirs + P_RCRED);
            if (F.dup(r, k, me)) {
              publish(theirs + P_RCRED);
              f[FS_DUPED] += 1;
              if constexpr (kObs)
                O.emit(TR_CREDIT, O.r, (k << 8) | partner, CR_DUPED);
            }
          }
          if (drop_mine) {
            f[flt::OWED + k] += 1;
            if (plan[flt::CREDIT_TIMEOUT] == 0 && f[FS_STARVED] == 0)
              f[FS_STARVED] = ((k << 8) | partner) + 1;
          }
          if (plan[flt::CREDIT_TIMEOUT] > 0 && (drop_mine || drop_theirs))
            f[flt::PAIR_DOWN + k] = r + plan[flt::CREDIT_TIMEOUT];
        }
      } else if constexpr (kSteal) {
        const int myb = s_counts[C_TAIL] - s_counts[C_HEAD];
        const int quota =
            peer_b < starve_below
                ? min(max(floor_div(myb - peer_b + 1, 2), 0), W)
                : 0;
        ok = r == 0 || X.wait(mine + P_RCRED, r, r, k, W_ROW_CREDIT);
        if (!ok) break;
        int32_t* box = theirs + p_inbox;
        int nsend = 0;
        if constexpr (kHome)
          nsend = quota > 0 ? X.export_home(S, a, quota, box,
                                            P.mine(PG_PSTATE))
                            : 0;
        else
          nsend = quota > 0 ? X.export_rows<true>(S, a, quota, box) : 0;
        box[W * DESC] = nsend;
        xs[XS_ROWS] += nsend;
        if constexpr (kObs)
          if (nsend > 0) O.emit(TR_XFER, O.r, partner, nsend);
        publish(theirs + P_RARR);
        ok = X.wait(mine + P_RARR, r + 1, r, k, W_ROW_ARRIVAL);
        if (!ok) break;
        if constexpr (kHome)
          P.import_fixed(S, mine + p_inbox);
        else
          X.import_rows(S, mine + p_inbox);
        publish(theirs + P_RCRED);
      }
    }
    if (!ok) break;
    if constexpr (kFault) {
      if (F.p[flt::DEAD_DEV] >= 0) F.detect<kObs>(me, m.ndev, r, O);
    }
    const bool aborted = acc[SF_ABORT] > 0;
    if (aborted && abort_round < 0) {
      abort_round = r;
      if constexpr (kObs) O.emit(TR_ABORT, O.r, r, 0);
    }
    const bool ring_idle = !kInject || acc[SF_INJ] == 0;
    done = (acc[SF_PEND] == 0 && ring_idle) || aborted;
    if constexpr (kPgas) {
      done = (acc[SF_PEND] == 0 && acc[SF_OUTB] == 0 && ring_idle &&
              acc[SF_SENT] == acc[SF_RECV]) ||
             aborted;
    }
    if constexpr (kObs) {
      // The folded quiesce: recorded once, sticky, and the clean-cut exit
      // once nothing is on the wire (the ring residue stays).
      const bool folded = acc_q > 0;
      if (folded && quiesce_round < 0) {
        quiesce_round = r;
        O.emit(TR_QUIESCE, O.r, r, 0);
      }
      held = held || folded;
      done = done ||
             (folded && acc[SF_OUTB] == 0 && acc[SF_SENT] == acc[SF_RECV]);
    }
    if constexpr (kPgas) {
      if (!P.drain_receives(S)) break;
      P.scan_waits(S);
    }
    if constexpr (kFault) {
      // A wedged mesh exits at this fold; a drop anywhere this round,
      // with regeneration off, wedges it for the next.
      done = done || acc[SF_WEDGE] > 0;
      if (F.wedges(r, m.nhops, m.ndev)) F.f[flt::WEDGE] = 1;
    }
    ++r;
  }
  s_counts[C_VBASE] = r;  // C_ROUNDS
  if constexpr (kObs) {
    // The state-export record of a quiesced launch, the recorder's header
    // and the consumed cursor.
    if (held)
      O.emit(TR_CKPT, O.r, s_counts[C_PENDING],
             s_counts[C_TAIL] - s_counts[C_HEAD]);
    mesh_obs_exit(O);
    if constexpr (kInject) m.ictl[8 * me + 2] = I.consumed;
  }
  for (int i = 0; i < 8; ++i) a.counts[i] = s_counts[i];
  if constexpr (kPgas) {
    const int32_t* sent = P.mine(PG_AM_SENT);
    const int32_t* ds = P.mine(PG_DATA_SENT);
    for (int d = 0; d < m.ndev; ++d) {
      xs[XS_AMS] += sent[d];
      for (int c = 0; c < m.nchan; ++c) xs[XS_PUTS] += ds[d * m.nchan + c];
    }
  }
  for (int i = 0; i < XS_WORDS; ++i) m.xstats[me * XS_WORDS + i] = xs[i];
  int32_t* fs = m.fstats + me * FS_WORDS;
  for (int i = 0; i < FS_WORDS; ++i)
    fs[i] = i == FS_DEAD_ROUND || i == FS_QUIESCE_ROUND ? -1
            : i == FS_ABORT_ROUND                       ? abort_round
                                                        : 0;
  if constexpr (kObs) fs[FS_QUIESCE_ROUND] = quiesce_round;
  if constexpr (kInject) fs[FS_TEN_EXPIRED] = I.expired;
  if constexpr (kFault) {
    // FS_DROPPED .. FS_REHOMED and FS_STARVED; FS_ABORT_ROUND is above.
    for (int i = FS_DROPPED; i <= FS_STARVED; ++i)
      if (i != FS_ABORT_ROUND) fs[i] = F.f[i];
    fs[FS_HB] = F.f[flt::HB];
  }
}

// pgas_kernel.py PGASMegakernel._kernel (row 6, a mesh whose size is not
// a power of two), on one card: a round is sched(quantum); the abort word;
// drain_outbox (TR_XFER when any message left); the stat exchange; the
// exit test (the summed pending, outbox backlog and sent minus received
// all 0, or an abort folded: TR_ABORT); then, unconditionally, the
// receive drain and scan_waits. The stat exchange: each device writes its
// slot of this round's parity (RS_*: the five totals, the messages it
// sent each target, the puts it sent each (target, channel)) in its port,
// adds one to device 0's arrival counter (release), waits (acquire) until
// every device of the round did, and reads the five totals of every slot,
// its own column of messages and its own put counts. A device writes
// round r + 2's slot only after every device counted round r + 1, which
// each does after reading round r. The receive drain waits (bounded)
// until each source's put and message counters reach what it announced,
// then sets each channel's count to the total announced, and installs the
// messages source by source, FIFO within a source (JAX's row order).
// kObs: the recorder (the core's records, TR_XFER, TR_ABORT).
constexpr int RS_PEND = 0, RS_RECV = 1, RS_OUTB = 2, RS_ABORT = 3,
              RS_SENT = 4, RS_AM = 5;

template <bool kLanes, class B, bool kObs = false>
__global__ void __launch_bounds__(1) pgas_ring_kernel(MeshArgs m) {
  __shared__ int32_t s_counts[8];
  __shared__ Round R;
  const int me = blockIdx.x, ndev = m.ndev, nchan = m.nchan;
  Args a = mesh_slice(m, me);
  a.fuel = m.quantum;
  a.stage_all_values = 1;
  Sched S{a.tasks, a.succ, a.ready, s_counts, a.ivalues, a.freestk, a.cap};
  Obs O{};
  if constexpr (kObs) O = mesh_obs(m, me);
  const Mesh X{m, me, 1, nullptr};
  Pgas P{m, X, me, 0, true};
  const B bodies(m, a, &P);
  const int sw = m.stat_words, slot_words = (sw + 7) / 8 * 8;
  int32_t* arrivals = X.port(0, 0) + P_SARR;
  int32_t* ps = P.mine(PG_PSTATE);
  int32_t* ob = P.mine(PG_OBCTL);
  int xs[XS_WORDS] = {0, 0, 0, 0};
  S.stage(a);
  int r = 0;
  bool done = false;
  while (!done && r < m.max_rounds) {
    P.r = r;
    mesh_sched<kLanes, kObs>(S, a, R, O, bodies);
    if (X.stopped()) break;  // a body's protocol fault
    const int local_abort = ld_relaxed(m.abort + 8 * me) != 0;
    const int h0 = ob[0];
    P.drain_outbox();
    if constexpr (kObs)
      if (ob[0] > h0) O.emit(TR_XFER, O.r, me, ob[0] - h0);
    const int par = (r & 1) * slot_words;
    int32_t* mine = X.port(me, 0) + P_STAT + par;
    mine[RS_PEND] = s_counts[C_PENDING];
    mine[RS_RECV] = ps[PS_RECV];
    mine[RS_OUTB] = ob[1] - ob[0];
    mine[RS_ABORT] = local_abort;
    mine[RS_SENT] = ps[PS_SENT];
    const int32_t* sent = P.mine(PG_AM_SENT);
    const int32_t* ds = P.mine(PG_DATA_SENT);
    for (int t = 0; t < ndev; ++t) mine[RS_AM + t] = sent[t];
    for (int i = 0; i < ndev * nchan; ++i) mine[RS_AM + ndev + i] = ds[i];
    xs[XS_STAT_WORDS] += sw;
    publish(arrivals);
    if (!X.wait(arrivals, ndev * (r + 1), r, 0, W_STAT_ARRIVAL)) break;
    int tot[RS_AM] = {0, 0, 0, 0, 0};
    for (int s = 0; s < ndev; ++s) {
      const int32_t* sl = X.port(s, 0) + P_STAT + par;
      for (int i = 0; i < RS_AM; ++i) tot[i] = wrap_add(tot[i], __ldcg(sl + i));
    }
    const bool aborted = tot[RS_ABORT] > 0;
    done = (tot[RS_PEND] == 0 && tot[RS_OUTB] == 0 &&
            tot[RS_SENT] == tot[RS_RECV]) ||
           aborted;
    if constexpr (kObs)
      if (aborted) O.emit(TR_ABORT, O.r, r, 0);
    // The receive drain: the puts, channel by channel, then the messages.
    bool ok = true;
    int32_t* recv = P.mine(PG_CHAN_RECV);
    int32_t* ctot = P.mine(PG_CHAN_TOT);
    for (int c = 0; c < nchan && ok; ++c) {
      int total = 0;
      for (int s = 0; s < ndev && ok; ++s) {
        const int e =
            __ldcg(X.port(s, 0) + P_STAT + par + RS_AM + ndev + me * nchan + c);
        if (e > recv[s * nchan + c]) {
          ok = X.wait(P.mine(PG_CHAN_ARR) + s * nchan + c, e, r, s,
                      W_PUT_ARRIVAL);
          recv[s * nchan + c] = e;
        }
        total += e;
      }
      ps[PS_RECV] += total - ctot[c];
      ctot[c] = total;
    }
    if (!ok) break;
    int32_t* arecv = P.mine(PG_AM_RECV);
    const int32_t* inbox = P.mine(PG_INBOX);
    for (int s = 0; s < ndev && ok; ++s) {
      const int e = __ldcg(X.port(s, 0) + P_STAT + par + RS_AM + me);
      const int base = arecv[s];
      if (e <= base) continue;
      ok = X.wait(P.mine(PG_AM_ARR) + s, e, r, s, W_AM_ARRIVAL);
      for (int i = 0; ok && i < e - base; ++i) {
        const int32_t* row = inbox + (s * m.amw + (base + i) % m.amw) * DESC;
        int32_t d[DESC];
        for (int w = 0; w < DESC; ++w) d[w] = __ldcg(row + w);
        S.install_descriptor(d);
      }
      arecv[s] = e;
      ps[PS_RECV] += e - base;
    }
    if (!ok) break;
    P.scan_waits(S);
    ++r;
  }
  s_counts[C_VBASE] = r;  // C_ROUNDS
  if constexpr (kObs) mesh_obs_exit(O);
  for (int i = 0; i < 8; ++i) a.counts[i] = s_counts[i];
  const int32_t* sent = P.mine(PG_AM_SENT);
  const int32_t* ds = P.mine(PG_DATA_SENT);
  for (int d = 0; d < ndev; ++d) {
    xs[XS_AMS] += sent[d];
    for (int c = 0; c < nchan; ++c) xs[XS_PUTS] += ds[d * nchan + c];
  }
  for (int i = 0; i < XS_WORDS; ++i) m.xstats[me * XS_WORDS + i] = xs[i];
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
  long long vfree, s_vfree, pg, s_pg, nchan, amw, outq, maxw, stat_words,
      p_inbox;
  long long chan_buf[MAX_CHANS], chan_rows[MAX_CHANS],
      chan_nrows[MAX_CHANS], chan_row_bytes[MAX_CHANS];
  long long pg_off[PG_SECTIONS];
  long long iring, ictl, tctl, ring_rows, ntenants, region;
  long long fplan, fws;
  long long ring, tr_cap, ckpt;
};

}  // extern "C"

namespace {

// The kernel arguments of host struct h.
MeshArgs mesh_args(const MeshHost* h) {
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
  m.vfree = reinterpret_cast<int32_t*>(h->vfree);
  m.s_vfree = h->s_vfree;
  m.pg = reinterpret_cast<int32_t*>(h->pg);
  m.s_pg = h->s_pg;
  m.nchan = static_cast<int>(h->nchan);
  m.amw = static_cast<int>(h->amw);
  m.outq = static_cast<int>(h->outq);
  m.maxw = static_cast<int>(h->maxw);
  m.stat_words = static_cast<int>(h->stat_words);
  m.p_inbox = static_cast<int>(h->p_inbox);
  for (int i = 0; i < MAX_CHANS; ++i) {
    m.chan_buf[i] = static_cast<int>(h->chan_buf[i]);
    m.chan_rows[i] = static_cast<int>(h->chan_rows[i]);
    m.chan_nrows[i] = static_cast<int>(h->chan_nrows[i]);
    m.chan_row_bytes[i] = h->chan_row_bytes[i];
  }
  for (int i = 0; i < PG_SECTIONS; ++i)
    m.pg_off[i] = static_cast<int>(h->pg_off[i]);
  m.iring = reinterpret_cast<const int32_t*>(h->iring);
  m.ictl = reinterpret_cast<int32_t*>(h->ictl);
  m.tctl = reinterpret_cast<int32_t*>(h->tctl);
  m.ring_rows = static_cast<int>(h->ring_rows);
  m.ntenants = static_cast<int>(h->ntenants);
  m.region = static_cast<int>(h->region);
  m.fplan = reinterpret_cast<const int32_t*>(h->fplan);
  m.fws = reinterpret_cast<int32_t*>(h->fws);
  m.ring = reinterpret_cast<int32_t*>(h->ring);
  m.tr_cap = static_cast<int>(h->tr_cap);
  m.ckpt = static_cast<int>(h->ckpt);
  return m;
}

// The checks every steal-kernel launch makes on its host struct.
bool steal_args_ok(const MeshHost* h) {
  return h->nhops <= MAX_HOPS && h->scan <= MAX_SCAN && h->scan >= 0 &&
         h->window >= 1 && h->ws && h->err && h->xstats && h->fstats &&
         h->nchan >= 0 && h->nchan <= MAX_CHANS;
}

// The checks of an observed launch (`obs`): a recorder ring with a capacity
// or none; and an unobserved launch passes neither a ring nor a quiesce
// word.
bool obs_args_ok(const MeshHost* h, bool obs) {
  if (!obs) return !h->ring && !h->ckpt;
  return (h->ring == 0) == (h->tr_cap == 0) && h->tr_cap >= 0;
}

// The checks of a launch with the fault layer (h->fplan set): its
// workspace, at most 31 devices (the quarantine mask is one word), and a
// stat slab that holds the routed heartbeats after the backlog.
bool fault_args_ok(const MeshHost* h, bool pgas) {
  return h->fws && h->ndev <= 31 &&
         h->p_inbox >= P_STAT + (pgas ? h->stat_words : STAT_WORDS) + h->ndev;
}

// How many CTAs of `kernel` (one thread each) the card holds at once, at
// one an SM at most: the occupancy API's blocks an SM times the SMs,
// capped at the SM count; 0 without cooperative launch.
cudaError_t coresident(void* kernel, int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 1, 0);
  if (e != cudaSuccess) return e;
  *out = !coop ? 0 : per_sm >= 1 ? sms : 0;
  return cudaSuccess;
}

// A cooperative launch of ndev one-thread CTAs of a steal kernel, refused
// past what the card holds at once.
cudaError_t launch_steal(void* kernel, MeshArgs& m, cudaStream_t st) {
  int limit = 0;
  cudaError_t e = coresident(kernel, &limit);
  if (e != cudaSuccess) return e;
  if (m.ndev > limit) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&m};
  e = cudaLaunchCooperativeKernel(kernel, dim3(m.ndev), dim3(1), args, 0, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
