// The graph-frontier EXPAND bodies and the branch-and-bound NODE body of
// the scheduler megakernel (CUDA C++, sm_90a), as device functions for one
// block. Included by megakernel.cu; they run in its policy instances
// (kMode 4, and 5 for the dynamic-graph tables), beside the lane-age and
// priority-bucket scheduler.
//
// Replaces hclib_tpu/device/frontier.py FrontierKernel.scalar_kernel
// (:347), _relax_block (:322), batch_body (:407), batch_drain (:453),
// _slot_loads (:388), _spawn_blocks (:236) and the relax closures of
// bfs_kernel (:472), sssp_kernel (:494) and pagerank_kernel (:597);
// hclib_tpu/device/bnb.py _node_kernel (:195); and the dynamic-graph
// kinds of hclib_tpu/device/dyngraph.py: SpliceKernel._splice (:399) with
// scalar_kernel (:508) and batch_body (:512), QueryKernel (:523-546), and
// DynFrontierKernel (:279) with _eff_cnt (:291) and _dyn_spawn (:306).
//
// What it computes. EXPAND(v, blk, carry, cnt) adds cnt to the traversed-
// edge counter V_EDGES, then relaxes the first cnt edges of block row blk
// of the blocked CSR (indices, and weights for SSSP: (nblocks, 128) int32)
// in edge order against the per-vertex state in the value slots:
//   BFS       nd = carry + 1; if nd < state[u]: state[u] = nd, V_RELAX++,
//             spawn u's blocks with nd
//   SSSP      the same with nd = carry + w
//   PageRank  qc = (13 q / 16) / max(deg u, 1); expand iff q >= reps,
//             qc > 0, deg u > 0; state[u] += expand ? q - deg*qc : q;
//             V_RELAX++; if expand: spawn u's blocks with qc
// A vertex's blocks are spawned one EXPAND each, cnt = clip(deg - 128 i,
// 0, 128), from its 3-word vertex-table entry (block start, count, deg).
// NODE(level, value, weight, bound) prunes against the incumbent V_BEST,
// folds a leaf into it (monotone max), or spawns the skip child and, if
// it fits, the take child, bound = value + suffix[level + 1].
// Under the dynamic-graph layout (kDyn, the table's `dyn` parameter) an
// EXPAND relaxes min(cnt, the edges the vertex table shows live in blk)
// and a vertex's blocks are its static rows bs .. bs + min(bc, bcs) - 1,
// then its spare rows spare_base + u * spare + j (bcs: its static block
// count). UPDATE(u, v, w, uid) appends v to u's chain once per uid: lane
// pos of the tail row, or, with the tail full, the next spare row written
// whole (v, then -1s; weights w, then 0s); with no spare ordinal left it
// drops, bumps V_DROPPED and flags the engine overflow. Then the vertex
// table, the applied flag, V_FREE and V_UPDATES fold, and (BFS, SSSP) the
// new edge relaxes with u's current label. QUERY(v) counts V_QUERIES and
// writes state[v] to the descriptor's out slot.
// int32 arithmetic wraps as jnp's does (done in uint32), and divisions
// floor.
//
// Design. A block row is 512 bytes, a whole (128,) int32 row, so it is
// always 16-byte aligned: the block copies it (and its weight row) into
// shared memory with 16-byte cp.async, one copy a thread, then waits and
// synchronises. The relax itself stays serial on thread 0, in edge order
// and slot order: each relax may read the state the one before it wrote
// (targets need not be distinct, and slot b of a round sees the writes of
// slots < b, as JAX's phase 4 does), and the spawn order fixes the task
// rows the scheduler allocates, which the port keeps equal to JAX's word
// for word. The batched round is JAX's phases 1-4 on cp.async commit
// groups, as forasync.cuh's tile_round runs them: (1) live slots the last
// round's prefetch did not cover go in flight into operand half buf, (2)
// the next batch's first nxt slots into the other half, (3)
// cp.async.wait_group 1 and a barrier, (4) thread 0 relaxes slot by slot.
// The drain is the megakernel's cp.async.wait_all before the spill.
//
// What bounds it: bytes on paper (each traversed edge's index, and weight,
// read once, its state word read once, 136 bytes a descriptor), but a
// relax is a dependent load of state[u] by one thread (L2 latency), and
// each EXPAND a serial chain of those: latency-bound on one SM. Loading
// the slab block-wide before the serial loop keeps the edge reads out of
// that chain; a warp-wide test of nd < state[u] over distinct targets is
// the next step.
//
// The splice is serial on thread 0 too: a read of the vertex's four
// ledger words and its flag, then direct global stores (one word a
// buffer, or the fresh row as 32 16-byte stores a buffer) and the folds.
// Bytes bound it on paper (136 B a descriptor, 20 B read, 4-8 B or 0.5-1
// KB written); its chain of dependent loads bounds it in fact. Slot b of
// a batched round runs after slots < b, so same-vertex splices of one
// round serialize in slot order as JAX's do, and a splice's stores precede
// the barrier that ends its round, so the next round's copies see them.
// The dynamic layout is a template parameter (megakernel.cu's instance
// 5): the static tables run the loops they ran before.
#pragma once

#include <stdint.h>

#include "layout.cuh"  // floor_div

namespace hc {

// hclib_tpu_torch/device/frontier.py EBLOCK, V_*, VT_BASE, PR_*;
// bnb.py V_*, BB_TAB; megakernel.py DESC_WORDS / F_A0.
constexpr int EBLOCK = 128;
constexpr int V_EDGES = 0, V_RELAX = 1, VT_BASE = 8;
constexpr uint32_t PR_NUM = 13;
constexpr int PR_DEN = 16;
constexpr int V_BEST = 0, V_PRUNED = 1, V_LEAVES = 2, BB_TAB = 8;
// dyngraph.py V_*.
constexpr int V_UPDATES = 2, V_FREE = 3, V_DROPPED = 4, V_QUERIES = 5;
constexpr int FR_DESC = 16, FR_A0 = 6, FR_OUT = 12;
enum { FR_BFS, FR_SSSP, FR_PAGERANK };

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// The graph a table traverses: the block rows (weights null unless the
// table holds them; the splices write both) and the layout parameters
// (megakernel.py PARAMS; the last four only under the dynamic layout).
struct FrGraph {
  int32_t* idx;
  int32_t* wgt;
  int st_base, nblocks, reps, spare_base, spare, bcs_base, flag_base;
};

// Put block row blk (and its weight row) of descriptor b in flight into
// slot b of a half: rows of 2 x 128 int32 (index row, weight row) a slot,
// 32 16-byte copies a row, spread over the block. The block index is
// clamped into the table, as a DMA slice start is.
__device__ __forceinline__ void fr_load(int32_t* half, const FrGraph& g,
                                        const int32_t* tasks, const int* rows,
                                        int first, int count) {
  const int rw = g.wgt ? 2 : 1;
  for (int j = threadIdx.x; j < count * rw * 32; j += blockDim.x) {
    const int b = first + j / (rw * 32), r = (j / 32) % rw, c = 4 * (j % 32);
    const int blk =
        min(max(tasks[static_cast<size_t>(rows[b]) * FR_DESC + FR_A0 + 1], 0),
            g.nblocks - 1);
    const int32_t* src = (r ? g.wgt : g.idx) + static_cast<size_t>(blk) *
                                                   EBLOCK + c;
    cp16(half + (b * 2 + r) * EBLOCK + c, src);
  }
}

// _spawn_blocks: one EXPAND (F_FN 0) per block of u, carrying carry; under
// the dynamic layout _dyn_spawn's two ranges, static rows then spares.
template <bool kDyn, class S>
__device__ void fr_spawn_blocks(S& s, const FrGraph& g, int u, int carry) {
  const int vt = VT_BASE + 3 * u;
  const int bs = s.iv[vt], bc = s.iv[vt + 1], deg = s.iv[vt + 2];
  const int bcs = kDyn ? s.iv[g.bcs_base + u] : bc;
  const int ns = min(bc, bcs);
  for (int i = 0; i < ns; ++i) {
    const int args[4] = {u, bs + i, carry,
                         min(max(deg - i * EBLOCK, 0), EBLOCK)};
    s.spawn(0, args, 4, 4, 0, -1, -1, 0);
  }
  if constexpr (kDyn) {
    const int row0 = wadd(g.spare_base, wmul(u, g.spare));
    for (int j = 0; j < bc - ns; ++j) {
      const int args[4] = {
          u, wadd(row0, j), carry,
          min(max(wsub(deg, wmul(wadd(bcs, j), EBLOCK)), 0), EBLOCK)};
      s.spawn(0, args, 4, 4, 0, -1, -1, 0);
    }
  }
}

// One relax (the relax closures): edge to u of weight w, carrying carry.
template <bool kDyn, class S>
__device__ __forceinline__ void fr_relax_one(S& s, int fam, const FrGraph& g,
                                             int u, int w, int carry) {
  int32_t* iv = s.iv;
  const int st = g.st_base + u;
  if (fam == FR_PAGERANK) {
    const int q = carry, deg = iv[VT_BASE + 3 * u + 2];
    const int qc = floor_div(floor_div(wmul(q, PR_NUM), PR_DEN), max(deg, 1));
    const bool expand = q >= g.reps && qc > 0 && deg > 0;
    iv[st] = wadd(iv[st], expand ? wsub(q, wmul(deg, qc)) : q);
    iv[V_RELAX] = wadd(iv[V_RELAX], 1);
    if (expand) fr_spawn_blocks<kDyn>(s, g, u, qc);
  } else {
    const int nd = wadd(carry, fam == FR_SSSP ? w : 1);
    if (nd < iv[st]) {
      iv[st] = nd;
      iv[V_RELAX] = wadd(iv[V_RELAX], 1);
      fr_spawn_blocks<kDyn>(s, g, u, nd);
    }
  }
}

// DynFrontierKernel._eff_cnt: cnt clamped to the live edges of block blk
// of v (a spare row's ordinal continues after the static block count).
template <class S>
__device__ int fr_eff_cnt(S& s, const FrGraph& g, int v, int blk, int cnt) {
  const int32_t* iv = s.iv;
  const int vt = VT_BASE + 3 * v;
  const int ordinal =
      blk >= g.spare_base
          ? wadd(iv[g.bcs_base + v],
                 wsub(wsub(blk, g.spare_base), wmul(v, g.spare)))
          : wsub(blk, iv[vt]);
  return min(cnt, min(max(wsub(iv[vt + 2], wmul(ordinal, EBLOCK)), 0),
                      EBLOCK));
}

// _relax_block on thread 0 for the descriptor whose arg words are a: the
// slot's index row ri (weight row rw).
template <bool kDyn, class S>
__device__ void fr_relax(S& s, int fam, const FrGraph& g, const int32_t* ri,
                         const int32_t* rw, const int32_t* a) {
  int32_t* iv = s.iv;
  const int carry = a[2];
  const int cnt = kDyn ? fr_eff_cnt(s, g, a[0], a[1], a[3]) : a[3];
  iv[V_EDGES] = wadd(iv[V_EDGES], cnt);
  const int n = min(max(cnt, 0), EBLOCK);
  for (int e = 0; e < n; ++e)
    fr_relax_one<kDyn>(s, fam, g, ri[e], fam == FR_SSSP ? rw[e] : 0, carry);
}

// The scalar EXPAND (FrontierKernel.scalar_kernel), the whole block: load
// the row, wait, then thread 0 relaxes. smem holds one slot.
template <bool kDyn, class S>
__device__ void fr_expand(S& s, int fam, const FrGraph& g, int32_t* smem,
                          const int32_t* tasks, const int* row) {
  fr_load(smem, g, tasks, row, 0, 1);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  if (threadIdx.x == 0)
    fr_relax<kDyn>(s, fam, g, smem, smem + EBLOCK,
                   tasks + static_cast<size_t>(*row) * FR_DESC + FR_A0);
}

// One batched round (batch_body): slots [0, take) of rows, of which the
// first pre were prefetched into half buf by the round before; the next
// batch's first nxt rows go in flight into the other half. smem holds two
// halves of width slots.
template <bool kDyn, class S>
__device__ void fr_expand_round(S& s, int fam, const FrGraph& g,
                                int32_t* smem, const int32_t* tasks,
                                int width, int take, int pre, int buf, int nxt,
                                const int* rows, const int* next_rows) {
  int32_t* cur = smem + static_cast<size_t>(buf) * width * 2 * EBLOCK;
  int32_t* oth = smem + static_cast<size_t>(1 - buf) * width * 2 * EBLOCK;
  fr_load(cur, g, tasks, rows, pre, take - pre);
  cp_commit();
  fr_load(oth, g, tasks, next_rows, 0, nxt);
  cp_commit();
  cp_wait_but_newest();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int b = 0; b < take; ++b)
      fr_relax<kDyn>(s, fam, g, cur + 2 * b * EBLOCK,
                     cur + (2 * b + 1) * EBLOCK,
                     tasks + static_cast<size_t>(rows[b]) * FR_DESC + FR_A0);
}

// A block row of the table (a DMA's row index is clamped into it).
__device__ __forceinline__ size_t fr_row(const FrGraph& g, int blk) {
  return static_cast<size_t>(min(max(blk, 0), g.nblocks - 1)) * EBLOCK;
}

// SpliceKernel._splice on thread 0 for UPDATE(u, v, w, uid) with arg words
// a, in a table whose traversal family is fam.
template <class S>
__device__ void dg_splice(S& s, int fam, const FrGraph& g, const int32_t* a) {
  int32_t* iv = s.iv;
  const int u = a[0], v = a[1], w = a[2], uid = a[3];
  const int vt = VT_BASE + 3 * u;
  const int bs = iv[vt], bc = iv[vt + 1], deg = iv[vt + 2];
  const int bcs = iv[g.bcs_base + u];
  if (iv[g.flag_base + uid] != 0) return;  // this uid is applied
  const bool need_new = deg == wmul(bc, EBLOCK);  // tail full, or no block
  const int used = wsub(bc, bcs);                  // spare ordinals in use
  if (need_new && used >= g.spare) {
    s.flag_overflow();
    iv[V_DROPPED] = wadd(iv[V_DROPPED], 1);
    return;
  }
  const int nb = wadd(wadd(g.spare_base, wmul(u, g.spare)), used);
  if (need_new) {
    // The fresh spare row, whole: the append cursor owns it.
    int4* ri = reinterpret_cast<int4*>(g.idx + fr_row(g, nb));
    ri[0] = make_int4(v, -1, -1, -1);
    for (int c = 1; c < EBLOCK / 4; ++c) ri[c] = make_int4(-1, -1, -1, -1);
    if (g.wgt) {
      int4* rw = reinterpret_cast<int4*>(g.wgt + fr_row(g, nb));
      rw[0] = make_int4(w, 0, 0, 0);
      for (int c = 1; c < EBLOCK / 4; ++c) rw[c] = make_int4(0, 0, 0, 0);
    }
  } else {
    // Lane pos of the tail: the static tail while it has slack, else the
    // newest spare ordinal.
    const size_t r = fr_row(g, bc <= bcs ? wsub(wadd(bs, bc), 1) : wsub(nb, 1));
    const int pos = wsub(deg, wmul(max(bc - 1, 0), EBLOCK));
    if (pos >= 0 && pos < EBLOCK) {
      g.idx[r + pos] = v;
      if (g.wgt) g.wgt[r + pos] = w;
    }
  }
  iv[vt + 1] = need_new ? bc + 1 : bc;
  iv[vt + 2] = wadd(deg, 1);
  iv[g.flag_base + uid] = 1;
  iv[V_FREE] = wadd(iv[V_FREE], need_new ? 1 : 0);
  iv[V_UPDATES] = wadd(iv[V_UPDATES], 1);
  if (fam != FR_PAGERANK)
    fr_relax_one<true>(s, fam, g, v, w, iv[g.st_base + u]);
}

// QueryKernel._query on thread 0 for the descriptor at desc: the label of
// v = arg 0 to the out slot.
template <class S>
__device__ void dg_query(S& s, const FrGraph& g, const int32_t* desc) {
  int32_t* iv = s.iv;
  iv[V_QUERIES] = wadd(iv[V_QUERIES], 1);
  iv[desc[FR_OUT]] = iv[g.st_base + desc[FR_A0]];
}

// bnb.py _node_kernel on thread 0 for the row whose arg words are a; n
// items, capacity cap.
template <class S>
__device__ void bnb_node(S& s, const int32_t* a, int n, int cap) {
  int32_t* iv = s.iv;
  const int level = a[0], value = a[1], weight = a[2], bound = a[3];
  const int best = iv[V_BEST];
  if (!(bound > best)) {
    iv[V_PRUNED] = wadd(iv[V_PRUNED], 1);
  } else if (level == n) {
    iv[V_BEST] = max(best, value);
    iv[V_LEAVES] = wadd(iv[V_LEAVES], 1);
  } else if (level < n) {
    const int v0 = BB_TAB + n + 1;
    const int sfx = iv[BB_TAB + 1 + level];
    const int vi = iv[v0 + level], wi = iv[v0 + n + level];
    const int skip[4] = {level + 1, value, weight, wadd(value, sfx)};
    s.spawn(0, skip, 4, 4, 0, -1, -1, 0);
    if (wadd(weight, wi) <= cap) {
      const int take[4] = {level + 1, wadd(value, vi), wadd(weight, wi),
                           wadd(wadd(value, vi), sfx)};
      s.spawn(0, take, 4, 4, 0, -1, -1, 0);
    }
  }
}

}  // namespace hc
