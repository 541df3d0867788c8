// The persistent scheduler megakernel (CUDA C++, sm_90a), with the task
// bodies of its fixed kernel table.
//
// Replaces hclib_tpu/device/megakernel.py Megakernel._build_raw (:2114,
// pallas_call at :2165) -> _kernel (:1971) -> _make_core (:1111): the
// scalar tier (stage / sched / step / complete / push_ready,
// KernelContext.spawn / take_continuation / row_values) and the batched
// same-kind dispatch tier (BatchSpec :548, BatchContext :629, pop-time
// routing :1770-1810, the ring-drain-first firing policy :1546-1760,
// batch_round :1394-1492 with the prefetch handshake, the spill at exit
// :1858-1906, the tstats row :2132-2155), and the bodies of its table:
//   fib, sum   <- hclib_tpu/device/workloads.py _fib_kernel (:56),
//                 _sum_kernel (:82)
//   uts_node   <- workloads.py make_uts_megakernel.node (:241)
//   potrf, trsmcol, updrow, trsm <- device/cholesky.py, see tiles.cuh
//   fib_batch, uts_node_batch <- workloads.py batch_of (:86): the scalar
//                 body on each live slot's row, in slot order
//   updrow_batch <- cholesky.py _updrow_batch_kernel (:285)
//   sw_tile    <- device/smithwaterman.py _sw_tile_kernel (:59)
//   sw_wave_batch <- smithwaterman.py _sw_wave_batch_kernel (:234) with
//                 _sw_wave_drain (:398), _chunk_dma (:168), _zero_slot
//                 (:156) and _cummax_lanes (:48)
//   vfib, vnqueens <- the vector tier: megakernel.py _wrap_vector_spec
//                 (:771) over vector_engine.py make_subtree_runner (:136)
//                 with fib_spec (:342) / nqueens_spec (:396), see vector.cuh
//   add_tile   <- workloads.py _addtile_kernel (:515)
//   fa_stencil, fa_map, fa_stencil_batch, fa_map_batch <- the forasync
//                 tier's slab pipeline, forasync_tier.py scalar_kernel
//                 (:267), batch_body (:326), batch_drain (:386), see
//                 forasync.cuh
//   fr_bfs, fr_sssp, fr_pagerank and their _batch forms <- frontier.py
//                 scalar_kernel (:347), batch_body (:407), batch_drain
//                 (:453) and the relax closures, see frontier.cuh
//   bnb_node, bnb_node_batch <- bnb.py _node_kernel (:195), batch_of-shaped
//   dg_update, dg_update_batch, dg_query, dg_query_batch <- dyngraph.py
//                 SpliceKernel (:370-520) and QueryKernel (:523-546); under
//                 the dynamic layout the frontier EXPAND bodies are
//                 DynFrontierKernel's (:279), see frontier.cuh
// and, in the policy instances (kMode 4, 5), the lane-age firing policy
// (megakernel.py :893-909, the starved pass and age clock :1596-1836) and
// the priority-bucket rings (:910-929, :1196-1215, :1622-1799).
// The observed instances (kObs) add the flight recorder and the quiesce
// protocol: hclib_tpu/device/tracebuf.py Tracer.emit (:336), tick (:347),
// now (:353) and reset (:331) at every emit site of _make_core (:1233,
// :1456-1462, :1515, :1535, :1705-1760, :1805, :1846-1910), and
// megakernel.py quiesce_hook (:2019: the qctl poll every quiesce_stride
// rounds, the qstat words, TR_QUIESCE) with TR_CKPT at exit (:2079).
// stream_kernel (stream.cuh, included below mk_kernel) is the streaming
// front door's scheduler over the same core, with its own instances.
// The core itself (Args, Obs, Sched, the fib / sum / uts_node bodies and
// the batch tier's rounds) is csrc/sched.cuh, which the user-body
// libraries (csrc/user.cuh) include as well; the meta layout, one body
// count for every section, is csrc/layout.cuh.
//
// Design. The TPU runs the scheduler on its scalar core inside one
// pallas_call; here it is ONE block of one launch. Thread 0 runs the serial
// scheduler: each round it either fires a batch lane, or pops the newest
// ready row (LIFO) and routes it into its kind's lane or dispatches it.
// Routing rounds need no other thread; a round that runs a body publishes
// the row (or the batch's slot rows) in shared memory, and after a barrier
// every thread enters the switch - the scalar bodies run on thread 0, the
// tile and SW bodies on the whole block - then after a second barrier
// thread 0 completes the row (or slots 0..take-1 in slot order) and updates
// the lane state and tier counters. The serial order is what makes
// executed/allocated, the final task table and the tstats row equal the
// JAX package's word for word, so every order below is the JAX one: LIFO
// ring pops, LIFO lane pops for non-prefetch lanes (the newest take as one
// block, base tail - take) and FIFO for prefetch lanes, ring-drain-first
// firing with the lowest F_FN first, spawn's free-stack-first allocation,
// complete()'s succ0, succ1, CSR order, and the spill of unrun lane entries
// to the ring HEAD (positions head0 - 1 - s, so C_HEAD may go negative).
//
// Scheduler state (task table, ready ring, counts, value slots, data
// buffers, lanes, lane state, tstats) lives in global memory and is updated
// IN PLACE: the pointers the host passes are the outputs, as JAX aliases
// its inputs to its outputs (megakernel.py:2162). The *_in pointers are the
// staged inputs; they equal the state pointers unless reps > 1. The counts
// row is held in shared memory during a rep and written back at its end.
//
// What bounds it: the scheduler is a chain of dependent loads and stores
// by one thread (each pop, routing, spawn and completion touches a few
// words of the task table in L1/L2), so it is latency-bound, not bound by
// bytes or operations; one SM of the card's 132 does all the work. The
// batch tier cuts the barriers a task costs (a round's bodies share two)
// and, for the SW body, spreads a round's tiles over the block's 8 warps.
// The tile bodies are bound by that one SM's f32 rate (tiles.cuh), the SW
// tile DP by its integer and shuffle issue (see sw_tile_dp). Lifting the
// one-block limit is the first thing a later slice does.
//
// Integer semantics follow jnp: int32 arithmetic wraps (done in uint32
// here, since signed overflow is undefined in C++), >> is arithmetic, and
// ring indices use a floor modulo.

#include <cuda_runtime.h>
#include <stdint.h>

#include "forasync.cuh"
#include "frontier.cuh"
#include "tiles.cuh"
#include "vector.cuh"

#include "sched.cuh"

namespace {

using namespace hc;

// ---------------------------------------------------------------------------
// Smith-Waterman tile DP.
//
// One warp computes one 128 x 128 tile; lane l holds columns 4l..4l+3 of
// the current row in registers. Each row is the JAX recurrence
// (smithwaterman.py:115-135): cand = max(diag + sub, up - GAP), the row's
// left boundary entering as an extra candidate at column 0, then
// H = max(0, cummax(cand + j) - j), solved as an in-thread running max
// over the lane's 4 columns plus a __shfl_up_sync max-scan over the 32
// lanes (JAX's _cummax_lanes: 7 roll+max steps over 128 lanes). All of it
// is int32 and exact. Bound: operations - each cell is a handful of
// integer ops, and each row of 4 cells a lane costs 7 shuffles; the SASS
// of sw_row_ops below is what chip_smoke.py reads for the bound.

struct SwData {
  const int32_t* aseq;  // (nt_i, 1, T)
  const int32_t* bseq;  // (nt_j, 1, T)
  int32_t* bot;         // (nt_i, nt_j, 1, T)
  int32_t* right;       // (nt_i, nt_j, 1, T)
  int32_t* htiles;      // (nt_i, nt_j, T, T) or null
  int ntj;

  __device__ size_t tile(int ti, int tj) const {
    return (static_cast<size_t>(ti) * ntj + tj) * SW_T;
  }
};

// One row of the DP for this lane's 4 columns, in place on hp (the row
// above on entry). ai: this row's a character; lft: H[i][-1] (this row's
// left boundary); prev_left: H[i-1][-1] (the corner on row 0).
__device__ __forceinline__ void sw_row(int (&hp)[4], const int (&bc)[4],
                                       int ai, int lft, int prev_left) {
  const int lane = threadIdx.x & 31, j0 = 4 * lane;
  const int up3 = __shfl_up_sync(FULL, hp[3], 1);
  int x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int diag = c ? hp[c - 1] : (lane ? up3 : prev_left);
    int cand = max(diag + (bc[c] == ai ? MATCH : MISMATCH), hp[c] - GAP);
    if (c == 0 && lane == 0) cand = max(cand, lft - GAP);
    x[c] = cand + j0 + c;
  }
  x[1] = max(x[1], x[0]);
  x[2] = max(x[2], x[1]);
  x[3] = max(x[3], x[2]);
  int run = x[3];
#pragma unroll
  for (int sh = 1; sh < 32; sh <<= 1) {
    const int o = __shfl_up_sync(FULL, run, sh);
    if (lane >= sh) run = max(run, o);
  }
  int excl = __shfl_up_sync(FULL, run, 1);
  if (lane == 0) excl = NEG;
#pragma unroll
  for (int c = 0; c < 4; ++c) hp[c] = max(max(x[c], excl) - (j0 + c), 0);
}

// The tile (one warp): a, b its characters, top the row above (null:
// zeros), left the column to its left (null: zeros), corner H of the
// diagonal neighbour's last cell. Writes the last row to bot_out, the last
// column to right_out and, if h_out, every row; returns the tile's max.
__device__ int sw_tile_dp(const int32_t* a, const int32_t* b,
                          const int32_t* top, const int32_t* left, int corner,
                          int32_t* bot_out, int32_t* right_out,
                          int32_t* h_out) {
  const int lane = threadIdx.x & 31, j0 = 4 * lane;
  int bc[4], hp[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    bc[c] = b[j0 + c];
    hp[c] = top ? top[j0 + c] : 0;
  }
  int m = 0, prev_left = corner;
  for (int i = 0; i < SW_T; ++i) {
    const int lft = left ? left[i] : 0;
    sw_row(hp, bc, a[i], lft, prev_left);
    prev_left = lft;
    m = max(m, max(max(hp[0], hp[1]), max(hp[2], hp[3])));
    if (h_out)
      *reinterpret_cast<int4*>(h_out + i * SW_T + j0) =
          make_int4(hp[0], hp[1], hp[2], hp[3]);
    if (lane == 31) right_out[i] = hp[3];
  }
  *reinterpret_cast<int4*>(bot_out + j0) =
      make_int4(hp[0], hp[1], hp[2], hp[3]);
#pragma unroll
  for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
  return m;
}

// sw_tile (scalar body): tile (ti, tj) on warp 0, operands straight from
// global memory. Returns the tile max on lane 0 of warp 0.
__device__ int sw_tile_body(const SwData& d, int ti, int tj) {
  const int32_t* top = ti > 0 ? d.bot + d.tile(ti - 1, tj) : nullptr;
  const int32_t* left = tj > 0 ? d.right + d.tile(ti, tj - 1) : nullptr;
  const int corner =
      ti > 0 && tj > 0 ? d.right[d.tile(ti - 1, tj - 1) + SW_T - 1] : 0;
  return sw_tile_dp(d.aseq + static_cast<size_t>(ti) * SW_T,
                    d.bseq + static_cast<size_t>(tj) * SW_T, top, left,
                    corner, d.bot + d.tile(ti, tj), d.right + d.tile(ti, tj),
                    d.htiles ? d.htiles + d.tile(ti, tj) * SW_T : nullptr);
}

// One operand half of sw_wave_batch in dynamic shared memory: per tile
// slot its a, b, top and left rows and the 16-byte chunk of the diagonal
// neighbour's right column that holds its corner (lane 3 of 4).
struct SwHalf {
  int32_t *a, *b, *top, *left, *corn;
};

__device__ SwHalf sw_half(int32_t* smem, int slots, int h) {
  int32_t* p = smem + static_cast<size_t>(h) * slots * (4 * SW_T + 4);
  return {p, p + slots * SW_T, p + 2 * slots * SW_T, p + 3 * slots * SW_T,
          p + 4 * slots * SW_T};
}

// _chunk_dma's starts: put descriptor b's operand rows (tiles (lo+s,
// w-lo-s), s < cnt) in flight into its slots b*chunk+s of half H, 16 bytes
// a copy spread over the block; rows with no neighbour are zeroed.
__device__ void sw_load_desc(const SwData& d, SwHalf H, int b, int chunk,
                             int w, int lo, int cnt) {
  constexpr int PARTS = 4 * (SW_T / 4) + 1;  // 4 rows of 32 chunks + corner
  cnt = min(cnt, chunk);
  for (int j = threadIdx.x; j < cnt * PARTS; j += blockDim.x) {
    const int s = j / PARTS, r = j % PARTS;
    const int slot = b * chunk + s, ti = lo + s, tj = w - ti;
    int32_t* dst;
    const int32_t* src = nullptr;
    if (r == PARTS - 1) {
      dst = H.corn + slot * 4;
      if (ti > 0 && tj > 0) src = d.right + d.tile(ti - 1, tj - 1) + SW_T - 4;
    } else {
      const int c = (r % (SW_T / 4)) * 4, off = slot * SW_T + c;
      switch (r / (SW_T / 4)) {
        case 0:
          dst = H.a + off;
          src = d.aseq + static_cast<size_t>(ti) * SW_T + c;
          break;
        case 1:
          dst = H.b + off;
          src = d.bseq + static_cast<size_t>(tj) * SW_T + c;
          break;
        case 2:
          dst = H.top + off;
          if (ti > 0) src = d.bot + d.tile(ti - 1, tj) + c;
          break;
        default:
          dst = H.left + off;
          if (tj > 0) src = d.right + d.tile(ti, tj - 1) + c;
          break;
      }
    }
    if (src)
      cp16(dst, src);
    else
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
  }
}

// The 4 arg words of a tile body's slot b: those of task row rows[b].
struct TaskArgs {
  const int32_t* tasks;
  const int* rows;
  __device__ const int32_t* operator()(int b) const {
    return tasks + static_cast<size_t>(rows[b]) * DESC + F_A0;
  }
};

// sw_wave_batch: JAX's phases 1-5 on the card. Phase 1 starts the copies
// of live descriptors the last round's prefetch did not cover; phase 2 puts
// the next batch's copies in flight into the other half (announced by the
// tier as nxt); phase 3 retires all but that newest group; phase 4 sweeps
// the live tiles, one a warp (dead slots, which JAX zeroes and sweeps as
// part of its planes, are skipped); phase 5's stores go straight from the
// warps to global memory, and the tile maxes to s_tmax for thread 0.
__device__ void sw_wave_batch_body(const SwData& d, int32_t* smem,
                                   const Round& R, Sched& S, int chunk,
                                   int* s_tmax) {
  const int slots = R.width * chunk;
  const SwHalf cur = sw_half(smem, slots, R.buf);
  const SwHalf oth = sw_half(smem, slots, 1 - R.buf);
  for (int b = R.pre; b < R.take; ++b) {
    const int row = R.rows[b];
    sw_load_desc(d, cur, b, chunk, S.w(row, F_A0), S.w(row, F_A0 + 1),
                 S.w(row, F_A0 + 2));
  }
  cp_commit();
  for (int b = 0; b < R.nxt; ++b) {
    const int row = R.next_rows[b];
    sw_load_desc(d, oth, b, chunk, S.w(row, F_A0), S.w(row, F_A0 + 1),
                 S.w(row, F_A0 + 2));
  }
  cp_commit();
  cp_wait_but_newest();
  __syncthreads();
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int t = warp; t < R.ntiles; t += nwarps) {
    const int slot = R.tile_slot[t], ti = R.tile_ti[t], tj = R.tile_tj[t];
    const size_t o = static_cast<size_t>(slot) * SW_T;
    const int m = sw_tile_dp(
        cur.a + o, cur.b + o, cur.top + o, cur.left + o, cur.corn[slot * 4 + 3],
        d.bot + d.tile(ti, tj), d.right + d.tile(ti, tj),
        d.htiles ? d.htiles + d.tile(ti, tj) * SW_T : nullptr);
    if ((threadIdx.x & 31) == 0) s_tmax[t] = m;
  }
}

// A vector F_FN's body (_wrap_vector_spec): the whole block runs the
// subtree of its family's engine from the task's 6 arg words; thread 0
// writes the out accumulator to F_OUT, credits the expanded nodes to
// C_EXECUTED and flags OVF_ENGINE on overflow (the scheduler completes
// the task after the barrier that follows).
__device__ void vector_body(Sched& S, const Args& a, int idx, int body,
                            VecSmem& vs) {
  const int fn = min(max(S.w(idx, F_FN), 0), a.nfn - 1);
  const int32_t* vm = a.meta + META_VEC + VEC_WORDS * fn;
  const VecParams p{vm[0], vm[1], vm[2], vm[3], vm[4]};
  int args[6];
  for (int i = 0; i < 6; ++i) args[i] = S.w(idx, F_A0 + i);
  VecResult r;
  if (body == B_VFIB)
    r = vector_seeded<VFib>(p, args, a.vstack, vs);
  else
    r = vector_seeded<VNQueens>(p, args, a.vstack, vs);
  if (threadIdx.x == 0) {
    S.iv[S.w(idx, F_OUT)] = r.acc;
    S.counts[C_EXECUTED] = wrap_add(S.counts[C_EXECUTED], r.nodes);
    if (r.over) S.counts[C_OVERFLOW] |= OVF_ENGINE;
  }
}

// The bucket of a routed descriptor with arg words x under its kind's
// priority rule pm (megakernel.py bucket_of), clipped into [0, nbk).
__device__ int bucket_of(const int32_t* pm, const int32_t* x, int nbk) {
  const int v = x[pm[1]];
  long long b = 0;
  if (pm[0] == PR_DIV) {
    b = floor_div(v, pm[2]);
  } else if (pm[0] == PR_BAND) {
    for (int k = 1; k < BK_MAX; ++k)
      b += static_cast<long long>(v) >= (static_cast<long long>(pm[2]) << k);
  } else if (pm[0] == PR_LINEAR_DESC) {
    b = floor_div(wmul(wsub(pm[2], v), pm[3]), pm[2] + 1);
  } else if (pm[0] == PR_CONST) {
    b = pm[2];
  }
  return static_cast<int>(min(max(b, 0ll), static_cast<long long>(nbk - 1)));
}

// The starved-round clocks after a round (lane_max_age on): a row that
// holds entries and did not fire (fired: the row a batch fired off, or -1)
// ages by one, the others reset; TS_MAX_AGE keeps the largest age.
__device__ void age_clock(const Args& a, int fired) {
  if (a.max_age <= 0 || a.nrows == 0) return;
  int top = a.tstats[TS_MAX_AGE];
  for (int r = 0; r < a.nrows; ++r) {
    int32_t* L = a.lstate + r * LS_WORDS;
    const int age = r == fired || L[LS_TAIL] == L[LS_HEAD] ? 0 : L[LS_AGE] + 1;
    L[LS_AGE] = age;
    top = max(top, age);
  }
  a.tstats[TS_MAX_AGE] = top;
}

// schedule() with JAX's full firing policy (the policy instance): each
// round fires the first starved row (kind by kind, its lowest starved
// bucket; age >= lane_max_age), which jumps a busy ring, else with the
// ring empty the lowest non-empty bucket over all kinds (ties to the lower
// F_FN), else pops the ring; routing pushes a descriptor into its kind's
// bucket ring. Every routing pop is one JAX round: the starved check runs
// before it and the age clock after it (after a batch fire, the clock runs
// once finish_batch has moved the cursors). A quiesced round fires and
// pops nothing, but its age clock still runs, as in JAX.
template <bool kObs>
__device__ void schedule_policy(Sched& S, const Args& a, int e0, Round& R,
                                Obs& O) {
  int32_t* c = S.counts;
  const int nbk = a.nbk;
  for (;;) {
    if (!(c[C_PENDING] > 0 && c[C_EXECUTED] - e0 < a.fuel)) break;
    const int tail = c[C_TAIL];
    const bool ring_work = c[C_HEAD] < tail;
    int rt = 0;
    if constexpr (kObs) {
      rt = O.tick();
      if (O.poll(c[C_EXECUTED] - e0)) {
        age_clock(a, -1);
        break;
      }
    }
    int row = -1;
    bool starved = false;
    if (a.max_age > 0)
      for (int r = 0; r < a.nrows && row < 0; ++r) {
        const int32_t* L = a.lstate + r * LS_WORDS;
        if (L[LS_TAIL] - L[LS_HEAD] > 0 && L[LS_AGE] >= a.max_age) {
          row = r;
          starved = true;
        }
      }
    if (row < 0 && !ring_work)
      for (int bk = 0; bk < nbk && row < 0; ++bk)
        for (int li = 0; li < a.nbatch && row < 0; ++li) {
          const int32_t* L = a.lstate + (li * nbk + bk) * LS_WORDS;
          if (L[LS_TAIL] - L[LS_HEAD] > 0) row = li * nbk + bk;
        }
    if (row >= 0) {
      const int bk = row % nbk;
      if constexpr (kObs) {
        // The fire-reason records, before the round's TR_FIRE_BATCH:
        // take is prepare_batch's min(avail, width).
        const int32_t* L = a.lstate + row * LS_WORDS;
        const int fid = a.meta[META_BATCH + 4 * (row / nbk)];
        const int take = min(L[LS_TAIL] - L[LS_HEAD],
                             a.meta[META_BATCH + 4 * (row / nbk) + 1]);
        if (starved && ring_work)
          O.emit(TR_FIRE_AGE, rt, (fid << 16) | take, L[LS_AGE]);
        if (nbk > 1) O.emit(TR_FIRE_BUCKET, rt, (bk << 16) | take, fid);
      }
      if (starved && ring_work) a.tstats[TS_AGE_FIRES] += 1;
      if (starved && nbk > 1)
        for (int r = 0; r < a.nrows; ++r) {
          const int32_t* L = a.lstate + r * LS_WORDS;
          if (r % nbk < bk && L[LS_TAIL] - L[LS_HEAD] > 0) {
            a.tstats[TS_INVERSIONS] += 1;
            break;
          }
        }
      if (bk > 0) a.tstats[TS_BUCKET_FIRES] += 1;
      prepare_batch<true, kObs>(S, a, row, e0, R, rt, O);
      return;
    }
    if (!ring_work) break;  // neither ring nor lane work: stuck (or done)
    const int idx = a.ready[floor_mod(tail - 1, a.cap)];
    c[C_TAIL] = tail - 1;
    const int fn = S.w(idx, F_FN);
    bool routed = false;
    for (int li = 0; li < a.nbatch && !routed; ++li) {
      if (fn == a.meta[META_BATCH + 4 * li]) {
        const int r =
            li * nbk + (nbk > 1 ? bucket_of(a.meta + META_PRIO + PRIO_WORDS * li,
                                            &S.w(idx, F_A0), nbk)
                                : 0);
        int32_t* L = a.lstate + r * LS_WORDS;
        const int lt = L[LS_TAIL];
        a.lanes[static_cast<size_t>(r) * a.cap + floor_mod(lt, a.cap)] = idx;
        L[LS_TAIL] = lt + 1;
        a.tstats[TS_ROUTED] += 1;
        routed = true;
      }
    }
    age_clock(a, -1);
    if (routed) continue;
    if constexpr (kObs) O.emit(TR_FIRE_SCALAR, rt, fn, idx);
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

// The graph of a frontier or dynamic-graph table: its buffers and the
// layout parameters.
__device__ __forceinline__ FrGraph fr_graph(const int32_t* meta, void* idx,
                                            void* wgt) {
  return {static_cast<int32_t*>(idx), static_cast<int32_t*>(wgt),
          meta[P_STBASE],   meta[P_NBLOCKS],  meta[P_REPS],
          meta[P_SPARE_BASE], meta[P_SPARE], meta[P_BCS_BASE],
          meta[P_FLAG_BASE]};
}

// kMode picks the instance. 0 (lean): a table with no batch lane, no SW
// and no vector body (the scalar tier with the fib, UTS and Cholesky
// bodies); its instance leaves the lane, spill and SW code out of the
// loop: with that code in, the card ran fib(24) 2.0% and UTS depth 20
// 4.3% slower a task, though no scalar round enters it (same-card A/B on
// an H100, scripts/ab_sched.py). 1: lanes and SW. 2: those and the
// vector engine, kept out of the other two for the same reason. 3: lanes
// and the tile bodies (forasync.cuh), out of 0-2 for that reason too. 4:
// lanes with the lane-age and priority-bucket policies (schedule_policy)
// and the frontier and knapsack bodies (frontier.cuh), so that 0-3
// compile what they compiled before the policies existed. 5: 4 under the
// dynamic-graph layout (the UPDATE and QUERY bodies, the clamped and
// spare-aware EXPAND), kept out of 4: with it in, a static scalar EXPAND
// cost 12% more (SSSP on bench.py --graph's graph at width 0, 22.30 ->
// 24.97 ms, same-card A/B on an H100, scripts/ab_sched.py).
// kObs adds the flight recorder and the quiesce poll to any of them: a
// launch with neither a ring nor qctl runs the kObs = false instance,
// whose code is what it was before the recorder existed.
// The body is csrc/mk_body.cuh, included here and in mesh.cuh's
// mk_grid_kernel (one block a mesh device): text included in place keeps
// this kernel's code, and so its registers and frame, what it was.
template <int kMode, bool kObs>
__global__ void __launch_bounds__(BT) mk_kernel(Args a) {
#include "mk_body.cuh"
}

// Standalone entries: one tile body, one block, same device functions.
__global__ void __launch_bounds__(BT)
    potrf_entry(float* tiles, uint16_t* linvsp, float* work, int k, int nt,
                int ts, int nb) {
  extern __shared__ float dsm[];
  __shared__ GemmSmem gs;
  const size_t tt = static_cast<size_t>(ts) * ts;
  potrf_tile(gs, dsm, tiles + (static_cast<size_t>(k) * nt + k) * tt, work,
             linvsp + static_cast<size_t>(k) * 2 * tt,
             linvsp + (static_cast<size_t>(k) * 2 + 1) * tt, ts, nb);
}

__global__ void __launch_bounds__(BT)
    trsmcol_entry(float* tiles, const uint16_t* linvsp, uint16_t* lsp,
                  float* work, int k, int nt, int ts) {
  __shared__ GemmSmem gs;
  trsmcol_tile(gs, tiles, linvsp, lsp, work, k, nt, ts);
}

__global__ void __launch_bounds__(BT)
    trsm_entry(float* tiles, const uint16_t* linvsp, uint16_t* lsp,
               float* work, int i, int k, int nt, int ts) {
  __shared__ GemmSmem gs;
  trsm_tile(gs, tiles, linvsp, lsp, work, i, k, nt, ts);
}

__global__ void __launch_bounds__(BT)
    updrow_entry(float* tiles, const uint16_t* lsp, int i, int k, int nt,
                 int ts) {
  __shared__ GemmSmem gs;
  updrow_tile(gs, tiles, lsp, i, k, nt, ts);
}

// Standalone run of the subtree engine (JAX's make_subtree_runner with
// max_steps): out = nodes, acc, over, steps.
__global__ void __launch_bounds__(BT)
    vector_entry(int family, VecParams p, int s0, int s1, int s2,
                 int seed_count, int max_steps, int32_t* stk, int32_t* out) {
  __shared__ VecSmem vs;
  VecResult r;
  if (family == 0) {
    const int f[1] = {s0};
    r = subtree<VFib>(p, f, seed_count, max_steps, stk, vs);
  } else {
    const int f[3] = {s0, s1, s2};
    r = subtree<VNQueens>(p, f, seed_count, max_steps, stk, vs);
  }
  if (threadIdx.x == 0) {
    out[0] = r.nodes;
    out[1] = r.acc;
    out[2] = r.over;
    out[3] = r.steps;
  }
}

// For the bound (never launched; chip_smoke.py reads their SASS): one
// lane step of a family, one lane a thread, its state loaded from and
// stored back to st, against the same loads and stores of the lane state
// and of one stack level (a step pushes or pops at most one) with no step
// between.
constexpr int VEC_STATE = 9;  // sp, ch, cn, 3 frame words, nodes, acc, base

template <class F>
__device__ void step_ops(int32_t* stk, int32_t* st, int S, int board) {
  constexpr int U = F::U;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int nl = gridDim.x * blockDim.x;
  int32_t* s = st + static_cast<size_t>(l) * VEC_STATE;
  VecLane<U> L{s[0], s[1], s[2], s[8]};
#pragma unroll
  for (int w = 0; w < U; ++w) L.f[w] = s[3 + w];
  int over = 0, nodes = s[6], acc = s[7];
  vec_step<F>(stk, nl, l, S, board, L, over, nodes, acc);
  s[0] = L.sp | over;
  s[1] = L.ch;
  s[2] = L.cn;
#pragma unroll
  for (int w = 0; w < U; ++w) s[3 + w] = L.f[w];
  s[6] = nodes;
  s[7] = acc;
  s[8] = L.base;
}

template <class F>
__device__ void step_copy_ops(int32_t* stk, int32_t* st) {
  constexpr int U = F::U, W = U + 2;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int nl = gridDim.x * blockDim.x;
  int32_t* s = st + static_cast<size_t>(l) * VEC_STATE;
  int v[3 + U + 3];
#pragma unroll
  for (int i = 0; i < 3 + U; ++i) v[i] = s[i];
  v[3 + U] = s[6];
  v[4 + U] = s[7];
  v[5 + U] = s[8];
  int32_t* at = stk + static_cast<size_t>(v[0] + v[5 + U]) * W * nl + l;
  int w[W];
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = at[i * nl];
#pragma unroll
  for (int i = 0; i < W; ++i) at[i * nl] = w[i] ^ v[1];
#pragma unroll
  for (int i = 0; i < 3 + U; ++i) s[i] = v[i] ^ w[0];
  s[6] = v[3 + U];
  s[7] = v[4 + U];
  s[8] = v[5 + U];
}

// Standalone run of a tile body (forasync.cuh), without the scheduler:
// tiles [0, n) of the (n, 4) arg words, in rounds of `width` slots in
// order, with the FIFO prefetch protocol when `prefetch` (the next
// round's tiles loaded into the other half under this round's compute);
// width 1 without prefetch is the scalar body, one tile a round.
struct ListArgs {
  const int32_t* args;
  int first;
  __device__ const int32_t* operator()(int b) const {
    return args + 4 * (first + b);
  }
};

struct DataPtrs {
  void* p[MAX_DATA];
};

__global__ void __launch_bounds__(BT)
    tile_entry(const int32_t* meta, DataPtrs data, const int32_t* args,
               int n, int width, int prefetch, int op) {
  extern __shared__ __align__(16) float dsm[];
  int32_t* smem = reinterpret_cast<int32_t*>(dsm);
  int pre = 0, buf = 0;
  for (int first = 0; first < n;) {
    const int take = min(width, n - first);
    const int nxt = prefetch ? min(width, n - first - take) : 0;
    tile_round(op, meta, data.p, smem, width, take, pre, buf, nxt,
               ListArgs{args, first}, ListArgs{args, first + take});
    __syncthreads();
    first += take;
    pre = nxt;
    if (prefetch) buf = 1 - buf;
  }
  cp_wait_all();
}

struct UpdRows {
  int v[2 * MAX_WIDTH];  // (i, k) of each slot
};

__global__ void __launch_bounds__(BT)
    updrow_batch_entry(float* tiles, const uint16_t* lsp, UpdRows rows, int n,
                       int nt, int ts) {
  __shared__ GemmSmem gs;
  for (int s = 0; s < n; ++s)
    updrow_tile(gs, tiles, lsp, rows.v[2 * s], rows.v[2 * s + 1], nt, ts);
}

// Standalone run of a static frontier table's EXPAND body, without the
// scheduler (a dynamic-graph table is refused by the caller): the
// descriptors at task rows rows[0, n) of a state, in rounds of `width`
// slots in order with the prefetch protocol when `prefetch` (width 0: the
// scalar body, one row a round). Relaxes write the value slots; spawns go
// to the ready ring (and the task table) and are not run.
struct FrEntry {
  int32_t* tasks;
  int32_t* ready;
  int32_t* counts;
  int32_t* iv;
  int32_t* freestk;
  const int32_t* meta;
  const int32_t* rows;
  void* idx;
  void* wgt;
  int n, width, prefetch, cap;
};

__global__ void __launch_bounds__(BT) fr_entry(FrEntry e) {
  extern __shared__ __align__(16) float dsm[];
  __shared__ int32_t s_counts[8];
  int32_t* smem = reinterpret_cast<int32_t*>(dsm);
  Sched S{e.tasks, nullptr, e.ready, s_counts, e.iv, e.freestk, e.cap};
  if (threadIdx.x < 8) s_counts[threadIdx.x] = e.counts[threadIdx.x];
  __syncthreads();
  const FrGraph g = fr_graph(e.meta, e.idx, e.wgt);
  const int fam = e.meta[META_BODY_OF_FN] - B_FR_BFS;
  if (e.width == 0) {
    for (int i = 0; i < e.n; ++i) {
      fr_expand<false>(S, fam, g, smem, e.tasks, e.rows + i);
      __syncthreads();
    }
  } else {
    int pre = 0, buf = 0;
    for (int first = 0; first < e.n;) {
      const int take = min(e.width, e.n - first);
      const int nxt = e.prefetch ? min(e.width, e.n - first - take) : 0;
      fr_expand_round<false>(S, fam, g, smem, e.tasks, e.width, take, pre,
                             buf, nxt, e.rows + first, e.rows + first + take);
      __syncthreads();
      first += take;
      pre = nxt;
      if (e.prefetch) buf = 1 - buf;
    }
  }
  cp_wait_all();
  __syncthreads();
  if (threadIdx.x < 8) e.counts[threadIdx.x] = s_counts[threadIdx.x];
}

}  // namespace

// The streaming front door's stream_kernel instances, over the same Sched,
// Obs and bodies (their launch entry is hclib_stream_launch below).
#include "stream.cuh"
// The mesh kernels (the ring and the resident kernel, over the built-in
// thread-0 bodies) and the grid launch of the sharded runner.
#include "mesh.cuh"

namespace {

// sharded.py's per-device entry: block b runs mk_kernel's body on mesh
// device b's slice (no recorder, no quiesce poll).
template <int kMode>
__global__ void __launch_bounds__(BT) mk_grid_kernel(MeshArgs mesh) {
  constexpr bool kObs = false;
  const Args a = mesh_slice(mesh, blockIdx.x);
#include "mk_body.cuh"
}

// The steal kernels' instance bits: 1 lanes, 2 the fault layer (the
// resident kernel), 4 observed (the recorder and the quiesce word).
template <int kMode>
void* resident_of() {
  return reinterpret_cast<void*>(
      resident_kernel<(kMode & 1) != 0, true, false, BuiltinBodies, false,
                      false, (kMode & 2) != 0, (kMode & 4) != 0>);
}

void* mesh_kernel_of(int kind, int mode) {
  switch (kind) {
    case 0:
      return mode ? reinterpret_cast<void*>(mk_grid_kernel<1>)
                  : reinterpret_cast<void*>(mk_grid_kernel<0>);
    case 1:
      switch (mode) {
        case 0:
          return reinterpret_cast<void*>(
              ici_ring_kernel<false, BuiltinBodies>);
        case 1:
          return reinterpret_cast<void*>(ici_ring_kernel<true, BuiltinBodies>);
        case 4:
          return reinterpret_cast<void*>(
              ici_ring_kernel<false, BuiltinBodies, true>);
        default:
          return reinterpret_cast<void*>(
              ici_ring_kernel<true, BuiltinBodies, true>);
      }
    default: {
      static void* const resident[8] = {
          resident_of<0>(), resident_of<1>(), resident_of<2>(),
          resident_of<3>(), resident_of<4>(), resident_of<5>(),
          resident_of<6>(), resident_of<7>()};
      return resident[mode];
    }
  }
}

// A mesh instance `mode` of kernel `kind` this library holds.
bool mesh_mode_ok(int kind, int mode) {
  switch (kind) {
    case 0:
      return mode == 0 || mode == 1;
    case 1:
      return mode == 0 || mode == 1 || mode == 4 || mode == 5;
    case 2:
      return mode >= 0 && mode <= 7;
    default:
      return false;
  }
}

}  // namespace

extern "C" {

const char* hclib_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every launch returns cudaGetLastError() (0 = launched).
int hclib_mk_launch(int32_t* tasks, const int32_t* tasks_in,
                    const int32_t* succ, int32_t* ready,
                    const int32_t* ready_in, int32_t* counts,
                    const int32_t* counts_in, int32_t* ivalues,
                    const int32_t* ivalues_in, int32_t* freestk,
                    const int32_t* meta, int32_t* dispatch,
                    void* const* data, float* work, int32_t* lanes,
                    int32_t* lstate, int32_t* tstats, int32_t* vstack,
                    int32_t* ring, const int32_t* qctl, int32_t* qstat,
                    int tr_cap, int qstride, int nfn, int nbatch, int nrows,
                    int nbk, int max_age, int cap, int num_values, int fuel,
                    int reps, int stage_all_values, int mode, int threads,
                    int smem, void* stream) {
  if (mode < 0 || mode > 5 || (mode < 4 && (nbk != 1 || max_age != 0)) ||
      (ring && tr_cap < 1) || (qctl && !qstat))
    return cudaErrorInvalidValue;
  using K = void (*)(Args);
  static const K plain[6] = {mk_kernel<0, false>, mk_kernel<1, false>,
                             mk_kernel<2, false>, mk_kernel<3, false>,
                             mk_kernel<4, false>, mk_kernel<5, false>};
  static const K observed[6] = {mk_kernel<0, true>, mk_kernel<1, true>,
                                mk_kernel<2, true>, mk_kernel<3, true>,
                                mk_kernel<4, true>, mk_kernel<5, true>};
  const K kernel = ring || qctl ? observed[mode] : plain[mode];
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  Args a{};
  a.tasks = tasks;
  a.tasks_in = tasks_in;
  a.succ = succ;
  a.ready = ready;
  a.ready_in = ready_in;
  a.counts = counts;
  a.counts_in = counts_in;
  a.ivalues = ivalues;
  a.ivalues_in = ivalues_in;
  a.freestk = freestk;
  a.meta = meta;
  a.dispatch = dispatch;
  for (int i = 0; i < MAX_DATA; ++i) a.data[i] = data[i];
  a.work = work;
  a.lanes = lanes;
  a.lstate = lstate;
  a.tstats = tstats;
  a.vstack = vstack;
  a.ring = ring;
  a.qctl = qctl;
  a.qstat = qstat;
  a.tr_cap = tr_cap;
  a.qstride = qstride;
  a.nfn = nfn;
  a.nbatch = nbatch;
  a.nrows = nrows;
  a.nbk = nbk;
  a.max_age = max_age;
  a.cap = cap;
  a.num_values = num_values;
  a.fuel = fuel;
  a.reps = reps;
  a.stage_all_values = stage_all_values;
  kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

int hclib_potrf_launch(float* tiles, uint16_t* linvsp, float* work, int k,
                       int nt, int ts, int nb, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      potrf_entry, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  potrf_entry<<<1, BT, smem, static_cast<cudaStream_t>(stream)>>>(
      tiles, linvsp, work, k, nt, ts, nb);
  return cudaGetLastError();
}

int hclib_trsmcol_launch(float* tiles, const uint16_t* linvsp, uint16_t* lsp,
                         float* work, int k, int nt, int ts, void* stream) {
  trsmcol_entry<<<1, BT, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, linvsp, lsp, work, k, nt, ts);
  return cudaGetLastError();
}

int hclib_trsm_launch(float* tiles, const uint16_t* linvsp, uint16_t* lsp,
                      float* work, int i, int k, int nt, int ts,
                      void* stream) {
  trsm_entry<<<1, BT, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, linvsp, lsp, work, i, k, nt, ts);
  return cudaGetLastError();
}

int hclib_updrow_launch(float* tiles, const uint16_t* lsp, int i, int k,
                        int nt, int ts, void* stream) {
  updrow_entry<<<1, BT, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, lsp, i, k, nt, ts);
  return cudaGetLastError();
}

// rows: n (i, k) pairs, n <= MAX_WIDTH.
int hclib_updrow_batch_launch(float* tiles, const uint16_t* lsp,
                              const int* rows, int n, int nt, int ts,
                              void* stream) {
  if (n < 1 || n > MAX_WIDTH) return cudaErrorInvalidValue;
  UpdRows r{};
  for (int i = 0; i < 2 * n; ++i) r.v[i] = rows[i];
  updrow_batch_entry<<<1, BT, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, lsp, r, n, nt, ts);
  return cudaGetLastError();
}

// op: 0 add, 1 stencil, 2 map (forasync.cuh TILE_*); meta holds the
// table's slab words; data its buffers; args (n, 4) tile arg words.
int hclib_tile_launch(const int32_t* meta, void* const* data,
                      const int32_t* args, int n, int width, int prefetch,
                      int op, int smem, void* stream) {
  if (n < 1 || width < 1 || width > MAX_WIDTH || op < 0 || op > 2)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tile_entry, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  DataPtrs d{};
  for (int i = 0; i < MAX_DATA; ++i) d.p[i] = data[i];
  tile_entry<<<1, BT, smem, static_cast<cudaStream_t>(stream)>>>(
      meta, d, args, n, width, prefetch, op);
  return cudaGetLastError();
}

// A frontier table's EXPAND body over task rows rows[0, n) (fr_entry);
// data: the table's buffers (indices[, weights]).
int hclib_fr_launch(int32_t* tasks, int32_t* ready, int32_t* counts,
                    int32_t* ivalues, int32_t* freestk, const int32_t* meta,
                    void* const* data, const int32_t* rows, int n, int width,
                    int prefetch, int cap, int smem, int threads,
                    void* stream) {
  if (n < 1 || width < 0 || width > MAX_WIDTH || threads < 32 ||
      threads > BT)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fr_entry, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const FrEntry fe{tasks, ready, counts, ivalues, freestk, meta, rows,
                   data[0], data[1], n, width, prefetch, cap};
  fr_entry<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(fe);
  return cudaGetLastError();
}

// family: 0 vfib, 1 vnqueens (vector_engine.py VECTOR_BODIES).
int hclib_vector_launch(int family, int rows, int cols, int S,
                        int min_idle_div, int board, int s0, int s1, int s2,
                        int seed_count, int max_steps, int32_t* stk,
                        int32_t* out, void* stream) {
  if (family < 0 || family > 1 || rows < 1 || cols < 2 ||
      rows * cols > VEC_MAX_LANES || S < 1 || min_idle_div < 1)
    return cudaErrorInvalidValue;
  const VecParams p{rows, cols, S, min_idle_div, board};
  vector_entry<<<1, BT, 0, static_cast<cudaStream_t>(stream)>>>(
      family, p, s0, s1, s2, seed_count, max_steps, stk, out);
  return cudaGetLastError();
}

__global__ void vfib_step_ops(int32_t* stk, int32_t* st, int S, int board) {
  step_ops<VFib>(stk, st, S, board);
}
__global__ void vfib_copy_ops(int32_t* stk, int32_t* st) {
  step_copy_ops<VFib>(stk, st);
}
__global__ void vnqueens_step_ops(int32_t* stk, int32_t* st, int S,
                                  int board) {
  step_ops<VNQueens>(stk, st, S, board);
}
__global__ void vnqueens_copy_ops(int32_t* stk, int32_t* st) {
  step_copy_ops<VNQueens>(stk, st);
}

// Never launched: read from the built library's SASS by chip_smoke.py for
// the SW bound. Both load and store the same words; the first computes
// one DP row of a lane's 4 cells (sw_row, as sw_tile_dp does), the second
// a few XORs, so the difference of their instruction counts is one row of
// 4 cells as this compiler issues it.
__global__ void sw_row_ops(const int4* __restrict__ in,
                           int4* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int4 h = in[3 * t], b = in[3 * t + 1], s = in[3 * t + 2];
  int hp[4] = {h.x, h.y, h.z, h.w};
  const int bc[4] = {b.x, b.y, b.z, b.w};
  sw_row(hp, bc, s.x, s.y, s.z);
  out[t] = make_int4(hp[0], hp[1], hp[2], hp[3]);
}

__global__ void sw_row_copy_ops(const int4* __restrict__ in,
                                int4* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int4 h = in[3 * t], b = in[3 * t + 1], s = in[3 * t + 2];
  out[t] = make_int4(h.x ^ b.x ^ s.x, h.y ^ b.y ^ s.y, h.z ^ b.z ^ s.z,
                     h.w ^ b.w);
}

// One entry of the stream (device/inject.py _launch_cuda). The state
// pointers are updated in place (tasks_in == tasks and so on: staging
// copies nothing and rebuilds the free stack). Returns
// cudaGetLastError() (0 = launched).
int hclib_stream_launch(int32_t* tasks, const int32_t* succ, int32_t* ready,
                        int32_t* counts, int32_t* ivalues, int32_t* freestk,
                        const int32_t* meta, int32_t* dispatch,
                        void* const* data, int32_t* trace,
                        const int32_t* ring, const int32_t* ctl_in,
                        int32_t* ctl_out, int32_t* tctl, int32_t* egr,
                        int32_t* park, int32_t* ectl, int32_t* etok,
                        int32_t* tele, int32_t* tlat, int tr_cap, int nfn,
                        int cap, int num_values, int T, int region,
                        int depth, int telemetry, int quantum, int max_rounds,
                        int ckpt, int mode, int threads, int smem,
                        void* stream) {
  if ((mode != 0 && mode != 4 && mode != 5) || (trace && tr_cap < 1) ||
      (telemetry && depth < 1) || (T > 0 && region < 1) || T < 0 ||
      depth < 0 || quantum < 1)
    return cudaErrorInvalidValue;
  using K = void (*)(Args, StreamArgs);
  static const K plain[6] = {stream_kernel<0, false>, nullptr, nullptr,
                             nullptr, stream_kernel<4, false>,
                             stream_kernel<5, false>};
  static const K observed[6] = {stream_kernel<0, true>, nullptr, nullptr,
                                nullptr, stream_kernel<4, true>,
                                stream_kernel<5, true>};
  const K kernel = trace ? observed[mode] : plain[mode];
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  Args a{};
  a.tasks = tasks;
  a.tasks_in = tasks;
  a.succ = succ;
  a.ready = ready;
  a.ready_in = ready;
  a.counts = counts;
  a.counts_in = counts;
  a.ivalues = ivalues;
  a.ivalues_in = ivalues;
  a.freestk = freestk;
  a.meta = meta;
  a.dispatch = dispatch;
  for (int i = 0; i < MAX_DATA; ++i) a.data[i] = data[i];
  a.ring = trace;
  a.tr_cap = tr_cap;
  a.qstride = 1;
  a.nfn = nfn;
  a.nbk = 1;
  a.cap = cap;
  a.num_values = num_values;
  a.fuel = quantum;
  a.reps = 1;
  a.stage_all_values = 1;
  StreamArgs s{ring, ctl_in, ctl_out, tctl, egr, park, ectl, etok, tele,
               tlat, T, region, depth, telemetry, quantum, max_rounds, ckpt};
  kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(a, s);
  return cudaGetLastError();
}

// The most CTAs of a steal kernel (kind 1 ring, 2 resident steal-only;
// mode 0 lean, 1 lanes, and for the resident kernel 2 and 3 the same with
// the fault layer) the card holds at once, at one CTA an SM at most.
// Returns a CUDA error, the count in *out.
int hclib_mesh_coresident(int kind, int mode, int* out) {
  if (!mesh_mode_ok(kind, mode)) return cudaErrorInvalidValue;
  return coresident(mesh_kernel_of(kind, mode), out);
}

// kind 0: mk_grid_kernel (an ordinary launch of ndev blocks of `threads`);
// 1: ici_ring_kernel, 2: the resident kernel's steal-only configuration
// (cooperative launches of ndev one-thread CTAs, refused past
// hclib_mesh_coresident). mode: bit 0 lanes; bit 1 the resident kernel's
// fault layer, which wants h->fplan and h->fws; bit 2 the observed
// instance of the ring or the resident kernel (h->ring and h->tr_cap, and
// h->ckpt for the resident kernel's quiesce word). Returns
// cudaGetLastError() (0 = launched).
int hclib_mesh_launch(const MeshHost* h, int kind, int mode, int threads,
                      int smem, void* stream) {
  const bool fault = (mode & 2) != 0, obs = (mode & 4) != 0;
  if (!mesh_mode_ok(kind, mode) || h->ndev < 1 ||
      (kind > 0 && !steal_args_ok(h)) || (kind > 0 && h->nchan != 0) ||
      (h->fplan != 0) != fault || (fault && !fault_args_ok(h, false)) ||
      !obs_args_ok(h, obs) || (kind == 1 && h->ckpt) ||
      (obs && h->ckpt && h->p_inbox < P_STAT + STAT_WORDS + 1 +
                                          (fault ? h->ndev : 0)))
    return cudaErrorInvalidValue;
  MeshArgs m = mesh_args(h);
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
  return launch_steal(kernel, m, st);
}

}  // extern "C"
