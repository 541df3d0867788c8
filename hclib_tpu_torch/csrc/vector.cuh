// The vector (subtree) dispatch tier's engine (CUDA C++, sm_90a), with its
// compiled families vfib and vnqueens. Included by megakernel.cu.
//
// Replaces hclib_tpu/device/vector_engine.py make_subtree_runner (:136):
// step (:170), balance (:214) and run (:265), with fib_spec (:342),
// _popcount (:387) and nqueens_spec (:396), reached from the TPU
// megakernel's lax.switch through _wrap_vector_spec (megakernel.py:771).
//
// What it computes. A (rows, cols) grid of lanes (at most 1024) runs one
// family's subtree in lock-step: each lane a tail-call DFS over its own
// stack of frames, one task a lane a step; when enough lanes starve, one
// steal round by ring rotation lets each starved lane claim level 0 (the
// bottom frame) of the lane the round's rotation pairs it with. JAX's
// engine is deterministic, so this one is held to it word for word at any
// max_steps, not only at completion: the same do-while (one balance, then
// at least one step, then steps while fewer than min_idle lanes starve or
// no lane can donate), the same rotation (dc = 1 + rnd % (cols-1),
// dr = (rnd / (cols-1)) % rows, rot(x)[r][c] = x[r-dr][c-dc], jnp.roll's
// sign), the same stores on an overflowing push (the level clamped to
// S-1).
//
// Design. One block of BT = 256 threads holds the grid: lane l belongs to
// thread l % BT, so a thread holds up to 4 lanes; sp, the top frame (its
// words, child cursor and count) and the per-lane counters stay in
// registers. The levels below the top (S levels x (U + 2) words) do not
// fit shared memory at full width (vfib(30): 34 x 3 x 1024 words = 418
// KB), so they live in a global scratch the wrapper allocates, slots
// [slot][word][lane] so that neighbouring lanes touch neighbouring words,
// each lane's levels a ring over its S slots; only a push (the parent goes
// down) and a pop (the frame below comes up) touch it, and a tail call or
// a leaf that is not its parent's last child stays in registers. A step
// touches only the stepping lane's own stack, so it needs no barrier; the
// loop conditions are block counts (lanes starved, lanes able to donate)
// from one warp-reduce and one barrier a step. A steal round runs in two
// phases around a barrier: every claimant first reads its donor's level 0,
// then donors advance their ring base past it (JAX shifts the whole stack
// down; a ring needs no copy) and claimants take it as their top; the
// rotation is a bijection, so each donor is robbed at most once.
//
// What bounds it on the H100: one SM does all the work, 8 warps of 4
// lanes a thread, so every step is a chain of dependent instructions and
// scratch accesses with little to hide their latency, far from the card's
// integer rate (the bound chip_smoke.py reads from the SASS of
// vfib_step_ops / vnqueens_step_ops below spreads the nodes over all 132
// SMs). Neither the scratch loads nor the stack shifts were the cost
// (moving the top frame to registers and the stacks to rings left vfib(30)
// within 10% on an H100, PERF.md); more warps a lane set, or subtrees
// spread over blocks, is the later speed work.

#pragma once

#include <stdint.h>

namespace hc {

constexpr int VEC_MAX_LANES = 1024;
constexpr int VEC_MAXK = VEC_MAX_LANES / BT;  // lanes a thread holds
constexpr int VEC_WARPS = BT / 32;

struct VecParams {
  int rows, cols, S, min_idle_div, board;
};

struct VecResult {
  int nodes, acc, over, steps;
};

struct VecSmem {
  int sp[VEC_MAX_LANES];       // published for a steal round
  int base[VEC_MAX_LANES];     // (the donor's ring slot of level 0)
  int red[2][VEC_WARPS];       // per-step counts, double-buffered
  unsigned part[3][VEC_WARPS];  // the final sums
};

// fib_spec: frame (n,), children n-1-k, leaves (n < 2) contribute n.
struct VFib {
  static constexpr int U = 1;
  __device__ static void seed(const int* args, int, int (&f)[U], int& c) {
    f[0] = args[0];
    c = args[0] >= 2 ? 2 : 0;
  }
  __device__ static void child(const int (&f)[U], int k, int,
                               int (&cf)[U], int& cc) {
    cf[0] = f[0] - 1 - k;
    cc = cf[0] >= 2 ? 2 : 0;
  }
  __device__ static int contrib(const int (&cf)[U], int cc, int) {
    return cc == 0 ? cf[0] : 0;
  }
  __device__ static int root_contrib(const int* args) { return args[0]; }
};

// nqueens_spec: frame (cols, left-diagonal, right-diagonal) attack masks;
// child k is the k-th set bit of the free columns; a full board
// contributes one solution.
struct VNQueens {
  static constexpr int U = 3;
  __device__ static void seed(const int*, int n, int (&f)[U], int& c) {
    f[0] = f[1] = f[2] = 0;
    c = n;
  }
  __device__ static void child(const int (&f)[U], int k, int n,
                               int (&cf)[U], int& cc) {
    const int full = (1 << n) - 1;
    int free = ~(f[0] | f[1] | f[2]) & full;
    for (int i = 0; i < k && free; ++i) free &= free - 1;
    const int bit = free & -free;  // 0 past the last set bit, as in JAX
    cf[0] = f[0] | bit;
    cf[1] = ((f[1] | bit) << 1) & full;
    cf[2] = (f[2] | bit) >> 1;
    cc = cf[0] == full ? 0 : __popc(~(cf[0] | cf[1] | cf[2]) & full);
  }
  __device__ static int contrib(const int (&cf)[U], int, int n) {
    return cf[0] == (1 << n) - 1;
  }
  __device__ static int root_contrib(const int*) { return 0; }
};

// A lane's state: its stack pointer and its top frame (the frame words,
// the child cursor and count of level sp) in registers; levels 0..sp-1
// live in the stack scratch as a ring, level L at slot (base + L) mod S,
// so a steal of level 0 only advances base.
template <int U>
struct VecLane {
  int sp, ch, cn, base;
  int f[U];
};

// The scratch words of level L of lane l.
template <int U>
__device__ __forceinline__ int32_t* vec_level(int32_t* stk, int nl, int l,
                                              int S, int base, int L) {
  int slot = base + L;
  if (slot >= S) slot -= S;
  return stk + static_cast<size_t>(slot) * (U + 2) * nl + l;
}

template <int U>
__device__ __forceinline__ void vec_load(int32_t* stk, int nl, int l, int S,
                                         VecLane<U>& L) {
  const int32_t* at = vec_level<U>(stk, nl, l, S, L.base, L.sp);
#pragma unroll
  for (int w = 0; w < U; ++w) L.f[w] = at[w * nl];
  L.ch = at[U * nl];
  L.cn = at[(U + 1) * nl];
}

// One lock-step expansion of a lane (JAX's step, for one lane): expand the
// top frame's next child; the last non-leaf child replaces its parent
// (tail call), a leaf or an exhausted frame pops. Only a push (the parent
// goes down to the scratch) and a pop (the frame below comes up) touch
// memory.
template <class F>
__device__ __forceinline__ void vec_step(int32_t* stk, int nl, int l, int S,
                                         int board, VecLane<F::U>& L,
                                         int& over, int& nodes, int& acc) {
  constexpr int U = F::U;
  if (L.sp < 0) return;
  if (L.ch >= L.cn) {  // exhausted: pop
    if (--L.sp >= 0) vec_load(stk, nl, l, S, L);
    return;
  }
  int cf[U], cc;
  F::child(L.f, L.ch, board, cf, cc);
  ++nodes;
  acc = static_cast<int>(static_cast<uint32_t>(acc) +
                         static_cast<uint32_t>(F::contrib(cf, cc, board)));
  const bool last = L.ch + 1 >= L.cn;
  if (cc == 0) {  // a leaf
    if (!last)
      ++L.ch;
    else if (--L.sp >= 0)
      vec_load(stk, nl, l, S, L);
    return;
  }
  if (!last) {  // push the parent, its cursor advanced
    if (L.sp + 1 >= S) {
      over = 1;  // JAX rewrites level S-1 with the child: the parent is lost
    } else {
      int32_t* at = vec_level<U>(stk, nl, l, S, L.base, L.sp);
#pragma unroll
      for (int w = 0; w < U; ++w) at[w * nl] = L.f[w];
      at[U * nl] = L.ch + 1;
      at[(U + 1) * nl] = L.cn;
      ++L.sp;
    }
  }
  // Push or tail call: the child is the new top.
#pragma unroll
  for (int w = 0; w < U; ++w) L.f[w] = cf[w];
  L.ch = 0;
  L.cn = cc;
}

// Block counts of the loop conditions: lanes starved (sp < 0) and lanes
// able to donate (sp >= 1). One barrier; the buffer alternates so a fast
// thread's next write never meets a slow thread's read.
template <int U>
__device__ __forceinline__ void vec_counts(const VecLane<U> (&ln)[VEC_MAXK],
                                           int nl, VecSmem& sm, int& parity,
                                           int& ndone, int& ndonor) {
  unsigned v = 0;
#pragma unroll
  for (int k = 0; k < VEC_MAXK; ++k) {
    if (static_cast<int>(threadIdx.x) + k * BT < nl)
      v += (ln[k].sp < 0 ? 1u : 0u) + (ln[k].sp >= 1 ? 1u << 16 : 0u);
  }
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) sm.red[parity][threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned s = 0;
#pragma unroll
  for (int w = 0; w < VEC_WARPS; ++w) s += sm.red[parity][w];
  parity ^= 1;
  ndone = static_cast<int>(s & 0xffffu);
  ndonor = static_cast<int>(s >> 16);
}

// One steal round (JAX's balance). Phase 1: publish sp and base;
// claimants read their donor's level 0 (in the scratch: a donor's top is
// level >= 1). Phase 2, after a barrier: donors drop level 0 (base moves
// up one slot, the top stays), claimants take the stolen frame as their
// top.
template <int U>
__device__ void vec_balance(int32_t* stk, const VecParams& p, int nl, int rnd,
                            VecLane<U> (&ln)[VEC_MAXK], VecSmem& sm) {
  constexpr int W = U + 2;
  const int rows = p.rows, cols = p.cols;
#pragma unroll
  for (int k = 0; k < VEC_MAXK; ++k) {
    const int l = threadIdx.x + k * BT;
    if (l < nl) {
      sm.sp[l] = ln[k].sp;
      sm.base[l] = ln[k].base;
    }
  }
  __syncthreads();
  const int dc = 1 + rnd % (cols - 1), dr = (rnd / (cols - 1)) % rows;
  bool claim[VEC_MAXK], robbed[VEC_MAXK];
  int took[VEC_MAXK][W];
#pragma unroll
  for (int k = 0; k < VEC_MAXK; ++k) {
    const int l = threadIdx.x + k * BT;
    claim[k] = robbed[k] = false;
    if (l >= nl) continue;
    const int r = l / cols, c = l % cols;
    const int src = ((r - dr + rows) % rows) * cols + (c - dc + cols) % cols;
    const int dst = ((r + dr) % rows) * cols + (c + dc) % cols;
    claim[k] = ln[k].sp < 0 && sm.sp[src] >= 1;
    robbed[k] = ln[k].sp >= 1 && sm.sp[dst] < 0;
    if (claim[k]) {
      const int32_t* at = vec_level<U>(stk, nl, src, p.S, sm.base[src], 0);
#pragma unroll
      for (int w = 0; w < W; ++w) took[k][w] = at[w * nl];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < VEC_MAXK; ++k) {
    if (robbed[k]) {
      if (++ln[k].base == p.S) ln[k].base = 0;
      --ln[k].sp;
    }
    if (claim[k]) {
#pragma unroll
      for (int w = 0; w < U; ++w) ln[k].f[w] = took[k][w];
      ln[k].ch = took[k][U];
      ln[k].cn = took[k][U + 1];
      ln[k].sp = 0;
    }
  }
}

// The whole-subtree run (JAX's run) from one seed frame: every thread of
// the block calls it and gets the same result. nodes counts expanded
// tasks (not the seed); over is any lane's stack overflow or the step
// budget spent.
template <class F>
__device__ __noinline__ VecResult subtree(const VecParams& p,
                                          const int (&seed)[F::U],
                             int seed_count, int max_steps, int32_t* stk,
                             VecSmem& sm) {
  constexpr int U = F::U;
  const int nl = p.rows * p.cols;
  const int min_idle = max(p.cols / 2, nl / p.min_idle_div);
  VecLane<U> ln[VEC_MAXK];
  int over = 0, nodes = 0, acc = 0;
#pragma unroll
  for (int k = 0; k < VEC_MAXK; ++k) {
    ln[k].sp = -1;
    ln[k].base = 0;
  }
  if (threadIdx.x == 0 && seed_count > 0) {  // lane 0 is thread 0's
#pragma unroll
    for (int w = 0; w < U; ++w) ln[0].f[w] = seed[w];
    ln[0].ch = 0;
    ln[0].cn = seed_count;
    ln[0].sp = 0;
  }
  int parity = 0, ndone, ndonor, steps = 0;
  vec_counts(ln, nl, sm, parity, ndone, ndonor);
  for (int rnd = 0; ndone < nl && steps < max_steps; ++rnd) {
    vec_balance(stk, p, nl, rnd, ln, sm);
    do {
#pragma unroll
      for (int k = 0; k < VEC_MAXK; ++k)
        if (static_cast<int>(threadIdx.x) + k * BT < nl)
          vec_step<F>(stk, nl, threadIdx.x + k * BT, p.S, p.board, ln[k],
                      over, nodes, acc);
      ++steps;
      vec_counts(ln, nl, sm, parity, ndone, ndonor);
    } while (ndone < nl && (ndone < min_idle || ndonor == 0) &&
             steps < max_steps);
  }
  unsigned n = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(nodes));
  unsigned a = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(acc));
  unsigned o = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(over));
  if ((threadIdx.x & 31) == 0) {
    sm.part[0][threadIdx.x >> 5] = n;
    sm.part[1][threadIdx.x >> 5] = a;
    sm.part[2][threadIdx.x >> 5] = o;
  }
  __syncthreads();
  n = a = o = 0;
#pragma unroll
  for (int w = 0; w < VEC_WARPS; ++w) {
    n += sm.part[0][w];
    a += sm.part[1][w];
    o |= sm.part[2][w];
  }
  __syncthreads();  // part[] is free for the next run
  return {static_cast<int>(n), static_cast<int>(a),
          static_cast<int>(o != 0 || steps >= max_steps), steps};
}

// The megakernel's body of a vector F_FN (_wrap_vector_spec): seed from
// the 6 arg words, run the subtree, add root_contrib for a leaf seed.
// Every thread of the block calls it; the result is the same on all.
template <class F>
__device__ VecResult vector_seeded(const VecParams& p, const int* args,
                                   int32_t* stk, VecSmem& sm) {
  int f[F::U], c;
  F::seed(args, p.board, f, c);
  VecResult r = subtree<F>(p, f, c, 0x7fffffff, stk, sm);
  if (c == 0)
    r.acc = static_cast<int>(static_cast<uint32_t>(r.acc) +
                             static_cast<uint32_t>(F::root_contrib(args)));
  return r;
}

}  // namespace hc
