// The persistent scheduler megakernel (CUDA C++, sm_90a), with the task
// bodies of its fixed kernel table.
//
// Replaces hclib_tpu/device/megakernel.py Megakernel._build_raw (:2114,
// pallas_call at :2165) -> _kernel (:1971) -> _make_core (:1111), scalar
// tier: stage / sched / step / complete / push_ready, KernelContext.spawn /
// take_continuation / row_values, and the bodies of its kernel table:
//   fib, sum   <- hclib_tpu/device/workloads.py _fib_kernel (:56),
//                 _sum_kernel (:82)
//   uts_node   <- workloads.py make_uts_megakernel.node (:241)
//   potrf, trsmcol, updrow, trsm <- device/cholesky.py, see tiles.cuh
//
// Design. The TPU runs the scheduler on its scalar core inside one
// pallas_call; here it is ONE block of one launch. Thread 0 runs the serial
// scheduler: it pops the newest ready row (LIFO), publishes the row and
// its body in shared memory, and after a barrier every thread enters the
// switch - the scalar bodies run on thread 0, the tile bodies on the whole
// block - then after a second barrier thread 0 completes the row. The
// serial pop order is what makes executed/allocated and the final task
// table equal the JAX package's word for word, so every order below is the
// JAX one: LIFO pop, spawn's free-stack-first allocation with the clamp on
// overflow, complete()'s succ0, succ1, CSR, pending-1, executed+1,
// tombstone, free-stack push.
//
// Scheduler state (task table, ready ring, counts, value slots, data
// buffers) lives in global memory and is updated IN PLACE: the pointers
// the host passes are the outputs, as JAX aliases its inputs to its
// outputs (megakernel.py:2162). The *_in pointers are the staged inputs;
// they equal the state pointers unless reps > 1. The counts row is held in
// shared memory during a rep and written back at its end.
//
// What bounds it: the scalar scheduler is a chain of dependent loads and
// stores by one thread (each pop, spawn and completion touches a few
// words of the task table in L1/L2), so it is latency-bound, not bound by
// bytes or operations; one SM of the card's 132 does all the work. The
// tile bodies are bound by that one SM's f32 rate (tiles.cuh). Lifting the
// one-block limit is the first thing a later slice does.
//
// Integer semantics follow jnp: int32 arithmetic wraps (done in uint32
// here, since signed overflow is undefined in C++), >> is arithmetic, and
// ring indices use a floor modulo.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

using namespace hc;

constexpr int DESC = 16;
constexpr int F_FN = 0, F_DEP = 1, F_SUCC0 = 2, F_SUCC1 = 3, F_CSR_OFF = 4,
              F_CSR_N = 5, F_A0 = 6, F_OUT = 12;
constexpr int NO_TASK = -1;
constexpr int C_HEAD = 0, C_TAIL = 1, C_ALLOC = 2, C_PENDING = 3,
              C_VALLOC = 4, C_EXECUTED = 5, C_OVERFLOW = 6, C_VBASE = 7;
constexpr int OVF_ROWS = 1;
constexpr int VBLOCK = 4;

// Body ids: hclib_tpu_torch/device/megakernel.py BODIES.
enum { B_FIB, B_SUM, B_UTS, B_POTRF, B_TRSMCOL, B_UPDROW, B_TRSM, NBODY };
// Meta words: static body parameters, then the table maps.
enum { P_SEED, P_QMILLIS, P_MCHILD, P_MAXDEPTH, P_TILE, P_FBASE, P_NT };
constexpr int META_FN_OF_BODY = 8, META_BODY_OF_FN = 16;

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
  int32_t* dispatch;  // per-body dispatch counts
  float* tiles;
  uint16_t* linvsp;
  uint16_t* lsp;
  float* work;  // ts*ts f32 scratch of the tile bodies
  int nfn, cap, num_values, fuel, reps, stage_all_values;
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
      if (dep == 0) push_ready(a);
    } else {
      counts[C_OVERFLOW] |= OVF_ROWS;
    }
    return a;
  }

  __device__ void take_continuation(int idx, int nidx) {
    w(nidx, F_SUCC0) = w(idx, F_SUCC0);
    w(nidx, F_SUCC1) = w(idx, F_SUCC1);
    w(nidx, F_CSR_OFF) = w(idx, F_CSR_OFF);
    w(nidx, F_CSR_N) = w(idx, F_CSR_N);
    w(idx, F_SUCC0) = NO_TASK;
    w(idx, F_SUCC1) = NO_TASK;
    w(idx, F_CSR_N) = 0;
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
  }
};

// workloads.py _fib_kernel: spawn SUM (the continuation), hand it our
// successors, point its args at its own row's value block, then spawn
// FIB(n-1) and FIB(n-2) into that block.
__device__ void fib_body(Sched& S, const int32_t* meta, int idx) {
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
__device__ void uts_body(Sched& S, const int32_t* meta, int idx) {
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

__global__ void __launch_bounds__(BT) mk_kernel(Args a) {
  extern __shared__ float dsm[];
  __shared__ GemmSmem gs;
  __shared__ int32_t s_counts[8];
  __shared__ int s_go, s_idx, s_body;
  const int tid = threadIdx.x;
  Sched S{a.tasks, a.succ, a.ready, s_counts, a.ivalues, a.freestk, a.cap};
  const int32_t* meta = a.meta;
  const int ts = meta[P_TILE], nt = meta[P_NT];
  const size_t tt = static_cast<size_t>(ts) * ts;
  uint32_t total = 0;
  for (int rep = 0; rep < a.reps; ++rep) {
    int e0 = 0;
    if (tid == 0) {
      S.stage(a);
      e0 = s_counts[C_EXECUTED];
    }
    for (;;) {
      if (tid == 0) {
        int go = 0;
        if (s_counts[C_PENDING] > 0 && s_counts[C_EXECUTED] - e0 < a.fuel) {
          const int tail = s_counts[C_TAIL];
          if (s_counts[C_HEAD] < tail) {
            const int idx = a.ready[floor_mod(tail - 1, a.cap)];
            s_counts[C_TAIL] = tail - 1;
            // lax.switch clamps an out-of-range index; so does this.
            const int fn = min(max(S.w(idx, F_FN), 0), a.nfn - 1);
            const int body = meta[META_BODY_OF_FN + fn];
            if (body >= 0 && body < NBODY) a.dispatch[body] += 1;
            s_idx = idx;
            s_body = body;
            go = 1;
          }
        }
        s_go = go;
      }
      __syncthreads();
      if (!s_go) break;
      const int idx = s_idx;
      const int a0 = S.w(idx, F_A0);  // k (potrf, trsmcol), i (updrow, trsm)
      switch (s_body) {
        case B_FIB:
          if (tid == 0) fib_body(S, meta, idx);
          break;
        case B_SUM:
          if (tid == 0) sum_body(S, idx);
          break;
        case B_UTS:
          if (tid == 0) uts_body(S, meta, idx);
          break;
        case B_POTRF:
          potrf_tile(gs, dsm,
                     a.tiles + (static_cast<size_t>(a0) * nt + a0) * tt,
                     a.work, a.linvsp + static_cast<size_t>(a0) * 2 * tt,
                     a.linvsp + (static_cast<size_t>(a0) * 2 + 1) * tt, ts,
                     meta[P_FBASE]);
          break;
        case B_TRSMCOL:
          trsmcol_tile(gs, a.tiles, a.linvsp, a.lsp, a.work, a0, nt, ts);
          break;
        case B_UPDROW:
          updrow_tile(gs, a.tiles, a.lsp, a0, S.w(idx, F_A0 + 1), nt, ts);
          break;
        case B_TRSM:
          trsm_tile(gs, a.tiles, a.linvsp, a.lsp, a.work, a0,
                    S.w(idx, F_A0 + 1), nt, ts);
          break;
        default:
          break;
      }
      __syncthreads();
      if (tid == 0) S.complete(idx);
    }
    if (tid == 0) {
      for (int i = 0; i < 8; ++i) a.counts[i] = s_counts[i];
      total += static_cast<uint32_t>(s_counts[C_EXECUTED]);
    }
    __syncthreads();
  }
  if (tid == 0) a.counts[C_EXECUTED] = static_cast<int32_t>(total);
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
                    const int32_t* meta, int32_t* dispatch, float* tiles,
                    uint16_t* linvsp, uint16_t* lsp, float* work, int nfn,
                    int cap, int num_values, int fuel, int reps,
                    int stage_all_values, int threads, int smem,
                    void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      mk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  Args a{tasks,   tasks_in, succ,  ready,  ready_in, counts,
         counts_in, ivalues, ivalues_in, freestk, meta, dispatch,
         tiles,   linvsp,   lsp,   work,   nfn,      cap,
         num_values, fuel,  reps,  stage_all_values};
  mk_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
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

}  // extern "C"
