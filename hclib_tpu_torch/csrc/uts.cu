// The fused UTS tree-search engine (CUDA C++, sm_90a): every lane runs
// its own depth-first traversal of seeded subtrees, all in one launch.
//
// Replaces hclib_tpu/device/uts_pallas.py _uts_dfs_pallas (:208, its
// pallas_call at :227) -> _dfs_kernel (:126), with the shared traversal
// loop and step of hclib_tpu/device/uts_vec.py (make_traversal,
// make_dfs_step) and the TPU workarounds it needs: _mm_cumsum (:64, a
// prefix sum by triangular matmuls), _row_select (:83) and
// _monotone_gather (:107) (the claim gather) and the 1024-aligned
// root-window DMA (:153-172). None of those is carried over: they exist
// because a TPU core runs its lanes in lockstep and Mosaic gathers only
// in-row.
//
// Design. One thread is one lane (lanes = (rows, 128) as in the JAX
// engine, launched as rows*128 threads). Each thread runs its own DFS with
// the JAX engine's tail-call scheduling (a frame expanding its last
// non-leaf child is replaced by that child; a last leaf child pops at
// once), so every iteration expands exactly one node. Its stack (5 SHA-1
// state words, next child, child count and depth a level) lives in local
// memory, the top frame in registers. A thread whose stack is empty takes
// the next subtree root with one atomicAdd on a global counter: roots are
// claimed in the host's LPT order, as the JAX engine's flat prefix-sum
// claim does, but a thread never waits for others. Leaf children are
// counted without a push. Child counts are exact: #(t_k <= r) by binary
// search over the host's integer thresholds, held in shared memory - one
// row for FIXED (0 at depth >= gen_mx), or the padded per-depth table
// (LINEAR, CYCLIC, EXPDEC; 0 beyond the table). Per lane it writes
// nodes, leaves, max depth and its expansion count; the host sums them in
// int64.
//
// Not lockstep: a lane's step count is its own expansions, which equal
// its nodes, and the engine's ``steps`` is the largest of them - not the
// JAX engine's lockstep step count.
//
// What bounds it: integer operations. Each node is one SHA-1 compression
// (80 rounds and the message schedule, with the constant message words
// folded), a ~7-step binary search and a few words of stack traffic, all
// in registers and L1. Its floor on the card is the SHA-1 alone, as the
// built SASS issues it (uts_sha1_ops below): an SM issues 128 thread
// operations a clock, of which 64 on the ALU pipe (LOP3, SHF, IADD3,
// compares) and 64 IMADs on the FMA pipe, so the bound is nodes x the
// largest of ALU ops / 64, IMAD ops / 64 and all ops / 128 SM clocks,
// over 132 SMs (chip_smoke.py counts the SASS and states the bound). The
// design keeps every lane busy to the end of the queue (atomic claims
// instead of lockstep refill rounds) and reads device memory only to
// claim a root; the tail is one subtree.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

struct UtsArgs {
  const uint32_t* roots_state;  // (5, P): root r's word i at [i * P + r]
  const int32_t* roots_count;   // (P,)
  const int32_t* tab;           // (rows, cols) thresholds, -1 padded
  const int32_t* tab_len;       // (rows,) valid thresholds of each row
  int32_t* nodes;               // per lane
  int32_t* leaves;
  int32_t* maxd;
  int32_t* steps;
  int32_t* ctl;  // [0] next root, [1] unfinished, [2] stack overflow
  int P, R, d0, gen_mx, rows, cols, fixed, stack_size, nlanes, max_steps;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) {
  return __funnelshift_l(x, x, s);
}

// SHA1(parent(20 B) || BE32(child)): one padded 24-byte block.
__device__ __forceinline__ void sha1_child(const uint32_t s[5], uint32_t c,
                                           uint32_t out[5]) {
  uint32_t w[16] = {s[0], s[1], s[2], s[3], s[4], c, 0x80000000u,
                    0,    0,    0,    0,    0,    0,  0,           0, 192};
  uint32_t a = 0x67452301u, b = 0xEFCDAB89u, cc = 0x98BADCFEu,
           d = 0x10325476u, e = 0xC3D2E1F0u;
#pragma unroll
  for (int i = 0; i < 80; ++i) {
    if (i >= 16)
      w[i & 15] = rotl(w[(i - 3) & 15] ^ w[(i - 8) & 15] ^ w[(i - 14) & 15] ^
                           w[i & 15],
                       1);
    uint32_t f, k;
    if (i < 20) {
      f = d ^ (b & (cc ^ d));
      k = 0x5A827999u;
    } else if (i < 40) {
      f = b ^ cc ^ d;
      k = 0x6ED9EBA1u;
    } else if (i < 60) {
      f = (b & cc) | (d & (b | cc));
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ cc ^ d;
      k = 0xCA62C1D6u;
    }
    const uint32_t t = rotl(a, 5) + f + e + k + w[i & 15];
    e = d;
    d = cc;
    cc = rotl(b, 30);
    b = a;
    a = t;
  }
  out[0] = a + 0x67452301u;
  out[1] = b + 0xEFCDAB89u;
  out[2] = cc + 0x98BADCFEu;
  out[3] = d + 0x10325476u;
  out[4] = e + 0xC3D2E1F0u;
}

// #(t <= r) over the sorted valid prefix of a threshold row.
__device__ __forceinline__ int count_le(const int32_t* t, int n, int r) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (t[lo + half] <= r) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

template <int SMAX>
__global__ void __launch_bounds__(BLOCK) uts_kernel(UtsArgs a) {
  extern __shared__ int32_t sm[];  // tab (rows * cols), then tab_len (rows)
  int32_t* stab = sm;
  int32_t* slen = sm + a.rows * a.cols;
  for (int e = threadIdx.x; e < a.rows * a.cols; e += blockDim.x)
    stab[e] = a.tab[e];
  for (int e = threadIdx.x; e < a.rows; e += blockDim.x) slen[e] = a.tab_len[e];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.nlanes) return;

  uint32_t stk[SMAX][8];  // saved frames below the top: 5 words, ch, cn, dp
  int sp = -1;            // level of the top frame; -1 = starved
  uint32_t s[5];
  int ch = 0, cn = 0, dp = 0;
  int nodes = 0, leaves = 0, maxd = 0, steps = 0;
  for (;;) {
    if (sp < 0) {
      if (steps >= a.max_steps) break;  // capped: others take the roots
      const int r = atomicAdd(&a.ctl[0], 1);
      if (r >= a.R) break;
#pragma unroll
      for (int i = 0; i < 5; ++i) s[i] = a.roots_state[(size_t)i * a.P + r];
      ch = 0;
      cn = a.roots_count[r];
      dp = a.d0;
      sp = 0;
    }
    if (steps >= a.max_steps) {
      atomicOr(&a.ctl[1], 1);  // capped with work on the stack
      break;
    }
    uint32_t c[5];
    sha1_child(s, static_cast<uint32_t>(ch), c);
    const int rr = static_cast<int>(c[4] & 0x7FFFFFFFu);
    const int cd = dp + 1;
    int cc = 0;
    if (a.fixed) {
      if (cd < a.gen_mx) cc = count_le(stab, slen[0], rr);
    } else if (cd < a.rows) {
      cc = count_le(stab + cd * a.cols, slen[cd], rr);
    }
    ++steps;
    ++nodes;
    leaves += cc == 0;
    maxd = max(maxd, cd);
    const bool last = ch + 1 >= cn;
    if (cc == 0) {
      if (!last) {
        ++ch;
      } else if (--sp >= 0) {  // pop: the saved frame below becomes the top
#pragma unroll
        for (int i = 0; i < 5; ++i) s[i] = stk[sp][i];
        ch = static_cast<int>(stk[sp][5]);
        cn = static_cast<int>(stk[sp][6]);
        dp = static_cast<int>(stk[sp][7]);
      }
    } else {
      if (!last) {  // push: save the parent (cursor bumped) below the child
        if (sp + 1 >= a.stack_size) {  // the host keeps stack_size <= SMAX
          atomicOr(&a.ctl[2], 1);
          atomicOr(&a.ctl[1], 1);
          break;
        }
#pragma unroll
        for (int i = 0; i < 5; ++i) stk[sp][i] = s[i];
        stk[sp][5] = static_cast<uint32_t>(ch + 1);
        stk[sp][6] = static_cast<uint32_t>(cn);
        stk[sp][7] = static_cast<uint32_t>(dp);
        ++sp;
      }
      // push or tail call: the child is the new top frame
#pragma unroll
      for (int i = 0; i < 5; ++i) s[i] = c[i];
      ch = 0;
      cn = cc;
      dp = cd;
    }
  }
  a.nodes[lane] = nodes;
  a.leaves[lane] = leaves;
  a.maxd[lane] = maxd;
  a.steps[lane] = steps;
}

constexpr int MAX_DEVICES = 64;

template <int SMAX>
cudaError_t launch(const UtsArgs& a, int smem, cudaStream_t stream) {
  // Dynamic shared memory granted to this instance on each device, so the
  // attribute is set once and a timed launch is only the launch.
  static int granted[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > granted[dev]) {
    e = cudaFuncSetAttribute(uts_kernel<SMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    granted[dev] = smem;
  }
  const int grid = (a.nlanes + BLOCK - 1) / BLOCK;
  uts_kernel<SMAX><<<grid, BLOCK, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hclib_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a stack above 128 levels (uts_fused.py
// MAX_STACK), which no instance of the kernel holds.
int hclib_uts_launch(const uint32_t* roots_state, const int32_t* roots_count,
                     const int32_t* tab, const int32_t* tab_len,
                     int32_t* nodes, int32_t* leaves, int32_t* maxd,
                     int32_t* steps, int32_t* ctl, int P, int R, int d0,
                     int gen_mx, int rows, int cols, int fixed,
                     int stack_size, int nlanes, int max_steps,
                     void* stream) {
  UtsArgs a{roots_state, roots_count, tab,    tab_len, nodes,
            leaves,      maxd,        steps,  ctl,     P,
            R,           d0,          gen_mx, rows,    cols,
            fixed,       stack_size,  nlanes, max_steps};
  const int smem = (rows * cols + rows) * static_cast<int>(sizeof(int32_t));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stack_size <= 16) return launch<16>(a, smem, s);
  if (stack_size <= 32) return launch<32>(a, smem, s);
  if (stack_size <= 64) return launch<64>(a, smem, s);
  if (stack_size <= 128) return launch<128>(a, smem, s);
  return cudaErrorInvalidValue;
}

// Never launched: chip_smoke.py reads these two kernels' SASS from the
// built library. They load and store the same words; the first computes
// sha1_child on them as uts_kernel does, the second five XORs, so the
// difference of their instruction counts is one SHA-1 child as this
// compiler issues it (less those five XORs), the work uts_kernel's bound
// counts a node.
__global__ void uts_sha1_ops(const uint32_t* __restrict__ in,
                             uint32_t* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t s[5], c[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) s[i] = in[6 * t + i];
  sha1_child(s, in[6 * t + 5], c);
#pragma unroll
  for (int i = 0; i < 5; ++i) out[5 * t + i] = c[i];
}

__global__ void uts_copy_ops(const uint32_t* __restrict__ in,
                             uint32_t* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t ch = in[6 * t + 5];
#pragma unroll
  for (int i = 0; i < 5; ++i) out[5 * t + i] = in[6 * t + i] ^ ch;
}

}  // extern "C"
