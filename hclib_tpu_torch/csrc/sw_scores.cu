// Batched Smith-Waterman scores (CUDA C++, sm_90a): B independent pairs,
// a (B, n) against b (B, m), to B int32 local-alignment scores.
//
// Replaces hclib_tpu/device/sw_pallas.py _sw_pallas (:86, pallas_call at
// :94) -> _kernel (:57) with _shifted_cummax0 (:46). The TPU kernel puts
// the batch on lanes and a pair's sequence on sublanes, and sweeps n rows
// over (m, B) planes: t = max(diag + s, prev - GAP, 0), the in-row gap
// chain as c = cummax(t + j) - j (log2(m) shifted maxima), best =
// max(best, c). Same recurrences here (models/smithwaterman.py scoring,
// int32, exact).
//
// Design: one warp a pair, no padding (any n, any m). Each row is swept in
// 128-column chunks, lane l holding columns 4l..4l+3 of the chunk; the
// cummax is an in-thread running max over the lane's 4 columns plus a
// 5-step __shfl_up_sync max-scan over the warp (megakernel.cu's sw_row
// does the same on a tile), and a running max of (t + j) carries it from
// chunk to chunk. The previous row and b live in shared memory (2 x m
// words a warp, rounded up to whole chunks); the row is updated in place
// chunk by chunk, the old value of each chunk's last column kept in a
// register as the next chunk's diagonal. The row's a symbols come 32 at a
// time, one coalesced load, and go round the warp by shuffles.
//
// What bounds it on the H100: operations - a cell is a handful of integer
// ops and a lane's 4 cells share 8 shuffles (chip_smoke.py reads one
// chunk's SASS, sw_chunk_ops less sw_chunk_copy_ops, for the bound). At
// bench.py's B = 1024 pairs only about 8 warps reach each SM, too few to
// hide the latency of the dependent shuffle chain, so it runs latency-bound
// below that rate; more pairs, or several chunks in flight a warp, is the
// later speed work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MATCH = 2, MISMATCH = -1, GAP = 1;
constexpr int NEG = -(1 << 30);
constexpr int CHUNK = 128;  // columns a warp sweeps at once
constexpr int WARPS = 4;    // pairs a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;  // the H100's shared memory a block

// One chunk of one row for this lane's 4 columns j0..j0+3, in place on
// h (the row above on entry). ai: the row's a symbol; pdiag: the row
// above at column j0c - 1 (0 left of column 0); carry: max of (t + j) over
// the row's earlier chunks. Columns at or past m take no part. Returns
// the max of the lane's new cells.
__device__ __forceinline__ int sw_chunk(int (&h)[4], const int (&bc)[4],
                                        int ai, int pdiag, int carry, int j0,
                                        int m, int& run_out) {
  const int lane = threadIdx.x & 31;
  const int up3 = __shfl_up_sync(FULL, h[3], 1);
  int x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int diag = c ? h[c - 1] : (lane ? up3 : pdiag);
    const int t = max(max(diag + (bc[c] == ai ? MATCH : MISMATCH), h[c] - GAP),
                      0);
    x[c] = j0 + c < m ? t + j0 + c : NEG;
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
  excl = max(lane ? excl : NEG, carry);
  run_out = max(__shfl_sync(FULL, run, 31), carry);
  int best = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    h[c] = max(x[c], excl) - (j0 + c);
    if (j0 + c < m) best = max(best, h[c]);
  }
  return best;
}

__global__ void sw_scores_kernel(const int32_t* __restrict__ a,
                                 const int32_t* __restrict__ b,
                                 int32_t* __restrict__ out, int B, int n,
                                 int m, int mp) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * WARPS + warp;
  if (pair >= B) return;  // the whole warp; no block barrier follows
  int32_t* prev = smem + static_cast<size_t>(warp) * 2 * mp;
  int32_t* bs = prev + mp;
  const int32_t* ap = a + static_cast<size_t>(pair) * n;
  const int32_t* bp = b + static_cast<size_t>(pair) * m;
  for (int j = lane; j < mp; j += 32) {
    prev[j] = 0;
    bs[j] = j < m ? bp[j] : 0;
  }
  __syncwarp();
  int best = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int areg = i0 + lane < n ? ap[i0 + lane] : 0;
    const int rows = min(32, n - i0);
    for (int r = 0; r < rows; ++r) {
      const int ai = __shfl_sync(FULL, areg, r);
      int carry = NEG, pdiag = 0;
      for (int j0c = 0; j0c < mp; j0c += CHUNK) {
        const int j0 = j0c + 4 * lane;
        const int4 o = *reinterpret_cast<const int4*>(prev + j0);
        const int4 s = *reinterpret_cast<const int4*>(bs + j0);
        int h[4] = {o.x, o.y, o.z, o.w};
        const int bc[4] = {s.x, s.y, s.z, s.w};
        const int next_pdiag = __shfl_sync(FULL, o.w, 31);
        best = max(best, sw_chunk(h, bc, ai, pdiag, carry, j0, m, carry));
        *reinterpret_cast<int4*>(prev + j0) =
            make_int4(h[0], h[1], h[2], h[3]);
        pdiag = next_pdiag;
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, o));
  if (lane == 0) out[pair] = best;
}

}  // namespace

extern "C" {

const char* hclib_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a (B, n), b (B, m) int32 row-major; out (B,). Returns cudaGetLastError().
int hclib_sw_scores_launch(const int32_t* a, const int32_t* b, int32_t* out,
                           int B, int n, int m, void* stream) {
  if (B < 1 || n < 0 || m < 0) return cudaErrorInvalidValue;
  const int mp = (m + CHUNK - 1) / CHUNK * CHUNK;
  const size_t smem = static_cast<size_t>(WARPS) * 2 * mp * sizeof(int32_t);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sw_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  sw_scores_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(a, b, out, B, n, m,
                                                          mp);
  return cudaGetLastError();
}

// Never launched: read from the built library's SASS by chip_smoke.py for
// the bound. Both load and store the same words; the first sweeps one
// chunk of one row for a lane's 4 cells (sw_chunk, as the kernel does),
// the second a few XORs, so the difference of their instruction counts is
// one chunk row of 4 cells as this compiler issues it.
__global__ void sw_chunk_ops(const int4* __restrict__ in,
                             int4* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int4 h = in[3 * t], b = in[3 * t + 1], s = in[3 * t + 2];
  int hp[4] = {h.x, h.y, h.z, h.w};
  const int bc[4] = {b.x, b.y, b.z, b.w};
  int carry = s.y;
  const int best =
      sw_chunk(hp, bc, s.x, s.z, carry, 4 * (t & 31), s.w, carry);
  out[t] = make_int4(hp[0] ^ best, hp[1] ^ carry, hp[2], hp[3]);
}

__global__ void sw_chunk_copy_ops(const int4* __restrict__ in,
                                  int4* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int4 h = in[3 * t], b = in[3 * t + 1], s = in[3 * t + 2];
  out[t] = make_int4(h.x ^ b.x ^ s.x, h.y ^ b.y ^ s.y, h.z ^ b.z ^ s.z,
                     h.w ^ b.w ^ s.w);
}

}  // extern "C"
