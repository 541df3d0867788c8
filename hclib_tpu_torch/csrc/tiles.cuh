// Tile bodies of the Cholesky megakernel, as device functions for one
// block of BT threads (CUDA C++, sm_90a).
//
// Replaces the TPU kernels of hclib_tpu/device/cholesky.py:
//   potrf_tile   <- _potrf_kernel (:77) + ops/tiles.py factor_and_inv (:151)
//                   with factor_tile, tri_inverse, _chol8_and_inv, _mm_tn
//   trsm_tile    <- _trsm_kernel (:95) + ops/tiles.py mm_nt_rsplit (:225)
//   trsmcol_tile <- _trsmcol_kernel (:121): trsm_tile down the column
//   updrow_tile  <- _updrow_kernel / _updrow_stream (:271, :205)
//                   + ops/tiles.py mm_nt_split (:217)
//
// What bounds them here: operations. A 512^2 tile product is 268 MFLOP
// against 3 MB of operands (about 90 FLOP per byte), far above the
// card's f32 balance, and the whole factorization runs on ONE SM (the
// megakernel is one block), so each body is bound by that SM's f32 FMA
// rate. The TPU kernels keep 512^2 tiles whole in 16+ MiB of VMEM; a
// block here has at most 227 KB of shared memory and a 512^2 f32 tile is
// 1 MB, so tiles stay in global memory (and the 50 MB L2) and every body
// is built on block_gemm: 64x64 output tiles, 16-deep operand slabs
// staged through shared memory, a 4x4 register block per thread, f32 FMA.
// The TPU's 3-pass bf16 products are replaced by f32 FMA on the same
// operand values (hi + lo of each split operand; the f32 tile A_ik of
// TRSMCOL is split on the fly exactly as mm_nt_rsplit splits it), so the
// results equal the JAX ones up to rounding (JAX drops lo*lo and sums in
// another order). wgmma, TMA and more than one SM are later work.
//
// POTRF computes what factor_and_inv computes, not its TPU blocking: a
// blocked right-looking Cholesky whose nb x nb diagonal blocks (nb =
// factor_base, the JAX ``base``) are factored and inverted serially in
// shared memory, then a row-block forward substitution for inv(L). The
// plain versions in hclib_tpu_torch/ops/tiles.py follow these steps.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hc {

constexpr int BT = 256;  // threads of a block that runs a tile body
constexpr int GM = 64;   // block_gemm output tile edge
constexpr int GK = 16;   // block_gemm depth step

struct GemmSmem {
  float a[GK][GM + 4];
  float b[GK][GM + 4];
};

__device__ __forceinline__ float bf(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ uint16_t to_bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// split_bf16: hi = bf16(x), lo = bf16(x - hi), both round to nearest even.
__device__ __forceinline__ void split(float x, uint16_t& hi, uint16_t& lo) {
  hi = to_bf(x);
  lo = to_bf(x - bf(hi));
}

__device__ __forceinline__ float unsplit(uint16_t hi, uint16_t lo) {
  return bf(hi) + bf(lo);
}

// C = A B^T over an M x N output: st(m, n, sum_q la(m, q) * lb(n, q)).
// The sum runs in two levels: an FMA chain over each GK-deep slab, then
// the slab sums added up, which keeps long sums (K = 512) more accurate.
// Loaders are called only in range. LOWER skips outputs with n > m.
// B_NMAJOR loads B with consecutive threads on consecutive n (for a B
// stored as B[q][n]); otherwise on consecutive q. Every output tile ends
// its operand loads (a barrier) before its stores, but tiles run one
// after another: an operand element that a later tile reads must not be
// overwritten by an earlier tile's store.
template <bool LOWER, bool B_NMAJOR, class LA, class LB, class ST>
__device__ void block_gemm(GemmSmem& sm, int M, int N, int K, LA la, LB lb,
                           ST st) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int m0 = 0; m0 < M; m0 += GM) {
    for (int n0 = 0; n0 < N; n0 += GM) {
      if (LOWER && n0 > m0) continue;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += GK) {
        float p[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
        for (int e = tid; e < GM * GK; e += BT) {
          const int r = e / GK, q = e % GK;
          const int m = m0 + r, kq = k0 + q;
          sm.a[q][r] = (m < M && kq < K) ? la(m, kq) : 0.f;
          const int rb = B_NMAJOR ? e % GM : r;
          const int qb = B_NMAJOR ? e / GM : q;
          const int n = n0 + rb, kb = k0 + qb;
          sm.b[qb][rb] = (n < N && kb < K) ? lb(n, kb) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < GK; ++q) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = sm.a[q][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sm.b[q][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              p[i][j] = fmaf(av[i], bv[j], p[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += p[i][j];
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
          if (m < M && n < N && (!LOWER || n <= m)) st(m, n, acc[i][j]);
        }
    }
  }
}

// Serial lower Cholesky of the nb x nb block D (row stride ld) in shared
// memory, one column at a time, left-looking (ops/tiles.py _chol_block):
// each entry subtracts ONE dot product of the columns before it, so a
// large diagonal value takes one rounding instead of one per column.
__device__ void chol_block(float* D, int nb, int ld) {
  const int tid = threadIdx.x;
  for (int c = 0; c < nb; ++c) {
    if (tid == 0) {
      float acc = 0.f;
      for (int q = 0; q < c; ++q) acc = fmaf(D[c * ld + q], D[c * ld + q], acc);
      D[c * ld + c] = sqrtf(D[c * ld + c] - acc);
    }
    __syncthreads();
    const float d = D[c * ld + c];
    for (int r = c + 1 + tid; r < nb; r += BT) {
      float acc = 0.f;
      for (int q = 0; q < c; ++q) acc = fmaf(D[r * ld + q], D[c * ld + q], acc);
      D[r * ld + c] = (D[r * ld + c] - acc) / d;
    }
    __syncthreads();
  }
}

// I = inv(L) of the lower block in D by forward substitution, one column
// per thread (ops/tiles.py _inv_block). Writes I's upper triangle zero.
__device__ void inv_block(const float* D, float* I, int nb, int ld) {
  for (int t = threadIdx.x; t < nb; t += BT) {
    for (int r = 0; r < t; ++r) I[r * ld + t] = 0.f;
    for (int r = t; r < nb; ++r) {
      float s = (r == t) ? 1.f : 0.f;
      for (int q = t; q < r; ++q) s -= D[r * ld + q] * I[q * ld + t];
      I[r * ld + t] = s / D[r * ld + r];
    }
  }
  __syncthreads();
}

// POTRF of one ts x ts tile T (global, in place): T <- L (upper zeroed),
// hi/lo <- split(inv(L)). W is ts x ts f32 scratch that ends holding
// inv(L). dsm: 2 * nb * (nb + 1) floats of dynamic shared memory.
__device__ void potrf_tile(GemmSmem& gs, float* dsm, float* T, float* W,
                           uint16_t* hi, uint16_t* lo, int ts, int nb) {
  const int tid = threadIdx.x;
  const int ld = nb + 1;
  float* D = dsm;
  float* I = dsm + nb * ld;
  const int tt = ts * ts;
  for (int e = tid; e < tt; e += BT) W[e] = 0.f;
  __syncthreads();
  for (int j0 = 0; j0 < ts; j0 += nb) {
    const int j1 = j0 + nb;
    for (int e = tid; e < nb * nb; e += BT)
      D[(e / nb) * ld + e % nb] = T[(j0 + e / nb) * ts + j0 + e % nb];
    __syncthreads();
    chol_block(D, nb, ld);
    inv_block(D, I, nb, ld);
    for (int e = tid; e < nb * nb; e += BT) {
      const int r = e / nb, c = e % nb;
      T[(j0 + r) * ts + j0 + c] = c <= r ? D[r * ld + c] : 0.f;
      W[(j0 + r) * ts + j0 + c] = I[r * ld + c];
    }
    __syncthreads();
    if (j1 < ts) {
      const int rest = ts - j1;
      // Panel L[j1:, j0:j1] = A[j1:, j0:j1] inv(L_jj)^T, staged in W's
      // not-yet-computed strictly-lower region (its own columns are read
      // by every output tile of the row, so it cannot go in place).
      block_gemm<false, false>(
          gs, rest, nb, nb,
          [=](int m, int q) { return T[(j1 + m) * ts + j0 + q]; },
          [=](int n, int q) { return I[n * ld + q]; },
          [=](int m, int n, float v) { W[(j1 + m) * ts + j0 + n] = v; });
      __syncthreads();
      for (int e = tid; e < rest * nb; e += BT) {
        const int r = j1 + e / nb, c = j0 + e % nb;
        T[r * ts + c] = W[r * ts + c];
      }
      // Trailing rank-nb update of the lower triangle.
      block_gemm<true, false>(
          gs, rest, rest, nb,
          [=](int m, int q) { return W[(j1 + m) * ts + j0 + q]; },
          [=](int n, int q) { return W[(j1 + n) * ts + j0 + q]; },
          [=](int m, int n, float v) { T[(j1 + m) * ts + j1 + n] -= v; });
      __syncthreads();
    }
  }
  // inv(L) by row blocks: X[i0:i1, :i0] = -X_ii (L[i0:i1, :i0] X[:i0, :i0]).
  // The product in brackets is kept transposed in T's upper triangle
  // (rows < i0, columns i0..i1), which is zeroed afterwards.
  for (int i0 = nb; i0 < ts; i0 += nb) {
    block_gemm<false, true>(
        gs, nb, i0, i0,
        [=](int m, int q) { return T[(i0 + m) * ts + q]; },
        [=](int n, int q) { return W[q * ts + n]; },
        [=](int m, int n, float v) { T[n * ts + i0 + m] = v; });
    __syncthreads();
    block_gemm<false, false>(
        gs, nb, i0, nb,
        [=](int m, int q) { return W[(i0 + m) * ts + i0 + q]; },
        [=](int n, int q) { return T[n * ts + i0 + q]; },
        [=](int m, int n, float v) { W[(i0 + m) * ts + n] = -v; });
    __syncthreads();
  }
  for (int e = tid; e < tt; e += BT) {
    if (e % ts > e / ts) T[e] = 0.f;
    split(W[e], hi[e], lo[e]);
  }
  __syncthreads();
}

// TRSM of tile (i, k): S = split(A_ik) inv(L_kk)^T; tiles[i,k] <- S (f32)
// and lsp[i,k] <- split(S). W: ts*ts f32 scratch (the product reads A_ik
// until its last output tile, so it cannot go in place).
__device__ void trsm_tile(GemmSmem& gs, float* tiles, const uint16_t* linvsp,
                          uint16_t* lsp, float* W, int i, int k, int nt,
                          int ts) {
  const size_t tt = static_cast<size_t>(ts) * ts;
  const uint16_t* ih = linvsp + (static_cast<size_t>(k) * 2) * tt;
  const uint16_t* il = ih + tt;
  float* A = tiles + (static_cast<size_t>(i) * nt + k) * tt;
  block_gemm<false, false>(
      gs, ts, ts, ts,
      [=](int m, int q) {
        uint16_t h, l;
        split(A[m * ts + q], h, l);
        return unsplit(h, l);
      },
      [=](int n, int q) { return unsplit(ih[n * ts + q], il[n * ts + q]); },
      [=](int m, int n, float v) { W[m * ts + n] = v; });
  __syncthreads();
  uint16_t* oh = lsp + ((static_cast<size_t>(i) * nt + k) * 2) * tt;
  uint16_t* ol = oh + tt;
  for (int e = threadIdx.x; e < ts * ts; e += BT) {
    const float v = W[e];
    A[e] = v;
    split(v, oh[e], ol[e]);
  }
  __syncthreads();
}

// TRSMCOL of step k: the column stream of TRSM tiles (i, k), i > k.
__device__ void trsmcol_tile(GemmSmem& gs, float* tiles,
                             const uint16_t* linvsp, uint16_t* lsp, float* W,
                             int k, int nt, int ts) {
  for (int i = k + 1; i < nt; ++i)
    trsm_tile(gs, tiles, linvsp, lsp, W, i, k, nt, ts);
}

// UPDROW of row i at step k: A_ij -= L_ik L_jk^T for j in k+1..i, both
// operands read split from lsp (in place: the output is no operand).
__device__ void updrow_tile(GemmSmem& gs, float* tiles, const uint16_t* lsp,
                            int i, int k, int nt, int ts) {
  const size_t tt = static_cast<size_t>(ts) * ts;
  const uint16_t* lh = lsp + ((static_cast<size_t>(i) * nt + k) * 2) * tt;
  const uint16_t* ll = lh + tt;
  for (int j = k + 1; j <= i; ++j) {
    float* C = tiles + (static_cast<size_t>(i) * nt + j) * tt;
    const uint16_t* bh = lsp + ((static_cast<size_t>(j) * nt + k) * 2) * tt;
    const uint16_t* bl = bh + tt;
    block_gemm<false, false>(
        gs, ts, ts, ts,
        [=](int m, int q) { return unsplit(lh[m * ts + q], ll[m * ts + q]); },
        [=](int n, int q) { return unsplit(bh[n * ts + q], bl[n * ts + q]); },
        [=](int m, int n, float v) { C[m * ts + n] -= v; });
    __syncthreads();
  }
}

}  // namespace hc
