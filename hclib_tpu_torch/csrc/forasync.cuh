// The forasync tile bodies of the scheduler megakernel (CUDA C++, sm_90a),
// as device functions for one block. Included by megakernel.cu.
//
// Replaces the slab pipeline of hclib_tpu/device/forasync_tier.py:
// TileKernel.scalar_kernel (:267), _slot_loads (:312), batch_body (:326)
// and batch_drain (:386), for the compiled families fa_stencil and fa_map
// (workloads.py stencil_loop :341, map_loop :417), and the arrayadd tile
// hclib_tpu/device/workloads.py _addtile_kernel (:515).
//
// What it computes. A tile's descriptor args are [a0, a1, a2, a3] (the
// forasync tier's [flat, lo0, lo1, lo2]; arrayadd's block index in a0).
// Its load slabs (windows of the data buffers) go into shared memory, the
// family's arithmetic maps them to the store slab, which goes back to its
// buffer. The geometry is data, the slab words of the table
// (hclib_tpu_torch/device/megakernel.py META_SLAB): per slab its buffer,
// the buffer's leading stride, rows and cols, and its start element as
// c0*a0 + c1*a1 + c2*a2 + c3*a3 + k; per load slab also its shared-memory
// row pitch and offset within an operand slot. So the load and store
// pipeline is generic, as JAX's is, and only the arithmetic is a switch:
//   TILE_ADD      c = a + b, f32 (one rounding, bit-identical to jnp)
//   TILE_STENCIL  out[i][j] = the 5-point sum around in[i+1][j+1], int32
//   TILE_MAP      out = in * MAP_MUL + MAP_ADD, int32
// int32 arithmetic wraps as jnp's does (done in uint32).
//
// A round (tile_round) is JAX's phases 1-5 on cp.async commit groups, as
// sw_wave_batch runs them: (1) the block puts the load slabs of the live
// slots the last round's prefetch did not cover in flight into operand
// half buf and commits them; (2) it puts the next batch's first nxt
// tiles' slabs in flight into the other half and commits them; (3)
// cp.async.wait_group 1 retires all but that newest group (this round's
// and the last round's prefetch), then a barrier; (4, 5) each warp takes
// output rows of live slots, computes them from shared memory and stores
// them straight from registers. The scalar body is the same round with
// one slot, nothing prefetched and nothing announced. Slots past take are
// dead and are skipped (JAX sweeps whole planes); a prefetched slot is
// never loaded twice. The scheduler's barrier after the body orders the
// stores before the completions; its cp.async.wait_all before the spill
// is the drain (a prefetch announced for a round that never runs).
//
// Copies: a warp per slab row, a lane per 16-byte unit where the row's
// source address allows it, else 8 or 4 bytes (a 4096-wide stencil's rows
// are 4098 int32 apart, so every other row starts 8 bytes off 16), and
// the row's tail in 4-byte copies; shared-memory rows are padded to 16
// bytes. Stores likewise take 16, 8 or 4 bytes by the destination's
// alignment (the stencil's output window starts one element in, so 4).
//
// What bounds it: bytes. Each tile reads its slabs once and writes its
// output once (a stencil slab reads its halo again: 1.27x the unique
// input at 8 x 128). But the megakernel is one block on one SM, and a
// round is a dependent chain of its loads, one barrier, the compute and
// the stores, with the serial scheduler between rounds; so the loop is
// bound by one SM's latency, orders of magnitude above the card's
// bandwidth bound. Double-buffering hides a round's loads behind the
// previous one's compute and stores; spreading the tiles over the card is
// later work.
#pragma once

#include <stdint.h>

#include "layout.cuh"

namespace hc {

// megakernel.py SLAB_HDR / SLAB_WORDS / SL_* (META_SLAB: layout.cuh).
constexpr int SLAB_HDR = 4, SLAB_WORDS = 12;
enum { SL_BUF, SL_LD, SL_ROWS, SL_COLS, SL_PITCH, SL_SOFF, SL_C0, SL_K = 10 };
enum { TILE_ADD, TILE_STENCIL, TILE_MAP };
// hclib_tpu/device/workloads.py MAP_MUL, MAP_ADD.
constexpr uint32_t MAP_MUL = 3, MAP_ADD = 7;

// cp.async, global -> shared: 16 bytes L2 only (.cg), 8 and 4 bytes
// through L1 (.ca, the only form for them), in commit groups.
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The start element of slab sw for a tile whose 4 arg words are at a.
__device__ __forceinline__ long long slab_start(const int32_t* sw,
                                                const int32_t* a) {
  return static_cast<long long>(sw[SL_C0]) * a[0] +
         static_cast<long long>(sw[SL_C0 + 1]) * a[1] +
         static_cast<long long>(sw[SL_C0 + 2]) * a[2] +
         static_cast<long long>(sw[SL_C0 + 3]) * a[3] + sw[SL_K];
}

// One slab row into shared memory (d: 16-byte aligned), by one warp.
__device__ __forceinline__ void copy_row(int32_t* d, const int32_t* g,
                                         int cols, int lane) {
  const unsigned addr = static_cast<unsigned>(reinterpret_cast<uintptr_t>(g));
  int e = 0;
  if ((addr & 15) == 0) {
    const int n = cols >> 2;
    for (int u = lane; u < n; u += 32) cp16(d + 4 * u, g + 4 * u);
    e = n << 2;
  } else if ((addr & 7) == 0) {
    const int n = cols >> 1;
    for (int u = lane; u < n; u += 32) cp8(d + 2 * u, g + 2 * u);
    e = n << 1;
  }
  for (int u = e + lane; u < cols; u += 32) cp4(d + u, g + u);
}

// Put the load slabs of slots [s0, s1) in flight into operand half `half`
// (slot b at half + b * slot words); args(b) points at slot b's 4 arg
// words. Rows of every slot and slab are spread over the warps.
template <class ArgsOf>
__device__ void tile_loads(const int32_t* meta, void* const* data,
                           int32_t* half, int s0, int s1, ArgsOf args) {
  const int32_t* hdr = meta + META_SLAB;
  const int nl = hdr[0], slot_words = hdr[2];
  const int32_t* first = hdr + SLAB_HDR;
  int rows = 0;
  for (int l = 0; l < nl; ++l) rows += first[l * SLAB_WORDS + SL_ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int j = warp; j < (s1 - s0) * rows; j += nw) {
    const int b = s0 + j / rows;
    int r = j % rows;
    const int32_t* sw = first;
    while (r >= sw[SL_ROWS]) {
      r -= sw[SL_ROWS];
      sw += SLAB_WORDS;
    }
    const int32_t* g = static_cast<const int32_t*>(data[sw[SL_BUF]]) +
                       slab_start(sw, args(b)) +
                       static_cast<long long>(r) * sw[SL_LD];
    copy_row(half + b * slot_words + sw[SL_SOFF] + r * sw[SL_PITCH], g,
             sw[SL_COLS], lane);
  }
}

// Output element (i, j) from a slot's load slabs x (pitch P) and y
// (pitch Q, arrayadd's second operand).
template <int kOp>
__device__ __forceinline__ int32_t tile_value(const int32_t* x, int P,
                                              const int32_t* y, int Q, int i,
                                              int j) {
  if constexpr (kOp == TILE_ADD) {
    return __float_as_int(__int_as_float(x[i * P + j]) +
                          __int_as_float(y[i * Q + j]));
  } else if constexpr (kOp == TILE_STENCIL) {
    const int32_t* c = x + (i + 1) * P + j + 1;
    return static_cast<int32_t>(
        static_cast<uint32_t>(c[0]) + static_cast<uint32_t>(c[-P]) +
        static_cast<uint32_t>(c[P]) + static_cast<uint32_t>(c[-1]) +
        static_cast<uint32_t>(c[1]));
  } else {
    return static_cast<int32_t>(
        static_cast<uint32_t>(x[i * P + j]) * MAP_MUL + MAP_ADD);
  }
}

// Phases 4 and 5 for slots [0, take): a warp per output row, each lane
// computing 4, 2 or 1 neighbouring outputs (by the destination's
// alignment) and storing them from registers. The slab words are read
// into registers first: the stores could alias them for the compiler.
template <int kOp, class ArgsOf>
__device__ void tile_compute_store(const int32_t* meta, void* const* data,
                                   const int32_t* half, int take,
                                   ArgsOf args) {
  const int32_t* hdr = meta + META_SLAB;
  const int nl = hdr[0], slot_words = hdr[2];
  const int32_t* in0 = hdr + SLAB_HDR;
  const int32_t* in1 = in0 + (nl > 1 ? SLAB_WORDS : 0);
  const int32_t* out = in0 + nl * SLAB_WORDS;
  const int xo = in0[SL_SOFF], P = in0[SL_PITCH];
  const int yo = in1[SL_SOFF], Q = in1[SL_PITCH];
  const int rows = out[SL_ROWS], cols = out[SL_COLS], ld = out[SL_LD];
  int32_t* const base = static_cast<int32_t*>(data[out[SL_BUF]]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int j = warp; j < take * rows; j += nw) {
    const int b = j / rows, i = j % rows;
    const int32_t* x = half + b * slot_words + xo;
    const int32_t* y = half + b * slot_words + yo;
    int32_t* g = base + slab_start(out, args(b)) +
                 static_cast<long long>(i) * ld;
    const unsigned addr =
        static_cast<unsigned>(reinterpret_cast<uintptr_t>(g));
    int e = 0;
    if ((addr & 15) == 0) {
      const int n = cols >> 2;
      for (int u = lane; u < n; u += 32) {
        const int c = 4 * u;
        *reinterpret_cast<int4*>(g + c) =
            make_int4(tile_value<kOp>(x, P, y, Q, i, c),
                      tile_value<kOp>(x, P, y, Q, i, c + 1),
                      tile_value<kOp>(x, P, y, Q, i, c + 2),
                      tile_value<kOp>(x, P, y, Q, i, c + 3));
      }
      e = n << 2;
    } else if ((addr & 7) == 0) {
      const int n = cols >> 1;
      for (int u = lane; u < n; u += 32) {
        const int c = 2 * u;
        *reinterpret_cast<int2*>(g + c) =
            make_int2(tile_value<kOp>(x, P, y, Q, i, c),
                      tile_value<kOp>(x, P, y, Q, i, c + 1));
      }
      e = n << 1;
    }
    for (int c = e + lane; c < cols; c += 32)
      g[c] = tile_value<kOp>(x, P, y, Q, i, c);
  }
}

// One round of a tile body over `width`-slot operand halves at smem:
// slots [0, take) live, [0, pre) prefetched into half buf last round,
// the next batch's nxt tiles (args nargs(b)) prefetched into the other.
template <class ArgsOf>
__device__ void tile_round(int op, const int32_t* meta, void* const* data,
                           int32_t* smem, int width, int take, int pre,
                           int buf, int nxt, ArgsOf args, ArgsOf nargs) {
  const int half = width * meta[META_SLAB + 2];
  int32_t* cur = smem + buf * half;
  tile_loads(meta, data, cur, pre, take, args);
  cp_commit();
  tile_loads(meta, data, smem + (1 - buf) * half, 0, nxt, nargs);
  cp_commit();
  cp_wait_but_newest();
  __syncthreads();
  switch (op) {
    case TILE_ADD:
      tile_compute_store<TILE_ADD>(meta, data, cur, take, args);
      break;
    case TILE_STENCIL:
      tile_compute_store<TILE_STENCIL>(meta, data, cur, take, args);
      break;
    default:
      tile_compute_store<TILE_MAP>(meta, data, cur, take, args);
      break;
  }
}

}  // namespace hc
