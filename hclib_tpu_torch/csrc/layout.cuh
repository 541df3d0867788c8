// The meta-word layout of a kernel table, shared by every library of the
// port (the built-in megakernel library and the user-body libraries) and
// by hclib_tpu_torch/device/megakernel.py, which writes the words: one
// body count, MAX_BODIES, fixes where every section starts.
//
//   [0, MAX_PARAMS)              static body parameters (megakernel.py PARAMS)
//   META_FN_OF_BODY + body       the F_FN of body id `body`, or -1
//   META_BODY_OF_FN + fn         the body id F_FN `fn` dispatches to
//   META_BATCH + 4 li ..         batch lane li: F_FN, width, prefetch, body
//   META_VEC + VEC_WORDS fn ..   a vector F_FN's engine words
//   META_SLAB ..                 the tile body's slab words (forasync.cuh)
//   META_PRIO + 4 li ..          routed kind li's priority rule
//
// Body ids: the built-in bodies take [0, NBODY) (megakernel.cu's enum,
// never renumbered); a table's user bodies take the ids after them, up to
// MAX_BODIES. The per-body dispatch counters (NDISPATCH) cover them all.
#pragma once

namespace hc {

constexpr int MAX_PARAMS = 32;
constexpr int MAX_BODIES = 64;  // the one body count
constexpr int MAX_FNS = 32;     // F_FN values a table holds
constexpr int META_FN_OF_BODY = MAX_PARAMS;
constexpr int META_BODY_OF_FN = META_FN_OF_BODY + MAX_BODIES;
constexpr int META_BATCH = META_BODY_OF_FN + MAX_FNS;
constexpr int VEC_WORDS = 8;
constexpr int META_VEC = META_BATCH + 4 * MAX_FNS;
constexpr int META_SLAB = META_VEC + VEC_WORDS * MAX_FNS;
constexpr int MAX_SLAB_WORDS = 64;
constexpr int META_PRIO = META_SLAB + MAX_SLAB_WORDS;
constexpr int NDISPATCH = MAX_BODIES;

// jnp's // on int32 (floor), b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

}  // namespace hc
