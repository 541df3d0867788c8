// A user-body library (CUDA C++, sm_90a): the scheduler instances a table
// of user-defined bodies reaches, built from the bodies' CUDA source.
//
// Replaces hclib_tpu/device/megakernel.py Megakernel(kernels=[(name, fn)])
// (:225-420: KernelContext's arg, value, set_value, set_out, spawn,
// take_continuation, row_values, alloc_values :330, free_values :404)
// for the card. JAX traces each Python body into the pallas_call's
// lax.switch; CUDA cannot take a Python callable, so a user body comes
// with CUDA C++ statements over `ctx` (a Ctx below), and
// hclib_tpu_torch/_build.py writes one source per table:
//
//   #include "user.cuh"
//   __device__ void user_body_0(Ctx& ctx) { <the body's statements> }
//   ...
//   __device__ void user_body(int k, Ctx& ctx) { switch (k) { ... } }
//
// compiled into its own small library keyed by a hash of that text and of
// these headers. It holds only what a user table can reach, none of
// megakernel.cu's tile, SW, vector or graph bodies, and of the scheduler
// instances only those of one variant, which the generated source fixes
// with two macros before the include:
//   HCLIB_USER_LANES  1 for a table with batch-routed built-in bodies
//                     (the lanes instances), else 0;
//   HCLIB_USER_PGAS   0: mk_user_kernel (the scheduler, thread 0 of one
//                     CTA a mesh device: Megakernel.run on one device,
//                     and the sharded runner's grid launch),
//                     ici_ring_kernel and resident_kernel steal-only;
//                     1: resident_kernel's PGAS configurations (ctx.pgas:
//                     put, am, wait_until, count, the atomics fadd,
//                     fadd_get, cswap and the locks lock, unlock, me,
//                     ndev, nchan), without steal and with it, and
//                     pgas_ring_kernel (PGASMegakernel on a mesh whose
//                     size is not a power of two: put, am, wait_until,
//                     count; an atomic or a lock op stops the mesh);
//                     2: resident_kernel's migrating configuration
//                     (homed copies and their completions, value args;
//                     the PGAS ops too), its bodies spawning through
//                     HomeSched;
//   HCLIB_USER_INJECT 1: instead of those, resident_kernel's injecting
//                     instances of the same configurations (kInject: the
//                     injection ring and mesh tenancy).
//   HCLIB_USER_FAULT  1: instead of those, resident_kernel's instances
//                     with the fault layer (kFault: a DeviceFaultPlan) of
//                     the variant's steal configurations: steal-only (0),
//                     steal with channels (1), migrating (2).
//   HCLIB_USER_OBS    1: the observed instances (kObs: the flight recorder
//                     and the quiesce word) of the variant's ring and
//                     resident kernels (injecting, or with the fault
//                     layer, with those macros) in place of the
//                     unobserved ones; no mk_user_kernel.
// A table whose bodies name ctx.pgas runs only under PGAS 1 and 2; a
// table builds a variant only when it is run there. A table of built-in
// bodies alone (fib and sum, say) builds a library with no user body for
// PGAS 1 and 2 and for the injecting instances.
// A table may mix user bodies with the built-in thread-0 bodies fib, sum
// and uts_node (and their batch_of forms); their body ids are the
// built-in ones, a user body's is NBODY + its index in the table's user
// bodies (layout.cuh).
//
// What bounds it: what bounds mk_kernel, one thread's chain of dependent
// loads and stores a CTA.

#pragma once

#include "mesh.cuh"

#ifndef HCLIB_USER_LANES
#define HCLIB_USER_LANES 0
#endif
#ifndef HCLIB_USER_PGAS
#define HCLIB_USER_PGAS 0
#endif
#ifndef HCLIB_USER_INJECT
#define HCLIB_USER_INJECT 0
#endif
#ifndef HCLIB_USER_FAULT
#define HCLIB_USER_FAULT 0
#endif
#ifndef HCLIB_USER_OBS
#define HCLIB_USER_OBS 0
#endif
static_assert(!(HCLIB_USER_INJECT && HCLIB_USER_FAULT),
              "a fault plan on an injecting mesh is not ported");

namespace {

// What a CUDA user body sees (the plain KernelContext's operations).
struct Ctx;
__device__ void user_body(int k, Ctx& ctx);

// The scheduler a body spawns through: the homed variant's keeps the
// home links (mesh.cuh HomeSched).
#if HCLIB_USER_PGAS == 2
using USched = HomeSched;
#else
using USched = Sched;
#endif

// ctx.pgas: the resident kernel's PGAS ops on this device (the plain
// KernelContext.pgas namespace): put, am, wait_until, count, and the
// atomics and locks fadd, fadd_get, cswap, lock, unlock. Under another
// runner p is null, and the host refuses a table whose bodies name
// ctx.pgas before the launch.
struct PgasOps {
  Pgas* p;
  Sched& S;
  int me, ndev, nchan;

  __device__ void put(int dev, int chan, int dst_row, int src_row) const {
    if (p) p->put(dev, chan, dst_row, src_row);
  }
  __device__ void am(int dev, int fn, const int* args = nullptr,
                     int nargs = 0, int out = 0) const {
    if (p) p->am(S, dev, fn, args, nargs, out);
  }
  __device__ void wait_until(int chan, int need, int row) const {
    if (p) p->wait_until(S, chan, need, row);
  }
  __device__ int count(int chan) const { return p ? p->count(chan) : 0; }
  __device__ void fadd(int dev, int slot, int delta) const {
    if (p) p->fadd(S, dev, slot, delta);
  }
  __device__ void fadd_get(int dev, int slot, int delta, int row,
                           int rslot) const {
    if (p) p->fadd_get(S, dev, slot, delta, row, rslot);
  }
  __device__ void cswap(int dev, int slot, int expected, int nv, int row,
                        int rslot) const {
    if (p) p->cswap(S, dev, slot, expected, nv, row, rslot);
  }
  __device__ void lock(int dev, int lbase, int row, int qcap) const {
    if (p) p->lock(S, dev, lbase, row, qcap);
  }
  __device__ void unlock(int dev, int lbase, int qcap) const {
    if (p) p->unlock(S, dev, lbase, qcap);
  }
};

struct Ctx {
  USched& S;
  const Args& a;
  int idx;          // this task's row
  int32_t* vfree;   // the value-block free stack: [0] count, then bases
  PgasOps pgas;

  __device__ int arg(int i) const { return S.w(idx, F_A0 + i); }
  __device__ void set_arg(int row, int i, int v) const {
    S.w(row, F_A0 + i) = v;
  }
  __device__ int out_slot() const { return S.w(idx, F_OUT); }
  __device__ int value(int slot) const { return S.iv[slot]; }
  __device__ void set_value(int slot, int v) const { S.iv[slot] = v; }
  __device__ void set_out(int v) const { S.iv[out_slot()] = v; }
  __device__ int row_values(int row) const {
    return S.counts[C_VBASE] + row * VBLOCK;
  }
  __device__ void take_continuation(int row) const {
    S.take_continuation(idx, row);
  }
  // KernelContext.spawn with its default nargs (all six arg words).
  __device__ int spawn(int fn, const int* args = nullptr, int nargs = 0,
                       int dep = 0, int s0 = NO_TASK, int s1 = NO_TASK,
                       int out = 0) const {
    return S.spawn(fn, args, nargs, NUM_ARGS, dep, s0, s1, out);
  }
  // Buffer i of the table's data_specs (this device's slice).
  template <class T = int32_t>
  __device__ T* data(int i) const {
    return static_cast<T*>(a.data[i]);
  }

  // KernelContext.alloc_values: k <= VBLOCK takes one VBLOCK-word block,
  // a recycled one first; a larger k bumps exactly k slots and is never
  // recycled. Exhaustion sets OVF_VALUES and returns a clamped base.
  __device__ int alloc_values(int k) const {
    int32_t* c = S.counts;
    const int nv = a.num_values;
    if (k > VBLOCK) {
      const int base = c[C_VALLOC];
      const bool ok = base + k <= nv;
      if (ok)
        c[C_VALLOC] = base + k;
      else
        c[C_OVERFLOW] |= OVF_VALUES;
      return ok ? base : max(nv - k, 0);
    }
    const int nfree = vfree[0];
    const bool use_free = nfree > 0;
    const int b_free = vfree[max(nfree, 1)];
    const int b_new = c[C_VALLOC];
    const bool ok = use_free || b_new + VBLOCK <= nv;
    vfree[0] = nfree - (use_free ? 1 : 0);
    if (!use_free && ok) c[C_VALLOC] = b_new + VBLOCK;
    if (!ok) c[C_OVERFLOW] |= OVF_VALUES;
    return use_free ? b_free : ok ? b_new : max(nv - VBLOCK, 0);
  }

  // KernelContext.free_values: push the block at base; more frees than
  // blocks clamp inside the stack and set OVF_VALUES.
  __device__ void free_values(int base) const {
    const int vcap = a.num_values / VBLOCK;
    const int nf = vfree[0] + 1;
    const bool ok = nf <= vcap;
    const int nfc = min(nf, vcap);
    vfree[0] = nfc;
    if (ok)
      vfree[nfc] = base;
    else
      S.counts[C_OVERFLOW] |= OVF_VALUES;
  }
};

// The body table of a user library: the built-in thread-0 bodies, then
// the user bodies (body id NBODY + k -> user_body(k)).
struct UserBodies : BuiltinBodies {
  int32_t* vfree;
  Pgas* pg;
  int me, ndev, nchan;

  __device__ UserBodies(const MeshArgs& m, const Args& a, Pgas* p)
      : BuiltinBodies(m, a, p),
        vfree(m.vfree + blockIdx.x * m.s_vfree),
        pg(p),
        me(blockIdx.x),
        ndev(m.ndev),
        nchan(m.nchan) {}

  __device__ void scalar(USched& S, const Args& a, int body, int idx) const {
    if (body < NBODY) {
      BuiltinBodies::scalar(S, a, body, idx);
    } else if (body < MAX_BODIES) {
      Ctx ctx{S, a, idx, vfree, PgasOps{pg, S, me, ndev, nchan}};
      user_body(body - NBODY, ctx);
    }
  }
};

constexpr bool kUserLanes = HCLIB_USER_LANES;
constexpr bool kUserObs = HCLIB_USER_OBS;

// The scheduler of a user table: block b runs mesh device b's slice to
// completion or fuel (Megakernel.launch on one device, and the sharded
// runner's grid launch), on thread 0: stage (value-block stack emptied,
// as JAX's stage does), the rounds, the counts written back.
template <bool kLanes>
__global__ void __launch_bounds__(1) mk_user_kernel(MeshArgs m) {
  __shared__ int32_t s_counts[8];
  __shared__ Round R;
  const Args a = mesh_slice(m, blockIdx.x);
  Sched S{a.tasks, a.succ, a.ready, s_counts, a.ivalues, a.freestk, a.cap};
  Obs O{};
  const UserBodies bodies(m, a, nullptr);
  S.stage(a);
  bodies.vfree[0] = 0;
  mesh_sched<kLanes>(S, a, R, O, bodies);
  for (int i = 0; i < 8; ++i) a.counts[i] = s_counts[i];
}

// The resident kernel instance of this library's variant.
template <bool kSteal, bool kPgas, bool kHome, bool kInject, bool kFault>
void* user_resident() {
  return reinterpret_cast<void*>(
      resident_kernel<kUserLanes, kSteal, kPgas, UserBodies, kHome, kInject,
                      kFault, kUserObs>);
}

// The instance of (kind, lanes, steal, pgas) this library holds, or null.
void* user_kernel_of(int kind, int lanes, int steal, int pgas) {
  if (lanes != int(kUserLanes) || pgas != HCLIB_USER_PGAS) return nullptr;
  constexpr bool kP = HCLIB_USER_PGAS != 0, kH = HCLIB_USER_PGAS == 2;
#if HCLIB_USER_FAULT
  if (kind == 2 && steal) return user_resident<true, kP, kH, false, true>();
#elif HCLIB_USER_INJECT && HCLIB_USER_PGAS == 2
  if (kind == 2 && steal) return user_resident<true, true, true, true, false>();
#elif HCLIB_USER_INJECT && HCLIB_USER_PGAS
  if (kind == 2)
    return steal ? user_resident<true, true, false, true, false>()
                 : user_resident<false, true, false, true, false>();
#elif HCLIB_USER_INJECT
  if (kind == 2 && steal)
    return user_resident<true, false, false, true, false>();
#elif HCLIB_USER_PGAS == 2
  if (kind == 2 && steal) return user_resident<true, true, true, false, false>();
#elif HCLIB_USER_PGAS
  if (kind == 2)
    return steal ? user_resident<true, true, false, false, false>()
                 : user_resident<false, true, false, false, false>();
  if (kind == 3 && !steal)
    return reinterpret_cast<void*>(
        pgas_ring_kernel<kUserLanes, UserBodies, kUserObs>);
#else
  if (kind == 0 && !kUserObs)
    return reinterpret_cast<void*>(mk_user_kernel<kUserLanes>);
  if (kind == 1)
    return reinterpret_cast<void*>(
        ici_ring_kernel<kUserLanes, UserBodies, kUserObs>);
  if (kind == 2 && steal)
    return user_resident<true, false, false, false, false>();
#endif
  return nullptr;
}

}  // namespace

extern "C" {

const char* hclib_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most CTAs of a steal kernel of this library (kind 1 ring, 2
// resident, 3 the PGAS ring kernel; lanes, steal, pgas pick the instance)
// the card holds at once.
int hclib_user_coresident(int kind, int lanes, int steal, int pgas,
                          int* out) {
  void* kernel = user_kernel_of(kind, lanes, steal, pgas);
  if (!kernel) return cudaErrorInvalidValue;
  return coresident(kernel, out);
}

// kind 0: mk_user_kernel, an ordinary launch of ndev one-thread blocks;
// 1: ici_ring_kernel; 2: resident_kernel with steal and / or pgas (pgas
// 2: the migrating configuration); 3: pgas_ring_kernel (pgas 1, no steal;
// its two stat slots a device in the ports) (cooperative launches of ndev
// one-thread CTAs); an injecting library's resident_kernel wants the ring (h->ictl,
// and h->tctl with tenant lanes), any other library none; a library with
// the fault layer wants the plan and its workspace (h->fplan, h->fws),
// any other none. An instance this library's variant does not hold is
// invalid. Returns
// cudaGetLastError() (0 = launched).
int hclib_user_launch(const MeshHost* h, int kind, int lanes, int steal,
                      int pgas, void* stream) {
  void* kernel = user_kernel_of(kind, lanes, steal, pgas);
  if (!kernel || h->ndev < 1 || !h->vfree ||
      (kind > 0 && !steal_args_ok(h)) ||
      (pgas && (!h->pg || h->nchan < 1 || h->amw < 2 || h->outq < 1 ||
                h->stat_words < S_BL + 1 ||
                h->p_inbox < P_STAT + h->stat_words)) ||
      (h->ictl != 0) != (HCLIB_USER_INJECT != 0) ||
      (h->fplan != 0) != (HCLIB_USER_FAULT != 0) ||
      (h->fplan && !fault_args_ok(h, pgas != 0)) ||
      !obs_args_ok(h, kUserObs) || ((kind == 1 || kind == 3) && h->ckpt) ||
      (kind == 3 && (steal || pgas != 1 ||
                     h->p_inbox < P_STAT + 2 * ((h->stat_words + 7) / 8 * 8))) ||
      (h->ckpt && h->p_inbox < P_STAT + (pgas ? h->stat_words : STAT_WORDS) +
                                   1 + (h->fplan ? h->ndev : 0)) ||
      (h->ictl && (!h->iring || h->ntenants < 0 ||
                   (h->ntenants > 0 &&
                    (!h->tctl || h->ntenants * h->region > h->ring_rows)))))
    return cudaErrorInvalidValue;
  MeshArgs m = mesh_args(h);
  const auto st = static_cast<cudaStream_t>(stream);
#if !HCLIB_USER_PGAS && !HCLIB_USER_INJECT && !HCLIB_USER_FAULT && \
    !HCLIB_USER_OBS
  if (kind == 0) {
    mk_user_kernel<kUserLanes><<<m.ndev, 1, 0, st>>>(m);
    return cudaGetLastError();
  }
#endif
  return launch_steal(kernel, m, st);
}

}  // extern "C"
