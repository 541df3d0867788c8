// mk_kernel's body (csrc/megakernel.cu), as statements: included in the
// body of a kernel that has `a` (the Args of the block's state) and the
// template constants kMode and kObs in scope. mk_kernel includes it with
// its parameter; mesh.cuh's mk_grid_kernel with mesh device
// blockIdx.x's slice of the stacked state and kObs false. Text included
// in place keeps mk_kernel's code what it was (registers and frame of
// every instance; scripts/ab_sched.py prints them). No include guard:
// each kernel includes it once.
  constexpr bool kLean = kMode == 0, kVector = kMode == 2;
  constexpr bool kSw = kMode == 1 || kMode == 2, kTile = kMode == 3;
  constexpr bool kPolicy = kMode >= 4, kDyn = kMode == 5;
  extern __shared__ __align__(16) float dsm[];
  __shared__ GemmSmem gs;
  __shared__ int32_t s_counts[8];
  __shared__ Round R;
  __shared__ int s_tmax[MAX_SW_SLOTS];
  const int tid = threadIdx.x;
  Sched S{a.tasks, a.succ, a.ready, s_counts, a.ivalues, a.freestk, a.cap};
  // Thread 0's recorder and poll (qstat zeroed once a launch); unused,
  // and compiled out, where kObs is false.
  Obs O{a.ring, a.qctl, a.tr_cap, a.qstride};
  O.left = 1;
  const int32_t* meta = a.meta;
  const int ts = meta[P_TILE], nt = meta[P_NT];
  const size_t tt = static_cast<size_t>(ts) * ts;
  float* tiles = static_cast<float*>(a.data[0]);
  uint16_t* linvsp = static_cast<uint16_t*>(a.data[1]);
  uint16_t* lsp = static_cast<uint16_t*>(a.data[2]);
  const SwData sw{static_cast<const int32_t*>(a.data[0]),
                  static_cast<const int32_t*>(a.data[1]),
                  static_cast<int32_t*>(a.data[2]),
                  static_cast<int32_t*>(a.data[3]),
                  static_cast<int32_t*>(a.data[4]), meta[P_NTJ]};
  int32_t* swm = reinterpret_cast<int32_t*>(dsm);
  const FrGraph fg = fr_graph(meta, a.data[0], a.data[1]);
  // The family a splice relaxes with: that of F_FN 0, the EXPAND kind
  // every relax spawns.
  [[maybe_unused]] const int dg_fam = meta[META_BODY_OF_FN] - B_FR_BFS;
  uint32_t total = 0;
  for (int rep = 0; rep < a.reps; ++rep) {
    int e0 = 0;
    if (tid == 0) {
      S.stage(a);
      e0 = s_counts[C_EXECUTED];
      if constexpr (kObs) {
        // Tracer.reset each rep, then the entry record.
        O.n = O.slot = O.r = 0;
        O.emit(TR_ROUND_BEGIN, O.tick(),
                    s_counts[C_TAIL] - s_counts[C_HEAD], s_counts[C_PENDING]);
      }
    }
    for (;;) {
      if (tid == 0) {
        if constexpr (kPolicy) {
          schedule_policy<kObs>(S, a, e0, R, O);
        } else if constexpr (!kLean) {
          schedule<kObs>(S, a, e0, R, O);
        } else {
          // schedule() with no lane, written out on s_counts: about 6%
          // faster a task than the call (same A/B).
          R.act = ACT_EXIT;
          if (s_counts[C_PENDING] > 0 && s_counts[C_EXECUTED] - e0 < a.fuel) {
            const int tail = s_counts[C_TAIL];
            int rt = 0;
            bool quiesce = false;
            if constexpr (kObs) {
              rt = O.tick();
              quiesce = O.poll(s_counts[C_EXECUTED] - e0);
            }
            if (s_counts[C_HEAD] < tail && !quiesce) {
              const int idx = a.ready[floor_mod(tail - 1, a.cap)];
              s_counts[C_TAIL] = tail - 1;
              if constexpr (kObs)
                O.emit(TR_FIRE_SCALAR, rt, S.w(idx, F_FN), idx);
              const int fn = min(max(S.w(idx, F_FN), 0), a.nfn - 1);
              const int body = meta[META_BODY_OF_FN + fn];
              if (body >= 0 && body < NDISPATCH) a.dispatch[body] += 1;
              R.idx = idx;
              R.body = body;
              R.act = ACT_SCALAR;
            }
          }
        }
      }
      __syncthreads();
      if (R.act == ACT_EXIT) break;
      if (R.act == ACT_SCALAR) {
        const int idx = R.idx;
        const int a0 = S.w(idx, F_A0);  // k (potrf, trsmcol), i (updrow,..)
        switch (R.body) {
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
                       tiles + (static_cast<size_t>(a0) * nt + a0) * tt,
                       a.work, linvsp + static_cast<size_t>(a0) * 2 * tt,
                       linvsp + (static_cast<size_t>(a0) * 2 + 1) * tt, ts,
                       meta[P_FBASE]);
            break;
          case B_TRSMCOL:
            trsmcol_tile(gs, tiles, linvsp, lsp, a.work, a0, nt, ts);
            break;
          case B_UPDROW:
            updrow_tile(gs, tiles, lsp, a0, S.w(idx, F_A0 + 1), nt, ts);
            break;
          case B_TRSM:
            trsm_tile(gs, tiles, linvsp, lsp, a.work, a0, S.w(idx, F_A0 + 1),
                      nt, ts);
            break;
          case B_SW_TILE:
            if constexpr (kSw) {
              if (tid < 32) {
                const int m = sw_tile_body(sw, a0, S.w(idx, F_A0 + 1));
                if (tid == 0) S.iv[0] = max(S.iv[0], m);
              }
            }
            break;
          case B_VFIB:
          case B_VNQUEENS:
            if constexpr (kVector) {
              __shared__ VecSmem vs;
              vector_body(S, a, idx, R.body, vs);
            }
            break;
          case B_ADD_TILE:
          case B_FA_STENCIL:
          case B_FA_MAP:
            if constexpr (kTile)
              tile_round(R.body == B_ADD_TILE     ? TILE_ADD
                         : R.body == B_FA_STENCIL ? TILE_STENCIL
                                                  : TILE_MAP,
                         meta, a.data, swm, 1, 1, 0, 0, 0,
                         TaskArgs{a.tasks, &R.idx}, TaskArgs{a.tasks, &R.idx});
            break;
          case B_FR_BFS:
          case B_FR_SSSP:
          case B_FR_PAGERANK:
            if constexpr (kPolicy)
              fr_expand<kDyn>(S, R.body - B_FR_BFS, fg, swm, a.tasks,
                              &R.idx);
            break;
          case B_BNB_NODE:
            if constexpr (kPolicy)
              if (tid == 0)
                bnb_node(S, &S.w(idx, F_A0), meta[P_KN], meta[P_KCAP]);
            break;
          case B_DG_UPDATE:
            if constexpr (kDyn)
              if (tid == 0) dg_splice(S, dg_fam, fg, &S.w(idx, F_A0));
            break;
          case B_DG_QUERY:
            if constexpr (kDyn)
              if (tid == 0) dg_query(S, fg, &S.w(idx, 0));
            break;
          default:  // B_SW_WAVE: JAX's _batch_stub, never dispatched
            break;
        }
        __syncthreads();
        if (tid == 0) S.complete(idx);
      } else if constexpr (!kLean) {
        switch (R.body) {
          case B_FIB_BATCH:  // batch_of: the scalar body slot by slot
            if (tid == 0)
              for (int s = 0; s < R.take; ++s) fib_body(S, meta, R.rows[s]);
            break;
          case B_UTS_BATCH:
            if (tid == 0)
              for (int s = 0; s < R.take; ++s) uts_body(S, meta, R.rows[s]);
            break;
          case B_UPDROW_BATCH:
            // JAX double-buffers each slot's L_ik split (1 MB at tile 512)
            // in VMEM while the previous slot streams; no shared memory
            // holds that, so each slot reads it from L2 as the scalar
            // UPDROW does. Slots write disjoint rows: bit-identical to
            // scalar dispatch.
            for (int s = 0; s < R.take; ++s)
              updrow_tile(gs, tiles, lsp, S.w(R.rows[s], F_A0),
                          S.w(R.rows[s], F_A0 + 1), nt, ts);
            break;
          case B_SW_WAVE_BATCH:
            if constexpr (kSw)
              sw_wave_batch_body(sw, swm, R, S, meta[P_CHUNK], s_tmax);
            break;
          case B_FA_STENCIL_BATCH:
          case B_FA_MAP_BATCH:
            if constexpr (kTile)
              tile_round(R.body == B_FA_STENCIL_BATCH ? TILE_STENCIL
                                                      : TILE_MAP,
                         meta, a.data, swm, R.width, R.take, R.pre, R.buf,
                         R.nxt, TaskArgs{a.tasks, R.rows},
                         TaskArgs{a.tasks, R.next_rows});
            break;
          case B_FR_BFS_BATCH:
          case B_FR_SSSP_BATCH:
          case B_FR_PAGERANK_BATCH:
            if constexpr (kPolicy)
              fr_expand_round<kDyn>(S, R.body - B_FR_BFS_BATCH, fg, swm,
                                    a.tasks, R.width, R.take, R.pre, R.buf,
                                    R.nxt, R.rows, R.next_rows);
            break;
          case B_DG_UPDATE_BATCH:  // slot by slot, in slot order
            if constexpr (kDyn)
              if (tid == 0)
                for (int s = 0; s < R.take; ++s)
                  dg_splice(S, dg_fam, fg, &S.w(R.rows[s], F_A0));
            break;
          case B_DG_QUERY_BATCH:
            if constexpr (kDyn)
              if (tid == 0)
                for (int s = 0; s < R.take; ++s)
                  dg_query(S, fg, &S.w(R.rows[s], 0));
            break;
          case B_BNB_NODE_BATCH:  // batch_of: the NODE body slot by slot
            if constexpr (kPolicy)
              if (tid == 0)
                for (int s = 0; s < R.take; ++s)
                  bnb_node(S, &S.w(R.rows[s], F_A0), meta[P_KN],
                           meta[P_KCAP]);
            break;
          default:
            break;
        }
        __syncthreads();
        if (tid == 0) {
          finish_batch<kPolicy>(S, a, R, s_tmax);
          if constexpr (kPolicy) age_clock(a, R.li);
        }
      }
    }
    if constexpr (!kLean) {
      // _sw_wave_drain and the tile tier's batch_drain: no prefetch copy
      // outlives the round loop (a no-op for tables without a prefetch
      // lane).
      cp_wait_all();
      __syncthreads();
      if (tid == 0) spill<kObs>(S, a, O);
    }
    if (tid == 0) {
      if constexpr (kObs)
        O.emit(TR_ROUND_END, O.tick(), s_counts[C_EXECUTED] - e0,
                    s_counts[C_PENDING]);
      for (int i = 0; i < 8; ++i) a.counts[i] = s_counts[i];
      total += static_cast<uint32_t>(s_counts[C_EXECUTED]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    a.counts[C_EXECUTED] = static_cast<int32_t>(total);
    if constexpr (kObs) {
      // The state-export record of a quiesced launch, then the ring's
      // header (the last rep's cursors) and the qstat row.
      if (O.qs[QS_QUIESCED])
        O.emit(TR_CKPT, O.r, s_counts[C_PENDING],
               s_counts[C_TAIL] - s_counts[C_HEAD]);
      if (O.ring)
        for (int i = 0; i < TR_HDR; ++i)
          O.ring[i] = i == 0 ? O.n : i == 1 ? O.r : 0;
      if (O.qctl)
        for (int i = 0; i < 8; ++i) a.qstat[i] = i < 3 ? O.qs[i] : 0;
    }
  }
