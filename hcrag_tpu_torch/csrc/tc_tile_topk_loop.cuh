// tc_tile_topk_loop.cuh — the body of the tensor-core kernel of
// tc_tile_topk.cuh (whose header says what it does), included by each
// __global__ that runs it: tc_tile_topk_kernel there, and
// float_tile_topk_kernel_tc in float_tile_topk.cu.  Both lie in namespace
// tc_tile and have the same template arguments and parameters, which the
// body uses.  No include guard: it is included once per kernel.

  constexpr int NT = TQB * 2;    // the consumer warpgroups' threads
  constexpr int NW = NT / 32;
  constexpr int QPW = TQB / NW;  // queries each warp holds and merges: 16
  using Key = typename K::Key;
  constexpr bool WIDE = sizeof(Key) == 8;  // B3e, B4: compare the value word first
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int kc_n = row_chunks(d, Op::BYTES);
  unsigned char* q_s =                                // kc_n chunks of TQB rows
      smem_raw + ((1024 - (tc_mma::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = q_s + (size_t)TQB * kc_n * 128;  // STAGES chunks of 64 rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * CHUNK);  // full, empty
  Key* cand = reinterpret_cast<Key*>(bars + 2 * STAGES);  // [TQB][RB]
  Key* lists = cand + TQB * RB;                       // [TQB][k], sorted descending
  int* cnt = reinterpret_cast<int*>(lists + TQB * k);  // [TQB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.y;
  const int tile_base = tile * tile_n;
  const int rows_here = min(tile_n, n - tile_base);
  const int steps = (rows_here + RB - 1) / RB * kc_n;
  const uint32_t ring_addr = tc_mma::smem_addr(ring);
  const uint32_t full = tc_mma::smem_addr(bars);  // + 8 slot: chunk landed
  const uint32_t empty = full + 8 * STAGES;       // + 8 slot: every warp is done with it

  if (tid == 0) {
    for (int x = 0; x < STAGES; ++x) {
      tc_mma::mbar_init(full + 8 * x, 1);
      tc_mma::mbar_init(empty + 8 * x, NW);
    }
    tc_mma::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NW) {
    // The producer warp: lane 0 keeps STAGES chunks in flight, chunk s
    // (chunk s % kc_n of sub-tile s / kc_n) into slot s % STAGES once every
    // consumer warp has released the slot's previous chunk.
    if (lane == 0)
      for (int s = 0; s < steps; ++s) {
        const int slot = s % STAGES;
        if (s >= STAGES) tc_mma::mbar_wait(empty + 8 * slot, (s / STAGES - 1) & 1);
        tc_mma::mbar_expect(full + 8 * slot, CHUNK);
        tc_mma::tma_2d(ring_addr + slot * CHUNK, &emap, (s % kc_n) * (128 / Op::BYTES),
                       tile_base + (s / kc_n) * RB, full + 8 * slot);
      }
    return;
  }

  // The consumers: two warpgroups (one for TQB = 64).
  const int wg = warp >> 2;  // warpgroup: queries 64 wg .. 64 wg + 63
  const int qw = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // and + 8: this thread's
  const int q0 = blockIdx.x * TQB;
  const uint32_t q_addr = tc_mma::smem_addr(q_s);
  // The query block, rows past b and segments past d as zeros.
  const int row_bytes = d * Op::BYTES;
  const int segs = row_bytes / 16, segs_pad = kc_n * 8;
  for (int x = tid; x < TQB * segs_pad; x += NT) {
    const int r = x / segs_pad, seg = x - r * segs_pad;
    const bool in = q0 + r < b && seg < segs;
    tc_mma::cp16(q_addr + (seg >> 3) * (TQB * 128) + tc_mma::swz(r, seg),
                 in ? (const void*)(q + (size_t)(q0 + r) * row_bytes + seg * 16)
                    : (const void*)q,
                 in ? 16 : 0);
  }
  tc_mma::cp_commit();
  if (!DOTS && KC == 0) {
    for (int x = tid; x < TQB * k; x += NT) lists[x] = K::filler();
    for (int x = tid; x < TQB; x += NT) cnt[x] = 0;
  }
  // Over int8: the scales of this thread's two queries (0 past b).
  float qs0 = 0.0f, qs1 = 0.0f;
  if constexpr (Op::SCALED) {
    if (q0 + qw < b) qs0 = q_scale[q0 + qw];
    if (q0 + qw + 8 < b) qs1 = q_scale[q0 + qw + 8];
  }
  tc_mma::cp_wait<0>();
  tc_mma::fence_async_smem();
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");  // the consumers only

  // acc[4 j + 2 h + c]: query qw + 8 h, row 8 j + 2 (lane % 4) + c of the
  // sub-tile (tc_mma::wgmma_64x64).
  typename Op::Acc acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0;
  constexpr int NL = KC > 0 ? KC : 1;
  Key l0[NL], l1[NL];  // KC: this thread's lists of its two queries
  Key t0 = K::filler(), t1 = K::filler();  // and their filters
#pragma unroll
  for (int i = 0; i < NL; ++i) l0[i] = l1[i] = K::filler();
  // The mask bytes of this thread's rows 8 j + 2 (lane % 4) + {0, 1} of the
  // sub-tile, loaded with its first chunk; 1 where set, 0 past the bank.
  // Over int8 also their scales (0 past the bank).
  unsigned short mb[8];
  float2 es[Op::SCALED ? 8 : 1];

  for (int s = 0; s < steps; ++s) {
    const int kc = s % kc_n, slot = s % STAGES;
    const int sub = (s / kc_n) * RB;
    if (!DOTS && kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tile_base + sub + 8 * j + 2 * (lane & 3);
        mb[j] = r + 1 < n ? *reinterpret_cast<const unsigned short*>(mask + r)
                          : (r < n ? mask[r] : 0);
        if constexpr (Op::SCALED)
          es[j] = r + 1 < n ? *reinterpret_cast<const float2*>(e_scale + r)
                            : make_float2(r < n ? e_scale[r] : 0.0f, 0.0f);
      }
    }
    tc_mma::mbar_wait(full + 8 * slot, (s / STAGES) & 1);
    const uint32_t a0 = q_addr + kc * (TQB * 128) + wg * (64 * 128);
    const uint32_t b0 = ring_addr + slot * CHUNK;
    if (kc == 0) tc_mma::wg_fence();  // the epilogue touched acc
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      tc_mma::wgmma_64x64(acc, tc_mma::desc_sw128(a0 + 32 * ks),
                          tc_mma::desc_sw128(b0 + 32 * ks), kc != 0 || ks != 0);
    tc_mma::wg_commit();
    // A sub-tile's chunks chain on the tensor cores: wait only for the
    // previous chunk's products, and release its slot; after the last
    // chunk, wait for all and release this one.
    if (kc > 0) {
      tc_mma::wg_wait<1>();
      __syncwarp();
      if (lane == 0) tc_mma::mbar_arrive(empty + 8 * ((s - 1) % STAGES));
    }
    if (kc != kc_n - 1) continue;
    tc_mma::wg_wait<0>();
    tc_mma::wg_fence_operands(acc);
    __syncwarp();
    if (lane == 0) tc_mma::mbar_arrive(empty + 8 * slot);  // this warp is done with it

    // The epilogue of sub-tile `sub`.
    if constexpr (DOTS) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int gq = q0 + qw + 8 * ((x >> 1) & 1);
        const int r = sub + 8 * (x >> 2) + 2 * (lane & 3) + (x & 1);
        if (gq < b && r < rows_here) out_v[(size_t)gq * n + tile_base + r] = acc[x];
      }
      continue;
    }
    if (KC == 0) {
      t0 = lists[qw * k + k - 1];
      t1 = lists[(qw + 8) * k + k - 1];
    }
    if constexpr (WIDE) {
      // The value words of this thread's 16 rows for each of its two
      // queries, and which reach the filters' words; of those, the keys
      // that beat the filters join the lists or the buffers.
      int w0[16], w1[16];
      unsigned pass0 = 0, pass1 = 0;
      const int tw0 = (int)(t0 >> 32), tw1 = (int)(t1 >> 32);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int j = x >> 1, c = x & 1;
        const int r = sub + 8 * j + 2 * (lane & 3) + c;
        const bool valid = ((mb[j] >> (8 * c)) & 0xFF) != 0;
        if constexpr (Op::SCALED) {
          const float esc = c ? es[j].y : es[j].x;
          w0[x] = policy.word(acc[4 * j + c], qs0, esc);
          w1[x] = policy.word(acc[4 * j + 2 + c], qs1, esc);
        } else {
          w0[x] = policy.word(acc[4 * j + c]);
          w1[x] = policy.word(acc[4 * j + 2 + c]);
        }
        if (r < rows_here && valid) {
          pass0 |= (unsigned)(w0[x] >= tw0) << x;
          pass1 |= (unsigned)(w1[x] >= tw1) << x;
        }
      }
      const int rl = sub + 2 * (lane & 3);  // the row of x: rl + 8 (x / 2) + x % 2
      while (pass0) {
        const int x = __ffs(pass0) - 1;
        pass0 &= pass0 - 1;
        const Key key = K::key(pick16(w0, x), rl + 8 * (x >> 1) + (x & 1));
        if (!(key > t0)) continue;
        if (KC > 0) reg_insert(l0, key);
        else cand[qw * RB + atomicAdd(cnt + qw, 1)] = key;
      }
      while (pass1) {
        const int x = __ffs(pass1) - 1;
        pass1 &= pass1 - 1;
        const Key key = K::key(pick16(w1, x), rl + 8 * (x >> 1) + (x & 1));
        if (!(key > t1)) continue;
        if (KC > 0) reg_insert(l1, key);
        else cand[(qw + 8) * RB + atomicAdd(cnt + qw + 8, 1)] = key;
      }
    } else {
      // The keys of this thread's 16 rows for each of its two queries, and
      // which beat the filters.  Only this short loop indexes acc, so it
      // unrolls and acc stays in registers.
      int key0[16], key1[16];
      unsigned pass0 = 0, pass1 = 0;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int j = x >> 1, c = x & 1;
        const int r = sub + 8 * j + 2 * (lane & 3) + c;
        const bool valid = ((mb[j] >> (8 * c)) & 0xFF) != 0;
        if constexpr (Op::SCALED) {
          const float esc = c ? es[j].y : es[j].x;
          key0[x] = policy.make(acc[4 * j + c], qs0, esc, valid, r);
          key1[x] = policy.make(acc[4 * j + 2 + c], qs1, esc, valid, r);
        } else {
          key0[x] = policy.make(acc[4 * j + c], valid, r);
          key1[x] = policy.make(acc[4 * j + 2 + c], valid, r);
        }
        if (r < rows_here) {  // past the tile: never a candidate
          pass0 |= (unsigned)(key0[x] > t0) << x;
          pass1 |= (unsigned)(key1[x] > t1) << x;
        }
      }
      while (pass0) {
        const int x = __ffs(pass0) - 1;
        pass0 &= pass0 - 1;
        const int key = pick16(key0, x);
        if (KC > 0) reg_insert(l0, key);
        else cand[qw * RB + atomicAdd(cnt + qw, 1)] = key;
      }
      while (pass1) {
        const int x = __ffs(pass1) - 1;
        pass1 &= pass1 - 1;
        const int key = pick16(key1, x);
        if (KC > 0) reg_insert(l1, key);
        else cand[(qw + 8) * RB + atomicAdd(cnt + qw + 8, 1)] = key;
      }
    }
    if (KC > 0) {
      // The next sub-tile's filters: a key must beat this thread's own
      // k-th best, and the quad's bound x, the least of its four lanes'
      // ceil(k / 4)-th best: at least k keys of the tile lie at or above x.
      t0 = max(reg_kth(l0, k), quad_min(reg_kth(l0, (k + 3) >> 2)));
      t1 = max(reg_kth(l1, k), quad_min(reg_kth(l1, (k + 3) >> 2)));
      continue;
    }
    // The warp filled its queries' buffers alone and merges them without
    // waiting for the block.
    __syncwarp();
    const int mine = lane < QPW ? cnt[warp * QPW + lane] : 0;
    unsigned busy = __ballot_sync(tile_select::FULL, mine > 0);  // one bit a query
    while (busy) {
      const int qq = warp * QPW + __ffs(busy) - 1;
      busy &= busy - 1;
      const int c = cnt[qq];
      Key* buf = cand + qq * RB;
      const Key x0 = lane < c ? buf[lane] : K::filler();
      const Key x1 = lane + 32 < c ? buf[lane + 32] : K::filler();
      __syncwarp();  // buf is the merge's scratch
      tile_select::merge_pair(lists + qq * k, k, x0, x1, K::filler(), buf, lane);
    }
    __syncwarp();
    if (lane < QPW) cnt[warp * QPW + lane] = 0;
    __syncwarp();
  }
  if constexpr (DOTS) return;
  if (KC > 0) {
    // The four lists of each query (one per lane of its quad) into cand,
    // then each query's first k of their 64 keys.
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      cand[qw * RB + (lane & 3) * NL + i] = l0[i];
      cand[(qw + 8) * RB + (lane & 3) * NL + i] = l1[i];
    }
    __syncwarp();
  }
  for (int qq = warp * QPW; qq < (warp + 1) * QPW; ++qq) {
    const int gq = q0 + qq;
    if (gq >= b) break;
    if (KC > 0) {
      // 4 NL keys a query: past them (NL < 16), fillers.
      Key x0 = cand[qq * RB + lane];
      Key x1 = 32 + lane < 4 * NL ? cand[qq * RB + 32 + lane] : K::filler();
      tile_select::sort64_desc(x0, x1, lane);
      if (lane < k) {
        const size_t o = ((size_t)gq * tiles + tile) * k + lane;
        policy.decode(x0, tile_base, out_v + o, out_i + o);
      }
      continue;
    }
    const Key* L = lists + qq * k;
    for (int j = lane; j < k; j += 32) {
      const size_t o = ((size_t)gq * tiles + tile) * k + j;
      policy.decode(L[j], tile_base, out_v + o, out_i + o);
    }
  }
