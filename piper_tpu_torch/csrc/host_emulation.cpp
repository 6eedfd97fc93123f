// Host build of the two CUDA kernels, for checking their index arithmetic
// on a machine without a GPU (tests/test_torch_kernel_emulation.py,
// tests/test_torch_wgmma_emulation.py, tests/test_torch_launch_config.py):
//
//   g++ -O2 -std=c++17 -shared -fPIC -DPT_HOST_EMULATION host_emulation.cpp -o libemu.so
//
// With PT_HOST_EMULATION the kernels' bodies (mrf_block_tc,
// stage_block_tc, in float32 and bf16) run one block at a time, phase by
// phase over all threads of the block (see mrf_common.cuh); their
// warpgroup phases run group by group, with ldmatrix, wgmma (bf16 and
// tf32), cvt.rna.tf32.f32, the mbarriers and the bulk copy emulated from
// the PTX ISA (tc_common.cuh). The entry points take the same arguments as
// pt_mrf_fused / pt_fused_upsample_mrf, less the stream, and refuse what
// those refuse (-3: a layout that does not fit); -4 is a fault of the
// emulated instructions (emu_fault() says which); bf16 buffers hold raw
// 16-bit patterns.
#define PT_HOST_EMULATION 1
#include <vector>

#include "fused_upsample_mrf.cu"
#include "mrf_fused.cu"

static void emu_reset(char* smem, size_t bytes) {
  pt::g_smem = smem;
  pt::g_smem_bytes = bytes;
  pt::g_fault = nullptr;
  for (int g = 0; g < pt::kGroups; ++g) {
    pt::g_mma[g].clear();
    pt::g_mma_groups[g].clear();
    pt::g_mma_open[g] = 0;
    pt::g_mma_fenced[g] = false;
  }
}

template <typename Body>
static int run_blocks(int n_x, int batch, int smem_bytes, Body body) {
  std::vector<char> smem(smem_bytes);
  emu_reset(smem.data(), smem.size());
  for (int by = 0; by < batch; ++by)
    for (int bx = 0; bx < n_x; ++bx) {
      body(bx, by, smem.data());
      for (int g = 0; g < pt::kGroups; ++g)
        if (!pt::g_mma[g].empty()) pt::fault("wgmma: a block ended with products that never retired");
      if (pt::g_fault) return -4;
    }
  return 0;
}

extern "C" const char* emu_fault() { return pt::g_fault ? pt::g_fault : ""; }

template <typename E>
static int emu_mrf(const void* x, const void* lengths, const void* wm, const void* bm, void* out, int batch, int c,
                   int t_len, int tile, int halo, const pt::MrfPlan& plan, int smem_bytes) {
  if (int rc = pt::mrf_tc_check<E>(c, tile, halo, plan.rb1, smem_bytes)) return rc;
  const int n_x = (t_len + tile - 1) / tile;
  int rc = -3;
  PT_WITH_WIDTH(pt::mrf_layout<E>(c, tile, halo, plan.rb1).np, rc = run_blocks(n_x, batch, smem_bytes, [&](int bx, int by, char* smem) {
    pt::mrf_block_tc<E, N>((const E*)x, (const int*)lengths, (const E*)wm, (const float*)bm, (E*)out, c, t_len, tile,
                           halo, plan, bx, by, smem);
  }), rc = -3);
  return rc;
}

extern "C" int emu_mrf_fused(const void* x, const void* lengths, const void* wm, const void* bm, void* out,
                             int batch, int c, int t_len, int tile, int halo, int dtype, const int* plan_ints,
                             int n_plan, int smem_bytes) {
  pt::MrfPlan plan;
  if (!pt::parse_plan(plan_ints, n_plan, &plan)) return -1;
  if (dtype == 0) return emu_mrf<float>(x, lengths, wm, bm, out, batch, c, t_len, tile, halo, plan, smem_bytes);
  if (dtype == 1) return emu_mrf<pt_bf16>(x, lengths, wm, bm, out, batch, c, t_len, tile, halo, plan, smem_bytes);
  return -2;
}

template <typename E>
static int emu_stage(const void* x, const void* lengths, const void* wt, const void* bt, const void* wm,
                     const void* bm, const void* wpost, void* out, int batch, const pt::StageArgs& s,
                     const pt::MrfPlan& plan, int smem_bytes) {
  if (int rc = pt::tc_check<E>(s, plan.rb1, smem_bytes)) return rc;
  const int n_out = s.v * s.u * s.u_in, n_x = (n_out + s.tile - 1) / s.tile;
  int rc = -3;
  PT_WITH_WIDTH(pt::stage_layout<E>(s, plan.rb1).np, rc = run_blocks(n_x, batch, smem_bytes, [&](int bx, int by, char* smem) {
    pt::stage_block_tc<E, N>((const E*)x, (const int*)lengths, (const E*)wt, (const float*)bt, (const E*)wm,
                             (const float*)bm, (const E*)wpost, (E*)out, s, plan, bx, by, smem);
  }), rc = -3);
  return rc;
}

static bool stage_args(const int* args, int n_args, pt::StageArgs* s) {
  if (n_args != 12) return false;
  *s = pt::StageArgs{args[0], args[1], args[2], args[3], args[4], args[5],
                     args[6], args[7], args[8], args[9], args[10], args[11]};
  return true;
}

extern "C" int emu_fused_upsample_mrf(const void* x, const void* lengths, const void* wt, const void* bt,
                                      const void* wm, const void* bm, const void* wpost, void* out, int batch,
                                      const int* args, int n_args, int dtype, const int* plan_ints, int n_plan,
                                      int smem_bytes) {
  pt::MrfPlan plan;
  pt::StageArgs s;
  if (!pt::parse_plan(plan_ints, n_plan, &plan) || !stage_args(args, n_args, &s)) return -1;
  if (dtype == 0) return emu_stage<float>(x, lengths, wt, bt, wm, bm, wpost, out, batch, s, plan, smem_bytes);
  if (dtype == 1) return emu_stage<pt_bf16>(x, lengths, wt, bt, wm, bm, wpost, out, batch, s, plan, smem_bytes);
  return -2;
}

// The bodies' shared-memory layouts, as ops/cuda/vocoder.py mirrors them
// (bf16: mrf_tc_layout, fused_tc_layout; float32: mrf_tf32_layout,
// fused_tf32_layout): out receives the fields in declaration order;
// returns their count.
template <size_t K>
static int put(const long long (&v)[K], long long* out) {
  for (size_t i = 0; i < K; ++i) out[i] = v[i];
  return (int)K;
}

extern "C" int emu_mrf_tc_layout(int c, int tile, int halo, long long* out) {
  const pt::MrfTcLayout L = pt::mrf_tc_layout(c, tile, halo);
  return put({L.cp, L.np, L.ldc, L.w, L.step_rows, L.taps, L.slot_bytes, L.n_slots, (long long)L.bar,
              (long long)L.ring, (long long)L.a0, (long long)L.a1, (long long)L.h, (long long)L.xs,
              (long long)L.bytes},
             out);
}

extern "C" int emu_mrf_tf32_layout(int c, int tile, int halo, int rb1, long long* out) {
  const pt::MrfTf32Layout L = pt::mrf_tf32_layout(c, tile, halo, rb1);
  return put({L.cp, L.np, L.ldc, L.w, L.step_rows, L.taps, L.slot_bytes, L.n_slots, (long long)L.bar,
              (long long)L.ring, (long long)L.h, (long long)L.b, (long long)L.xs, (long long)L.bytes},
             out);
}

extern "C" int emu_fused_tc_layout(const int* args, int n_args, long long* out) {
  pt::StageArgs s;
  if (!stage_args(args, n_args, &s)) return -1;
  const pt::TcLayout L = pt::tc_layout(s);
  return put({L.cp,           L.np,           L.ldc,          L.cip,           L.ldi,
              L.w,            L.xs_w,         L.n_fr,         L.in_rows,       L.step_rows_t,
              L.step_rows_c,  L.taps_t,       L.taps_c,       L.slot_bytes,    L.n_slots,
              (long long)L.bar, (long long)L.ring, (long long)L.a0, (long long)L.a1, (long long)L.h,
              (long long)L.y,   (long long)L.xs,   (long long)L.in, (long long)L.bytes},
             out);
}

extern "C" int emu_fused_tf32_layout(const int* args, int n_args, int rb1, long long* out) {
  pt::StageArgs s;
  if (!stage_args(args, n_args, &s)) return -1;
  const pt::Tf32Layout L = pt::tf32_layout(s, rb1);
  return put({L.cp,           L.np,           L.ldc,          L.cip,           L.ldi,
              L.w,            L.xs_w,         L.n_fr,         L.in_rows,       L.step_rows_t,
              L.step_rows_c,  L.taps_t,       L.taps_c,       L.slot_bytes,    L.n_slots,
              (long long)L.bar, (long long)L.ring, (long long)L.h, (long long)L.b, (long long)L.y,
              (long long)L.xs,  (long long)L.in,   (long long)L.bytes},
             out);
}

template <int N>
static void probe_product(const pt_bf16* as, uint64_t desc, int flags, float* d) {
  pt::Regs<pt::Acc<N>> acc;
  pt::Regs<pt::U4> fa;
  for (int t = 0; t < pt::kThreads; ++t)
    for (int i = 0; i < N / 2; ++i) acc[t].x[i] = 0.f;
  PT_GROUP_WARPS(0, wp) {
    pt::Regs<const pt_bf16*> pa;
    PT_LANES(wp, tid) {
      const int l = tid & 31;
      pa[tid] = as + (size_t)((wp & 3) * 16 + (l & 7) + ((l >> 3) & 1) * 8) * 16 + (l >> 4) * 8;
    }
    pt::ldsm_x4(fa, pa, wp);
  }
  if (!(flags & 1)) pt::wgmma_fence(0);
  pt::wgmma<N>(acc, fa, desc, 0);
  pt::wgmma_commit(0);
  if (flags & 2) fa[5].x[0] ^= 1;  // an A register written before the product retired
  pt::wgmma_wait<0>(0);
  for (int w = 0; w < 4; ++w)
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < N / 2; ++i) {
        const int row = 16 * w + (l >> 2) + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
        d[row * N + col] = acc[w * 32 + l].x[i];
      }
}

// One warpgroup product through the emulated instructions, for checking
// them against a plain matrix product: warpgroup 0 loads A (64 x 16 bf16,
// row-major) from shared memory with ldmatrix, B (16 x n bf16) is read
// through `desc` (its start address relative to b_image's place in shared
// memory, on 1024 bytes), D (64 x n f32, row-major) starts at zero.
// b_image reaches shared memory by one bulk copy of b_bytes on an mbarrier
// expecting expect_bytes. flags: 1 leaves out the wgmma.fence, 2 writes an
// A register before the product retires. Returns 0, -4 on a fault
// (emu_fault()), or -1 for an unsupported n or image.
extern "C" int emu_wgmma_probe(int n, const void* a, const void* b_image, int b_bytes, unsigned long long desc,
                               int expect_bytes, int flags, float* d) {
  constexpr int kB = 4096, kImage = 65536;
  std::vector<char> smem(kB + kImage);
  emu_reset(smem.data(), smem.size());
  char* base = smem.data();
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  pt_bf16* as = reinterpret_cast<pt_bf16*>(base + 16);
  if (b_bytes > kImage || b_bytes < 0) return -1;
  std::memcpy(as, a, 64 * 16 * 2);
  pt::mbar_init(bar, 1);
  pt::mbar_arrive_expect_tx(bar, (uint32_t)expect_bytes);
  pt::bulk_copy(base + kB, b_image, (uint32_t)b_bytes, bar);
  pt::mbar_wait(bar, 0);
  int rc = 0;
  PT_WITH_WIDTH(n, probe_product<N>(as, desc + (kB >> 4), flags, d), rc = -1);
  if (rc == 0 && pt::g_fault) rc = -4;
  return rc;
}

template <int N>
static void probe_tf32_product(const float* as, uint64_t desc, int flags, float* d) {
  pt::Regs<pt::Acc<N>> acc;
  pt::Regs<pt::U4> fa, lo;
  for (int t = 0; t < pt::kThreads; ++t)
    for (int i = 0; i < N / 2; ++i) acc[t].x[i] = 0.f;
  PT_GROUP_WARPS(0, wp) {
    pt::Regs<const pt_bf16*> pa;
    PT_LANES(wp, tid) {
      const int l = tid & 31;
      pa[tid] = reinterpret_cast<const pt_bf16*>(as + (size_t)((wp & 3) * 16 + (l & 7) + ((l >> 3) & 1) * 8) * 8 +
                                                 (l >> 4) * 4);
    }
    pt::ldsm_x4(fa, pa, wp);
    if (!(flags & 4))
      PT_LANES(wp, tid) {
        for (int i = 0; i < 4; ++i) pt::tf32_split(pt::bits_f(fa[tid].x[i]), fa[tid].x[i], lo[tid].x[i]);
      }
  }
  if (!(flags & 1)) pt::wgmma_fence(0);
  pt::wgmma_tf32<N>(acc, fa, desc, 0);
  pt::wgmma_commit(0);
  if (flags & 2) fa[5].x[0] ^= 1 << 13;  // an A register written before the product retired
  pt::wgmma_wait<0>(0);
  for (int w = 0; w < 4; ++w)
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < N / 2; ++i) {
        const int row = 16 * w + (l >> 2) + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
        d[row * N + col] = acc[w * 32 + l].x[i];
      }
}

// One tf32 warpgroup product through the emulated instructions: warpgroup
// 0 loads A (64 x 8 float, row-major) from shared memory with ldmatrix as
// the float32 bodies do and rounds it with cvt.rna.tf32.f32, B (8 x n
// tf32 patterns) is read through `desc` (its start address relative to
// b_image's place in shared memory, on 1024 bytes), D (64 x n f32,
// row-major) starts at zero. b_image reaches shared memory by one bulk
// copy of b_bytes on an mbarrier expecting expect_bytes. flags: 1 leaves
// out the wgmma.fence, 2 writes an A register before the product retires,
// 4 leaves out the rounding. Returns 0, -4 on a fault (emu_fault()), or -1
// for an unsupported n or image.
extern "C" int emu_tf32_probe(int n, const void* a, const void* b_image, int b_bytes, unsigned long long desc,
                              int expect_bytes, int flags, float* d) {
  constexpr int kB = 4096, kImage = 65536;
  std::vector<char> smem(kB + kImage);
  emu_reset(smem.data(), smem.size());
  char* base = smem.data();
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  float* as = reinterpret_cast<float*>(base + 16);
  if (b_bytes > kImage || b_bytes < 0) return -1;
  std::memcpy(as, a, 64 * 8 * 4);
  pt::mbar_init(bar, 1);
  pt::mbar_arrive_expect_tx(bar, (uint32_t)expect_bytes);
  pt::bulk_copy(base + kB, b_image, (uint32_t)b_bytes, bar);
  pt::mbar_wait(bar, 0);
  int rc = 0;
  PT_WITH_WIDTH(n, probe_tf32_product<N>(as, desc + (kB >> 4), flags, d), rc = -1);
  if (rc == 0 && pt::g_fault) rc = -4;
  return rc;
}

// cvt.rna.tf32.f32 and the 3xTF32 split of n floats, as the float32
// bodies split A: hi[i], lo[i] (32-bit patterns).
extern "C" void emu_tf32_split(const float* v, int n, uint32_t* hi, uint32_t* lo) {
  for (int i = 0; i < n; ++i) pt::tf32_split(v[i], hi[i], lo[i]);
}
