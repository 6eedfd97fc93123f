// Host build of the two CUDA kernels, for checking their index arithmetic
// on a machine without a GPU (tests/test_torch_kernel_emulation.py):
//
//   g++ -O2 -std=c++17 -shared -fPIC -DPT_HOST_EMULATION host_emulation.cpp -o libemu.so
//
// With PT_HOST_EMULATION the kernels' bodies (mrf_block, mrf_block_tc,
// stage_block, stage_block_tc) run one block at a time, phase by phase
// over all threads of the block (see mrf_common.cuh); the tensor-core
// bodies' warp phases run warp by warp, with ldmatrix, mma.sync and
// cp.async computed from their PTX fragment layouts (tc_common.cuh). The
// entry points take the same arguments as pt_mrf_fused /
// pt_fused_upsample_mrf, less the stream, and refuse what those refuse
// (-3: a bf16 layout that does not fit); bf16 buffers hold raw 16-bit
// patterns.
#define PT_HOST_EMULATION 1
#include <vector>

#include "fused_upsample_mrf.cu"
#include "mrf_fused.cu"

template <typename Body>
static void run_blocks(int n_x, int batch, int smem_bytes, Body body) {
  std::vector<char> smem(smem_bytes);
  for (int by = 0; by < batch; ++by)
    for (int bx = 0; bx < n_x; ++bx) body(bx, by, smem.data());
}

extern "C" int emu_mrf_fused(const void* x, const void* lengths, const void* wm, const void* bm, void* out,
                             int batch, int c, int t_len, int tile, int halo, int margin, int dtype,
                             const int* plan_ints, int n_plan, int smem_bytes) {
  pt::MrfPlan plan;
  if (!pt::parse_plan(plan_ints, n_plan, &plan)) return -1;
  const int n_x = (t_len + tile - 1) / tile;
  if (dtype == 0) {
    run_blocks(n_x, batch, smem_bytes, [&](int bx, int by, char* smem) {
      pt::mrf_block<float>((const float*)x, (const int*)lengths, (const float*)wm, (const float*)bm, (float*)out, c,
                           t_len, tile, halo, margin, plan, bx, by, smem);
    });
  } else if (dtype == 1) {
    if (int rc = pt::mrf_tc_check(c, tile, halo, smem_bytes)) return rc;
    run_blocks(n_x, batch, smem_bytes, [&](int bx, int by, char* smem) {
      pt::mrf_block_tc((const pt_bf16*)x, (const int*)lengths, (const pt_bf16*)wm, (const float*)bm, (pt_bf16*)out,
                       c, t_len, tile, halo, plan, bx, by, smem);
    });
  } else {
    return -2;
  }
  return 0;
}

extern "C" int emu_fused_upsample_mrf(const void* x, const void* lengths, const void* wt, const void* bt,
                                      const void* wm, const void* bm, const void* wpost, void* out, int batch,
                                      const int* args, int n_args, int dtype, const int* plan_ints, int n_plan,
                                      int smem_bytes) {
  pt::MrfPlan plan;
  if (!pt::parse_plan(plan_ints, n_plan, &plan)) return -1;
  if (n_args != 14) return -1;
  pt::StageArgs s{args[0], args[1], args[2], args[3],  args[4],  args[5],  args[6],
                  args[7], args[8], args[9], args[10], args[11], args[12], args[13]};
  const int n_out = s.v * s.u * s.u_in, n_x = (n_out + s.tile - 1) / s.tile;
  if (dtype == 0) {
    run_blocks(n_x, batch, smem_bytes, [&](int bx, int by, char* smem) {
      pt::stage_block((const float*)x, (const int*)lengths, (const float*)wt, (const float*)bt,
                             (const float*)wm, (const float*)bm, (const float*)wpost, (float*)out, s, plan, bx, by,
                             smem);
    });
  } else if (dtype == 1) {
    if (int rc = pt::tc_check(s, smem_bytes)) return rc;
    run_blocks(n_x, batch, smem_bytes, [&](int bx, int by, char* smem) {
      pt::stage_block_tc((const pt_bf16*)x, (const int*)lengths, (const pt_bf16*)wt, (const float*)bt,
                         (const pt_bf16*)wm, (const float*)bm, (const pt_bf16*)wpost, (pt_bf16*)out, s, plan, bx,
                         by, smem);
    });
  } else {
    return -2;
  }
  return 0;
}
