// mrf_fused: one HiFiGAN MRF stage, time-major, in one pass.
//
// Replaces the Pallas TPU kernel piper_tpu/ops/pallas/vocoder.py::mrf_fused
// (body _mrf_kernel, pallas_call at line 286).
//
// What it computes: for each row b and position t of x (B, C, T), the mean
// over resblocks of the resblock output, where each resblock runs its convs
// as  h += conv_kd(mask(lrelu_0.1(h))) + bias  (resblock "1": the convs go
// in (d, 1) pairs with the residual after each pair), every intermediate is
// masked to the row's valid length, and each conv is a dilated "same" conv
// with f32 accumulation. Output rows past lengths[b] are zero, so a batched
// row equals the same row alone.
//
// What bounds it on an H100: arithmetic. A stage-0 position of the medium
// voice (C=128, six convs with k = 3,3,5,5,7,7) costs 2*30*128*128 = 983 kFLOP
// against 2*2*128 bytes of input and output, far above the card's
// bytes-per-FLOP balance point, so the bound is the FMA rate.
//
// What the design does about it: one block per (row, time tile). The tile
// and its halo (the chain's receptive field, 45 positions each side on the
// medium voice) stay in shared memory for the whole chain, so device memory
// sees one read of x per resblock and one write of the result; the
// weights (1.4 MB in bf16 at C=128, far over the 227 KB a block may hold)
// are streamed from L2 per conv as vector loads shared by the lanes of a
// warp. Each thread keeps a 4-channel x 8-position register tile of f32
// accumulators, so one shared-memory read feeds 4 FMAs. Plain FMAs on the
// CUDA cores: the tensor cores (wgmma) and TMA are left for a later kernel.
#include "mrf_common.cuh"

namespace pt {

template <typename T>
PT_DEVICE void mrf_block(const T* __restrict__ x, const int* __restrict__ lengths, const T* __restrict__ wm,
                         const float* __restrict__ bm, T* __restrict__ out, int c, int t_len, int tile, int halo,
                         int margin, const MrfPlan& plan, int bx, int by, char* smem) {
  const int w = tile + 2 * halo;
  const int lda = w + 2 * margin;
  const int b = by;
  const int t0 = bx * tile;
  const int len = min(PT_LDG(lengths + b), t_len);
  const int org = t0 - halo;  // global position of window column 0
  const int v_lo = max(0, -org), v_hi = max(0, min(w, len - org));

  MrfSmem<T> m;
  T* p = reinterpret_cast<T*>(smem);
  m.a = p;
  p += align_elems((size_t)c * lda);
  m.h = p;
  p += align_elems((size_t)c * w);
  m.b = p;
  if (plan.rb1) p += align_elems((size_t)c * w);
  m.xs = p;

  PT_THREADS(tid) {
    for (int e = tid; e < c * lda; e += kThreads) m.a[e] = from_f<T>(0.f);
    for (int e = tid; e < c * tile; e += kThreads) m.xs[e] = from_f<T>(0.f);
  }
  PT_SYNC();

  const T* xrow = x + (size_t)b * c * t_len;
  auto load_h = [&](int tid) {
    for (int e = tid; e < c * w; e += kThreads) {
      int ch = e / w, i = e - ch * w;
      m.h[e] = (i >= v_lo && i < v_hi) ? xrow[(size_t)ch * t_len + org + i] : from_f<T>(0.f);
    }
  };
  mrf_chain(plan, m, c, w, lda, margin, v_lo, v_hi, halo, tile, wm, bm, load_h);

  T* orow = out + (size_t)b * c * t_len;
  const float n_res = (float)plan.n_res;
  PT_THREADS(tid) {
    for (int e = tid; e < c * tile; e += kThreads) {
      int ch = e / tile, j = e - ch * tile;
      if (t0 + j < t_len) orow[(size_t)ch * t_len + t0 + j] = from_f<T>(to_f(m.xs[e]) / n_res);
    }
  }
}

}  // namespace pt

#ifndef PT_HOST_EMULATION
template <typename T>
__global__ void __launch_bounds__(pt::kThreads)
    mrf_fused_kernel(const T* x, const int* lengths, const T* wm, const float* bm, T* out, int c, int t_len, int tile,
                     int halo, int margin, pt::MrfPlan plan) {
  extern __shared__ __align__(16) char smem[];
  pt::mrf_block<T>(x, lengths, wm, bm, out, c, t_len, tile, halo, margin, plan, blockIdx.x, blockIdx.y, smem);
}

template <typename T>
static int launch(const void* x, const void* lengths, const void* wm, const void* bm, void* out, int batch, int c,
                  int t_len, int tile, int halo, int margin, const pt::MrfPlan& plan, int smem_bytes,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mrf_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + tile - 1) / tile, batch);
  mrf_fused_kernel<T><<<grid, pt::kThreads, smem_bytes, stream>>>(
      (const T*)x, (const int*)lengths, (const T*)wm, (const float*)bm, (T*)out, c, t_len, tile, halo, margin, plan);
  return (int)cudaGetLastError();
}

// Returns 0 or a cudaError_t (-1: bad plan, -2: bad dtype).
extern "C" int pt_mrf_fused(const void* x, const void* lengths, const void* wm, const void* bm, void* out, int batch,
                            int c, int t_len, int tile, int halo, int margin, int dtype, const int* plan_ints,
                            int n_plan, int smem_bytes, void* stream) {
  pt::MrfPlan plan;
  if (!pt::parse_plan(plan_ints, n_plan, &plan)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, lengths, wm, bm, out, batch, c, t_len, tile, halo, margin, plan, smem_bytes, s);
  if (dtype == 1)
    return launch<pt_bf16>(x, lengths, wm, bm, out, batch, c, t_len, tile, halo, margin, plan, smem_bytes, s);
  return -2;
}
#endif
