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
// bytes-per-FLOP balance point, so the bound is the matrix rate. What
// holds the kernel back from it is latency: one block of 8 warps per SM,
// each warp issuing dependent ldmatrix -> mma.sync pairs, a __syncthreads
// per weight step, and the halo that every block computes again.
//
// What the design does about it: one block per (row, time tile). The tile
// and its halo (the chain's receptive field, 45 positions each side on the
// medium voice) stay in shared memory for the whole chain, so device memory
// sees one read of x per resblock and one write of the result. A block
// whose tile starts past its row's length only writes zeros. Two bodies:
//  - bfloat16 (mrf_block_tc, the serving precision): the MRF chain of
//    tc_common.cuh (mrf_chain_tc, shared with fused_upsample_mrf.cu), every
//    conv an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in,
//    f32 sums) over position-major windows with rows of round16(C) + 8
//    bf16. A dilated tap is a row shift of the A operand. The weights (1.4
//    MB in bf16 at C=128, far over the 227 KB a block may hold) stream
//    from L2 into two shared buffers with cp.async, 64 input channels of
//    one tap per step, double-buffered. Each conv computes only the rows
//    the rest of its resblock still reads, so the last conv of a resblock
//    computes just the tile. At C=128 a 96-position tile fits (w = 186
//    window rows: 12 x 8 GEMM tiles, all the block's warps hold). The
//    window is loaded from x at each resblock, transposed to
//    position-major with reads along T; the output is written along T.
//  - float32 (mrf_block, parity precision): f32 FMAs on the CUDA cores over
//    channel-major windows; the weights are streamed from L2 per conv as
//    vector loads shared by the lanes of a warp, and each thread keeps a
//    4-channel x 8-position register tile of f32 accumulators.
#include "mrf_common.cuh"
#include "tc_common.cuh"

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

// Weight rows (input channels) the bf16 body stages per GEMM step: at
// C = 128, half a tap, so the two weight buffers take 34,816 bytes and a
// 96-position tile fits (whole taps would leave room for 64).
constexpr int kStepRows = 64;

// Shared-memory layout of the bf16 body, in bf16 elements; every region
// starts on 16 bytes. ops/cuda/vocoder.py::mrf_smem_bytes_tc mirrors it.
struct MrfTcLayout {
  int cp, ldc, w, kw_rows;
  size_t a0, a1, h, xs, wb, wb_stride, bytes;
};

PT_HD MrfTcLayout mrf_tc_layout(int c, int tile, int halo) {
  MrfTcLayout L;
  L.cp = (c + 15) / 16 * 16;
  L.ldc = L.cp + 8;
  L.w = tile + 2 * halo;
  size_t o = 0;
  L.a0 = o;
  o += (size_t)(L.w + 16) * L.ldc;  // + 16 rows: a tile's reads past the range
  L.a1 = o;
  o += (size_t)(L.w + 16) * L.ldc;
  L.h = o;
  o += (size_t)L.w * L.ldc;
  L.xs = o;
  o += (size_t)tile * L.ldc;
  L.wb = o;
  L.kw_rows = L.cp < kStepRows ? L.cp : kStepRows;
  L.wb_stride = (size_t)L.kw_rows * L.ldc;
  o += 2 * L.wb_stride;
  L.bytes = 2 * o;
  return L;
}

// 0 if the bf16 body can run this tile in smem_bytes, else -3.
PT_HD int mrf_tc_check(int c, int tile, int halo, int smem_bytes) {
  if (c % 4 || tile < 1 || halo < 0) return -3;
  const MrfTcLayout L = mrf_tc_layout(c, tile, halo);
  if ((L.w + 15) / 16 * (L.cp / 16) > kWarps * kMI) return -3;
  return (size_t)smem_bytes < L.bytes ? -3 : 0;
}

PT_DEVICE void mrf_block_tc(const pt_bf16* __restrict__ x, const int* __restrict__ lengths,
                            const pt_bf16* __restrict__ wm, const float* __restrict__ bm, pt_bf16* __restrict__ out,
                            int c, int t_len, int tile, int halo, const MrfPlan& plan, int bx, int by, char* smem) {
  const MrfTcLayout L = mrf_tc_layout(c, tile, halo);
  const int w = L.w, ldc = L.ldc;
  const int b = by;
  const int t0 = bx * tile;
  const int n_out = min(tile, t_len - t0);  // positions this block writes
  const int len = min(PT_LDG(lengths + b), t_len);
  const pt_bf16 zero = from_f<pt_bf16>(0.f);
  pt_bf16* orow = out + (size_t)b * c * t_len + t0;
  if (t0 >= len) {  // past the row's end the output is zero
    PT_THREADS(tid) {
      for (int e = tid; e < c * n_out; e += kThreads) {
        const int ch = e / n_out;
        orow[(size_t)ch * t_len + (e - ch * n_out)] = zero;
      }
    }
    return;
  }
  const int org = t0 - halo;  // global position of window row 0
  const int v_lo = max(0, -org), v_hi = max(0, min(w, len - org));

  pt_bf16* base = reinterpret_cast<pt_bf16*>(smem);
  pt_bf16* a0 = base + L.a0;
  pt_bf16* h = base + L.h;
  pt_bf16* xs = base + L.xs;
  // zero everything: padded channels, weight columns and xs start at zero
  PT_THREADS(tid) {
    for (size_t e = tid; e < L.bytes / 16; e += kThreads) zero16(smem + 16 * e);
  }
  PT_SYNC();

  // the stage input, read again from x (L2) at each resblock: a thread
  // takes two channels of one position, neighbouring threads neighbouring
  // positions, so the reads run along T
  const pt_bf16* xrow = x + (size_t)b * c * t_len;
  const ChainTc m{{a0, base + L.a1}, h, xs, base + L.wb, L.wb_stride, L.kw_rows, c, L.cp, ldc, w, halo, tile,
                  v_lo, v_hi};
  mrf_chain_tc(plan, m, wm, bm, [&](int tid) {
    for (int e = tid; e < (c / 2) * w; e += kThreads) {
      const int cq = e / w, i = e - cq * w;
      const bool ok = i >= v_lo && i < v_hi;
      for (int q = 0; q < 2; ++q) {
        const int ch = 2 * cq + q;
        const pt_bf16 xv = ok ? xrow[(size_t)ch * t_len + org + i] : zero;
        h[(size_t)i * ldc + ch] = xv;
        a0[(size_t)i * ldc + ch] = ok ? from_f<pt_bf16>(lrelu(to_f(xv), 0.1f)) : zero;
      }
    }
  });

  // the mean over resblocks, read position-major, written along T
  const float n_res = (float)plan.n_res;
  PT_THREADS(tid) {
    for (int e = tid; e < c * n_out; e += kThreads) {
      const int ch = e / n_out, j = e - ch * n_out;
      orow[(size_t)ch * t_len + j] = from_f<pt_bf16>(to_f(xs[(size_t)j * ldc + ch]) / n_res);
    }
  }
}

}  // namespace pt

#ifndef PT_HOST_EMULATION
// float32: the CUDA-core body
__global__ void __launch_bounds__(pt::kThreads)
    mrf_fused_kernel(const float* x, const int* lengths, const float* wm, const float* bm, float* out, int c,
                     int t_len, int tile, int halo, int margin, pt::MrfPlan plan) {
  extern __shared__ __align__(16) char smem[];
  pt::mrf_block<float>(x, lengths, wm, bm, out, c, t_len, tile, halo, margin, plan, blockIdx.x, blockIdx.y, smem);
}

// bfloat16: the tensor-core body (one block per SM, up to 255 registers)
__global__ void __launch_bounds__(pt::kThreads, 1)
    mrf_fused_tc_kernel(const pt_bf16* x, const int* lengths, const pt_bf16* wm, const float* bm, pt_bf16* out,
                        int c, int t_len, int tile, int halo, pt::MrfPlan plan) {
  extern __shared__ __align__(16) char smem[];
  pt::mrf_block_tc(x, lengths, wm, bm, out, c, t_len, tile, halo, plan, blockIdx.x, blockIdx.y, smem);
}

template <typename Kernel, typename... Args>
static int launch(Kernel kernel, dim3 grid, int smem_bytes, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, pt::kThreads, smem_bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Returns 0 or a cudaError_t (-1: bad plan, -2: bad dtype, -3: the bf16
// layout does not fit smem_bytes or the warps' tiles).
extern "C" int pt_mrf_fused(const void* x, const void* lengths, const void* wm, const void* bm, void* out, int batch,
                            int c, int t_len, int tile, int halo, int margin, int dtype, const int* plan_ints,
                            int n_plan, int smem_bytes, void* stream) {
  pt::MrfPlan plan;
  if (!pt::parse_plan(plan_ints, n_plan, &plan)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((t_len + tile - 1) / tile, batch);
  const int* len = (const int*)lengths;
  const float* bias = (const float*)bm;
  if (dtype == 0)
    return launch(mrf_fused_kernel, grid, smem_bytes, s, (const float*)x, len, (const float*)wm, bias, (float*)out, c,
                  t_len, tile, halo, margin, plan);
  if (dtype == 1) {
    if (int rc = pt::mrf_tc_check(c, tile, halo, smem_bytes)) return rc;
    return launch(mrf_fused_tc_kernel, grid, smem_bytes, s, (const pt_bf16*)x, len, (const pt_bf16*)wm, bias,
                  (pt_bf16*)out, c, t_len, tile, halo, plan);
  }
  return -2;
}
#endif
