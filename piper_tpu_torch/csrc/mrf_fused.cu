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
// holds a kernel back from it on Hopper is feeding the tensor cores:
// wgmma is the only instruction that reaches their full rate, and it
// wants its weights in shared memory ahead of time, without a block-wide
// barrier per weight step.
//
// What the design does about it: one block per (row, time tile). The tile
// and its halo (the chain's receptive field, 45 positions each side on the
// medium voice) stay in shared memory for the whole chain, so device memory
// sees one read of x per resblock and one write of the result. A block
// whose tile starts past its row's length only writes zeros. Two bodies:
//  - bfloat16 (mrf_block_tc, the serving precision): the MRF chain of
//    tc_common.cuh (mrf_chain_tc, shared with fused_upsample_mrf.cu), every
//    conv an implicit GEMM of warpgroup products (wgmma m64nNk16, bf16 in,
//    f32 sums in registers; N = round16(C) rounded up to a power of two)
//    over position-major windows with rows of round16(C) + 8 bf16. A is
//    loaded into registers with ldmatrix, so a dilated tap is a row shift
//    of the A rows. The weights (1.4 MB in bf16 at C=128, far over the
//    227 KB a block may hold) flow from L2 through a ring of 3-4 shared
//    stages (64 input channels of one tap each at C=128), each filled by
//    one bulk copy of the Tensor Memory Accelerator that completes on an
//    mbarrier; the stages are in the kernel layout the wgmma descriptor
//    reads (K-major 8 x 8 core matrices), made once per weight tensor by
//    the wrapper. Two warpgroups each own 64-row output tiles; each conv
//    computes only the rows the rest of its resblock still reads, so the
//    last conv of a resblock computes just the tile. At C=128 a tile of
//    up to 96 positions fits (w = 186 window rows: 3 output tiles on the
//    widest conv); the wrapper picks the tile that costs the fewest
//    products per SM over the grid. The window is loaded from x at each
//    resblock, transposed to position-major with reads along T; the
//    output is written along T.
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

// Shared-memory layout of the bf16 body, in bytes: the ring's barriers,
// its weight stages, then the windows (every region on 16 bytes; the
// windows are zeroed at the start of a block). ops/cuda/vocoder.py::
// mrf_tc_layout mirrors it.
struct MrfTcLayout {
  int cp, np, ldc, w, step_rows, taps, slot_bytes, n_slots;
  size_t bar, ring, a0, a1, h, xs, bytes;
};

PT_HD MrfTcLayout mrf_tc_layout(int c, int tile, int halo) {
  MrfTcLayout L;
  L.cp = (c + 15) / 16 * 16;
  L.np = npad(L.cp);
  L.ldc = L.cp + 8;
  L.w = tile + 2 * halo;
  L.step_rows = L.np ? step_rows(L.cp, L.np) : 16;
  L.taps = L.np ? stage_taps(L.cp, L.np) : 1;
  L.slot_bytes = L.taps * L.step_rows * L.np * 2;
  const size_t row = (size_t)L.ldc * 2;
  const size_t windows = (3 * (size_t)L.w + tile) * row;
  L.n_slots = ring_slots(windows, L.slot_bytes);
  L.bar = 0;
  L.ring = kBarBytes;
  L.a0 = L.ring + (size_t)L.n_slots * L.slot_bytes;
  L.a1 = L.a0 + L.w * row;
  L.h = L.a1 + L.w * row;
  L.xs = L.h + L.w * row;
  L.bytes = L.xs + tile * row;
  return L;
}

// 0 if the bf16 body can run this tile in smem_bytes, else -3.
PT_HD int mrf_tc_check(int c, int tile, int halo, int smem_bytes) {
  if (c % 4 || tile < 1 || halo < 0) return -3;
  const MrfTcLayout L = mrf_tc_layout(c, tile, halo);
  if (!L.np || (L.w + 63) / 64 > kGroups * mt_per_group(L.np)) return -3;
  return (size_t)smem_bytes < L.bytes || L.bytes > (size_t)kSmemLimit ? -3 : 0;
}

// The chain's weight stream: conv i's k taps, (cp, np) slices of the
// kernel layout k_max taps apart, in stages of slot_bytes.
struct MrfStream {
  const char* w;
  const MrfPlan* plan;
  int tap_bytes, piece_bytes;
  PT_HD SegInfo operator()(int seg) const {
    return {w + (size_t)seg * plan->k_max * tap_bytes, plan->k[seg] * tap_bytes, piece_bytes};
  }
  PT_HD int total() const {
    int n = 0;
    for (int r = 0, conv = 0; r < plan->n_res; ++r)
      for (int j = 0; j < plan->n_steps[r]; ++j, ++conv) n += (plan->k[conv] * tap_bytes + piece_bytes - 1) / piece_bytes;
    return n;
  }
};

// wk: the packed weights in the kernel layout (ops/cuda/vocoder.py::
// tc_weight_layout): per conv and tap, (cp / 8, np / 8, 8, 8) bf16, the
// K-major 8 x 8 core matrices the wgmma descriptor reads, zero-padded.
template <int N>
PT_DEVICE void mrf_block_tc(const pt_bf16* __restrict__ x, const int* __restrict__ lengths,
                            const pt_bf16* __restrict__ wk, const float* __restrict__ bm, pt_bf16* __restrict__ out,
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
    PT_CTHREADS(tid) {
      for (int e = tid; e < c * n_out; e += kThreads) {
        const int ch = e / n_out;
        orow[(size_t)ch * t_len + (e - ch * n_out)] = zero;
      }
    }
    return;
  }
  const int org = t0 - halo;  // global position of window row 0
  const int v_lo = max(0, -org), v_hi = max(0, min(w, len - org));

  pt_bf16* a0 = reinterpret_cast<pt_bf16*>(smem + L.a0);
  pt_bf16* h = reinterpret_cast<pt_bf16*>(smem + L.h);
  pt_bf16* xs = reinterpret_cast<pt_bf16*>(smem + L.xs);
  // zero the windows: padded channels and xs start at zero
  PT_CTHREADS(tid) {
    for (size_t e = tid; e < (L.bytes - L.a0) / 16; e += kThreads) zero16(smem + L.a0 + 16 * e);
  }
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  Ring ring{smem + L.ring, L.slot_bytes, L.n_slots, bars, bars + L.n_slots};
  const int tap_bytes = L.cp * L.np * 2;
  const MrfStream stream{reinterpret_cast<const char*>(wk), &plan, tap_bytes, L.slot_bytes};
  if (!ring_split(ring, stream)) return;  // the producer warpgroup streams the weights

  // the stage input, read again from x (L2) at each resblock: a thread
  // takes two channels of one position, neighbouring threads neighbouring
  // positions, so the reads run along T
  const pt_bf16* xrow = x + (size_t)b * c * t_len;
  const ChainTc m{{a0, reinterpret_cast<pt_bf16*>(smem + L.a1)}, h, xs, L.step_rows / 16, L.taps, c, L.cp, ldc, w,
                  halo, tile, v_lo, v_hi};
  mrf_chain_tc<N>(plan, m, ring, stream, bm, [&](int tid) {
    const int n = (c / 2) * w;
    for (int e0 = tid; e0 < n; e0 += kBatch * kThreads) {
      pt_bf16 xv[kBatch][2];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // every load of the batch first, then the stores
        const int e = e0 + k * kThreads, cq = e / w, i = e - cq * w;
        const bool ok = e < n && i >= v_lo && i < v_hi;
        for (int q = 0; q < 2; ++q) xv[k][q] = ok ? xrow[(size_t)(2 * cq + q) * t_len + org + i] : zero;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kThreads, cq = e / w, i = e - cq * w;
        if (e >= n) break;
        const float x0 = to_f(xv[k][0]), x1 = to_f(xv[k][1]);
        st_pair(h + (size_t)i * ldc + 2 * cq, x0, x1);
        st_pair(a0 + (size_t)i * ldc + 2 * cq, lrelu(x0, 0.1f), lrelu(x1, 0.1f));
      }
    }
  });

  // the mean over resblocks, read position-major, written along T
  const float n_res = (float)plan.n_res;
  PT_CTHREADS(tid) {
    for (int e0 = tid; e0 < c * n_out; e0 += kBatch * kThreads) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kThreads, ch = e / n_out, j = e - ch * n_out;
        if (e < c * n_out) v[k] = to_f(xs[(size_t)j * ldc + ch]);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kThreads, ch = e / n_out, j = e - ch * n_out;
        if (e < c * n_out) orow[(size_t)ch * t_len + j] = from_f<pt_bf16>(v[k] / n_res);
      }
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

// bfloat16: the tensor-core body, one instantiation per product width N
// (one block per SM: two consumer warpgroups and a producer warpgroup)
template <int N>
__global__ void __launch_bounds__(pt::kTcThreads, 1)
    mrf_fused_tc_kernel(const pt_bf16* x, const int* lengths, const pt_bf16* wk, const float* bm, pt_bf16* out,
                        int c, int t_len, int tile, int halo, pt::MrfPlan plan) {
  extern __shared__ __align__(16) char smem[];
  pt::mrf_block_tc<N>(x, lengths, wk, bm, out, c, t_len, tile, halo, plan, blockIdx.x, blockIdx.y, smem);
}

template <typename Kernel, typename... Args>
static int launch(Kernel kernel, dim3 grid, int threads, int smem_bytes, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem_bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Returns 0 or a cudaError_t (-1: bad plan, -2: bad dtype, -3: the bf16
// layout does not fit smem_bytes or the warpgroups' tiles). For bf16, wm
// is the packed weights in the kernel layout (ops/cuda/vocoder.py::
// tc_weight_layout), on 16 bytes.
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
    return launch(mrf_fused_kernel, grid, pt::kThreads, smem_bytes, s, (const float*)x, len, (const float*)wm, bias, (float*)out, c,
                  t_len, tile, halo, margin, plan);
  if (dtype == 1) {
    if (int rc = pt::mrf_tc_check(c, tile, halo, smem_bytes)) return rc;
    int rc = -3;
    PT_WITH_WIDTH(pt::mrf_tc_layout(c, tile, halo).np,
                  rc = launch(mrf_fused_tc_kernel<N>, grid, pt::kTcThreads, smem_bytes, s, (const pt_bf16*)x, len,
                              (const pt_bf16*)wm, bias, (pt_bf16*)out, c, t_len, tile, halo, plan),
                  rc = -3);
    return rc;
  }
  return -2;
}
#endif
