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
// whose tile starts past its row's length only writes zeros. One body,
// mrf_block_tc, a template on the element type, runs the MRF chain of
// tc_common.cuh (mrf_chain_tc, shared with fused_upsample_mrf.cu): every
// conv an implicit GEMM of warpgroup products (f32 sums in registers; N =
// round16(C) rounded up to a power of two) over position-major windows.
// A is loaded into registers with ldmatrix, so a dilated tap is a row
// shift of the A rows. The weights (1.4 MB in bf16 at C=128, far over the
// 227 KB a block may hold) flow from L2 through a ring of 3-8 shared
// stages, each filled by bulk copies of the Tensor Memory Accelerator that
// complete on an mbarrier; the stages are in the kernel layout the wgmma
// descriptor reads (K-major core matrices of 8 rows x 16 bytes), made once
// per weight tensor by the wrapper. Two warpgroups each own 64-row output
// tiles; each conv computes only the rows the rest of its resblock still
// reads, so the last conv of a resblock computes just the tile. The
// wrapper picks the tile that costs the fewest products per SM over the
// grid. The window is loaded from x at each resblock, transposed to
// position-major with reads along T; the output is written along T.
//  - bfloat16 (the serving precision): wgmma m64nNk16; windows of rows of
//    round16(C) + 8 bf16 for the two activated conv inputs and the
//    residual stream; stages of up to 64 input channels of one tap at
//    C=128 (16 KB). At C=128 a tile of up to 96 positions fits (w = 186
//    window rows: 3 output tiles on the widest conv).
//  - float32 (parity precision, TF32 off): what bounds it on this card is
//    float32 accuracy on the tensor cores. One TF32 product keeps 11 bits
//    of each operand (about three decimal digits), and the CUDA cores' 67
//    TFLOP/s of float32 is an eighth of TF32's 495. So each product is
//    3xTF32 (tc_common.cuh): three wgmma m64nNk8 a unit of 8 channels,
//    A_hi B_hi + A_hi B_lo + A_lo B_hi, which keeps about 21 bits at a
//    third of TF32's rate (165 TFLOP/s, the bound the smoke states). The
//    weights' hi and lo planes are split once by the wrapper (two bulk
//    copies a stage, 16 input channels of both planes at C=128, 16 KB);
//    A's are split in registers as ldmatrix loads it. A float32 window
//    row is 528 bytes at C=128 (round16(C) + 4 floats), twice a bf16 one,
//    so shared memory is what limits the tile: the conv input is
//    activated on load (mask, leaky ReLU and split in registers, from the
//    residual stream itself), so no activated windows are kept, and each
//    conv updates the residual stream in place after a barrier between
//    the two warpgroups. The windows are then h, resblock "1"'s inner
//    output and the resblock sum: at C=128 (resblock "2") a tile of up to
//    128 positions fits beside three ring stages.
#include "mrf_common.cuh"
#include "tc_common.cuh"

namespace pt {

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

// Shared-memory layout of the float32 body, in bytes: the ring's
// barriers, its weight stages (a piece's hi plane, then its lo plane),
// then the windows, rows of round16(C) + 4 floats: the residual stream h
// and, for resblock "1", the inner conv output b (w rows each), and the
// resblock sum xs (tile rows). The conv inputs are activated on load, so
// there are no activated windows. ops/cuda/vocoder.py::mrf_tf32_layout
// mirrors it.
struct MrfTf32Layout {
  int cp, np, ldc, w, step_rows, taps, slot_bytes, n_slots;
  size_t bar, ring, h, b, xs, bytes;
};

PT_HD MrfTf32Layout mrf_tf32_layout(int c, int tile, int halo, int rb1) {
  MrfTf32Layout L;
  L.cp = (c + 15) / 16 * 16;
  L.np = npad(L.cp);
  L.ldc = L.cp + Elem<float>::kPad;
  L.w = tile + 2 * halo;
  L.step_rows = L.np ? tf32_step_rows(L.cp, L.np) : 8;
  L.taps = 1;
  L.slot_bytes = 2 * L.step_rows * L.np * 4;
  const size_t row = (size_t)L.ldc * 4;
  const size_t windows = ((rb1 ? 2 : 1) * (size_t)L.w + tile) * row;
  L.n_slots = ring_slots(windows, L.slot_bytes);
  L.bar = 0;
  L.ring = kBarBytes;
  L.h = L.ring + (size_t)L.n_slots * L.slot_bytes;
  L.b = L.h + L.w * row;
  L.xs = L.b + (rb1 ? L.w * row : 0);
  L.bytes = L.xs + tile * row;
  return L;
}

// The layout of the body of element type E.
template <typename E>
PT_HD auto mrf_layout(int c, int tile, int halo, int rb1) {
  if constexpr (kF32<E>)
    return mrf_tf32_layout(c, tile, halo, rb1);
  else
    return mrf_tc_layout(c, tile, halo);
}

// 0 if the body of element type E can run this tile in smem_bytes, else -3.
template <typename E>
PT_HD int mrf_tc_check(int c, int tile, int halo, int rb1, int smem_bytes) {
  if (c % 4 || tile < 1 || halo < 0) return -3;
  const auto L = mrf_layout<E>(c, tile, halo, rb1);
  if (!L.np || (L.w + 63) / 64 > kGroups * mt_per_group(L.np)) return -3;
  return (size_t)smem_bytes < L.bytes || L.bytes > (size_t)kSmemLimit ? -3 : 0;
}

// The chain's weight stream: conv i's k taps, (cp, np) slices of the
// kernel layout k_max taps apart, in stages of piece_bytes (float32: of
// each plane; the lo plane is lo bytes past the hi plane).
template <typename E>
struct MrfStream {
  static constexpr int kPlanes = Elem<E>::kPlanes;
  const char* w;
  const MrfPlan* plan;
  int tap_bytes, piece_bytes;
  size_t lo;
  PT_HD SegInfo operator()(int seg) const {
    return {w + (size_t)seg * plan->k_max * tap_bytes, plan->k[seg] * tap_bytes, piece_bytes, lo};
  }
  PT_HD int total() const {
    int n = 0;
    for (int r = 0, conv = 0; r < plan->n_res; ++r)
      for (int j = 0; j < plan->n_steps[r]; ++j, ++conv) n += (plan->k[conv] * tap_bytes + piece_bytes - 1) / piece_bytes;
    return n;
  }
};

// wk: the packed weights in the kernel layout (ops/cuda/vocoder.py::
// tc_weights): per conv and tap, K-major core matrices of 8 rows x 16
// bytes, zero-padded to (cp, np): bf16 (cp / 8, np / 8, 8, 8); float32 a
// hi and a lo plane (2, ..., cp / 4, np / 8, 8, 4) of tf32 values.
template <typename E, int N>
PT_DEVICE void mrf_block_tc(const E* __restrict__ x, const int* __restrict__ lengths, const E* __restrict__ wk,
                            const float* __restrict__ bm, E* __restrict__ out, int c, int t_len, int tile, int halo,
                            const MrfPlan& plan, int bx, int by, char* smem) {
  const auto L = mrf_layout<E>(c, tile, halo, plan.rb1);
  const int w = L.w, ldc = L.ldc;
  const int b = by;
  const int t0 = bx * tile;
  const int n_out = min(tile, t_len - t0);  // positions this block writes
  const int len = min(PT_LDG(lengths + b), t_len);
  const E zero = from_f<E>(0.f);
  E* orow = out + (size_t)b * c * t_len + t0;
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

  const size_t win = L.ring + (size_t)L.n_slots * L.slot_bytes;  // the first window
  E* a0;  // bf16: the conv inputs a0, a1; float32: resblock "1"'s inner output
  E* a1 = nullptr;
  if constexpr (kF32<E>) {
    a0 = reinterpret_cast<E*>(smem + L.b);
  } else {
    a0 = reinterpret_cast<E*>(smem + L.a0);
    a1 = reinterpret_cast<E*>(smem + L.a1);
  }
  E* h = reinterpret_cast<E*>(smem + L.h);
  E* xs = reinterpret_cast<E*>(smem + L.xs);
  // zero the windows: padded channels and xs start at zero
  PT_CTHREADS(tid) {
    for (size_t e = tid; e < (L.bytes - win) / 16; e += kThreads) zero16(smem + win + 16 * e);
  }
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  Ring ring{smem + L.ring, L.slot_bytes, L.n_slots, bars, bars + L.n_slots};
  const int tap_bytes = L.cp * L.np * (int)sizeof(E);
  const MrfStream<E> stream{reinterpret_cast<const char*>(wk), &plan, tap_bytes, L.slot_bytes / Elem<E>::kPlanes,
                            (size_t)plan_convs(plan) * plan.k_max * tap_bytes};
  if (!ring_split(ring, stream)) return;  // the producer warpgroup streams the weights

  // the stage input, read again from x (L2) at each resblock: a thread
  // takes two channels of one position, neighbouring threads neighbouring
  // positions, so the reads run along T
  const E* xrow = x + (size_t)b * c * t_len;
  const ChainTc<E> m{{a0, a1}, h, xs, L.step_rows / Elem<E>::kUnitCh, L.taps, c, L.cp, ldc, w,
                     halo, tile, v_lo, v_hi};
  mrf_chain_tc<E, N>(plan, m, ring, stream, bm, [&](int tid) {
    const int n = (c / 2) * w;
    for (int e0 = tid; e0 < n; e0 += kBatch * kThreads) {
      E xv[kBatch][2];
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
        if constexpr (!kF32<E>) st_pair(a0 + (size_t)i * ldc + 2 * cq, lrelu(x0, 0.1f), lrelu(x1, 0.1f));
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
        if (e < c * n_out) orow[(size_t)ch * t_len + j] = from_f<E>(v[k] / n_res);
      }
    }
  }
}

}  // namespace pt

#ifndef PT_HOST_EMULATION
// One instantiation per element type and product width N (one block per
// SM: two consumer warpgroups and a producer warpgroup)
template <typename E, int N>
__global__ void __launch_bounds__(pt::kTcThreads, 1)
    mrf_fused_tc_kernel(const E* x, const int* lengths, const E* wk, const float* bm, E* out, int c, int t_len,
                        int tile, int halo, pt::MrfPlan plan) {
  extern __shared__ __align__(16) char smem[];
  pt::mrf_block_tc<E, N>(x, lengths, wk, bm, out, c, t_len, tile, halo, plan, blockIdx.x, blockIdx.y, smem);
}

template <typename Kernel, typename... Args>
static int launch(Kernel kernel, dim3 grid, int threads, int smem_bytes, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem_bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename E>
static int launch_tc(const pt::MrfPlan& plan, dim3 grid, int smem_bytes, cudaStream_t s, const void* x,
                     const int* len, const void* wm, const float* bias, void* out, int c, int t_len, int tile,
                     int halo) {
  if (int rc = pt::mrf_tc_check<E>(c, tile, halo, plan.rb1, smem_bytes)) return rc;
  int rc = -3;
  PT_WITH_WIDTH(pt::mrf_layout<E>(c, tile, halo, plan.rb1).np,
                rc = launch(mrf_fused_tc_kernel<E, N>, grid, pt::kTcThreads, smem_bytes, s, (const E*)x, len,
                            (const E*)wm, bias, (E*)out, c, t_len, tile, halo, plan),
                rc = -3);
  return rc;
}

// Returns 0 or a cudaError_t (-1: bad plan, -2: bad dtype, -3: the layout
// does not fit smem_bytes or the warpgroups' tiles). wm is the packed
// weights in the kernel layout of the dtype (ops/cuda/vocoder.py::
// tc_weights), on 16 bytes.
extern "C" int pt_mrf_fused(const void* x, const void* lengths, const void* wm, const void* bm, void* out, int batch,
                            int c, int t_len, int tile, int halo, int dtype, const int* plan_ints, int n_plan,
                            int smem_bytes, void* stream) {
  pt::MrfPlan plan;
  if (!pt::parse_plan(plan_ints, n_plan, &plan)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((t_len + tile - 1) / tile, batch);
  const int* len = (const int*)lengths;
  const float* bias = (const float*)bm;
  if (dtype == 0) return launch_tc<float>(plan, grid, smem_bytes, s, x, len, wm, bias, out, c, t_len, tile, halo);
  if (dtype == 1) return launch_tc<pt_bf16>(plan, grid, smem_bytes, s, x, len, wm, bias, out, c, t_len, tile, halo);
  return -2;
}
#endif
