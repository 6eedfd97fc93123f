// fused_upsample_mrf: one whole HiFiGAN upsample stage in one pass.
//
// Replaces the Pallas TPU kernel
// piper_tpu/ops/pallas/vocoder.py::fused_upsample_mrf (body
// _fused_stage_kernel, pallas_call at line 693).
//
// What it computes, per row b and output sample t (true time at this
// stage's resolution, u_out = u * u_in samples per frame):
//   y  = polyphase ConvTranspose1d of mask(lrelu_0.1(x)) + bias  (u phases x
//        nq taps, tables from models/vits/generator.py::_tm_phase_plan)
//   y  = mask(y); then the MRF stage exactly as in mrf_fused.cu
//   post: wave = mask(tanh(conv_post_k7(mask(lrelu_0.01(y)))))  (C -> 1)
// The input is interleaved time-major (u_in = 1: rows = C_in) or the
// phase-plane output of the previous fused stage (u_in > 1: row
// p*C_in + c, frame f holds sample u_in*f + p). The output keeps the JAX
// function's plane layout: (B, u_out*C_out, V) planes, or (B, u_out, V)
// waveform planes with post.
//
// What bounds it on an H100: arithmetic. Stage 1 of the medium voice costs
// about 17.8 MFLOP per input frame against 2*128 bytes read and 2*8*64
// written, stage 2 (with conv_post) about 17.9 MFLOP against 2*8*64 read
// and 2*32 written: both far above the balance point, so the matrix rate
// is the bound.
//
// What the design does about it: one block per (row, tile of output
// samples). The TPU kernel computes in the phase-plane layout because
// Mosaic has no lane shuffle; here the block works in interleaved true
// time and uses the plane layout only as the index map of its input reads
// and output writes. The input window (with the transposed conv's taps and
// the chain's halo: 45 + 3 samples each side on stage 2) is loaded once;
// the transposed conv's output, the residual stream and the conv inputs
// stay in shared memory through the whole chain and conv_post, so device
// memory sees one read of x and one write of the planes.
//
// One body, stage_block_tc, a template on the element type: every conv
// runs on the tensor cores as an implicit GEMM of warpgroup products
// (tc_common.cuh::gemm, A loaded into registers with ldmatrix from
// position-major windows ([position][channel], rows padded to 16 channels
// + 16 bytes so ldmatrix is free of bank conflicts), B from shared memory
// through a matrix descriptor). A dilated tap is a row shift of the A
// rows. The weights, in the kernel layout the descriptor reads (made once
// per weight tensor by the wrapper), flow from L2 through a ring of 3-8
// shared stages, each filled by bulk copies of the Tensor Memory
// Accelerator completing on an mbarrier. The polyphase transposed conv is
// one GEMM per output phase over the window's input frames, its rows
// scattered to the phase's positions. The MRF chain is the one
// mrf_fused.cu runs (tc_common.cuh::mrf_chain_tc): each conv computes only
// the rows the rest of the chain still needs (the halo shrinks by the
// conv's reach), and its epilogue adds the bias, rounds and adds the
// residual. The rounding points are the plain version's. conv_post (C ->
// 1) stays on the CUDA cores. A block whose tile starts at or past its
// row's length writes zeros and returns: every output there is zero (xs
// adds nothing past the length, and conv_post's output is masked), so the
// bits are those of the full work.
//  - bfloat16 (the serving precision): wgmma m64nNk16; the chain keeps
//    two activated conv-input windows beside the residual stream.
//  - float32 (parity precision, TF32 off): as in mrf_fused.cu, what bounds
//    it is float32 accuracy on the tensor cores, and the design is the
//    same: 3xTF32 products (three wgmma m64nNk8 a unit of 8 channels on
//    the weights' hi and lo planes, A split in registers), conv inputs
//    activated on load from the residual stream, which each conv updates
//    in place. Its windows are the input frames, the transposed conv's
//    output y, the residual stream h, resblock "1"'s inner output and the
//    resblock sum, in rows of round16(C) + 4 floats.
#include "mrf_common.cuh"
#include "tc_common.cuh"

namespace pt {

struct StageArgs {
  int c_in, c_out, v;        // channels in/out, frames of input and output
  int u, u_in, q0, nq;       // upsample, input planes, polyphase taps
  int post, k_post;          // conv_post epilogue
  int tile, halo, hpost;     // output samples per block, total halo, post halo
};

// Shared-memory layout of the bf16 body, in bytes: the ring's barriers,
// its weight stages, then the windows (every region on 16 bytes; the
// windows are zeroed at the start of a block). ops/cuda/vocoder.py::
// fused_tc_layout mirrors it.
struct TcLayout {
  int cp, np, ldc, cip, ldi, w, xs_w, n_fr, in_rows, step_rows_t, step_rows_c, taps_t, taps_c, slot_bytes, n_slots;
  size_t bar, ring, a0, a1, h, y, xs, in, bytes;
};

PT_HD TcLayout tc_layout(const StageArgs& s) {
  TcLayout L;
  L.cp = (s.c_out + 15) / 16 * 16;
  L.np = npad(L.cp);
  L.ldc = L.cp + 8;  // 16*(odd) bytes per row: ldmatrix rows hit distinct banks
  L.cip = (s.c_in + 15) / 16 * 16;
  L.ldi = L.cip + 8;
  L.w = s.tile + 2 * s.halo;
  L.xs_w = s.tile + 2 * s.hpost;
  L.n_fr = (L.w + s.u - 2) / s.u + 1;  // most input frames a window spans
  L.in_rows = L.n_fr + s.nq - 1;
  L.step_rows_t = L.np ? step_rows(L.cip, L.np) : 16;
  L.step_rows_c = L.np ? step_rows(L.cp, L.np) : 16;
  L.taps_t = L.np ? stage_taps(L.cip, L.np) : 1;
  L.taps_c = L.np ? stage_taps(L.cp, L.np) : 1;
  const int rows_t = L.taps_t * L.step_rows_t, rows_c = L.taps_c * L.step_rows_c;
  L.slot_bytes = (rows_t > rows_c ? rows_t : rows_c) * L.np * 2;
  const size_t row = (size_t)L.ldc * 2;
  const size_t windows = (4 * (size_t)L.w + L.xs_w) * row + (size_t)L.in_rows * L.ldi * 2;
  L.n_slots = ring_slots(windows, L.slot_bytes);
  L.bar = 0;
  L.ring = kBarBytes;
  L.a0 = L.ring + (size_t)L.n_slots * L.slot_bytes;
  L.a1 = L.a0 + L.w * row;
  L.h = L.a1 + L.w * row;
  L.y = L.h + L.w * row;
  L.xs = L.y + L.w * row;
  L.in = L.xs + L.xs_w * row;
  L.bytes = L.in + (size_t)L.in_rows * L.ldi * 2;
  return L;
}

// Shared-memory layout of the float32 body, in bytes: the ring's
// barriers, its weight stages (a piece's hi plane, then its lo plane),
// then the windows, rows of round16(C) + 4 floats: the residual stream h,
// resblock "1"'s inner output b, the transposed conv's output y (w rows
// each; b only for resblock "1"), the resblock sum xs (tile + 2 hpost
// rows) and the input frames (rows of round16(C_in) + 4 floats). The conv
// inputs are activated on load. ops/cuda/vocoder.py::fused_tf32_layout
// mirrors it.
struct Tf32Layout {
  int cp, np, ldc, cip, ldi, w, xs_w, n_fr, in_rows, step_rows_t, step_rows_c, taps_t, taps_c, slot_bytes, n_slots;
  size_t bar, ring, h, b, y, xs, in, bytes;
};

PT_HD Tf32Layout tf32_layout(const StageArgs& s, int rb1) {
  Tf32Layout L;
  L.cp = (s.c_out + 15) / 16 * 16;
  L.np = npad(L.cp);
  L.ldc = L.cp + Elem<float>::kPad;
  L.cip = (s.c_in + 15) / 16 * 16;
  L.ldi = L.cip + Elem<float>::kPad;
  L.w = s.tile + 2 * s.halo;
  L.xs_w = s.tile + 2 * s.hpost;
  L.n_fr = (L.w + s.u - 2) / s.u + 1;  // most input frames a window spans
  L.in_rows = L.n_fr + s.nq - 1;
  L.step_rows_t = L.np ? tf32_step_rows(L.cip, L.np) : 8;
  L.step_rows_c = L.np ? tf32_step_rows(L.cp, L.np) : 8;
  L.taps_t = L.taps_c = 1;
  L.slot_bytes = 2 * (L.step_rows_t > L.step_rows_c ? L.step_rows_t : L.step_rows_c) * L.np * 4;
  const size_t row = (size_t)L.ldc * 4;
  const size_t windows = ((rb1 ? 3 : 2) * (size_t)L.w + L.xs_w) * row + (size_t)L.in_rows * L.ldi * 4;
  L.n_slots = ring_slots(windows, L.slot_bytes);
  L.bar = 0;
  L.ring = kBarBytes;
  L.h = L.ring + (size_t)L.n_slots * L.slot_bytes;
  L.b = L.h + L.w * row;
  L.y = L.b + (rb1 ? L.w * row : 0);
  L.xs = L.y + L.w * row;
  L.in = L.xs + L.xs_w * row;
  L.bytes = L.in + (size_t)L.in_rows * L.ldi * 4;
  return L;
}

// The layout of the body of element type E.
template <typename E>
PT_HD auto stage_layout(const StageArgs& s, int rb1) {
  if constexpr (kF32<E>)
    return tf32_layout(s, rb1);
  else
    return tc_layout(s);
}

// 0 if the body of element type E can run these arguments in smem_bytes,
// else -3.
template <typename E>
PT_HD int tc_check(const StageArgs& s, int rb1, int smem_bytes) {
  const auto L = stage_layout<E>(s, rb1);
  const int rows = L.w > L.n_fr ? L.w : L.n_fr;
  if (!L.np || (rows + 63) / 64 > kGroups * mt_per_group(L.np)) return -3;
  if (s.c_out % 4 || (size_t)smem_bytes < L.bytes || L.bytes > (size_t)kSmemLimit) return -3;
  return 0;
}

// The block's weight stream: the u polyphase output phases' nq taps
// ((cip, np) slices), then the chain's convs ((cp, np) slices, k_max taps
// apart), each in stages of its own piece bytes (float32: of each plane;
// each tensor's lo plane is lo_t or lo_c bytes past its hi plane).
template <typename E>
struct StageStream {
  static constexpr int kPlanes = Elem<E>::kPlanes;
  const char *wt, *wm;
  const MrfPlan* plan;
  int u, nq, tap_t, piece_t, tap_c, piece_c;
  size_t lo_t, lo_c;
  PT_HD SegInfo operator()(int seg) const {
    if (seg < u) return {wt + (size_t)seg * nq * tap_t, nq * tap_t, piece_t, lo_t};
    const int conv = seg - u;
    return {wm + (size_t)conv * plan->k_max * tap_c, plan->k[conv] * tap_c, piece_c, lo_c};
  }
  PT_HD int total() const {
    int n = u * ((nq * tap_t + piece_t - 1) / piece_t);
    for (int r = 0, conv = 0; r < plan->n_res; ++r)
      for (int j = 0; j < plan->n_steps[r]; ++j, ++conv) n += (plan->k[conv] * tap_c + piece_c - 1) / piece_c;
    return n;
  }
};

// wtk, wmk: the polyphase taps and the packed MRF weights in the kernel
// layout of E (ops/cuda/vocoder.py::tc_weights), K-major core matrices of
// 8 rows x 16 bytes per tap, zero-padded to (cip or cp, np); float32: a
// hi and a lo plane of tf32 values.
template <typename E, int N>
PT_DEVICE void stage_block_tc(const E* __restrict__ x, const int* __restrict__ lengths, const E* __restrict__ wtk,
                              const float* __restrict__ bt, const E* __restrict__ wmk, const float* __restrict__ bm,
                              const E* __restrict__ wpost, E* __restrict__ out, const StageArgs& s,
                              const MrfPlan& plan, int bx, int by, char* smem) {
  const auto L = stage_layout<E>(s, plan.rb1);
  const int c = s.c_out, u_out = s.u * s.u_in, w = L.w, ldc = L.ldc;
  const int xs_off = s.halo - s.hpost;
  const int b = by;
  const int t0 = bx * s.tile;
  const int len = min(PT_LDG(lengths + b), s.v * u_out);
  const int nf = s.tile / u_out;  // frames per tile (tile % u_out == 0)
  const int f0 = t0 / u_out;
  const E zero = from_f<E>(0.f);
  E* orow = out + (size_t)b * (s.post ? 1 : c) * u_out * s.v;
  if (t0 >= len) {  // past the row's end every output is zero
    const int rows = s.post ? 1 : c;
    PT_CTHREADS(tid) {
      for (int e = tid; e < rows * s.tile; e += kThreads) {
        const int ch = e / s.tile, r = e - ch * s.tile;
        const int pl = r / nf, f = r - pl * nf;
        if (f0 + f < s.v) orow[((size_t)pl * rows + ch) * s.v + f0 + f] = zero;
      }
    }
    return;
  }
  const int in_len = min(len / s.u, s.v * s.u_in);  // valid input samples
  const int org = t0 - s.halo;
  const int v_lo = max(0, -org), v_hi = max(0, min(w, len - org));
  const int vb = floor_div(org, s.u);
  const int n_fr = floor_div(org + w - 1, s.u) - vb + 1;
  const int s_lo = vb + s.q0, s_hi = s_lo + n_fr + s.nq - 2;

  const size_t win = L.ring + (size_t)L.n_slots * L.slot_bytes;  // the first window
  E* a[2] = {nullptr, nullptr};  // bf16: the conv inputs; float32: a[0] is resblock "1"'s inner output
  if constexpr (kF32<E>) {
    a[0] = reinterpret_cast<E*>(smem + L.b);
  } else {
    a[0] = reinterpret_cast<E*>(smem + L.a0);
    a[1] = reinterpret_cast<E*>(smem + L.a1);
  }
  E* h = reinterpret_cast<E*>(smem + L.h);
  E* y = reinterpret_cast<E*>(smem + L.y);
  E* xs = reinterpret_cast<E*>(smem + L.xs);
  E* in = reinterpret_cast<E*>(smem + L.in);

  // zero the windows: padded channels stay zero
  PT_CTHREADS(tid) {
    for (size_t e = tid; e < (L.bytes - win) / 16; e += kThreads) zero16(smem + win + 16 * e);
  }
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  Ring ring{smem + L.ring, L.slot_bytes, L.n_slots, bars, bars + L.n_slots};
  const int tap_t = L.cip * L.np * (int)sizeof(E), tap_c = L.cp * L.np * (int)sizeof(E);
  const StageStream<E> stream{reinterpret_cast<const char*>(wtk),
                              reinterpret_cast<const char*>(wmk),
                              &plan,
                              s.u,
                              s.nq,
                              tap_t,
                              L.taps_t * L.step_rows_t * L.np * (int)sizeof(E),
                              tap_c,
                              L.taps_c * L.step_rows_c * L.np * (int)sizeof(E),
                              (size_t)s.u * s.nq * tap_t,
                              (size_t)plan_convs(plan) * plan.k_max * tap_c};
  if (!ring_split(ring, stream)) return;  // the producer warpgroup streams the weights
  // input window: samples [s_lo, s_hi], masked, lrelu_0.1, position-major;
  // read frame-fastest so neighbouring threads read neighbouring frames
  const E* xrow = x + (size_t)b * s.u_in * s.c_in * s.v;
  const int fr_lo = floor_div(s_lo, s.u_in), n_fr_in = floor_div(s_hi, s.u_in) - fr_lo + 1;
  PT_CTHREADS(tid) {
    const int n = s.c_in * s.u_in * n_fr_in;
    for (int e0 = tid; e0 < n; e0 += kBatch * kThreads) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // every load of the batch first, then the stores
        const int e = e0 + k * kThreads, ci = e / (s.u_in * n_fr_in), r = e - ci * (s.u_in * n_fr_in);
        const int p1 = r / n_fr_in, f = fr_lo + (r - p1 * n_fr_in), smp = f * s.u_in + p1;
        v[k] = e < n && smp >= 0 && smp < in_len ? to_f(xrow[((size_t)p1 * s.c_in + ci) * s.v + f]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kThreads, ci = e / (s.u_in * n_fr_in), r = e - ci * (s.u_in * n_fr_in);
        const int p1 = r / n_fr_in, f = fr_lo + (r - p1 * n_fr_in), smp = f * s.u_in + p1;
        if (e < n && smp >= s_lo && smp <= s_hi)
          in[(size_t)(smp - s_lo) * L.ldi + ci] = from_f<E>(lrelu(v[k], 0.1f));
      }
    }
  }
  PT_CSYNC();

  // polyphase transposed conv, one GEMM per output phase p: frame row j
  // (input sample vb + j) reads in rows j + qi; it lands on window row
  // u*(vb + j) + p - org. The phases write disjoint rows, so they need no
  // barrier between them, and phase p's first tile goes to warpgroup
  // p % 2: with one tile a phase, one warpgroup runs a phase while the
  // other runs the next (as far as the ring's stages reach).
  constexpr int kCh = Elem<E>::kUnitCh;
  for (int p = 0; p < s.u; ++p) {
    const Gemm<E> g{in, L.ldi, L.in_rows, 0, n_fr, 1, 0, L.cip / kCh, L.step_rows_t / kCh, L.taps_t, c, s.nq, p};
    gemm<E, N>(g, ring, stream, [&](int j, int col0, const float* v) {
      constexpr int J = kEpiPairs<N>;
      const int i = s.u * (vb + j) + p - org;
      if (i < 0 || i >= w) return;
      const bool ok = org + i >= 0 && org + i < len;
      F2 b[J];
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        if (col0 + 8 * jj < c) b[jj] = ldg_pair(bt + col0 + 8 * jj);
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        if (col0 + 8 * jj >= c) break;
        st_pair(y + (size_t)i * ldc + col0 + 8 * jj, ok ? v[2 * jj] + b[jj].x : 0.f, ok ? v[2 * jj + 1] + b[jj].y : 0.f);
      }
    });
  }
  PT_CSYNC();

  // MRF chain over the transposed conv's output y
  const ChainTc<E> m{{a[0], a[1]}, h, xs, L.step_rows_c / kCh, L.taps_c, c, L.cp, ldc, w, xs_off, L.xs_w, v_lo, v_hi};
  mrf_chain_tc<E, N>(plan, m, ring, stream, bm, [&](int tid) {
    const int n = w * (c / 2);
    for (int e0 = tid; e0 < n; e0 += kBatch * kThreads) {
      F2 yv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {  // every load of the batch first, then the stores
        const int e = e0 + k * kThreads, i = e / (c / 2), cq = e - i * (c / 2);
        if (e < n) yv[k] = ld_pair(y + (size_t)i * ldc + 2 * cq);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kThreads, i = e / (c / 2), cq = e - i * (c / 2);
        if (e >= n) break;
        st_pair(h + (size_t)i * ldc + 2 * cq, yv[k].x, yv[k].y);
        if constexpr (!kF32<E>) {
          const bool ok = i >= v_lo && i < v_hi;
          st_pair(a[0] + (size_t)i * ldc + 2 * cq, ok ? lrelu(yv[k].x, 0.1f) : 0.f, ok ? lrelu(yv[k].y, 0.1f) : 0.f);
        }
      }
    }
  });

  const float n_res = (float)plan.n_res;
  if (!s.post) {
    // write (plane, channel, frame) with the frame fastest: coalesced rows
    PT_CTHREADS(tid) {
      for (int e0 = tid; e0 < c * s.tile; e0 += kBatch * kThreads) {
        float v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = e0 + k * kThreads, ch = e / s.tile, r = e - ch * s.tile, pl = r / nf, f = r - pl * nf;
          if (e < c * s.tile) v[k] = to_f(xs[(size_t)(f * u_out + pl) * ldc + ch]);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = e0 + k * kThreads, ch = e / s.tile, r = e - ch * s.tile, pl = r / nf, f = r - pl * nf;
          if (e < c * s.tile && f0 + f < s.v)
            orow[((size_t)pl * c + ch) * s.v + f0 + f] = from_f<E>(v[k] / n_res);
        }
      }
    }
    return;
  }
  // conv_post: g = mask(lrelu_0.01(E(xs / n_res))) into a window the chain
  // is done with (bf16 a[0], float32 h), then C -> 1 taps on the CUDA cores
  E* gw = kF32<E> ? h : a[0];
  PT_CTHREADS(tid) {
    for (int e = tid; e < L.xs_w * c; e += kThreads) {
      const int j = e / c, ch = e - j * c, i = xs_off + j;
      const float g = lrelu(round_e<E>(to_f(xs[(size_t)j * ldc + ch]) / n_res), 0.01f);
      gw[(size_t)j * ldc + ch] = (i >= v_lo && i < v_hi) ? from_f<E>(g) : zero;
    }
  }
  PT_CSYNC();
  PT_CTHREADS(tid) {
    for (int r = tid; r < s.tile; r += kThreads) {
      int pl = r / nf, f = r - pl * nf;
      int j = f * u_out + pl;
      int t = t0 + j;
      if (f0 + f >= s.v) continue;
      float acc = 0.f;
      for (int kk = 0; kk < s.k_post; ++kk) {
        const E* ar = gw + (size_t)(j + kk) * ldc;
        const E* wp = wpost + kk * c;
#pragma unroll 4
        for (int ch = 0; ch < c; ch += 4) {  // loads in pairs, ahead of the sums (same order)
          const F2 w0 = ld_pair(wp + ch), w1 = ld_pair(wp + ch + 2), g0 = ld_pair(ar + ch), g1 = ld_pair(ar + ch + 2);
          acc = fmaf(w0.x, g0.x, acc);
          acc = fmaf(w0.y, g0.y, acc);
          acc = fmaf(w1.x, g1.x, acc);
          acc = fmaf(w1.y, g1.y, acc);
        }
      }
      orow[(size_t)pl * s.v + f0 + f] = from_f<E>(t < len ? tanhf(acc) : 0.f);
    }
  }
}

}  // namespace pt

#ifndef PT_HOST_EMULATION
// One instantiation per element type and product width N (one block per
// SM: two consumer warpgroups and a producer warpgroup)
template <typename E, int N>
__global__ void __launch_bounds__(pt::kTcThreads, 1)
    fused_stage_tc_kernel(const E* x, const int* lengths, const E* wt, const float* bt, const E* wm, const float* bm,
                          const E* wpost, E* out, pt::StageArgs s, pt::MrfPlan plan) {
  extern __shared__ __align__(16) char smem[];
  pt::stage_block_tc<E, N>(x, lengths, wt, bt, wm, bm, wpost, out, s, plan, blockIdx.x, blockIdx.y, smem);
}

template <typename E>
static int launch_kernel(void (*kernel)(const E*, const int*, const E*, const float*, const E*, const float*,
                                        const E*, E*, pt::StageArgs, pt::MrfPlan),
                         const void* x, const void* lengths, const void* wt, const void* bt, const void* wm,
                         const void* bm, const void* wpost, void* out, int batch, const pt::StageArgs& s,
                         const pt::MrfPlan& plan, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_out = s.v * s.u * s.u_in;
  dim3 grid((n_out + s.tile - 1) / s.tile, batch);
  kernel<<<grid, pt::kTcThreads, smem_bytes, stream>>>((const E*)x, (const int*)lengths, (const E*)wt,
                                                      (const float*)bt, (const E*)wm, (const float*)bm,
                                                      (const E*)wpost, (E*)out, s, plan);
  return (int)cudaGetLastError();
}

template <typename E>
static int launch(const void* x, const void* lengths, const void* wt, const void* bt, const void* wm, const void* bm,
                  const void* wpost, void* out, int batch, const pt::StageArgs& s, const pt::MrfPlan& plan,
                  int smem_bytes, cudaStream_t stream) {
  if (int rc = pt::tc_check<E>(s, plan.rb1, smem_bytes)) return rc;
  int rc = -3;
  PT_WITH_WIDTH(pt::stage_layout<E>(s, plan.rb1).np,
                rc = launch_kernel(fused_stage_tc_kernel<E, N>, x, lengths, wt, bt, wm, bm, wpost, out, batch, s,
                                   plan, smem_bytes, stream),
                rc = -3);
  return rc;
}

// Returns 0 or a cudaError_t (-1: bad plan, -2: bad dtype, -3: the layout
// does not fit smem_bytes or the warpgroups' tiles). wt and wm are in the
// kernel layout of the dtype (ops/cuda/vocoder.py::tc_weights), on 16
// bytes.
extern "C" int pt_fused_upsample_mrf(const void* x, const void* lengths, const void* wt, const void* bt,
                                     const void* wm, const void* bm, const void* wpost, void* out, int batch,
                                     const int* args, int n_args, int dtype, const int* plan_ints, int n_plan,
                                     int smem_bytes, void* stream) {
  pt::MrfPlan plan;
  if (!pt::parse_plan(plan_ints, n_plan, &plan)) return -1;
  if (n_args != 12) return -1;
  pt::StageArgs s{args[0], args[1], args[2], args[3], args[4], args[5],
                  args[6], args[7], args[8], args[9], args[10], args[11]};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, lengths, wt, bt, wm, bm, wpost, out, batch, s, plan, smem_bytes, st);
  if (dtype == 1) return launch<pt_bf16>(x, lengths, wt, bt, wm, bm, wpost, out, batch, s, plan, smem_bytes, st);
  return -2;
}
#endif
