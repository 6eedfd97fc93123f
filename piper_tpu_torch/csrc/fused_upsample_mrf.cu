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
// Two bodies:
//  - bfloat16 (stage_block_tc, the serving precision): every conv runs on
//    the tensor cores as an implicit GEMM of warpgroup products
//    (tc_common.cuh::gemm: wgmma m64nNk16, A loaded into registers with
//    ldmatrix from position-major windows ([position][channel], rows
//    padded to 16 channels + 8 so ldmatrix is free of bank conflicts), B
//    from shared memory through a matrix descriptor). A dilated tap is a
//    row shift of the A rows. The weights, in the kernel layout the
//    descriptor reads (made once per weight tensor by the wrapper), flow
//    from L2 through a ring of 3-4 shared stages, each filled by one bulk
//    copy of the Tensor Memory Accelerator completing on an mbarrier. The
//    polyphase transposed conv is one GEMM per output phase over the
//    window's input frames, its rows scattered to the phase's positions.
//    The MRF chain is the one mrf_fused.cu's bf16 body runs
//    (tc_common.cuh::mrf_chain_tc): each conv computes only the rows the
//    rest of the chain still needs (the halo shrinks by the conv's reach),
//    and its epilogue adds the bias, rounds, adds the residual and writes
//    the next conv's masked lrelu input. The rounding points are the plain
//    version's. conv_post (C -> 1) stays on the CUDA cores. A block whose
//    tile starts at or past its row's length writes zeros and returns:
//    every output there is zero (xs adds nothing past the length, and
//    conv_post's output is masked), so the bits are those of the full work.
//  - float32 (stage_block, parity precision): f32 FMAs on the CUDA cores,
//    weights streamed from L2 as in mrf_fused.cu.
#include "mrf_common.cuh"
#include "tc_common.cuh"

namespace pt {

// y[co][i] = mask(bt[co] + sum_qi sum_ci wt[p][qi][ci][co] * in[ci][v + q0 + qi - s_lo])
// for window position i (sample t = org + i, v = floor(t / u), p = t - u*v).
PT_DEVICE void tconv_phase(int tid, const float* in, int ld_in, int s_lo, float* y, int c_in, int c_out, int w,
                           int org, int u, int q0, int nq, int len, const float* wt, const float* bt) {
  using T = float;
  PassMap m = pass_map(tid, c_out);
  if (!m.active) return;
  const int span = m.lanes * kTPer;
  // lanes a multiple of u: all kTPer positions of a thread share a phase
  const bool uniform = (m.lanes % u) == 0;
  for (int base = 0; base < w; base += span) {
    int xi[kTPer], ph[kTPer];
    float acc[kCoPer][kTPer];
    for (int j = 0; j < kTPer; ++j) {
      int i = base + m.lane + m.lanes * j;
      int t = org + (i < w ? i : w - 1);
      int v = floor_div(t, u);
      ph[j] = t - v * u;
      xi[j] = v + q0 - s_lo;
    }
    for (int q = 0; q < kCoPer; ++q) {
      float bv = PT_LDG(bt + m.co0 + q);
      for (int j = 0; j < kTPer; ++j) acc[q][j] = bv;
    }
    for (int qi = 0; qi < nq; ++qi) {
      for (int ci = 0; ci < c_in; ++ci) {
        const T* ir = in + ci * ld_in + qi;
        float xv[kTPer];
        for (int j = 0; j < kTPer; ++j) xv[j] = to_f(ir[xi[j]]);
        if (uniform) {
          float wv[kCoPer];
          load4(wt + ((size_t)(ph[0] * nq + qi) * c_in + ci) * c_out + m.co0, wv);
          for (int q = 0; q < kCoPer; ++q)
            for (int j = 0; j < kTPer; ++j) acc[q][j] = fmaf(wv[q], xv[j], acc[q][j]);
        } else {
          for (int j = 0; j < kTPer; ++j) {
            float wv[kCoPer];
            load4(wt + ((size_t)(ph[j] * nq + qi) * c_in + ci) * c_out + m.co0, wv);
            for (int q = 0; q < kCoPer; ++q) acc[q][j] = fmaf(wv[q], xv[j], acc[q][j]);
          }
        }
      }
    }
    for (int j = 0; j < kTPer; ++j) {
      int i = base + m.lane + m.lanes * j;
      if (i >= w) continue;
      int t = org + i;
      bool valid = t >= 0 && t < len;
      for (int q = 0; q < kCoPer; ++q)
        y[(m.co0 + q) * w + i] = valid ? from_f<T>(acc[q][j]) : from_f<T>(0.f);
    }
  }
}

struct StageArgs {
  int c_in, c_out, v;        // channels in/out, frames of input and output
  int u, u_in, q0, nq;       // upsample, input planes, polyphase taps
  int post, k_post;          // conv_post epilogue
  int tile, halo, hpost;     // output samples per block, total halo, post halo
  int margin, ld_in;         // float32 body: conv-input margin, input-window row length
};

// The float32 body: f32 FMAs on the CUDA cores over channel-major windows.
PT_DEVICE void stage_block(const float* __restrict__ x, const int* __restrict__ lengths,
                           const float* __restrict__ wt, const float* __restrict__ bt, const float* __restrict__ wm,
                           const float* __restrict__ bm, const float* __restrict__ wpost, float* __restrict__ out,
                           const StageArgs& s, const MrfPlan& plan, int bx, int by, char* smem) {
  using T = float;
  const int c = s.c_out, u_out = s.u * s.u_in;
  const int w = s.tile + 2 * s.halo;
  const int lda = w + 2 * s.margin;
  const int xs_w = s.tile + 2 * s.hpost, xs_off = s.halo - s.hpost;
  const int b = by;
  const int t0 = bx * s.tile;
  const int n_out = s.v * u_out;
  const int len = min(PT_LDG(lengths + b), n_out);
  const int in_len = min(len / s.u, s.v * s.u_in);  // valid input samples
  const int org = t0 - s.halo;
  const int v_lo = max(0, -org), v_hi = max(0, min(w, len - org));
  const int s_lo = floor_div(org, s.u) + s.q0;
  const int s_hi = floor_div(org + w - 1, s.u) + s.q0 + s.nq - 1;

  MrfSmem<T> m;
  T* p = reinterpret_cast<T*>(smem);
  m.a = p;
  p += align_elems((size_t)c * lda);
  m.h = p;
  p += align_elems((size_t)c * w);
  m.b = p;
  if (plan.rb1) p += align_elems((size_t)c * w);
  m.xs = p;
  p += align_elems((size_t)c * xs_w);
  T* y = p;
  p += align_elems((size_t)c * w);
  T* in = p;

  // input window: samples [s_lo, s_hi], masked, lrelu_0.1; read frame-fastest
  // so neighbouring threads read neighbouring frames of one plane
  const T* xrow = x + (size_t)b * s.u_in * s.c_in * s.v;
  const int fr_lo = floor_div(s_lo, s.u_in), n_fr = floor_div(s_hi, s.u_in) - fr_lo + 1;
  PT_THREADS(tid) {
    for (int e = tid; e < c * lda; e += kThreads) m.a[e] = from_f<T>(0.f);
    for (int e = tid; e < c * xs_w; e += kThreads) m.xs[e] = from_f<T>(0.f);
    for (int e = tid; e < s.c_in * s.u_in * n_fr; e += kThreads) {
      int ci = e / (s.u_in * n_fr), r = e - ci * (s.u_in * n_fr);
      int p1 = r / n_fr, f = fr_lo + (r - p1 * n_fr);
      int smp = f * s.u_in + p1;
      if (smp < s_lo || smp > s_hi) continue;
      float v = 0.f;
      if (smp >= 0 && smp < in_len) {
        v = to_f(xrow[((size_t)p1 * s.c_in + ci) * s.v + f]);
        v = v >= 0.f ? v : v * 0.1f;
      }
      in[ci * s.ld_in + (smp - s_lo)] = from_f<T>(v);
    }
  }
  PT_SYNC();
  PT_THREADS(tid) { tconv_phase(tid, in, s.ld_in, s_lo, y, s.c_in, c, w, org, s.u, s.q0, s.nq, len, wt, bt); }
  PT_SYNC();

  auto load_h = [&](int tid) {
    for (int e = tid; e < c * w; e += kThreads) m.h[e] = y[e];
  };
  mrf_chain(plan, m, c, w, lda, s.margin, v_lo, v_hi, xs_off, xs_w, wm, bm, load_h);

  const float n_res = (float)plan.n_res;
  const int nf = s.tile / u_out;  // frames per tile (tile % u_out == 0)
  const int f0 = t0 / u_out;
  T* orow = out + (size_t)b * (s.post ? 1 : c) * u_out * s.v;
  if (!s.post) {
    // write (plane, channel, frame) with the frame fastest: coalesced rows
    PT_THREADS(tid) {
      for (int e = tid; e < c * s.tile; e += kThreads) {
        int ch = e / s.tile, r = e - ch * s.tile;
        int pl = r / nf, f = r - pl * nf;
        int j = f * u_out + pl;
        if (f0 + f < s.v)
          orow[((size_t)pl * c + ch) * s.v + f0 + f] = from_f<T>(to_f(m.xs[ch * xs_w + j]) / n_res);
      }
    }
    return;
  }
  // conv_post: g = mask(lrelu_0.01(T(xs / n_res))) into a's data columns
  PT_THREADS(tid) {
    for (int e = tid; e < c * xs_w; e += kThreads) {
      int ch = e / xs_w, j = e - ch * xs_w;
      int i = xs_off + j;
      float g = to_f(from_f<T>(to_f(m.xs[e]) / n_res));
      g = g >= 0.f ? g : g * 0.01f;
      m.a[ch * lda + s.margin + j] = (i >= v_lo && i < v_hi) ? from_f<T>(g) : from_f<T>(0.f);
    }
  }
  PT_SYNC();
  PT_THREADS(tid) {
    for (int r = tid; r < s.tile; r += kThreads) {
      int pl = r / nf, f = r - pl * nf;
      int j = f * u_out + pl;
      int t = t0 + j;
      if (f0 + f >= s.v) continue;
      float acc = 0.f;
      for (int kk = 0; kk < s.k_post; ++kk) {
        const T* ar = m.a + s.margin + j + kk;
        const T* wp = wpost + kk * c;
        for (int ch = 0; ch < c; ++ch) acc = fmaf(to_f(PT_LDG(wp + ch)), to_f(ar[ch * lda]), acc);
      }
      float wave = t < len ? tanhf(acc) : 0.f;
      orow[(size_t)pl * s.v + f0 + f] = from_f<T>(wave);
    }
  }
}

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

// 0 if the bf16 body can run these arguments in smem_bytes, else -3.
PT_HD int tc_check(const StageArgs& s, int smem_bytes) {
  const TcLayout L = tc_layout(s);
  const int rows = L.w > L.n_fr ? L.w : L.n_fr;
  if (!L.np || (rows + 63) / 64 > kGroups * mt_per_group(L.np)) return -3;
  if (s.c_out % 4 || (size_t)smem_bytes < L.bytes || L.bytes > (size_t)kSmemLimit) return -3;
  return 0;
}

// The block's weight stream: the u polyphase output phases' nq taps
// ((cip, np) slices), then the chain's convs ((cp, np) slices, k_max taps
// apart), each in stages of its own piece bytes.
struct StageStream {
  const char *wt, *wm;
  const MrfPlan* plan;
  int u, nq, tap_t, piece_t, tap_c, piece_c;
  PT_HD SegInfo operator()(int seg) const {
    if (seg < u) return {wt + (size_t)seg * nq * tap_t, nq * tap_t, piece_t};
    const int conv = seg - u;
    return {wm + (size_t)conv * plan->k_max * tap_c, plan->k[conv] * tap_c, piece_c};
  }
  PT_HD int total() const {
    int n = u * ((nq * tap_t + piece_t - 1) / piece_t);
    for (int r = 0, conv = 0; r < plan->n_res; ++r)
      for (int j = 0; j < plan->n_steps[r]; ++j, ++conv) n += (plan->k[conv] * tap_c + piece_c - 1) / piece_c;
    return n;
  }
};

// wtk, wmk: the polyphase taps and the packed MRF weights in the kernel
// layout (ops/cuda/vocoder.py::tc_weight_layout), K-major 8 x 8 core
// matrices per tap, zero-padded to (cip or cp, np).
template <int N>
PT_DEVICE void stage_block_tc(const pt_bf16* __restrict__ x, const int* __restrict__ lengths,
                              const pt_bf16* __restrict__ wtk, const float* __restrict__ bt,
                              const pt_bf16* __restrict__ wmk, const float* __restrict__ bm,
                              const pt_bf16* __restrict__ wpost, pt_bf16* __restrict__ out, const StageArgs& s,
                              const MrfPlan& plan, int bx, int by, char* smem) {
  const TcLayout L = tc_layout(s);
  const int c = s.c_out, u_out = s.u * s.u_in, w = L.w, ldc = L.ldc;
  const int xs_off = s.halo - s.hpost;
  const int b = by;
  const int t0 = bx * s.tile;
  const int len = min(PT_LDG(lengths + b), s.v * u_out);
  const int nf = s.tile / u_out;  // frames per tile (tile % u_out == 0)
  const int f0 = t0 / u_out;
  const pt_bf16 zero = from_f<pt_bf16>(0.f);
  pt_bf16* orow = out + (size_t)b * (s.post ? 1 : c) * u_out * s.v;
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

  pt_bf16* a[2] = {reinterpret_cast<pt_bf16*>(smem + L.a0), reinterpret_cast<pt_bf16*>(smem + L.a1)};
  pt_bf16* h = reinterpret_cast<pt_bf16*>(smem + L.h);
  pt_bf16* y = reinterpret_cast<pt_bf16*>(smem + L.y);
  pt_bf16* xs = reinterpret_cast<pt_bf16*>(smem + L.xs);
  pt_bf16* in = reinterpret_cast<pt_bf16*>(smem + L.in);

  // zero the windows: padded channels stay zero
  PT_CTHREADS(tid) {
    for (size_t e = tid; e < (L.bytes - L.a0) / 16; e += kThreads) zero16(smem + L.a0 + 16 * e);
  }
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  Ring ring{smem + L.ring, L.slot_bytes, L.n_slots, bars, bars + L.n_slots};
  const StageStream stream{reinterpret_cast<const char*>(wtk),
                           reinterpret_cast<const char*>(wmk),
                           &plan,
                           s.u,
                           s.nq,
                           L.cip * L.np * 2,
                           L.taps_t * L.step_rows_t * L.np * 2,
                           L.cp * L.np * 2,
                           L.taps_c * L.step_rows_c * L.np * 2};
  if (!ring_split(ring, stream)) return;  // the producer warpgroup streams the weights
  // input window: samples [s_lo, s_hi], masked, lrelu_0.1, position-major;
  // read frame-fastest so neighbouring threads read neighbouring frames
  const pt_bf16* xrow = x + (size_t)b * s.u_in * s.c_in * s.v;
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
          in[(size_t)(smp - s_lo) * L.ldi + ci] = from_f<pt_bf16>(lrelu(v[k], 0.1f));
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
  for (int p = 0; p < s.u; ++p) {
    const Gemm g{in, L.ldi, L.in_rows, 0, n_fr, 1, 0, L.cip / 16, L.step_rows_t / 16, L.taps_t, c, s.nq, p};
    gemm<N>(g, ring, stream, [&](int j, int col0, const float* v) {
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
  const ChainTc m{{a[0], a[1]}, h, xs, L.step_rows_c / 16, L.taps_c, c, L.cp, ldc, w, xs_off, L.xs_w, v_lo, v_hi};
  mrf_chain_tc<N>(plan, m, ring, stream, bm, [&](int tid) {
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
        const bool ok = i >= v_lo && i < v_hi;
        st_pair(h + (size_t)i * ldc + 2 * cq, yv[k].x, yv[k].y);
        st_pair(a[0] + (size_t)i * ldc + 2 * cq, ok ? lrelu(yv[k].x, 0.1f) : 0.f, ok ? lrelu(yv[k].y, 0.1f) : 0.f);
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
            orow[((size_t)pl * c + ch) * s.v + f0 + f] = from_f<pt_bf16>(v[k] / n_res);
        }
      }
    }
    return;
  }
  // conv_post: g = mask(lrelu_0.01(bf16(xs / n_res))) into a[0], then
  // C -> 1 taps on the CUDA cores
  PT_CTHREADS(tid) {
    for (int e = tid; e < L.xs_w * c; e += kThreads) {
      const int j = e / c, ch = e - j * c, i = xs_off + j;
      const float g = lrelu(round_bf16(to_f(xs[(size_t)j * ldc + ch]) / n_res), 0.01f);
      a[0][(size_t)j * ldc + ch] = (i >= v_lo && i < v_hi) ? from_f<pt_bf16>(g) : zero;
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
        const pt_bf16* ar = a[0] + (size_t)(j + kk) * ldc;
        const pt_bf16* wp = wpost + kk * c;
#pragma unroll 4
        for (int ch = 0; ch < c; ch += 4) {  // loads in pairs, ahead of the sums (same order)
          const F2 w0 = ld_pair(wp + ch), w1 = ld_pair(wp + ch + 2), g0 = ld_pair(ar + ch), g1 = ld_pair(ar + ch + 2);
          acc = fmaf(w0.x, g0.x, acc);
          acc = fmaf(w0.y, g0.y, acc);
          acc = fmaf(w1.x, g1.x, acc);
          acc = fmaf(w1.y, g1.y, acc);
        }
      }
      orow[(size_t)pl * s.v + f0 + f] = from_f<pt_bf16>(t < len ? tanhf(acc) : 0.f);
    }
  }
}

}  // namespace pt

#ifndef PT_HOST_EMULATION
// float32: the CUDA-core body
__global__ void __launch_bounds__(pt::kThreads)
    fused_stage_kernel(const float* x, const int* lengths, const float* wt, const float* bt, const float* wm,
                       const float* bm, const float* wpost, float* out, pt::StageArgs s, pt::MrfPlan plan) {
  extern __shared__ __align__(16) char smem[];
  pt::stage_block(x, lengths, wt, bt, wm, bm, wpost, out, s, plan, blockIdx.x, blockIdx.y, smem);
}

// bfloat16: the tensor-core body, one instantiation per product width N
// (one block per SM: two consumer warpgroups and a producer warpgroup)
template <int N>
__global__ void __launch_bounds__(pt::kTcThreads, 1)
    fused_stage_tc_kernel(const pt_bf16* x, const int* lengths, const pt_bf16* wt, const float* bt,
                          const pt_bf16* wm, const float* bm, const pt_bf16* wpost, pt_bf16* out, pt::StageArgs s,
                          pt::MrfPlan plan) {
  extern __shared__ __align__(16) char smem[];
  pt::stage_block_tc<N>(x, lengths, wt, bt, wm, bm, wpost, out, s, plan, blockIdx.x, blockIdx.y, smem);
}

template <typename T>
static int launch(void (*kernel)(const T*, const int*, const T*, const float*, const T*, const float*, const T*, T*,
                                 pt::StageArgs, pt::MrfPlan),
                  const void* x, const void* lengths, const void* wt, const void* bt, const void* wm, const void* bm,
                  const void* wpost, void* out, int batch, const pt::StageArgs& s, const pt::MrfPlan& plan,
                  int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_out = s.v * s.u * s.u_in;
  dim3 grid((n_out + s.tile - 1) / s.tile, batch);
  kernel<<<grid, sizeof(T) == 2 ? pt::kTcThreads : pt::kThreads, smem_bytes, stream>>>((const T*)x, (const int*)lengths, (const T*)wt,
                                                     (const float*)bt, (const T*)wm, (const float*)bm,
                                                     (const T*)wpost, (T*)out, s, plan);
  return (int)cudaGetLastError();
}

// Returns 0 or a cudaError_t (-1: bad plan, -2: bad dtype, -3: the bf16
// layout does not fit smem_bytes or the warpgroups' tiles). For bf16, wt
// and wm are in the kernel layout (ops/cuda/vocoder.py::tc_weight_layout),
// on 16 bytes.
extern "C" int pt_fused_upsample_mrf(const void* x, const void* lengths, const void* wt, const void* bt,
                                     const void* wm, const void* bm, const void* wpost, void* out, int batch,
                                     const int* args, int n_args, int dtype, const int* plan_ints, int n_plan,
                                     int smem_bytes, void* stream) {
  pt::MrfPlan plan;
  if (!pt::parse_plan(plan_ints, n_plan, &plan)) return -1;
  if (n_args != 14) return -1;
  pt::StageArgs s{args[0], args[1], args[2], args[3],  args[4],  args[5],  args[6],
                  args[7], args[8], args[9], args[10], args[11], args[12], args[13]};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(fused_stage_kernel, x, lengths, wt, bt, wm, bm, wpost, out, batch, s, plan, smem_bytes, st);
  if (dtype == 1) {
    if (int rc = pt::tc_check(s, smem_bytes)) return rc;
    int rc = -3;
    PT_WITH_WIDTH(pt::tc_layout(s).np,
                  rc = launch<pt_bf16>(fused_stage_tc_kernel<N>, x, lengths, wt, bt, wm, bm, wpost, out, batch, s,
                                       plan, smem_bytes, st),
                  rc = -3);
    return rc;
  }
  return -2;
}
#endif
