// Tensor-core building blocks of the two bf16 vocoder kernels
// (mrf_fused.cu, fused_upsample_mrf.cu): ldmatrix, mma.sync m16n8k16
// (bf16 in, f32 accumulators), cp.async, one implicit-GEMM conv over a
// window held position-major in shared memory, and the MRF chain that
// both kernels run on such a window.
//
// A warp phase is written as
//     PT_WARPS(wp) { ...warp-uniform code...  PT_LANES(wp, tid) { ...lane... } }
// and a value that each thread holds in a register is a Regs<T>, indexed
// by the thread's tid. On the GPU PT_WARPS and PT_LANES run their bodies
// once (wp = threadIdx.x / 32, tid = threadIdx.x) and Regs<T> is one
// register. With -DPT_HOST_EMULATION, PT_WARPS loops over the block's
// warps, PT_LANES over the warp's 32 lanes, Regs<T> holds one T per
// thread of the block, and the warp-collective instructions are computed
// from the documented fragment layouts of the PTX ISA (ldmatrix, and
// mma.m16n8k16 with .bf16 operands). So the host build checks the kernel's
// addressing, shifts, padding and fragment-to-(row, column) maps.
#pragma once

#include "mrf_common.cuh"

#ifdef PT_HOST_EMULATION
#define PT_HD inline
#define PT_WARPS(wp) for (int wp = 0; wp < pt::kWarps; ++wp)
#define PT_LANES(wp, tid) for (int tid = (wp) * 32; tid < (wp) * 32 + 32; ++tid)
#else
#define PT_HD __host__ __device__ __forceinline__
#define PT_WARPS(wp) for (int wp = threadIdx.x >> 5, pt_wonce_ = 1; pt_wonce_; pt_wonce_ = 0)
#define PT_LANES(wp, tid) for (int tid = threadIdx.x, pt_lonce_ = 1; pt_lonce_; pt_lonce_ = 0)
#endif

namespace pt {

constexpr int kWarps = kThreads / 32;
constexpr int kMI = 12;  // (16-row, 16-column) output tiles one warp holds in a GEMM

template <typename T>
struct Regs {
#ifdef PT_HOST_EMULATION
  T v[kThreads];
  T& operator[](int tid) { return v[tid]; }
  const T& operator[](int tid) const { return v[tid]; }
#else
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
  __device__ __forceinline__ const T& operator[](int) const { return v; }
#endif
};

struct U4 {
  uint32_t x[4];
};
struct F4 {
  float x[4];
};

#ifdef PT_HOST_EMULATION
static inline uint32_t pack2(pt_bf16 lo, pt_bf16 hi) { return uint32_t(lo.bits) | (uint32_t(hi.bits) << 16); }
static inline float half_f(uint32_t r, int hi) { return pt_bf16_to_float(pt_bf16{uint16_t(hi ? r >> 16 : r)}); }
#else
PT_DEVICE uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
#endif

// ldmatrix.x4: lane l gives the address of row (l & 7) of 8x8 matrix l >> 3;
// register i of lane l receives elements (l >> 2, 2(l & 3) + {0, 1}) of
// matrix i. With .trans it receives elements (2(l & 3) + {0, 1}, l >> 2).
PT_DEVICE void ldsm_x4(Regs<U4>& d, const Regs<const pt_bf16*>& p, int wp) {
#ifdef PT_HOST_EMULATION
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 4; ++i) {
      const pt_bf16* row = p[wp * 32 + i * 8 + (l >> 2)];
      d[wp * 32 + l].x[i] = pack2(row[2 * (l & 3)], row[2 * (l & 3) + 1]);
    }
#else
  U4& r = d[0];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x[0]), "=r"(r.x[1]), "=r"(r.x[2]), "=r"(r.x[3])
               : "r"(smem_addr(p[0])));
#endif
}

PT_DEVICE void ldsm_x4_trans(Regs<U4>& d, const Regs<const pt_bf16*>& p, int wp) {
#ifdef PT_HOST_EMULATION
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < 4; ++i) {
      const pt_bf16* r0 = p[wp * 32 + i * 8 + 2 * (l & 3)];
      const pt_bf16* r1 = p[wp * 32 + i * 8 + 2 * (l & 3) + 1];
      d[wp * 32 + l].x[i] = pack2(r0[l >> 2], r1[l >> 2]);
    }
#else
  U4& r = d[0];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x[0]), "=r"(r.x[1]), "=r"(r.x[2]), "=r"(r.x[3])
               : "r"(smem_addr(p[0])));
#endif
}

// c += A (16x16, row) * B (16x8, col), f32 accumulators. Fragments (g =
// lane >> 2, t = lane & 3): a.x = {(g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)}; B is b.x[2j] = rows (2t, 2t+1), b.x[2j+1] = rows
// (2t+8, 2t+9), column g; c.x = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
PT_DEVICE void mma_bf16(Regs<F4>& c, const Regs<U4>& a, const Regs<U4>& b, int j, int wp) {
#ifdef PT_HOST_EMULATION
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    const U4& ra = a[wp * 32 + l];
    const U4& rb = b[wp * 32 + l];
    for (int q = 0; q < 2; ++q) {
      A[g][2 * t + q] = half_f(ra.x[0], q);
      A[g + 8][2 * t + q] = half_f(ra.x[1], q);
      A[g][2 * t + 8 + q] = half_f(ra.x[2], q);
      A[g + 8][2 * t + 8 + q] = half_f(ra.x[3], q);
      B[2 * t + q][g] = half_f(rb.x[2 * j], q);
      B[2 * t + 8 + q][g] = half_f(rb.x[2 * j + 1], q);
    }
  }
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    F4& rc = c[wp * 32 + l];
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
      float acc = rc.x[e];
      for (int k = 0; k < 16; ++k) acc = fmaf(A[row][k], B[k][col], acc);
      rc.x[e] = acc;
    }
  }
#else
  F4& r = c[0];
  const U4& ra = a[0];
  const U4& rb = b[0];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(r.x[0]), "+f"(r.x[1]), "+f"(r.x[2]), "+f"(r.x[3])
      : "r"(ra.x[0]), "r"(ra.x[1]), "r"(ra.x[2]), "r"(ra.x[3]), "r"(rb.x[2 * j]), "r"(rb.x[2 * j + 1]));
#endif
}

// cp.async: 16- or 8-byte copies from device memory into shared memory,
// in flight until cp_async_wait_all (the host build copies at once).
PT_DEVICE void cp_async16(void* dst, const void* src) {
#ifdef PT_HOST_EMULATION
  std::memcpy(dst, src, 16);
#else
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
#endif
}
PT_DEVICE void cp_async8(void* dst, const void* src) {
#ifdef PT_HOST_EMULATION
  std::memcpy(dst, src, 8);
#else
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
#endif
}
PT_DEVICE void cp_async_commit() {
#ifndef PT_HOST_EMULATION
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
PT_DEVICE void cp_async_wait_all() {
#ifndef PT_HOST_EMULATION
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

PT_DEVICE void zero16(void* p) {
#ifdef PT_HOST_EMULATION
  std::memset(p, 0, 16);
#else
  *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
#endif
}

// One weight slice, (k_real, n_real) row-major in device memory, into
// shared rows of stride ldw. n_real % 4 == 0 (the wrapper checks it);
// 16-byte copies where n_real % 8 == 0.
PT_DEVICE void fetch_slice(int tid, pt_bf16* dst, int ldw, const pt_bf16* src, int k_real, int n_real) {
  if (n_real % 8 == 0) {
    const int per = n_real / 8;
    for (int e = tid; e < k_real * per; e += kThreads) {
      const int r = e / per, c = (e - r * per) * 8;
      cp_async16(dst + (size_t)r * ldw + c, src + (size_t)r * n_real + c);
    }
  } else {
    const int per = n_real / 4;
    for (int e = tid; e < k_real * per; e += kThreads) {
      const int r = e / per, c = (e - r * per) * 4;
      cp_async8(dst + (size_t)r * ldw + c, src + (size_t)r * n_real + c);
    }
  }
}

// One conv as an implicit GEMM on the tensor cores:
//   out[r][n] = sum_tap sum_k A[r + tap*a_step + a_shift][k] * W_tap[k][n]
// for output rows r in [row0, row0 + n_rows) and columns n < n_real. A is
// position-major bf16 in shared memory (row stride lda, zero columns past
// the real K); W_tap is a (k_real, n_real) slice of device memory at
// w + tap*w_tap. Each step stages step_rows rows (a multiple of 16) of one
// tap's slice into one of two shared buffers (wbuf, rows of ldw,
// wbuf_stride apart) with cp.async while the previous step's products
// run; a step_rows of at least K stages whole taps. Warp wp owns the
// (16-row, 16-column) tiles wp, wp + kWarps, ... (at most kMI) and keeps
// their f32 sums in registers; sums run over taps, then 16-channel
// chunks, so each output element's order depends neither on the tile nor
// on step_rows. A tile may read up to 15 rows past row0 + n_rows; those
// rows are discarded.
// epi(r, n, v0, v1) receives columns n, n+1 of row r.
struct Gemm {
  const pt_bf16* a;
  int lda, row0, n_rows, a_step, a_shift, k_chunks, n_pairs;
  const pt_bf16* w;
  size_t w_tap;
  int k_real, n_real, n_taps;
};

template <typename Epi>
PT_DEVICE void gemm(const Gemm& g, pt_bf16* wbuf, int ldw, int step_rows, size_t wbuf_stride, Epi epi) {
  const int step_chunks = step_rows / 16;
  const int n_items = (g.n_rows + 15) / 16 * g.n_pairs;
  const int n_pieces = (g.k_chunks + step_chunks - 1) / step_chunks;  // steps per tap
  const int n_steps = g.n_taps * n_pieces;
  auto fetch = [&](int tid, int st) {
    const int kk = st / n_pieces, k0 = (st - kk * n_pieces) * step_rows;
    fetch_slice(tid, wbuf + (st & 1) * wbuf_stride, ldw, g.w + kk * g.w_tap + (size_t)k0 * g.n_real,
                min(step_rows, g.k_real - k0), g.n_real);
  };
  Regs<F4> acc[kMI][2];
  PT_WARPS(wp) {
#pragma unroll
    for (int m = 0; m < kMI; ++m)
      for (int j = 0; j < 2; ++j) PT_LANES(wp, tid) for (int e = 0; e < 4; ++e) acc[m][j][tid].x[e] = 0.f;
  }
  PT_THREADS(tid) {
    fetch(tid, 0);
    cp_async_commit();
  }
  for (int st = 0; st < n_steps; ++st) {
    PT_THREADS(tid) { cp_async_wait_all(); }
    PT_SYNC();  // step st has landed; every warp is done with step st - 1
    if (st + 1 < n_steps) {
      PT_THREADS(tid) {
        fetch(tid, st + 1);
        cp_async_commit();
      }
    }
    const pt_bf16* wb = wbuf + (st & 1) * wbuf_stride;
    const int kk = st / n_pieces, kc0 = (st - kk * n_pieces) * step_chunks;
    const int kc1 = min(g.k_chunks, kc0 + step_chunks);
    PT_WARPS(wp) {
#pragma unroll
      for (int m = 0; m < kMI; ++m) {
        const int e = wp + kWarps * m;
        if (e >= n_items) break;
        const int mt = e / g.n_pairs, np = e - mt * g.n_pairs;
        const int ra = g.row0 + mt * 16 + kk * g.a_step + g.a_shift;
        for (int kc = kc0; kc < kc1; ++kc) {
          Regs<const pt_bf16*> pa, pb;
          Regs<U4> fa, fb;
          PT_LANES(wp, tid) {
            const int l = tid & 31, r = (l & 7) + ((l >> 3) & 1) * 8, c = (l >> 4) * 8;
            pa[tid] = g.a + (size_t)(ra + r) * g.lda + kc * 16 + c;
            pb[tid] = wb + (size_t)((kc - kc0) * 16 + r) * ldw + np * 16 + c;
          }
          ldsm_x4(fa, pa, wp);
          ldsm_x4_trans(fb, pb, wp);
          mma_bf16(acc[m][0], fa, fb, 0, wp);
          mma_bf16(acc[m][1], fa, fb, 1, wp);
        }
      }
    }
  }
  PT_WARPS(wp) {
#pragma unroll
    for (int m = 0; m < kMI; ++m) {
      const int e = wp + kWarps * m;
      if (e >= n_items) break;
      const int mt = e / g.n_pairs, np = e - mt * g.n_pairs;
      for (int j = 0; j < 2; ++j) {
        PT_LANES(wp, tid) {
          const int l = tid & 31;
          const int col = np * 16 + j * 8 + 2 * (l & 3);
          if (col < g.n_real) {
            const F4& c = acc[m][j][tid];
            const int r = g.row0 + mt * 16 + (l >> 2);
            if (r < g.row0 + g.n_rows) epi(r, col, c.x[0], c.x[1]);
            if (r + 8 < g.row0 + g.n_rows) epi(r + 8, col, c.x[2], c.x[3]);
          }
        }
      }
    }
  }
}

PT_DEVICE float lrelu(float v, float slope) { return v >= 0.f ? v : v * slope; }
PT_DEVICE float round_bf16(float v) { return to_f(from_f<pt_bf16>(v)); }

// The bf16 MRF chain's shared-memory buffers over a window of w
// position-major rows of stride ldc (round16(c) + 8 bf16: ldmatrix rows
// hit distinct banks): the conv inputs a[0], a[1] (w + 16 rows each, for
// a GEMM tile's reads past its range), the residual stream h (w rows),
// the resblock sum xs (xs_w rows, window rows xs_off...) and the two
// weight-step buffers wb (wb_rows rows each, wb_stride apart). Window
// rows in [v_lo, v_hi) are inside the row's valid length.
struct ChainTc {
  pt_bf16 *a[2], *h, *xs, *wb;
  size_t wb_stride;
  int wb_rows, c, cp, ldc, w, xs_off, xs_w, v_lo, v_hi;
};

// Run the MRF chain of one stage on the tensor cores; xs must be zero on
// entry and receives the sum over resblocks of the masked resblock
// outputs over its rows. At the start of each resblock, load_in(tid)
// writes the thread's share of the stage input over the window: h = the
// input (zero outside [v_lo, v_hi)), a[0] = mask(lrelu_0.1(h)).
// Conv j of a resblock computes the rows the rest of the resblock still
// reads: [xs_off - E, xs_off + xs_w + E), E = the reach of the convs after
// it; its input covers the previous conv's rows. Its epilogue adds the
// bias and rounds, then (resblock "1", first conv of a pair) writes the
// next conv's input, or adds the residual, rounds, and writes the next
// conv's input or, after the last conv, adds to xs; the rounding points
// are those of the plain version (ops/cuda/vocoder.py::mrf_fused_plain).
template <typename LoadIn>
PT_DEVICE void mrf_chain_tc(const MrfPlan& plan, const ChainTc& m, const pt_bf16* __restrict__ wm,
                            const float* __restrict__ bm, LoadIn load_in) {
  const int c = m.c, ldc = m.ldc;
  const pt_bf16 zero = from_f<pt_bf16>(0.f);
  int conv = 0;
  for (int r = 0; r < plan.n_res; ++r) {
    PT_THREADS(tid) { load_in(tid); }
    PT_SYNC();
    int reach = 0;
    for (int j = 0; j < plan.n_steps[r]; ++j) reach += (plan.k[conv + j] * plan.d[conv + j] - plan.d[conv + j]) / 2;
    int cur = 0;
    for (int j = 0; j < plan.n_steps[r]; ++j, ++conv) {
      const int k = plan.k[conv], d = plan.d[conv], pad = (k * d - d) / 2;
      reach -= pad;
      const bool inner = plan.rb1 && (j % 2 == 0);  // resblock "1": conv before the residual add
      const bool last = j == plan.n_steps[r] - 1;
      const float* bias = bm + (size_t)conv * c;
      pt_bf16* nxt = m.a[cur ^ 1];
      pt_bf16* h = m.h;
      pt_bf16* xs = m.xs;
      Gemm g{m.a[cur], ldc, m.xs_off - reach, m.xs_w + 2 * reach, d, -pad, m.cp / 16, m.cp / 16,
             wm + (size_t)conv * plan.k_max * c * c, (size_t)c * c, c, c, k};
      gemm(g, m.wb, ldc, m.wb_rows, m.wb_stride, [&](int i, int col, float v0, float v1) {
        const bool ok = i >= m.v_lo && i < m.v_hi;
        for (int q = 0; q < 2; ++q) {
          const size_t e = (size_t)i * ldc + col + q;
          const float v = round_bf16((q ? v1 : v0) + PT_LDG(bias + col + q));
          if (inner) {
            nxt[e] = ok ? from_f<pt_bf16>(lrelu(v, 0.1f)) : zero;
            continue;
          }
          const float hn = round_bf16(to_f(h[e]) + v);
          h[e] = from_f<pt_bf16>(hn);
          if (last) {
            const size_t ex = (size_t)(i - m.xs_off) * ldc + col + q;
            xs[ex] = from_f<pt_bf16>(to_f(xs[ex]) + (ok ? hn : 0.f));
          } else {
            nxt[e] = ok ? from_f<pt_bf16>(lrelu(hn, 0.1f)) : zero;
          }
        }
      });
      PT_SYNC();
      cur ^= 1;
    }
  }
}

}  // namespace pt
