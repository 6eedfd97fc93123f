// Shared device code of the two HiFiGAN vocoder kernels (mrf_fused.cu,
// fused_upsample_mrf.cu): the stage plan, bf16 conversions, and the
// float32 bodies' MRF residual conv chain on the CUDA cores, run on a
// tile held in shared memory (the bf16 bodies' chain is in tc_common.cuh).
//
// Every phase of a block is written as
//     PT_THREADS(tid) { ...work of thread tid... }  PT_SYNC();
// and no thread reads, inside a phase, what another thread writes in the
// same phase. On the GPU PT_THREADS runs its body once with tid =
// threadIdx.x; with -DPT_HOST_EMULATION the same source compiles with a
// host C++ compiler, PT_THREADS loops over all tids of the block and
// PT_SYNC is empty, so a block runs phase by phase on the CPU. That
// build is how the kernels' index arithmetic is checked off the card.
#pragma once

#include <stdint.h>

#ifdef PT_HOST_EMULATION
#include <algorithm>
#include <cmath>
#include <cstring>
using std::max;
using std::min;
#define PT_DEVICE inline
#define PT_THREADS(tid) for (int tid = 0; tid < pt::kThreads; ++tid)
#define PT_SYNC() ((void)0)
struct pt_bf16 {
  uint16_t bits;
};
static inline float pt_bf16_to_float(pt_bf16 v) {
  uint32_t u = uint32_t(v.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
static inline pt_bf16 pt_float_to_bf16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7f800000u) == 0x7f800000u && (u & 0x7fffffu)) return pt_bf16{uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return pt_bf16{uint16_t(u >> 16)};
}
#define PT_LDG(p) (*(p))
#else
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#define PT_DEVICE __device__ __forceinline__
#define PT_THREADS(tid) for (int tid = threadIdx.x, pt_once_ = 1; pt_once_; pt_once_ = 0)
#define PT_SYNC() __syncthreads()
typedef __nv_bfloat16 pt_bf16;
#define PT_LDG(p) __ldg(p)
#endif

namespace pt {

constexpr int kThreads = 256;  // threads per block
constexpr int kCoPer = 4;      // output channels per thread in a conv pass
constexpr int kTPer = 8;       // positions per thread in a conv pass
constexpr int kMaxConvs = 32;
constexpr int kMaxRes = 8;

// One MRF stage: resblocks of (kernel, dilation) conv steps, flattened in
// packing order (ops/cuda/vocoder.py::mrf_plan_ints encodes it).
struct MrfPlan {
  int n_res;               // resblocks
  int rb1;                 // resblock "1": convs come in (d, 1) pairs
  int k_max;               // tap stride of the packed weights
  int n_steps[kMaxRes];    // convs per resblock
  int k[kMaxConvs];
  int d[kMaxConvs];
};

inline bool parse_plan(const int* v, int n, MrfPlan* p) {
  if (n < 3) return false;
  p->n_res = v[0];
  p->rb1 = v[1];
  p->k_max = v[2];
  if (p->n_res < 1 || p->n_res > kMaxRes) return false;
  if (n < 3 + p->n_res) return false;
  int total = 0;
  for (int r = 0; r < p->n_res; ++r) {
    p->n_steps[r] = v[3 + r];
    total += p->n_steps[r];
  }
  if (total > kMaxConvs || n != 3 + p->n_res + 2 * total) return false;
  for (int c = 0; c < total; ++c) {
    p->k[c] = v[3 + p->n_res + 2 * c];
    p->d[c] = v[3 + p->n_res + 2 * c + 1];
  }
  return true;
}

PT_DEVICE float to_f(float v) { return v; }
PT_DEVICE float to_f(pt_bf16 v) {
#ifdef PT_HOST_EMULATION
  return pt_bf16_to_float(v);
#else
  return __bfloat162float(v);
#endif
}
template <typename T>
PT_DEVICE T from_f(float v);
template <>
PT_DEVICE float from_f<float>(float v) { return v; }
template <>
PT_DEVICE pt_bf16 from_f<pt_bf16>(float v) {
#ifdef PT_HOST_EMULATION
  return pt_float_to_bf16(v);
#else
  return __float2bfloat16_rn(v);
#endif
}

// Four consecutive float32 weights (output channels co..co+3). The
// wrapper checks C_out % 4 == 0, so the vector loads are aligned.
PT_DEVICE void load4(const float* p, float w[4]) {
#ifdef PT_HOST_EMULATION
  for (int a = 0; a < 4; ++a) w[a] = p[a];
#else
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
#endif
}

PT_DEVICE int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// Thread -> (output-channel group, position lane) of a conv pass: lanes
// of a warp walk consecutive positions (conflict-free shared reads) and
// share few channel groups (broadcast weight loads).
struct PassMap {
  int co0, lane, lanes, active;
};
PT_DEVICE PassMap pass_map(int tid, int c_out) {
  PassMap m;
  int groups = c_out / kCoPer;
  m.lanes = kThreads / groups;
  m.active = tid < groups * m.lanes;
  m.co0 = (tid / m.lanes) * kCoPer;
  m.lane = tid % m.lanes;
  return m;
}

// a[c][i] = valid(i) ? lrelu_0.1(h[c][i]) : 0 over the window; a rows of
// stride lda with the data at column `margin`.
template <typename T>
PT_DEVICE void act_phase(int tid, const T* h, T* a, int c, int w, int lda, int margin, int v_lo, int v_hi) {
  for (int e = tid; e < c * w; e += kThreads) {
    int ch = e / w, i = e - ch * w;
    float v = to_f(h[e]);
    v = v >= 0.f ? v : v * 0.1f;
    a[ch * lda + margin + i] = (i >= v_lo && i < v_hi) ? from_f<T>(v) : from_f<T>(0.f);
  }
}

// One dilated "same" conv over the window, computed for all w positions:
//   acc[co][i] = bias[co] + sum_kk sum_ci wk[kk][ci][co] * a[ci][i + kk*d - pad]
// a has zero margins of at least `pad` columns, so no bounds checks.
// Epilogue: dst = res ? T(res + T(acc)) : T(acc)   (dst may alias res).
template <typename T>
PT_DEVICE void conv_phase(int tid, const T* a, int lda, int margin, T* dst, const T* res, int c, int w,
                          const T* wk, const float* bias, int k, int d) {
  PassMap m = pass_map(tid, c);
  if (!m.active) return;
  const int pad = (k * d - d) / 2;
  const int span = m.lanes * kTPer;
  for (int base = 0; base < w; base += span) {
    int pos[kTPer];
    float acc[kCoPer][kTPer];
    for (int j = 0; j < kTPer; ++j) {
      int i = base + m.lane + m.lanes * j;
      pos[j] = i < w ? i : w - 1;
    }
    for (int q = 0; q < kCoPer; ++q) {
      float bv = PT_LDG(bias + m.co0 + q);
      for (int j = 0; j < kTPer; ++j) acc[q][j] = bv;
    }
    for (int kk = 0; kk < k; ++kk) {
      const T* wrow = wk + (size_t)kk * c * c + m.co0;
      const T* arow = a + margin + kk * d - pad;
#pragma unroll 4
      for (int ci = 0; ci < c; ++ci) {
        float wv[kCoPer];
        load4(wrow + (size_t)ci * c, wv);
        const T* ar = arow + ci * lda;
        float xv[kTPer];
        for (int j = 0; j < kTPer; ++j) xv[j] = to_f(ar[pos[j]]);
        for (int q = 0; q < kCoPer; ++q)
          for (int j = 0; j < kTPer; ++j) acc[q][j] = fmaf(wv[q], xv[j], acc[q][j]);
      }
    }
    for (int j = 0; j < kTPer; ++j) {
      int i = base + m.lane + m.lanes * j;
      if (i >= w) continue;
      for (int q = 0; q < kCoPer; ++q) {
        int e = (m.co0 + q) * w + i;
        T r = from_f<T>(acc[q][j]);
        dst[e] = res ? from_f<T>(to_f(res[e]) + to_f(r)) : r;
      }
    }
  }
}

// Shared-memory layout of the MRF chain over a window of w positions.
template <typename T>
struct MrfSmem {
  T* a;   // c x lda, conv input (activated), zero margins
  T* h;   // c x w, residual stream
  T* b;   // c x w, resblock-"1" inner conv output (rb1 only)
  T* xs;  // c x xs_w, sum over resblocks of the masked residual streams
};

PT_DEVICE size_t align_elems(size_t n) { return (n + 7) & ~size_t(7); }

// Run the MRF chain of one stage. `load_h(tid)` fills m.h with the
// stage input over the window (already masked) for the thread's share of
// elements. xs[c][j] += valid ? h[c][xs_off + j] : 0 for j < xs_w.
template <typename T, typename LoadH>
PT_DEVICE void mrf_chain(const MrfPlan& plan, const MrfSmem<T>& m, int c, int w, int lda, int margin,
                         int v_lo, int v_hi, int xs_off, int xs_w, const T* wm, const float* bm, LoadH load_h) {
  int conv = 0;
  for (int r = 0; r < plan.n_res; ++r) {
    PT_THREADS(tid) { load_h(tid); }
    PT_SYNC();
    for (int s = 0; s < plan.n_steps[r]; s += (plan.rb1 ? 2 : 1)) {
      const T* w1 = wm + (size_t)conv * plan.k_max * c * c;
      PT_THREADS(tid) { act_phase(tid, m.h, m.a, c, w, lda, margin, v_lo, v_hi); }
      PT_SYNC();
      if (plan.rb1) {
        const T* w2 = w1 + (size_t)plan.k_max * c * c;
        PT_THREADS(tid) {
          conv_phase(tid, m.a, lda, margin, m.b, (const T*)nullptr, c, w, w1, bm + conv * c, plan.k[conv],
                     plan.d[conv]);
        }
        PT_SYNC();
        PT_THREADS(tid) { act_phase(tid, m.b, m.a, c, w, lda, margin, v_lo, v_hi); }
        PT_SYNC();
        PT_THREADS(tid) {
          conv_phase(tid, m.a, lda, margin, m.h, m.h, c, w, w2, bm + (conv + 1) * c, plan.k[conv + 1],
                     plan.d[conv + 1]);
        }
        PT_SYNC();
        conv += 2;
      } else {
        PT_THREADS(tid) {
          conv_phase(tid, m.a, lda, margin, m.h, m.h, c, w, w1, bm + conv * c, plan.k[conv], plan.d[conv]);
        }
        PT_SYNC();
        conv += 1;
      }
    }
    PT_THREADS(tid) {
      for (int e = tid; e < c * xs_w; e += kThreads) {
        int ch = e / xs_w, j = e - ch * xs_w;
        int i = xs_off + j;
        float hv = (i >= v_lo && i < v_hi) ? to_f(m.h[ch * w + i]) : 0.f;
        m.xs[e] = from_f<T>(to_f(m.xs[e]) + hv);
      }
    }
    PT_SYNC();
  }
}

}  // namespace pt
