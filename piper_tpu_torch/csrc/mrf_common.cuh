// Shared device code of the two HiFiGAN vocoder kernels (mrf_fused.cu,
// fused_upsample_mrf.cu): the stage plan and the bf16 conversions (their
// tensor-core bodies, in both element types, are built on tc_common.cuh).
//
// With -DPT_HOST_EMULATION the same sources compile with a host C++
// compiler and a block runs phase by phase on the CPU (tc_common.cuh).
// That build is how the kernels' index arithmetic is checked off the card.
#pragma once

#include <stdint.h>

#ifdef PT_HOST_EMULATION
#include <algorithm>
#include <cmath>
#include <cstring>
using std::max;
using std::min;
#define PT_DEVICE inline
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
typedef __nv_bfloat16 pt_bf16;
#define PT_LDG(p) __ldg(p)
#endif

namespace pt {

constexpr int kThreads = 256;  // consumer threads per block (two warpgroups)
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

// Convs of the plan (packed weight slices per tap: plan_convs * k_max).
PT_DEVICE int plan_convs(const MrfPlan& plan) {
  int n = 0;
  for (int r = 0; r < plan.n_res; ++r) n += plan.n_steps[r];
  return n;
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

PT_DEVICE int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

}  // namespace pt
