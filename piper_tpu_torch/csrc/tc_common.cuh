// Hopper tensor-core building blocks of the two vocoder kernels
// (mrf_fused.cu, fused_upsample_mrf.cu), in both of their element types:
// warpgroup products (wgmma, f32 sums, A from registers, B from a
// shared-memory matrix descriptor), ldmatrix for A, mbarriers and the bulk
// copy of the Tensor Memory Accelerator for B, a ring of weight stages fed
// by those copies, one implicit-GEMM conv over a window held position-major
// in shared memory, and the MRF chain that both kernels run on such a
// window. The conv core (gemm) and the chain are templates on the element
// type E:
//  - bfloat16: one wgmma m64nNk16 (bf16 in) per 16 input channels;
//  - float32, 3xTF32: every operand x is split into hi = tf32(x) and
//    lo = tf32(x - hi) (cvt.rna.tf32.f32), and each 8 input channels cost
//    three wgmma m64nNk8 (tf32 in): A_hi B_hi + A_hi B_lo + A_lo B_hi, so
//    the sums keep about 21 of float32's 24 bits where one TF32 product
//    keeps 11. The weights' hi and lo planes come from the wrapper (two
//    bulk copies a stage); A is split in registers as it is loaded, after
//    the conv input's mask and leaky ReLU (activation on load).
//
// A block is two consumer warpgroups, which run the products, and one
// producer warpgroup, one thread of which streams the weights (the ring
// below). A consumer warpgroup phase is written as
//     PT_GROUPS(wg) { ... PT_GROUP_WARPS(wg, wp) { ... PT_LANES(wp, tid) { ...lane... } } }
// and a value that each thread holds in a register is a Regs<T>, indexed
// by the thread's tid. On the GPU these run their bodies once (wg =
// threadIdx.x / 128, wp = threadIdx.x / 32, tid = threadIdx.x) and Regs<T>
// is one register. With -DPT_HOST_EMULATION they loop over the consumer
// warpgroups, the group's warps and the warp's lanes, Regs<T> holds one T
// per consumer thread, the producer's copies are issued where a consumer
// waits for them, and the asynchronous instructions are emulated
// from the PTX ISA: ldmatrix from its fragment layout; wgmma (bf16 and
// tf32) from its A register fragments, its B matrix descriptor (start
// address, leading and stride byte offsets, swizzle mode, decoded from the
// 64-bit value) and its accumulator layout, executed when wgmma.wait_group
// retires its group (a wgmma without a fence before it, or whose A
// registers change before it retires, or a tf32 operand with mantissa bits
// below tf32's, is a fault); cvt.rna.tf32.f32's rounding; the bulk copy at
// issue, counting its bytes on
// the mbarrier; an mbarrier's phases from its arrivals and transaction
// bytes (a wait on a phase that has not completed is a fault). So the host
// build checks the kernels' addressing, shifts, descriptors, lane maps and
// ring protocol; a fault makes the emulated entry point return -4.
#pragma once

#include "mrf_common.cuh"

#ifdef PT_HOST_EMULATION
#include <vector>
#define PT_CTHREADS(tid) for (int tid = 0; tid < pt::kThreads; ++tid)
#define PT_CSYNC() ((void)0)
#define PT_HD inline
#define PT_GROUPS(wg) for (int wg = 0; wg < pt::kGroups; ++wg)
#define PT_GROUP_WARPS(wg, wp) for (int wp = (wg) * 4; wp < (wg) * 4 + 4; ++wp)
#define PT_LANES(wp, tid) for (int tid = (wp) * 32; tid < (wp) * 32 + 32; ++tid)
#else
// the consumer threads (the kThreads of the two warpgroups that run the
// products) and their own barrier: the producer warpgroup takes part in
// neither
#define PT_CTHREADS(tid) for (int tid = threadIdx.x, pt_conce_ = threadIdx.x < pt::kThreads; pt_conce_; pt_conce_ = 0)
#define PT_CSYNC() asm volatile("bar.sync 1, %0;\n" ::"n"(pt::kThreads) : "memory")
#define PT_HD __host__ __device__ __forceinline__
// (the warpgroup index through a shuffle: the compiler then knows it is
// uniform across the warp, so branches on it around wgmma do not make it
// serialise the products)
#define PT_GROUPS(wg) \
  for (int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0), pt_gonce_ = 1; pt_gonce_; pt_gonce_ = 0)
#define PT_GROUP_WARPS(wg, wp) for (int wp = threadIdx.x >> 5, pt_wonce_ = 1; pt_wonce_; pt_wonce_ = 0)
#define PT_LANES(wp, tid) for (int tid = threadIdx.x, pt_lonce_ = 1; pt_lonce_; pt_lonce_ = 0)
#endif

namespace pt {

constexpr int kWarps = kThreads / 32;    // consumer warps: 8
constexpr int kGroups = kThreads / 128;  // consumer warpgroups: 2
// A block is the two consumer warpgroups and one producer warpgroup,
// whose first thread issues the weight ring's bulk copies; the producer
// gives its registers to the consumers (setmaxnreg): 256 x 232 + 128 x 40
// = 64,512 of the SM's 65,536.
constexpr int kTcThreads = kThreads + 128;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kSmemLimit = 232448;       // shared memory one block may use (H100)
constexpr int kMaxChunks = 4;            // 16-channel chunks of one weight stage
constexpr int kRingMin = 3, kRingMax = 8;  // weight stages in the ring: as many as fit
constexpr int kBarBytes = 128;           // the ring's mbarriers (2 per stage, 8 bytes each)
constexpr int kBatch = 8;                // elements a thread loads before it stores them (copy loops)

// The two element types. A unit is one 32-byte K slice of a row (16 bf16
// or 8 float input channels): one wgmma k16 in bf16, three k8 in 3xTF32.
// kPlanes: weight planes a stage holds (float: hi and lo); kPad: elements
// past round16(C) in a window row, 16 bytes, so that ldmatrix's 8 rows hit
// distinct banks; kMaxUnits: units of one step (float: A's hi and lo take
// the registers of two bf16 units each).
template <typename E>
struct Elem;
template <>
struct Elem<pt_bf16> {
  static constexpr int kUnitCh = 16, kPlanes = 1, kPad = 8, kMaxUnits = kMaxChunks;
};
template <>
struct Elem<float> {
  static constexpr int kUnitCh = 8, kPlanes = 2, kPad = 4, kMaxUnits = kMaxChunks / 2;
};
template <typename E>
constexpr bool kF32 = sizeof(E) == 4;

// Output width of the warpgroup product: the conv's padded output
// channels rounded up to a power of two, 16..256 (0: too wide).
PT_HD int npad(int cp) {
  int n = 16;
  while (n < cp) n *= 2;
  return n <= 256 ? n : 0;
}
// 64-row output tiles one warpgroup holds at once (their f32 sums, N/2
// registers a tile per thread, stay in registers for a whole conv).
PT_HD constexpr int mt_per_group(int n) { return n >= 256 ? 1 : n >= 128 ? 2 : n >= 64 ? 3 : 4; }
// Stages of slot bytes that fit beside `windows` bytes of windows: as
// many as fit, from kRingMin to kRingMax.
PT_HD int ring_slots(size_t windows, int slot) {
  int n = kRingMin;
  while (n < kRingMax && kBarBytes + (size_t)(n + 1) * slot + windows <= (size_t)kSmemLimit) ++n;
  return n;
}

// Input-channel rows of one weight stage (one tap's slice, or a piece of
// it): 16, 32 or 64 (1, 2 or kMaxChunks chunks), at most 16 KB, dividing k.
PT_HD int step_rows(int k, int n) {
  int r = 16 * kMaxChunks;
  while (r > 16 && (r * n * 2 > 16384 || k % r)) r /= 2;
  return r;
}
// Input-channel rows of one float32 weight stage: 16 or 8 (2 or 1 units),
// its hi and lo planes at most 16 KB together, dividing k. (A float32
// stage holds one tap's slice, or a piece of it.)
PT_HD int tf32_step_rows(int k, int n) {
  int r = 8 * Elem<float>::kMaxUnits;
  while (r > 8 && (r * n * 8 > 16384 || k % r)) r /= 2;
  return r;
}
// Taps of one weight stage: where a whole tap is one step of fewer than
// kMaxChunks chunks (k = 16 or 32) and the product is at most 64 wide,
// several taps, up to kMaxChunks chunks and 16 KB together; else 1 (a
// stage is then one step of a tap). (The widest products keep the fewest
// step shapes: their accumulators leave no registers for more.)
PT_HD int stage_taps(int k, int n) {
  if (n > 64 || step_rows(k, n) != k) return 1;
  int t = 16 * kMaxChunks / k;
  while (t > 1 && t * k * n * 2 > 16384) --t;
  return t;
}

// Runs `body` (statements that use the constant N) with N = np, the
// warpgroup product's width, or `otherwise` if np is not one of 16..256.
#define PT_WITH_WIDTH(np, body, otherwise) \
  switch (np) {                            \
    case 16: {                             \
      constexpr int N = 16;                \
      body;                                \
    } break;                               \
    case 32: {                             \
      constexpr int N = 32;                \
      body;                                \
    } break;                               \
    case 64: {                             \
      constexpr int N = 64;                \
      body;                                \
    } break;                               \
    case 128: {                            \
      constexpr int N = 128;               \
      body;                                \
    } break;                               \
    case 256: {                            \
      constexpr int N = 256;               \
      body;                                \
    } break;                               \
    default:                               \
      otherwise;                           \
  }

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
// One thread's part of a warpgroup product's m64nN f32 accumulators.
template <int N>
struct Acc {
  float x[N / 2];
};

#ifdef PT_HOST_EMULATION
// The emulated block's shared memory (addresses are offsets into it) and
// the first fault the emulation met (nullptr: none).
inline char* g_smem = nullptr;
inline size_t g_smem_bytes = 0;
inline const char* g_fault = nullptr;
inline void fault(const char* why) {
  if (!g_fault) g_fault = why;
}
inline uint32_t smem_addr(const void* p) { return (uint32_t)((const char*)p - g_smem); }
static inline uint32_t pack2(pt_bf16 lo, pt_bf16 hi) { return uint32_t(lo.bits) | (uint32_t(hi.bits) << 16); }
static inline float half_f(uint32_t r, int hi) { return pt_bf16_to_float(pt_bf16{uint16_t(hi ? r >> 16 : r)}); }
#else
PT_DEVICE uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
#endif

PT_DEVICE float bits_f(uint32_t u) {
#ifdef PT_HOST_EMULATION
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#else
  return __uint_as_float(u);
#endif
}
PT_DEVICE uint32_t f_bits(float v) {
#ifdef PT_HOST_EMULATION
  uint32_t u;
  std::memcpy(&u, &v, 4);
  return u;
#else
  return __float_as_uint(v);
#endif
}

// cvt.rna.tf32.f32: v rounded to tf32 (10 mantissa bits; to nearest, ties
// away from zero), as the 32-bit pattern a tf32 wgmma operand holds (the
// 13 bits below tf32's mantissa zero).
PT_DEVICE uint32_t tf32_rna(float v) {
#ifdef PT_HOST_EMULATION
  const uint32_t u = f_bits(v);
  if ((u & 0x7f800000u) == 0x7f800000u) return (u & 0x7fffffu) ? 0x7fffffffu : u;  // NaN, infinities
  return (u + 0x1000u) & 0xffffe000u;  // the magnitude's bits: ties round away from zero
#else
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
#endif
}

// The 3xTF32 split of one A element: hi = tf32(v), lo = tf32(v - hi) (the
// difference is exact in float32).
PT_DEVICE void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - bits_f(hi));
}

// ldmatrix.x4: lane l gives the address of row (l & 7) of 8x8 matrix l >> 3;
// register i of lane l receives elements (l >> 2, 2(l & 3) + {0, 1}) of
// matrix i (of 32-bit elements, a matrix of 8 rows x 4: element (l >> 2,
// l & 3)). The float32 bodies load their A through it too.
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

// ---------------------------------------------------------------------------
// mbarriers and the bulk copy
// ---------------------------------------------------------------------------

#ifdef PT_HOST_EMULATION
// An emulated mbarrier in its 8 bytes: arrivals still pending in this
// phase, the arrival count (bit 15: the phase), transaction bytes pending.
struct EmuBar {
  uint16_t pending, count_phase;
  int32_t tx;
};
static_assert(sizeof(EmuBar) == 8, "an mbarrier is 8 bytes");
inline EmuBar* emu_bar(uint64_t* b) { return reinterpret_cast<EmuBar*>(b); }
inline void emu_bar_settle(EmuBar* e) {
  if (e->pending == 0 && e->tx == 0) {
    e->count_phase ^= 0x8000;
    e->pending = e->count_phase & 0x7fff;
  }
}
#endif

PT_DEVICE void mbar_init(uint64_t* bar, int count) {
#ifdef PT_HOST_EMULATION
  *emu_bar(bar) = EmuBar{uint16_t(count), uint16_t(count), 0};
#else
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
#endif
}

// Makes the initialised barriers visible to the async proxy (bulk copies).
PT_DEVICE void mbar_fence_init() {
#ifndef PT_HOST_EMULATION
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

PT_DEVICE void mbar_arrive(uint64_t* bar) {
#ifdef PT_HOST_EMULATION
  EmuBar* e = emu_bar(bar);
  if (e->pending == 0) return fault("mbarrier: more arrivals than its count in one phase");
  --e->pending;
  emu_bar_settle(e);
#else
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
#endif
}

PT_DEVICE void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
#ifdef PT_HOST_EMULATION
  emu_bar(bar)->tx += (int32_t)bytes;
  mbar_arrive(bar);
#else
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
#endif
}

#ifdef PT_HOST_EMULATION
// Whether the barrier's phase of this parity has completed (no wait).
inline bool mbar_test(uint64_t* bar, uint32_t parity) { return (emu_bar(bar)->count_phase >> 15) != parity; }
#endif

// Wait until the barrier's phase of this parity has completed.
PT_DEVICE void mbar_wait(uint64_t* bar, uint32_t parity) {
#ifdef PT_HOST_EMULATION
  if ((emu_bar(bar)->count_phase >> 15) == parity)
    fault("mbarrier wait on a phase that has not completed (arrivals or transaction bytes missing)");
#else
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
#endif
}

// One bulk copy of the Tensor Memory Accelerator, device memory -> shared
// memory, completing `bytes` transaction bytes on `bar`. Both addresses on
// 16 bytes, bytes a multiple of 16.
PT_DEVICE void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
#ifdef PT_HOST_EMULATION
  const uint32_t d = smem_addr(dst);
  if ((d | bytes) % 16 || (uintptr_t)src % 16 || d + (size_t)bytes > g_smem_bytes)
    return fault("bulk copy: misaligned, or outside shared memory");
  std::memcpy(dst, src, bytes);
  EmuBar* e = emu_bar(bar);
  e->tx -= (int32_t)bytes;
  if (e->tx < 0) return fault("bulk copy: more bytes than the mbarrier expects");
  emu_bar_settle(e);
#else
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
#endif
}

// ---------------------------------------------------------------------------
// wgmma: D (64 x N, f32) += A (64 x 16 bf16, or 64 x 8 tf32; registers) *
// B (16 x N bf16, or 8 x N tf32; shared memory)
// ---------------------------------------------------------------------------

// Matrix descriptor of a K-major B without swizzle: core matrices of 8 rows
// x 16 bytes, 128 contiguous bytes (row n of a core matrix: 8 bf16 or 4
// tf32 input channels); `lbo` bytes between core matrices along K, `sbo`
// bytes between core matrices along N. Fields: start address >> 4 (bits 0-13), lbo >> 4 (16-29), sbo >> 4
// (32-45), base offset 0 (49-51), layout 0 = no swizzle (62-63).
PT_HD uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

#ifdef PT_HOST_EMULATION
// Byte address the descriptor gives element (k, n) of a K-major B of
// esize-byte elements (bf16: k < 16, tf32: k < 8; a core matrix row is 16
// bytes, 8 or 4 elements of K): no swizzle, or 128/64/32-byte swizzle (rows
// of that many bytes in 8-row atoms, the 16-byte unit XORed with the row
// within the atom).
inline bool desc_addr(uint64_t desc, int k, int n, int esize, uint32_t* out) {
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4, lbo = uint32_t((desc >> 16) & 0x3FFF) << 4,
                 sbo = uint32_t((desc >> 32) & 0x3FFF) << 4, base = uint32_t((desc >> 49) & 7),
                 layout = uint32_t(desc >> 62);
  if (base) return false;
  const int per = 16 / esize;  // K elements of a core matrix row
  if (layout == 0) {
    *out = start + (n >> 3) * sbo + (k / per) * lbo + (n & 7) * 16 + (k % per) * esize;
    return true;
  }
  const int bits = layout == 1 ? 3 : layout == 2 ? 2 : 1;  // 128B, 64B, 32B
  const uint32_t lin = start + (n >> 3) * sbo + (n & 7) * (16u << bits) + k * esize;
  *out = lin ^ (((lin >> 7) & ((1u << bits) - 1)) << 4);
  return true;
}

// The warpgroups' issued wgmmas, retired in order by wgmma_wait.
struct EmuMma {
  void* d;
  const Regs<U4>* a;
  U4 a_issued[128];
  uint64_t desc;
  int wg;
  void (*run)(const EmuMma&);
};
inline std::vector<EmuMma> g_mma[kGroups];
inline std::vector<int> g_mma_groups[kGroups];  // ops per committed group, oldest first
inline int g_mma_open[kGroups];                 // ops issued since the last commit
inline bool g_mma_fenced[kGroups];

// d += A (64 x K) * B (K x N) in the m64nN accumulator layout: register i
// of lane l of warp w holds (16w + (l >> 2) + 8((i >> 1) & 1), 8(i >> 2) +
// 2(l & 3) + (i & 1)); each sum runs over k in order.
template <int N, int K>
void emu_accumulate(Regs<Acc<N>>& d, int wg, const float (*A)[16], const float (*B)[256]) {
  for (int w = 0; w < 4; ++w)
    for (int l = 0; l < 32; ++l) {
      const int tid = wg * 128 + w * 32 + l, g = l >> 2, t = l & 3;
      Acc<N>& c = d[tid];
      for (int i = 0; i < N / 2; ++i) {
        const int row = 16 * w + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t + (i & 1);
        float acc = c.x[i];
        for (int k = 0; k < K; ++k) acc = fmaf(A[row][k], B[k][col], acc);
        c.x[i] = acc;
      }
    }
}

template <int N>
void emu_wgmma_run(const EmuMma& op) {
  Regs<Acc<N>>& d = *static_cast<Regs<Acc<N>>*>(op.d);
  float A[64][16];
  static float B[16][256];
  for (int w = 0; w < 4; ++w)
    for (int l = 0; l < 32; ++l) {
      const int tid = op.wg * 128 + w * 32 + l, g = l >> 2, t = l & 3;
      const U4& ra = op.a_issued[w * 32 + l];
      const U4& now = (*op.a)[tid];
      for (int i = 0; i < 4; ++i)
        if (now.x[i] != ra.x[i]) fault("wgmma: A registers changed before the product retired");
      for (int q = 0; q < 2; ++q) {
        A[16 * w + g][2 * t + q] = half_f(ra.x[0], q);
        A[16 * w + g + 8][2 * t + q] = half_f(ra.x[1], q);
        A[16 * w + g][2 * t + 8 + q] = half_f(ra.x[2], q);
        A[16 * w + g + 8][2 * t + 8 + q] = half_f(ra.x[3], q);
      }
    }
  for (int k = 0; k < 16; ++k)
    for (int n = 0; n < N; ++n) {
      uint32_t ad;
      if (!desc_addr(op.desc, k, n, 2, &ad) || ad + 2 > g_smem_bytes || ad % 2) {
        fault("wgmma: B descriptor outside shared memory or unsupported");
        B[k][n] = 0.f;
        continue;
      }
      pt_bf16 v;
      std::memcpy(&v, g_smem + ad, 2);
      B[k][n] = pt_bf16_to_float(v);
    }
  emu_accumulate<N, 16>(d, op.wg, A, B);
}

// A tf32 operand's 32-bit pattern as the product reads it (the 13 bits
// below tf32's mantissa must be zero, as cvt.rna.tf32.f32 leaves them).
inline float tf32_operand(uint32_t u) {
  if (u & 0x1fffu) fault("wgmma: a tf32 operand with mantissa bits below tf32's (no cvt.rna.tf32.f32)");
  return bits_f(u);
}

// wgmma m64nNk8 tf32: register i of lane l holds A element (16w + g +
// 8(i & 1), t + 4(i >> 1)) (g = l >> 2, t = l & 3, w the warp in the group);
// B is 8 x N through the descriptor, core matrices of 8 rows x 4 tf32.
template <int N>
void emu_wgmma_tf32_run(const EmuMma& op) {
  Regs<Acc<N>>& d = *static_cast<Regs<Acc<N>>*>(op.d);
  float A[64][16];
  static float B[16][256];
  for (int w = 0; w < 4; ++w)
    for (int l = 0; l < 32; ++l) {
      const int tid = op.wg * 128 + w * 32 + l, g = l >> 2, t = l & 3;
      const U4& ra = op.a_issued[w * 32 + l];
      const U4& now = (*op.a)[tid];
      for (int i = 0; i < 4; ++i) {
        if (now.x[i] != ra.x[i]) fault("wgmma: A registers changed before the product retired");
        A[16 * w + g + 8 * (i & 1)][t + 4 * (i >> 1)] = tf32_operand(ra.x[i]);
      }
    }
  for (int k = 0; k < 8; ++k)
    for (int n = 0; n < N; ++n) {
      uint32_t ad;
      if (!desc_addr(op.desc, k, n, 4, &ad) || ad + 4 > g_smem_bytes || ad % 4) {
        fault("wgmma: B descriptor outside shared memory or unsupported");
        B[k][n] = 0.f;
        continue;
      }
      uint32_t u;
      std::memcpy(&u, g_smem + ad, 4);
      B[k][n] = tf32_operand(u);
    }
  emu_accumulate<N, 8>(d, op.wg, A, B);
}
#else
template <int N>
PT_DEVICE void wgmma_rs_asm(float* d, const uint32_t* a, uint64_t desc);
template <>
PT_DEVICE void wgmma_rs_asm<16>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
PT_DEVICE void wgmma_rs_asm<32>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
PT_DEVICE void wgmma_rs_asm<64>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
PT_DEVICE void wgmma_rs_asm<128>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
PT_DEVICE void wgmma_rs_asm<256>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// wgmma m64nNk8, tf32 in: A's four registers and B's elements hold tf32
// patterns (cvt.rna.tf32.f32); no transpose (tf32 B is K-major only).
template <int N>
PT_DEVICE void wgmma_tf32_asm(float* d, const uint32_t* a, uint64_t desc);
template <>
PT_DEVICE void wgmma_tf32_asm<16>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
PT_DEVICE void wgmma_tf32_asm<32>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
PT_DEVICE void wgmma_tf32_asm<64>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
PT_DEVICE void wgmma_tf32_asm<128>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <>
PT_DEVICE void wgmma_tf32_asm<256>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
#endif

// wgmma.fence: orders this warpgroup's register writes (A fragments,
// accumulators) before the products that read them.
PT_DEVICE void wgmma_fence(int wg) {
#ifdef PT_HOST_EMULATION
  g_mma_fenced[wg] = true;
#else
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

PT_DEVICE void wgmma_commit(int wg) {
#ifdef PT_HOST_EMULATION
  g_mma_groups[wg].push_back(g_mma_open[wg]);
  g_mma_open[wg] = 0;
#else
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

// wgmma.wait_group: wait until at most `Pending` committed groups are in
// flight (the emulation retires the older ones now, in order).
template <int Pending>
PT_DEVICE void wgmma_wait(int wg) {
#ifdef PT_HOST_EMULATION
  while ((int)g_mma_groups[wg].size() > Pending) {
    const int n = g_mma_groups[wg].front();
    g_mma_groups[wg].erase(g_mma_groups[wg].begin());
    for (int i = 0; i < n; ++i) g_mma[wg][i].run(g_mma[wg][i]);
    g_mma[wg].erase(g_mma[wg].begin(), g_mma[wg].begin() + n);
  }
  g_mma_fenced[wg] = false;
#else
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
#endif
}

#ifdef PT_HOST_EMULATION
// Issue one emulated product: it runs when wait_group retires its group.
inline void emu_issue(void* d, const Regs<U4>& a, uint64_t desc_b, int wg, void (*run)(const EmuMma&)) {
  if (!g_mma_fenced[wg]) fault("wgmma without a wgmma.fence after its registers were written");
  EmuMma op;
  op.d = d;
  op.a = &a;
  for (int i = 0; i < 128; ++i) op.a_issued[i] = a[wg * 128 + i];
  op.desc = desc_b;
  op.wg = wg;
  op.run = run;
  g_mma[wg].push_back(op);
  ++g_mma_open[wg];
}
#endif

// One asynchronous warpgroup product, D += A * B (bf16, k16).
template <int N>
PT_DEVICE void wgmma(Regs<Acc<N>>& d, const Regs<U4>& a, uint64_t desc_b, int wg) {
#ifdef PT_HOST_EMULATION
  emu_issue(&d, a, desc_b, wg, &emu_wgmma_run<N>);
#else
  wgmma_rs_asm<N>(d[0].x, a[0].x, desc_b);
#endif
}

// One asynchronous warpgroup product, D += A * B (tf32, k8).
template <int N>
PT_DEVICE void wgmma_tf32(Regs<Acc<N>>& d, const Regs<U4>& a, uint64_t desc_b, int wg) {
#ifdef PT_HOST_EMULATION
  emu_issue(&d, a, desc_b, wg, &emu_wgmma_tf32_run<N>);
#else
  wgmma_tf32_asm<N>(d[0].x, a[0].x, desc_b);
#endif
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
PT_DEVICE void fence_acc(Regs<Acc<N>>& d) {
#ifndef PT_HOST_EMULATION
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[0].x[i])::"memory");
#endif
}

// ---------------------------------------------------------------------------
// The weight ring
// ---------------------------------------------------------------------------

// One segment of a block's weight stream: `bytes` contiguous from src
// (one conv's taps, or one polyphase output phase's), in stages of
// piece_bytes (the last one shorter where the bytes end first). A stream
// of two planes (Stream::kPlanes, float32: hi and lo) has the same bytes
// of the lo plane at src + lo; a stage then holds the piece's hi bytes,
// then its lo bytes.
struct SegInfo {
  const char* src;
  int bytes, piece_bytes;
  size_t lo = 0;
};

// The weights a block's GEMMs read, in the order they read them, flow
// from device memory (L2) through n_slots shared stages: stage s lands in
// slot s % n_slots by one bulk copy that completes on full[slot]; each of
// the block's consumer warps arrives on empty[slot] once its products on
// the stage have retired. One thread of the producer warpgroup issues the
// copies: it refills a slot as soon as its readers have released it, so
// up to n_slots stages are in flight and the consumers never issue or
// wait for one another. Stream: SegInfo operator()(int seg) and int
// total(), the stages of all segments.
struct Ring {
  char* slots;
  int slot_bytes, n_slots;
  uint64_t *full, *empty;
  int tail;                     // stages read (consumers)
  int head, total, seg, piece;  // stages issued, in the stream, cursor (producer)
};

template <typename Stream>
PT_DEVICE void ring_issue(Ring& r, const Stream& s) {
  const int slot = r.head % r.n_slots;
  const SegInfo si = s(r.seg);
  const int done = r.piece * si.piece_bytes, bytes = min(si.piece_bytes, si.bytes - done);
  char* dst = r.slots + (size_t)slot * r.slot_bytes;
  mbar_arrive_expect_tx(r.full + slot, (uint32_t)(bytes * Stream::kPlanes));
  bulk_copy(dst, si.src + done, (uint32_t)bytes, r.full + slot);
  if constexpr (Stream::kPlanes == 2) bulk_copy(dst + bytes, si.src + si.lo + done, (uint32_t)bytes, r.full + slot);
  ++r.head;
  if (done + bytes == si.bytes) {
    r.piece = 0;
    ++r.seg;
  } else {
    ++r.piece;
  }
}

#ifdef PT_HOST_EMULATION
// The producer's progress, as the host emulation models it where a
// consumer waits on stage `tail` (as far as the producer can have got):
// every stage whose slot its readers have released, waiting for a slot
// only when the stage about to be read is not yet issued.
template <typename Stream>
void ring_pump(Ring& r, const Stream& s) {
  while (r.head < r.total && r.head < r.tail + r.n_slots) {
    if (r.head >= r.n_slots) {
      uint64_t* empty = r.empty + r.head % r.n_slots;
      const uint32_t parity = (uint32_t)((r.head / r.n_slots - 1) & 1);
      if (r.head > r.tail) {
        if (!mbar_test(empty, parity)) return;
      } else {
        mbar_wait(empty, parity);
      }
    }
    ring_issue(r, s);
  }
}
#endif

#ifndef PT_HOST_EMULATION
template <int Regs>
PT_DEVICE void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}
template <int Regs>
PT_DEVICE void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}
#endif

// Start the ring and split the block: returns false in the producer
// warpgroup, whose first thread has streamed every stage of the block by
// then, and true in the consumers, once the barriers are initialised.
// Its barrier also orders the consumers' writes before it. (The host
// emulation initialises the barriers and issues the first stages here.)
template <typename Stream>
PT_DEVICE bool ring_split(Ring& r, const Stream& s) {
  r.tail = r.head = r.seg = r.piece = 0;
  r.total = s.total();
#ifdef PT_HOST_EMULATION
  for (int i = 0; i < r.n_slots; ++i) {
    mbar_init(r.full + i, 1);
    mbar_init(r.empty + i, kWarps);
  }
  ring_pump(r, s);
  return true;
#else
  if (threadIdx.x >= kThreads) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < kThreads + 32) {
      if (threadIdx.x == kThreads) {
        for (int i = 0; i < r.n_slots; ++i) {
          mbar_init(r.full + i, 1);
          mbar_init(r.empty + i, kWarps);
        }
        mbar_fence_init();
      }
      asm volatile("bar.sync 2, %0;\n" ::"n"(kThreads + 32) : "memory");
      if (threadIdx.x == kThreads)
        while (r.head < r.total) {
          if (r.head >= r.n_slots)
            mbar_wait(r.empty + r.head % r.n_slots, (uint32_t)((r.head / r.n_slots - 1) & 1));
          ring_issue(r, s);
        }
    }
    return false;
  }
  setmaxnreg_inc<kConsumerRegs>();
  asm volatile("bar.sync 2, %0;\n" ::"n"(kThreads + 32) : "memory");
  return true;
#endif
}

// ---------------------------------------------------------------------------
// One conv as an implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

PT_DEVICE float lrelu(float v, float slope) { return v >= 0.f ? v : v * slope; }

// out[r][n] = sum_tap sum_k A[r + tap*a_step + a_shift][k] * W_tap[k][n]
// for output rows r in [row0, row0 + n_rows) and columns n < n_real. A is
// position-major E in shared memory (a_rows rows of stride lda, zero
// columns past the real K); the W_tap come from the ring, tap by tap, each
// in k_chunks / step_chunks stages of step_chunks units (32-byte K slices:
// 16 bf16 or 8 float input channels; rows of the kernel's weight layout:
// K-major core matrices of 8 rows x 16 bytes, N = the product's width).
// Warpgroup wg owns the 64-row tiles mt with (mt + rot) % kGroups == wg (at
// most mt_per_group(N)) and every column, and keeps their f32 sums in
// registers; its four warps load A with ldmatrix (a dilated tap is a shift
// of the A rows; rows past the window are clamped to its last row and
// their sums discarded). In float32 (3xTF32) a warp then splits each A
// element into tf32 hi and lo in registers, after, where the GEMM's Act is
// set, the conv input's activation: A = mask(lrelu_0.1(window)), rows
// outside [v_lo, v_hi) zero. The sums run over taps, then units (then, in
// float32, A_hi B_hi, A_hi B_lo, A_lo B_hi), so an output element's order
// depends neither on the tile nor on the stage size. With sync_epi the
// consumer warpgroups meet at a barrier after their products and before
// any epilogue, so an epilogue may overwrite the A window in place.
// epi(r, col0, v) receives row r's sums at columns col0 + 8j + {0, 1} as
// v[2j], v[2j + 1] for j < kEpiPairs<N> (the columns one thread holds;
// those at or past n_real are not defined), so it can issue all its loads
// before its stores.
template <int N>
constexpr int kEpiPairs = N / 8 < 8 ? N / 8 : 8;

template <typename E>
struct Gemm {
  const E* a;
  int lda, a_rows, row0, n_rows, a_step, a_shift, k_chunks, step_chunks, step_taps, n_real, n_taps;
  int rot;  // tile mt belongs to warpgroup (mt + rot) % kGroups
  int sync_epi = 0;
  int v_lo = 0, v_hi = 0;  // float32 with Act: A rows in [v_lo, v_hi) are the conv input's valid rows
};

// One step of warpgroup wg: its T output tiles (first, first + kGroups,
// ...) times U units of the stage at shared address b0, unit u being
// unit kc0 + u % KC of tap kk0 + u / KC (a stage holds its taps' units
// in that order, N * 32 bytes each; in float32 the lo plane's U units
// follow the hi plane's). For each tile the warps load its A units with
// ldmatrix (float32: and split them), then the group issues their
// products (so the next tile's loads overlap this tile's products); then
// it waits for all of them. T, KC and U are compile-time, so the products
// form one branch-free run that the compiler does not serialise. A
// float32 unit's hi and lo fragments are fa[m][u] and fa[m][kMaxUnits + u].
template <typename E, int N, bool Act, int T, int KC, int U>
PT_DEVICE void step_products(Regs<Acc<N>>* acc, Regs<U4> (*fa)[kMaxChunks], const Gemm<E>& g, int wg, int first,
                             int kk0, int kc0, uint32_t b0) {
  constexpr int kLo = Elem<E>::kMaxUnits, kCh = Elem<E>::kUnitCh;
#pragma unroll
  for (int m = 0; m < T; ++m) {
    const int mt = first + kGroups * m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      PT_GROUP_WARPS(wg, wp) {
        Regs<const pt_bf16*> pa;
        PT_LANES(wp, tid) {
          const int l = tid & 31;
          const int r = g.row0 + mt * 64 + (wp & 3) * 16 + (kk0 + u / KC) * g.a_step + g.a_shift + (l & 7) +
                        ((l >> 3) & 1) * 8;
          pa[tid] = reinterpret_cast<const pt_bf16*>(g.a + (size_t)min(r, g.a_rows - 1) * g.lda +
                                                     (kc0 + u % KC) * kCh + (l >> 4) * (kCh / 2));
        }
        ldsm_x4(fa[m][u], pa, wp);
        if constexpr (kF32<E>) {
          // register i holds A (row g + 8(i & 1), column t + 4(i >> 1)) of
          // the warp's 16 rows, as the tf32 fragment wants it
          PT_LANES(wp, tid) {
            const int r = g.row0 + mt * 64 + (wp & 3) * 16 + (kk0 + u / KC) * g.a_step + g.a_shift + ((tid & 31) >> 2);
            U4& hi = fa[m][u][tid];
            U4& lo = fa[m][kLo + u][tid];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float v = bits_f(hi.x[i]);
              if constexpr (Act) {
                const int ri = r + 8 * (i & 1);
                v = ri >= g.v_lo && ri < g.v_hi ? lrelu(v, 0.1f) : 0.f;
              }
              tf32_split(v, hi.x[i], lo.x[i]);
            }
          }
        }
      }
    }
    wgmma_fence(wg);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // unit u: core-matrix rows 2u, 2u + 1 of the stage (N / 8 core
      // matrices of 128 bytes each)
      const uint64_t bh = wgmma_desc(b0 + u * N * 32, N * 16, 128);
      if constexpr (kF32<E>) {
        const uint64_t bl = wgmma_desc(b0 + (U + u) * N * 32, N * 16, 128);
        wgmma_tf32<N>(acc[m], fa[m][u], bh, wg);
        wgmma_tf32<N>(acc[m], fa[m][u], bl, wg);
        wgmma_tf32<N>(acc[m], fa[m][kLo + u], bh, wg);
      } else {
        wgmma<N>(acc[m], fa[m][u], bh, wg);
      }
    }
  }
  wgmma_commit(wg);
  wgmma_wait<0>(wg);
}

template <typename E, int N, bool Act, int KC, int U>
PT_DEVICE void step_tiles(Regs<Acc<N>>* acc, Regs<U4> (*fa)[kMaxChunks], const Gemm<E>& g, int wg, int first,
                          int mine, int kk0, int kc0, uint32_t b0) {
  constexpr int MT = mt_per_group(N);
  if (mine == 1) step_products<E, N, Act, 1, KC, U>(acc, fa, g, wg, first, kk0, kc0, b0);
  if constexpr (MT >= 2)
    if (mine == 2) step_products<E, N, Act, 2, KC, U>(acc, fa, g, wg, first, kk0, kc0, b0);
  if constexpr (MT >= 3)
    if (mine == 3) step_products<E, N, Act, 3, KC, U>(acc, fa, g, wg, first, kk0, kc0, b0);
  if constexpr (MT >= 4)
    if (mine == 4) step_products<E, N, Act, 4, KC, U>(acc, fa, g, wg, first, kk0, kc0, b0);
}

// The step's products with KC and U as compile-time constants. bf16: KC =
// 4 (one unit per chunk), 2 (one or two taps) or 1 (one to four taps).
// float32: one tap's piece of KC = U = 2 or 1 units.
template <typename E, int N, bool Act>
PT_DEVICE void step_units(Regs<Acc<N>>* acc, Regs<U4> (*fa)[kMaxChunks], const Gemm<E>& g, int wg, int first,
                          int mine, int units, int kk0, int kc0, uint32_t b0) {
  if constexpr (kF32<E>) {
    if (g.step_chunks == 2) step_tiles<E, N, Act, 2, 2>(acc, fa, g, wg, first, mine, kk0, kc0, b0);
    if (g.step_chunks == 1) step_tiles<E, N, Act, 1, 1>(acc, fa, g, wg, first, mine, kk0, kc0, b0);
  } else if (g.step_chunks == kMaxChunks) {
    step_tiles<E, N, Act, kMaxChunks, kMaxChunks>(acc, fa, g, wg, first, mine, kk0, kc0, b0);
  } else if (g.step_chunks == 2) {
    if constexpr (N <= 64)  // stage_taps: several taps only up to 64 wide
      if (units == 4) step_tiles<E, N, Act, 2, 4>(acc, fa, g, wg, first, mine, kk0, kc0, b0);
    if (units == 2) step_tiles<E, N, Act, 2, 2>(acc, fa, g, wg, first, mine, kk0, kc0, b0);
  } else {
    if constexpr (N <= 64) {
      if (units == 4) step_tiles<E, N, Act, 1, 4>(acc, fa, g, wg, first, mine, kk0, kc0, b0);
      if (units == 3) step_tiles<E, N, Act, 1, 3>(acc, fa, g, wg, first, mine, kk0, kc0, b0);
      if (units == 2) step_tiles<E, N, Act, 1, 2>(acc, fa, g, wg, first, mine, kk0, kc0, b0);
    }
    if (units == 1) step_tiles<E, N, Act, 1, 1>(acc, fa, g, wg, first, mine, kk0, kc0, b0);
  }
}

template <typename E, int N, bool Act = false, typename Stream, typename Epi>
PT_DEVICE void gemm(const Gemm<E>& g, Ring& ring, const Stream& stream, Epi epi) {
  constexpr int MT = mt_per_group(N);
  const int n_mt = (g.n_rows + 63) / 64;
  const int pieces = g.k_chunks / g.step_chunks;  // steps of one tap (1 where a step holds taps)
  const int n_steps = g.step_taps > 1 ? (g.n_taps + g.step_taps - 1) / g.step_taps : g.n_taps * pieces;
  Regs<Acc<N>> acc[MT];
  Regs<U4> fa[MT][kMaxChunks];
  PT_CTHREADS(tid) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[m][tid].x[i] = 0.f;
  }
  for (int st = 0; st < n_steps; ++st) {
    const int kk0 = g.step_taps > 1 ? st * g.step_taps : st / pieces;
    const int kc0 = g.step_taps > 1 ? 0 : (st - kk0 * pieces) * g.step_chunks;
    const int units = g.step_taps > 1 ? min(g.step_taps, g.n_taps - kk0) * g.step_chunks : g.step_chunks;
    const int slot = ring.tail % ring.n_slots;
    PT_CTHREADS(tid) {
#ifdef PT_HOST_EMULATION
      if (tid == 0) ring_pump(ring, stream);
#endif
      mbar_wait(ring.full + slot, (uint32_t)((ring.tail / ring.n_slots) & 1));
    }
    const uint32_t b0 = smem_addr(ring.slots + (size_t)slot * ring.slot_bytes);
    PT_GROUPS(wg) {
      const int first = (wg + kGroups - g.rot % kGroups) % kGroups;           // this group's first tile
      const int mine = n_mt > first ? (n_mt - first + kGroups - 1) / kGroups : 0;  // and its tiles
      step_units<E, N, Act>(acc, fa, g, wg, first, mine, units, kk0, kc0, b0);
      PT_GROUP_WARPS(wg, wp) {
        PT_LANES(wp, tid) {
          if ((tid & 31) == 0) mbar_arrive(ring.empty + slot);
        }
      }
    }
    ++ring.tail;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_acc<N>(acc[m]);
  if (g.sync_epi) PT_CSYNC();
  PT_GROUPS(wg) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = (wg + kGroups - g.rot % kGroups) % kGroups + kGroups * m;
      if (mt >= n_mt) break;
      PT_GROUP_WARPS(wg, wp) {
        PT_LANES(wp, tid) {
          const int l = tid & 31;
          const Acc<N>& c = acc[m][tid];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = g.row0 + mt * 64 + (wp & 3) * 16 + (l >> 2) + 8 * half;
            if (r >= g.row0 + g.n_rows) continue;
#pragma unroll
            for (int grp = 0; grp < N / 8 / kEpiPairs<N>; ++grp) {
              const int col0 = grp * 8 * kEpiPairs<N> + 2 * (l & 3);
              if (col0 >= g.n_real) break;
              float v[2 * kEpiPairs<N>];
#pragma unroll
              for (int jj = 0; jj < kEpiPairs<N>; ++jj) {
                v[2 * jj] = c.x[4 * (grp * kEpiPairs<N> + jj) + 2 * half];
                v[2 * jj + 1] = c.x[4 * (grp * kEpiPairs<N> + jj) + 2 * half + 1];
              }
              epi(r, col0, v);
            }
          }
        }
      }
    }
  }
}

// v rounded to E (the plain version's rounding points): bf16, or float32 as it is
template <typename E>
PT_DEVICE float round_e(float v) {
  return to_f(from_f<E>(v));
}

PT_DEVICE void zero16(void* p) {
#ifdef PT_HOST_EMULATION
  std::memset(p, 0, 16);
#else
  *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
#endif
}

// Two neighbouring elements (p on 4 bytes for bf16, 8 for float) as
// floats, and two floats rounded to the element type and stored together.
struct F2 {
  float x, y;
};
PT_DEVICE F2 ld_pair(const pt_bf16* p) {
#ifdef PT_HOST_EMULATION
  return {to_f(p[0]), to_f(p[1])};
#else
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return {f.x, f.y};
#endif
}
PT_DEVICE void st_pair(pt_bf16* p, float a, float b) {
#ifdef PT_HOST_EMULATION
  p[0] = from_f<pt_bf16>(a);
  p[1] = from_f<pt_bf16>(b);
#else
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
#endif
}
PT_DEVICE F2 ld_pair(const float* p) {
#ifdef PT_HOST_EMULATION
  return {p[0], p[1]};
#else
  const float2 f = *reinterpret_cast<const float2*>(p);
  return {f.x, f.y};
#endif
}
PT_DEVICE void st_pair(float* p, float a, float b) {
#ifdef PT_HOST_EMULATION
  p[0] = a;
  p[1] = b;
#else
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
#endif
}
PT_DEVICE F2 ldg_pair(const float* p) {
#ifdef PT_HOST_EMULATION
  return {p[0], p[1]};
#else
  const float2 f = __ldg(reinterpret_cast<const float2*>(p));
  return {f.x, f.y};
#endif
}

// The MRF chain's shared-memory buffers over a window of w position-major
// rows of stride ldc (round16(c) + Elem<E>::kPad: ldmatrix rows hit
// distinct banks): the residual stream h (w rows), the resblock sum xs
// (xs_w rows, window rows xs_off...), and a[0], a[1] (w rows each): in
// bf16 the convs' activated inputs; in float32 (activation on load) a[0]
// is resblock "1"'s inner conv output and a[1] unused. Window rows in
// [v_lo, v_hi) are inside the row's valid length; each conv's weights
// come from the ring in steps of step_chunks units of step_taps taps.
template <typename E>
struct ChainTc {
  E *a[2], *h, *xs;
  int step_chunks, step_taps, c, cp, ldc, w, xs_off, xs_w, v_lo, v_hi;
};

// Run the MRF chain of one stage on the tensor cores; xs must be zero on
// entry and receives the sum over resblocks of the masked resblock
// outputs over its rows. At the start of each resblock, load_in(tid)
// writes the thread's share of the stage input over the window: h = the
// input (zero outside [v_lo, v_hi)) and, in bf16, a[0] = mask(lrelu_0.1(h)).
// Conv j of a resblock computes the rows the rest of the resblock still
// reads: [xs_off - E, xs_off + xs_w + E), E = the reach of the convs after
// it; its input covers the previous conv's rows. Its epilogue adds the
// bias and rounds, then (resblock "1", first conv of a pair) writes the
// next conv's input, or adds the residual, rounds, and writes h and, in
// bf16, the next conv's input or, after the last conv, adds to xs; the
// rounding points are those of the plain version (ops/cuda/vocoder.py::
// mrf_fused_plain). In float32 a conv reads its input activated on load
// from h (or from a[0]), and writes h in place once both warpgroups have
// run their products (the GEMM's sync_epi). The convs' weights are the
// ring stream's next segments, in plan order.
template <typename E, int N, typename Stream, typename LoadIn>
PT_DEVICE void mrf_chain_tc(const MrfPlan& plan, const ChainTc<E>& m, Ring& ring, const Stream& stream,
                            const float* __restrict__ bm, LoadIn load_in) {
  const int c = m.c, ldc = m.ldc;
  int conv = 0;
  for (int r = 0; r < plan.n_res; ++r) {
    PT_CTHREADS(tid) { load_in(tid); }
    PT_CSYNC();
    int reach = 0;
    for (int j = 0; j < plan.n_steps[r]; ++j) reach += (plan.k[conv + j] * plan.d[conv + j] - plan.d[conv + j]) / 2;
    int cur = 0;
    for (int j = 0; j < plan.n_steps[r]; ++j, ++conv) {
      const int k = plan.k[conv], d = plan.d[conv], pad = (k * d - d) / 2;
      reach -= pad;
      const bool inner = plan.rb1 && (j % 2 == 0);  // resblock "1": conv before the residual add
      const bool last = j == plan.n_steps[r] - 1;
      const float* bias = bm + (size_t)conv * c;
      E* nxt = m.a[cur ^ 1];
      E* h = m.h;
      E* xs = m.xs;
      const E* src = kF32<E> ? (plan.rb1 && j % 2 ? m.a[0] : h) : m.a[cur];
      const Gemm<E> g{src,          ldc,           m.w,           m.xs_off - reach, m.xs_w + 2 * reach, d, -pad,
                      m.cp / Elem<E>::kUnitCh, m.step_chunks, m.step_taps, c, k, 0, kF32<E> && !inner,
                      m.v_lo,       m.v_hi};
      gemm<E, N, kF32<E>>(g, ring, stream, [&](int i, int col0, const float* v) {
        constexpr int J = kEpiPairs<N>;
        const bool ok = i >= m.v_lo && i < m.v_hi;
        const size_t row = (size_t)i * ldc + col0;
        F2 b[J], hv[J], xv[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {  // every load first, then the stores
          if (col0 + 8 * j >= c) break;
          b[j] = ldg_pair(bias + col0 + 8 * j);
          if (!inner) hv[j] = ld_pair(h + row + 8 * j);
          if (last) xv[j] = ld_pair(xs + (size_t)(i - m.xs_off) * ldc + col0 + 8 * j);
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (col0 + 8 * j >= c) break;
          const float u0 = round_e<E>(v[2 * j] + b[j].x), u1 = round_e<E>(v[2 * j + 1] + b[j].y);
          if (inner) {
            if constexpr (kF32<E>)
              st_pair(m.a[0] + row + 8 * j, u0, u1);
            else
              st_pair(nxt + row + 8 * j, ok ? lrelu(u0, 0.1f) : 0.f, ok ? lrelu(u1, 0.1f) : 0.f);
            continue;
          }
          const float h0 = round_e<E>(hv[j].x + u0), h1 = round_e<E>(hv[j].y + u1);
          if (last) {
            st_pair(xs + (size_t)(i - m.xs_off) * ldc + col0 + 8 * j, xv[j].x + (ok ? h0 : 0.f),
                    xv[j].y + (ok ? h1 : 0.f));
          } else {
            st_pair(h + row + 8 * j, h0, h1);
            if constexpr (!kF32<E>)
              st_pair(nxt + row + 8 * j, ok ? lrelu(h0, 0.1f) : 0.f, ok ? lrelu(h1, 0.1f) : 0.f);
          }
        }
      });
      PT_CSYNC();
      cur ^= 1;
    }
  }
}

}  // namespace pt
