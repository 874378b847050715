// Fused int8 matmul for Hopper (sm_90a): quantize -> int8 x int8 -> int32
// product -> dequant / bias / ReLU / requantize epilogue.
//
// Replaces the TPU kernel paddle_tpu/ops/int8_matmul.py::_kernel (launched
// by int8_matmul). Same function:
//   xq  = x                                   (int8 x), or
//         clip(rint(f32(x) * qscale), +-amax) (f32 / bf16 x, half-even)
//   acc = xq @ wq                             (int32, exact)
//   y   = f32(acc) * scale[n] + bias[n]       (two roundings, no FMA)
//   y   = max(y, 0)                           (relu)
//   out = clip(rint(y), +-amax) as int8       (int8 output), or y as f32/bf16
// so the int8 outputs equal the plain PyTorch version's bit for bit and the
// float outputs differ from it by nothing but the output cast.
//
// What bounds it on the H100: operations (2 M K N at the int8 tensor-core
// rate, 1,979 TOP/s) once M, N and K are in the thousands; the bytes (x,
// wq, out once each) are several times cheaper.
//
// Two routes, picked by shape before the launch (ops/int8_matmul.py:
// _mm_route):
//
// wgmma (K a multiple of 16, 16-byte aligned operands: TMA's row stride):
//  * x is quantized once, by int8_quantize_kernel, into an int8 copy
//    xq [M, K] (one f32 product, rint half-even, clip; 16 values a
//    thread); int8 x goes to the product as it is.
//  * wgmma reads 8-bit operands K-major only (the transpose flags exist
//    for 16-bit types), so the product reads wq as [N, K]. Int8Linear
//    keeps that copy beside its weight_q [K, N] (built once); a bare
//    int8_matmul call makes one per call.
//  * The product: wgmma.mma_async m64n256k32 s8 x s8 -> s32, both
//    operands from 128-byte-swizzled shared tiles that TMA wrote. A block
//    owns a 128 x 256 output tile: one producer warpgroup (one thread
//    issues every TMA load, setmaxnreg 24) streams [128 x 128] xq and
//    [256 x 128] wq tiles through a 4-stage ring of 48 KB (full / empty
//    mbarriers); two consumer warpgroups (setmaxnreg 240) each keep a
//    64 x 256 s32 accumulator (128 registers a thread) for the whole K
//    loop, one commit group of 4 products per k tile in flight while the
//    next waits. Blocks walk the tiles in groups of 8 row tiles, so the
//    blocks resident at once share their wq column tiles in L2.
//  * Epilogue: the same two-rounding math, staged in shared memory (the
//    ring, free by then) as 64 rows of 256 outputs a warpgroup, then
//    written with coalesced 16-byte stores (element stores at a ragged
//    column edge or an unaligned row pitch).
//  * Ragged M, N and K: TMA fills rows and columns past the extent with
//    zeros; rows and columns past M and N are never stored.
//
// mma (any other shape):
//  * mma.sync.m16n8k32 (s8 x s8 -> s32): a 128 x 128 output tile per block
//    of 8 warps (2 x 4, each 64 x 32), int32 accumulators in registers for
//    the whole K loop (the TPU kernel carried them in scratch across a
//    grid axis).
//  * mma wants both operands K-major (4 consecutive k of one row or column
//    in a 32-bit word). x [M, K] already is. wq [K, N] is N-major, so each
//    thread stages a 4 x 4 byte block and transposes it with byte_perm on
//    the way into shared memory. The shared rows are padded to 20 words,
//    which makes every fragment load conflict free (the transposed stores
//    of wq do conflict; staging is the smaller part of a tile's work).
//  * f32 / bf16 x is quantized while it is staged, so the int8 copy of x
//    never exists in device memory. Every block column quantizes its rows
//    of x again: the price of the fusion at this tile size.
//  * No padded copies of x or wq: ragged edges in M, N and K are zero
//    filled while staging and masked in the epilogue; rows that are not
//    word aligned (K or N not a multiple of 4) take byte loads.
//  * One shared buffer, no cp.async / TMA pipeline. Two blocks per SM
//    overlap one block's staging with the other's products.
//
// qscale, scale and bias are device pointers (no host sync).
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

using namespace ptt;

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // BK in int8 elements
constexpr int KW = BK / 4;                  // 32-bit words per staged row
constexpr int LDW = KW + 4;                 // padded row stride in words
constexpr int NT = 256;                     // threads per block

__device__ __forceinline__ uint32_t quant_byte(float x, float qs,
                                               float amax) {
  float v = rintf(__fmul_rn(x, qs));  // half-even of the one f32 product
  v = fminf(fmaxf(v, -amax), amax);
  return (uint32_t)(uint8_t)(int8_t)(int)v;
}

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

// One staged word of x: the 4 values x[row, k0 .. k0 + 3] as int8, lowest
// k in the lowest byte; zeros past M or K.
__device__ __forceinline__ uint32_t load_a_word(const int8_t* x, int row,
                                                int k0, int M, int K,
                                                bool vec, float, float) {
  if (row >= M || k0 >= K) return 0u;
  const int8_t* p = x + (long)row * K + k0;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k0 + j < K) w |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return w;
}

__device__ __forceinline__ uint32_t load_a_word(const float* x, int row,
                                                int k0, int M, int K,
                                                bool vec, float qs,
                                                float amax) {
  if (row >= M || k0 >= K) return 0u;
  const float* p = x + (long)row * K + k0;
  float v[4];
  if (vec) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = k0 + j < K ? p[j] : 0.f;
  }
  return pack4(quant_byte(v[0], qs, amax), quant_byte(v[1], qs, amax),
               quant_byte(v[2], qs, amax), quant_byte(v[3], qs, amax));
}

__device__ __forceinline__ uint32_t load_a_word(const __nv_bfloat16* x,
                                                int row, int k0, int M,
                                                int K, bool vec, float qs,
                                                float amax) {
  if (row >= M || k0 >= K) return 0u;
  const __nv_bfloat16* p = x + (long)row * K + k0;
  float v[4];
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    // a bf16 is the high half of its f32
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = k0 + j < K ? __bfloat162float(p[j]) : 0.f;
  }
  return pack4(quant_byte(v[0], qs, amax), quant_byte(v[1], qs, amax),
               quant_byte(v[2], qs, amax), quant_byte(v[3], qs, amax));
}

// wq[k, n .. n + 3] as one word, lowest n in the lowest byte; zeros past
// K or N.
__device__ __forceinline__ uint32_t load_b_word(const int8_t* wq, int k,
                                                int n, int K, int N,
                                                bool vec) {
  if (k >= K || n >= N) return 0u;
  const int8_t* p = wq + (long)k * N + n;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) w |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return w;
}

// c (16 x 8, s32) += a (16 x 32, s8, row major) * b (32 x 8, s8, column
// major). Fragment layout (g = lane / 4, t = lane % 4):
//   a[0] row g,     k 4t .. 4t+3      a[1] row g + 8, k 4t .. 4t+3
//   a[2] row g,     k 16+4t ..        a[3] row g + 8, k 16+4t ..
//   b[0] col g,     k 4t .. 4t+3      b[1] col g,     k 16+4t ..
//   c[0], c[1] row g, cols 2t, 2t+1   c[2], c[3] row g + 8, same cols
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OT>
__device__ __forceinline__ OT finish(float y, float amax);
template <>
__device__ __forceinline__ float finish<float>(float y, float) { return y; }
template <>
__device__ __forceinline__ __nv_bfloat16 finish<__nv_bfloat16>(float y,
                                                               float) {
  return __float2bfloat16(y);
}
template <>
__device__ __forceinline__ int8_t finish<int8_t>(float y, float amax) {
  return (int8_t)(int)fminf(fmaxf(rintf(y), -amax), amax);
}

template <typename XT, typename OT>
__global__ void __launch_bounds__(NT, 2)
int8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ qscale,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, OT* __restrict__ out,
                   int M, int K, int N, float amax, int relu, int a_vec,
                   int b_vec) {
  __shared__ uint32_t As[BM * LDW];
  __shared__ uint32_t Bs[BN * LDW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float qs = qscale != nullptr ? qscale[0] : 1.f;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int kt = 0; kt < K; kt += BK) {
    // x tile: 128 rows x 16 words, quantized on the way in
#pragma unroll
    for (int i = 0; i < BM * KW / NT; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / KW, kw = idx % KW;
      As[r * LDW + kw] =
          load_a_word(x, m0 + r, kt + kw * 4, M, K, a_vec != 0, qs, amax);
    }
    // wq tile: 4 (k) x 4 (n) byte blocks, transposed to k-major words
#pragma unroll
    for (int i = 0; i < KW * (BN / 4) / NT; ++i) {
      const int idx = tid + i * NT;
      const int ng = idx % (BN / 4), kg = idx / (BN / 4);
      const int n = n0 + ng * 4, k0 = kt + kg * 4;
      const uint32_t r0 = load_b_word(wq, k0, n, K, N, b_vec != 0);
      const uint32_t r1 = load_b_word(wq, k0 + 1, n, K, N, b_vec != 0);
      const uint32_t r2 = load_b_word(wq, k0 + 2, n, K, N, b_vec != 0);
      const uint32_t r3 = load_b_word(wq, k0 + 3, n, K, N, b_vec != 0);
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
      const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      uint32_t* dst = Bs + (ng * 4) * LDW + kg;
      dst[0 * LDW] = __byte_perm(t0, t2, 0x5410);  // column n:     k0 .. k0+3
      dst[1 * LDW] = __byte_perm(t0, t2, 0x7632);  // column n + 1
      dst[2 * LDW] = __byte_perm(t1, t3, 0x5410);  // column n + 2
      dst[3 * LDW] = __byte_perm(t1, t3, 0x7632);  // column n + 3
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint32_t* p = As + (wm * 64 + mi * 16 + g) * LDW + ks * 8 + t;
        a[mi][0] = p[0];
        a[mi][1] = p[8 * LDW];
        a[mi][2] = p[4];
        a[mi][3] = p[8 * LDW + 4];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t* p = Bs + (wn * 32 + ni * 8 + g) * LDW + ks * 8 + t;
        b[ni][0] = p[0];
        b[ni][1] = p[4];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // epilogue: y = f32(acc) * scale + bias as two separately rounded
  // operations (an FMA would differ in the last bit and could move a
  // requantized value across a .5 boundary)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col0 = n0 + wn * 32 + ni * 8 + t * 2;
    float sc[2], bi[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool ok = col0 + c < N;
      sc[c] = ok ? scale[col0 + c] : 0.f;
      bi[c] = ok && bias != nullptr ? bias[col0 + c] : 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 64 + mi * 16 + g + (e >> 1) * 8;
        const int c = e & 1;
        if (row < M && col0 + c < N) {
          float y = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[mi][ni][e]), sc[c]), bi[c]);
          if (relu) y = fmaxf(y, 0.f);
          out[(long)row * N + col0 + c] = finish<OT>(y, amax);
        }
      }
    }
  }
}

template <typename XT, typename OT>
cudaError_t launch(const void* x, const void* wq, const void* qscale,
                   const void* scale, const void* bias, void* out, int M,
                   int K, int N, float amax, int relu, cudaStream_t st) {
  // word loads need word-aligned rows: K (x) or N (wq) a multiple of 4
  // and an aligned base; otherwise the staging takes byte loads
  const int a_vec =
      K % 4 == 0 && (uintptr_t)x % (4 * sizeof(XT)) == 0 ? 1 : 0;
  const int b_vec = N % 4 == 0 && (uintptr_t)wq % 4 == 0 ? 1 : 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<XT, OT><<<grid, NT, 0, st>>>(
      (const XT*)x, (const int8_t*)wq, (const float*)qscale,
      (const float*)scale, (const float*)bias, (OT*)out, M, K, N, amax, relu,
      a_vec, b_vec);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_x(const void* x, const void* wq, const void* qscale,
                     const void* scale, const void* bias, void* out, int M,
                     int K, int N, int out_dtype, float amax, int relu,
                     cudaStream_t st) {
  if (out_dtype == DT_F32)
    return launch<XT, float>(x, wq, qscale, scale, bias, out, M, K, N, amax,
                             relu, st);
  if (out_dtype == DT_BF16)
    return launch<XT, __nv_bfloat16>(x, wq, qscale, scale, bias, out, M, K, N,
                                     amax, relu, st);
  if (out_dtype == DT_INT8)
    return launch<XT, int8_t>(x, wq, qscale, scale, bias, out, M, K, N, amax,
                              relu, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma route: x quantized once, then the TMA-fed tensor-core product
// ---------------------------------------------------------------------------
constexpr int kQuantThreads = 256;  // 16 values a thread

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// xq[i] = clip(rint(f32(x[i]) * qscale), +-amax), n values; `vec`: x and
// xq 16-byte aligned (a thread's 16 values are one or more 16-byte loads
// and one 16-byte store)
template <typename XT>
__global__ void __launch_bounds__(kQuantThreads)
int8_quantize_kernel(const XT* __restrict__ x,
                     const float* __restrict__ qscale,
                     int8_t* __restrict__ xq, long n, float amax, int vec) {
  const float qs = qscale[0];
  const long stride = (long)gridDim.x * kQuantThreads * 16;
  for (long i = ((long)blockIdx.x * kQuantThreads + threadIdx.x) * 16; i < n;
       i += stride) {
    if (vec && i + 16 <= n) {
      float v[16];
      load16(x + i, v);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = pack4(quant_byte(v[4 * j], qs, amax),
                     quant_byte(v[4 * j + 1], qs, amax),
                     quant_byte(v[4 * j + 2], qs, amax),
                     quant_byte(v[4 * j + 3], qs, amax));
      *reinterpret_cast<uint4*>(xq + i) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (long e = i; e < i + 16 && e < n; ++e)
        xq[e] = (int8_t)quant_byte(to_f32(x[e]), qs, amax);
    }
  }
}

namespace wg {
constexpr int BM = 128, BN = 256, BK = 128;  // BK in int8 values (bytes)
constexpr int kStages = 4, kThreads = 384, kGroupM = 8;
constexpr int kABytes = BM * BK;            // 16 KB
constexpr int kBBytes = BN * BK;            // 32 KB
constexpr int kStage = kABytes + kBBytes;   // 48 KB
constexpr int kBars = kStages * kStage;     // full[kStages], empty[kStages]
constexpr int kSmem = kBars + 16 * kStages + 1024;  // + alignment slack
// a staged output row: 256 values and 16 bytes of padding (the 8 rows a
// warp writes at once fall in distinct banks)
template <typename OT>
constexpr int kPitch = BN * (int)sizeof(OT) + 16;
static_assert(2 * 64 * kPitch<float> <= kBars, "epilogue fits the ring");
}  // namespace wg

// two adjacent outputs into the staged row
__device__ __forceinline__ void stage2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void stage2(__nv_bfloat16* p, __nv_bfloat16 a,
                                       __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}
__device__ __forceinline__ void stage2(int8_t* p, int8_t a, int8_t b) {
  *reinterpret_cast<uint16_t*>(p) =
      (uint16_t)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8));
}

template <typename OT>
__global__ void __launch_bounds__(wg::kThreads, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         OT* __restrict__ out, int M, int K, int N,
                         float amax, int relu, int vec_out) {
  using namespace ptt::hopper;
  // this route's tile (the mma route's BM, BN, BK are other sizes)
  constexpr int BM = wg::BM, BN = wg::BN, BK = wg::BK;
  constexpr int kStages = wg::kStages, kStage = wg::kStage;
  constexpr int kABytes = wg::kABytes, kGroupM = wg::kGroupM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + wg::kBars);
  uint64_t* empty = full + kStages;

  // tile order: groups of kGroupM row tiles, column tiles outer inside a
  // group, so the blocks resident together share wq's column tiles
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int per_group = kGroupM * nt;
  const int group = blockIdx.x / per_group, local = blockIdx.x % per_group;
  const int first_m = group * kGroupM, gm = min(mt - first_m, kGroupM);
  const int m0 = (first_m + local % gm) * BM, n0 = (local / gm) * BN;
  const int nk = (K + BK - 1) / BK;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kStage);
        uint8_t* dst = smem + s * kStage;
        tma_load_2d(dst, &tm_x, &full[s], kt * BK, m0);
        tma_load_2d(dst + kABytes, &tm_w, &full[s], kt * BK, n0);
      }
    }
    return;
  }
  // ---------------- consumers: rows m0 + 64 wgi .. + 63 ----------------
  setmaxnreg_inc<240>();
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* a = smem + s * kStage + wgi * 64 * BK;
    const uint8_t* b = smem + s * kStage + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_m64n256k32_s8(acc, desc_sw128(a + kk * 32, 16, 1024),
                          desc_sw128(b + kk * 32, 16, 1024), 1);
    wgmma_commit();
    // the previous k tile's products are done: its stage may be refilled
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: y = f32(acc) * scale + bias as two separately rounded
  // operations, staged in the ring once both consumers are done with it
  named_bar_sync(1, 256);
  constexpr int P = wg::kPitch<OT>;
  uint8_t* st = smem + wgi * 64 * P;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + 2 * t, col = n0 + c;
    float sc[2], bi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = col + e < N;
      sc[e] = ok ? scale[col + e] : 0.f;
      bi[e] = ok && bias != nullptr ? bias[col + e] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        y[e] = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * r + e]),
                                   sc[e]),
                         bi[e]);
        if (relu) y[e] = fmaxf(y[e], 0.f);
      }
      const int row = 16 * warp + g + 8 * r;
      stage2(reinterpret_cast<OT*>(st + row * P) + c, finish<OT>(y[0], amax),
             finish<OT>(y[1], amax));
    }
  }
  named_bar_sync(2 + wgi, 128);
  constexpr int VE = 16 / (int)sizeof(OT);  // outputs a 16-byte chunk
  constexpr int CPR = BN / VE;              // chunks a row
  for (int idx = tid; idx < 64 * CPR; idx += 128) {
    const int row = idx / CPR, c = (idx % CPR) * VE;
    const int grow = m0 + wgi * 64 + row, gcol = n0 + c;
    if (grow >= M || gcol >= N) continue;
    const uint8_t* src = st + row * P + c * (int)sizeof(OT);
    OT* dst = out + (long)grow * N + gcol;
    if (vec_out && gcol + VE <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const OT* sv = reinterpret_cast<const OT*>(src);
      for (int e = 0; e < VE && gcol + e < N; ++e) dst[e] = sv[e];
    }
  }
}

template <typename XT>
cudaError_t launch_quantize(const void* x, const void* qscale, void* xq,
                            long n, float amax, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int vec = (uintptr_t)x % 16 == 0 && (uintptr_t)xq % 16 == 0;
  const long chunks = (n + 15) / 16;
  const long blocks = std::min<long>((chunks + kQuantThreads - 1) /
                                         kQuantThreads,
                                     32L * sms);
  int8_quantize_kernel<XT><<<(int)blocks, kQuantThreads, 0, st>>>(
      (const XT*)x, (const float*)qscale, (int8_t*)xq, n, amax, vec);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t launch_wgmma(const void* xq, const void* wt, const void* scale,
                         const void* bias, void* out, int M, int K, int N,
                         float amax, int relu, cudaStream_t st) {
  CUtensorMap tx, tw;
  cudaError_t err = kmajor_s8_tensor_map(&tx, xq, M, K, wg::BM);
  if (err == cudaSuccess) err = kmajor_s8_tensor_map(&tw, wt, N, K, wg::BN);
  if (err != cudaSuccess) return err;
  auto kern = int8_matmul_wgmma_kernel<OT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::kSmem);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((M + wg::BM - 1) / wg::BM) *
                     ((N + wg::BN - 1) / wg::BN);
  const int vec_out = ((long)N * (long)sizeof(OT)) % 16 == 0 &&
                      (uintptr_t)out % 16 == 0;
  kern<<<(unsigned)tiles, wg::kThreads, wg::kSmem, st>>>(
      tx, tw, (const float*)scale, (const float*)bias, (OT*)out, M, K, N,
      amax, relu, vec_out);
  return cudaGetLastError();
}

}  // namespace

// C entry (ops/int8_matmul.py). All tensors contiguous:
//   x [M, K] f32 / bf16 (quantized in the kernel with qscale[0]) or int8
//   (qscale unused, may be null); wq [K, N] int8; scale [N] f32; bias [N]
//   f32 or null; out [M, N] f32 / bf16, or int8 (requantized output).
// dtype codes: 0 = f32, 1 = bf16, 2 = int8. Returns the launch's
// cudaError_t.
extern "C" int int8_matmul(const void* x, const void* wq, const void* qscale,
                           const void* scale, const void* bias, void* out,
                           int M, int K, int N, int x_dtype, int out_dtype,
                           float amax, int relu, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == DT_INT8)
    return (int)launch_x<int8_t>(x, wq, nullptr, scale, bias, out, M, K, N,
                                 out_dtype, amax, relu, st);
  if (qscale == nullptr) return (int)cudaErrorInvalidValue;
  if (x_dtype == DT_F32)
    return (int)launch_x<float>(x, wq, qscale, scale, bias, out, M, K, N,
                                out_dtype, amax, relu, st);
  if (x_dtype == DT_BF16)
    return (int)launch_x<__nv_bfloat16>(x, wq, qscale, scale, bias, out, M, K,
                                        N, out_dtype, amax, relu, st);
  return (int)cudaErrorInvalidValue;
}

// C entry (ops/int8_matmul.py, the wgmma route's quantize pass): xq [n]
// int8 = clip(rint(f32(x) * qscale[0]), +-amax) from x [n] f32 / bf16.
extern "C" int int8_quantize(const void* x, const void* qscale, void* xq,
                             long long n, int x_dtype, float amax,
                             void* stream) {
  if (n < 1 || qscale == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == DT_F32)
    return (int)launch_quantize<float>(x, qscale, xq, n, amax, st);
  if (x_dtype == DT_BF16)
    return (int)launch_quantize<__nv_bfloat16>(x, qscale, xq, n, amax, st);
  return (int)cudaErrorInvalidValue;
}

// C entry (ops/int8_matmul.py, the wgmma route): xq [M, K] int8, wt [N, K]
// int8 (wq K-major), both 16-byte aligned with K a multiple of 16; scale
// [N] f32; bias [N] f32 or null; out [M, N] f32 / bf16 / int8 (dtype code
// 0 / 1 / 2). Returns the launch's cudaError_t.
extern "C" int int8_matmul_wgmma(const void* xq, const void* wt,
                                 const void* scale, const void* bias,
                                 void* out, int M, int K, int N,
                                 int out_dtype, float amax, int relu,
                                 void* stream) {
  if (M < 1 || K < 1 || N < 1 || K % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == DT_F32)
    return (int)launch_wgmma<float>(xq, wt, scale, bias, out, M, K, N, amax,
                                    relu, st);
  if (out_dtype == DT_BF16)
    return (int)launch_wgmma<__nv_bfloat16>(xq, wt, scale, bias, out, M, K,
                                            N, amax, relu, st);
  if (out_dtype == DT_INT8)
    return (int)launch_wgmma<int8_t>(xq, wt, scale, bias, out, M, K, N, amax,
                                     relu, st);
  return (int)cudaErrorInvalidValue;
}
