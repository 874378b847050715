// Flash attention forward for Hopper (sm_90a), SIMT route: f32, and bf16
// at head dims the tensor-core kernel does not take.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd). Same function: o = softmax(q k^T * scale) v with an
// online softmax in base 2 (scores scaled by scale * log2 e, exp2), f32
// accumulation, causal tiles above the diagonal skipped, and the
// natural-log LSE exported as lse[b*H + h, s] = (m + log2 l) * ln 2, the
// contract the backward and ring-attention slices read. Inputs f32 or
// bf16; o has the input dtype, lse is f32.
//
// Layout: q, k, v, o keep the public [B, S, H, D] layout; the kernel reads
// rows (b, s, h, :) with strides instead of materializing the reference's
// [B*H, S, D] transpose (_reshape_in).
//
// What bounds it on the H100: operations. 4 * B * H * Sq * Sk * D flops
// (halved when causal) against the f32 rate of 67 TFLOP/s outside the
// tensor cores (TF32 stays off); the q/k/v/o bytes are far below that
// line. So the design is about feeding the FMA units:
//  * The products are the register-tiled core of attention_simt.cuh: a
//    block of 128 threads owns 64 queries (D <= 128) and walks key tiles
//    of 32; each thread holds a 4 x 4 score patch and a 4 x 4 NCH output
//    patch in registers, and reads Q and K 4 head-dim values at a time
//    (8 FMAs per shared load in QK^T, 12.8 in P.V at D 128). P stays in
//    the warp that made it (written once as float4, a __syncwarp).
//  * K/V tiles arrive through a 2-stage shared-memory ring with cp.async
//    (16 bytes a lane, no divides: a warp copies a row, a lane a chunk):
//    tile k+1 loads while tile k computes, one barrier a tile. bf16 is
//    copied raw and converted on the shared read.
//  * Occupancy: 108.5 KB of shared memory a block at D 128 f32, so two
//    blocks (8 warps) share an SM and one block's barriers hide behind
//    the other's math. At D > 128 a thread keeps 2 query rows (32-query
//    blocks) so the output patch stays at 64 registers.
//  * Causal: the key loop stops at the diagonal tile, and q tiles are
//    scheduled heaviest first (the q tile is the slow grid dimension,
//    reversed), so the longest blocks do not form a tail.
//  * Fully masked rows keep p = 0 and l = 0 and write o = 0, never NaN.
// Not here: split-TF32 or any tensor-core product (it would change the
// numerics class of the f32 route).
#include "attention_simt.cuh"

using namespace ptt;
using namespace ptt::simt;

namespace {

constexpr float kLn2 = 0.6931471805599453f;


template <typename T, class C, int NCH>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int D,
                 int causal, float scale_log2, int vec) {
  constexpr int NTY = C::NTY, NTX = C::NTX, RM = C::RM, KN = C::KN;
  constexpr int BQ = C::BQ, BK = C::BK, NW = C::NW;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int dp = pad16(D), ldk = dp + kChunk<T>, ldv = dp;
  float* sP = reinterpret_cast<float*>(smem_raw);  // [NW][BK][TYW RM]
  T* sQ = reinterpret_cast<T*>(sP + NW * BK * C::TYW * RM);  // [BQ][ldk]
  T* sK = sQ + BQ * ldk;                                       // [2][BK][ldk]
  T* sV = sK + 2 * BK * ldk;                                   // [2][BK][ldv]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % NTX, ty = tid / NTX;
  const long rs = (long)H * D;  // one sequence position
  const T* qb = q + (long)b * Sq * rs + (long)h * D;
  const T* kb = k + (long)b * Sk * rs + (long)h * D;
  const T* vb = v + (long)b * Sk * rs + (long)h * D;

  for (int r = warp; r < BQ; r += NW) {
    const bool ok = q0 + r < Sq;
    copy_row(sQ + r * ldk, ok ? qb + (q0 + r) * rs : qb, D, dp, ok, vec,
             lane);
  }
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    for (int r = warp; r < BK; r += NW) {
      const bool ok = k0 + r < Sk;
      const long off = ok ? (k0 + r) * rs : 0;
      copy_row(sK + (stage * BK + r) * ldk, kb + off, D, dp, ok, vec, lane);
      copy_row(sV + (stage * BK + r) * ldv, vb + off, D, dp, ok, vec, lane);
    }
  };

  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);
  load_kv(0, 0);
  cp_async_commit();

  RowState<RM, NCH> st;
  st.init();
  float* sPw = sP + warp * BK * C::TYW * RM;
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<0>();
    // tile kt (and Q) landed for every thread, and every thread is done
    // with tile kt - 1, whose stage the next copy refills
    __syncthreads();
    if (kt + 1 < nkt) {
      load_kv(kt + 1, (kt + 1) & 1);
      cp_async_commit();
    }
    const T* cK = sK + (kt & 1) * BK * ldk;
    const T* cV = sV + (kt & 1) * BK * ldv;
    float s[RM][KN];
    scores<RM, KN, NTY, NTX>(sQ, ldk, cK, ldk, dp, ty, tx, s);
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty + NTY * i;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int kj = k0 + tx + NTX * j;
        const bool dead = kj >= Sk || (causal && kj > qi);
        s[i][j] = dead ? -INFINITY : s[i][j] * scale_log2;
      }
    }
    softmax_update<RM, KN, NCH, NTX>(s, st);
    pv<RM, KN, NCH, NTY, NTX>(s, sPw, cV, ldv, dp, ty, tx, st);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty + NTY * i;
    if (qi >= Sq) continue;
    const float ls = st.l[i] == 0.f ? 1.f : st.l[i];
    T* orow = o + ((long)b * Sq + qi) * rs + (long)h * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = tx * 4 + 4 * NTX * c + e;
        if (d < D) orow[d] = from_f32<T>(st.o[i][c][e] / ls);
      }
    if (tx == 0) lse[(long)bh * Sq + qi] = (st.m[i] + log2f(ls)) * kLn2;
  }
}

// Dmax: the largest head dim of the instantiation (NCH covers it)
template <typename T, class C, int Dmax>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int D,
                   int causal, float scale, cudaStream_t st) {
  constexpr int NCH = (Dmax + 4 * C::NTX - 1) / (4 * C::NTX);
  const size_t smem = C::template smem<T, T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, C, NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = D % kChunk<T> == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const dim3 grid(B * H, (Sq + C::BQ - 1) / C::BQ);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd_kernel<T, C, NCH><<<grid, C::THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H, D, causal,
      scale_log2, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sq, int Sk, int H, int D,
                     int causal, float scale, cudaStream_t st) {
  if (D <= 64)
    return launch<T, Tile128, 64>(q, k, v, o, lse, B, Sq, Sk, H, D, causal,
                                  scale, st);
  if (D <= 128)
    return launch<T, Tile128, 128>(q, k, v, o, lse, B, Sq, Sk, H, D, causal,
                                   scale, st);
  return launch<T, Tile256, 256>(q, k, v, o, lse, B, Sq, Sk, H, D, causal,
                                 scale, st);
}

}  // namespace

// C entry (ops/flash_attention.py). q [B, Sq, H, D], k/v [B, Sk, H, D],
// o [B, Sq, H, D] (input dtype), lse [B*H, Sq] f32; all contiguous.
// dtype codes: 0 = f32, 1 = bf16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int Sq, int Sk, int H, int D, int causal,
                                   float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return (int)launch_d<float>(q, k, v, o, lse, B, Sq, Sk, H, D, causal,
                                scale, st);
  if (dtype == DT_BF16)
    return (int)launch_d<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, D,
                                        causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
