// Flash attention forward for Hopper (sm_90a).
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
// tensor cores (f32, TF32 off) or 989 TFLOP/s for bf16 on the tensor
// cores; the q/k/v/o bytes are far below that line at S = 2048.
//
// What the design does about it (simple first):
//  * One block per (b*h, 64-query tile), 256 threads as a 16 x 16 grid:
//    each thread owns a 4 x 4 patch of the 64 x 64 score tile and a 4 x
//    (D/16) patch of the output accumulator, in f32 registers. The running
//    max and denominator of each query row live in registers of the 16
//    threads sharing the row and are combined with half-warp shuffles.
//  * Q, K and V tiles are staged in shared memory as f32 (bf16 converted
//    on load) with rows padded to D + 1 floats, so the strided reads of
//    the register-blocked products hit distinct banks.
//  * Causal: the k-tile loop stops at the diagonal tile (the TPU kernel's
//    dead-tile skip becomes a loop bound); only the diagonal tile masks.
//  * Fully masked rows keep p = 0 and l = 0 and write o = 0, never NaN.
// Not yet: wgmma on the tensor cores, TMA staging, warp specialization.
#include "common.cuh"

using namespace ptt;

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int D,
                 int causal, float scale_log2) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;                 // [kBQ][ld]
  float* sK = sQ + kBQ * ld;        // [kBK][ld]
  float* sV = sK + kBK * ld;        // [kBK][ld]
  float* sP = sV + kBK * ld;        // [kBQ][kBK + 1]
  const int ldp = kBK + 1;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int rr = idx / D, d = idx - rr * D, s = q0 + rr;
    sQ[rr * ld + d] =
        s < Sq ? to_f32(q[(((long)b * Sq + s) * H + h) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int nkt = (Sk + kBK - 1) / kBK;
  if (causal) nkt = min(nkt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int rr = idx / D, d = idx - rr * D, s = k0 + rr;
      const long g = (((long)b * Sk + s) * H + h) * D + d;
      sK[rr * ld + d] = s < Sk ? to_f32(k[g]) : 0.f;
      sV[rr * ld + d] = s < Sk ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += a[i] * bk[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = sc[i][j] * scale_log2;
        if (kj >= Sk || (causal && kj > qi)) x = -INFINITY;
        sc[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float mn = fmaxf(m[i], half_warp_max(rmax));
      float rs = 0.f, alpha = 1.f;
      if (mn != -INFINITY) {
        alpha = exp2f(m[i] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pe = sc[i][j] == -INFINITY ? 0.f : exp2f(sc[i][j] - mn);
          sc[i][j] = pe;
          rs += pe;
        }
        m[i] = mn;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * ldp + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(ty * 4 + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? sV[kk * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pr[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    const long orow = (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) o[orow + d] = from_f32<T>(acc[i][c] / ls);
    }
    if (tx == 0) lse[(long)bh * Sq + qi] = (m[i] + log2f(ls)) * kLn2;
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int D,
                   int causal, float scale, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_fwd_kernel<T, NC><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H, D, causal,
      scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sq, int Sk, int H, int D,
                     int causal, float scale, cudaStream_t st) {
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, lse, B, Sq, Sk, H, D, causal, scale, st);
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, lse, B, Sq, Sk, H, D, causal, scale, st);
  return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, D, causal, scale, st);
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
