// Flash attention backward for Hopper (sm_90a): one kernel per TPU kernel.
//
// Replaces the three backward TPU kernels of
// paddle_tpu/ops/flash_attention.py (launched by _bwd):
//   flash_attention_bwd_dq          <- _bwd_dq_kernel           (row 3)
//   flash_attention_bwd_dkv         <- _bwd_dkv_kernel          (row 4)
//   flash_attention_bwd_single_tile <- _bwd_single_tile_kernel  (row 2)
// Same function: with the forward's natural-log LSE and
// delta = rowsum(dO * O) (computed by the caller, f32),
//   P  = exp2(q k^T * scale * log2 e - lse * log2 e)   (no online softmax)
//   dS = P * (dO v^T - delta) * scale
//   dQ = dS k,  dK = dS^T q,  dV = P^T dO,
// causal positions k > q masked to P = 0 exactly (a select, never
// exp2 of -inf - -inf). Inputs q/k/v/dO f32 or bf16, LSE and delta f32,
// f32 accumulation; dQ/dK/dV written in the input dtype or in f32 (the
// out_dtype override ring attention reads). The reference casts P and dS
// to the input dtype before its bf16 products; these kernels keep them in
// f32 (the chip check compares against the plain version on
// f32-upcast inputs).
//
// Layout: every tensor keeps the public [B, S, H, D] layout and rows
// (b, s, h, :) are read with strides, as the forward kernel does; LSE and
// delta are [B*H, S]. The reference's [B*H, S, D] transpose is never made.
//
// What bounds them on the H100: operations. dQ does 6, dK/dV 8 and the
// merged kernel 10 * B*H*Sq*Sk*D flops (halved when causal) against
// 67 TFLOP/s f32 outside the tensor cores (f32, TF32 off) or 989 TFLOP/s
// bf16 on the tensor cores; their bytes (q, k, v, dO once, the gradients
// once) are far below that line at S = 2048.
//
// What the design does about it (simple first: SIMT f32 FMAs):
//  * 256 threads as a 16 x 16 grid; each thread owns a 4 x (tile/16)
//    patch of the score tile and a 4 x (D/16) patch of its gradient
//    accumulators, in f32 registers. Tiles are staged in shared memory as
//    f32 (bf16 converted on load), rows padded to D + 1 floats so the
//    strided reads of the register-blocked products hit distinct banks.
//    Q, dO, K, V and the P/dS tiles need up to 210 KB: dynamic shared
//    memory above 48 KB is opted into per kernel. Tiles are 64 x 64 for
//    D <= 128 and 64 x 32 above.
//  * dQ: one block per (b*h, 64-query tile) looping over k tiles; the
//    TPU kernel's dead-tile skip becomes the loop bound at the diagonal.
//  * dK/dV: one block per (b*h, 64-key tile) looping over q tiles from
//    the diagonal on (the TPU index map's max(i, j) clamp becomes the
//    loop start); P^T dO and dS^T Q accumulate in registers.
//  * Merged (single tile): on the TPU one 1024 x 1024 score tile sat in
//    VMEM and P was computed once for all three gradients. No block here
//    holds 4 MB, so the merged kernel is the dK/dV kernel that also adds
//    each tile's dS k into an f32 dQ scratch with atomicAdd: P and dS are
//    still computed once (the pair recomputes them per kernel). The last
//    block of each (b*h) to finish (a ticket counter, after a
//    __threadfence) converts that head's scratch to the output dtype, so
//    one launch does all. With an f32 output the scratch is the output.
//  * Ragged lengths (S = 1000 is one reference tile): rows past S load as
//    zero, their P is masked to 0 and they are never written.
//  * Staging: one 150-215 KB block per SM leaves no other block to hide a
//    load's latency, so tiles are staged with 16-byte loads, four in
//    flight per thread, and converted to f32 after they land.
// Not yet: wgmma on the tensor cores, TMA staging, warp specialization.
#include <cstdint>

#include "common.cuh"

using namespace ptt;

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// rows s0 .. s0 + rows - 1 of head (b, h) of a [B, S, H, D] tensor into
// shared memory as f32 [rows][ld]; rows past S are zero. With `vec` (D a
// multiple of 16 bytes' worth of elements, 16-byte aligned rows) each
// load moves 16 bytes and a thread issues kLoads of them before it
// converts any: the tile is staged by a few round trips to memory, not
// one per element.
constexpr int kLoads = 4;

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int h, int s0, int rows,
                                          int S, int H, int D, int ld,
                                          int vec) {
  if (!vec) {
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const int rr = idx / D, d = idx - rr * D, s = s0 + rr;
      dst[rr * ld + d] =
          s < S ? to_f32(src[(((long)b * S + s) * H + h) * D + d]) : 0.f;
    }
    return;
  }
  constexpr int N = 16 / sizeof(T);
  const int per_row = D / N, total = rows * per_row;
  for (int base = threadIdx.x; base < total; base += kThreads * kLoads) {
    uint4 buf[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * kThreads, rr = idx / per_row;
      const int c = (idx - rr * per_row) * N, s = s0 + rr;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);   // zero bits: 0.f in f32 and bf16
      if (idx < total && s < S)
        buf[u] = *reinterpret_cast<const uint4*>(
            src + (((long)b * S + s) * H + h) * D + c);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = base + u * kThreads, rr = idx / per_row;
      const int c = (idx - rr * per_row) * N;
      if (idx >= total) break;
      const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
      for (int j = 0; j < N; ++j) dst[rr * ld + c + j] = to_f32(e[j]);
    }
  }
}

__device__ __forceinline__ void store_out(void* base, long i, float x,
                                          int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(base)[i] = x;
}

// ---------------------------------------------------------------------------
// dQ (row 3): block (q tile, b*h); BQ = 64 query rows, BK keys per tile
// ---------------------------------------------------------------------------
template <typename T, int NC, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, void* __restrict__ dq,
                    int Sq, int Sk, int H, int D, int causal, float scale,
                    float scale_log2, int out_bf16, int vec) {
  constexpr int BQ = 64, JN = BK / 16;
  extern __shared__ float smem[];
  const int ld = D + 1, ldp = BK + 1;
  float* sQ = smem;                 // [BQ][ld]
  float* sDO = sQ + BQ * ld;        // [BQ][ld]
  float* sK = sDO + BQ * ld;        // [BK][ld]
  float* sV = sK + BK * ld;         // [BK][ld]
  float* sDS = sV + BK * ld;        // [BQ][ldp]

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_rows(sQ, q, b, h, q0, BQ, Sq, H, D, ld, vec);
  load_rows(sDO, dout, b, h, q0, BQ, Sq, H, D, ld, vec);
  float lse2[4], dl[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    lse2[i] = qi < Sq ? lse[(long)bh * Sq + qi] * kLog2e : 0.f;
    dl[i] = qi < Sq ? delta[(long)bh * Sq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK / sDS reads are done
    load_rows(sK, k, b, h, k0, BK, Sk, H, D, ld, vec);
    load_rows(sV, v, b, h, k0, BK, Sk, H, D, ld, vec);
    __syncthreads();

    float s[4][JN], dp[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kk[JN], vv[JN];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty * 4 + i) * ld + d];
        g[i] = sDO[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        kk[j] = sK[(tx + 16 * j) * ld + d];
        vv[j] = sV[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          s[i][j] += a[i] * kk[j];
          dp[i][j] += g[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool live = qi < Sq && kj < Sk && !(causal && kj > qi);
        const float p = live ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.f;
        sDS[(ty * 4 + i) * ldp + tx + 16 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = sDS[(ty * 4 + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < D ? sK[kk * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += dsr[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const long row = (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store_out(dq, row + d, acc[i][c], out_bf16);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV (row 4), and with DQ the merged single-tile kernel (row 2):
// block (k tile, b*h); BK = 64 key rows, BQ queries per tile
// ---------------------------------------------------------------------------
template <typename T, int NC, int BQ, bool DQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, void* __restrict__ dk,
                     void* __restrict__ dv, float* __restrict__ dq_acc,
                     int* __restrict__ tickets, void* __restrict__ dq,
                     int Sq, int Sk, int H, int D, int causal, float scale,
                     float scale_log2, int out_bf16, int vec) {
  constexpr int BK = 64, JN = BQ / 16, RQ = BQ / 16;
  extern __shared__ float smem[];
  __shared__ int s_last;
  const int ld = D + 1, ldp = BQ + 1;
  float* sK = smem;                 // [BK][ld]
  float* sV = sK + BK * ld;         // [BK][ld]
  float* sQ = sV + BK * ld;         // [BQ][ld]
  float* sDO = sQ + BQ * ld;        // [BQ][ld]
  float* sP = sDO + BQ * ld;        // [BK][ldp]  P^T
  float* sDS = sP + BK * ldp;       // [BK][ldp]  dS^T
  float* sL = sDS + BK * ldp;       // [BQ]  lse * log2 e
  float* sDl = sL + BQ;             // [BQ]  delta

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_rows(sK, k, b, h, k0, BK, Sk, H, D, ld, vec);
  load_rows(sV, v, b, h, k0, BK, Sk, H, D, ld, vec);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nqt = (Sq + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < nqt; ++qt) {
    const int qs = qt * BQ;
    __syncthreads();  // the previous tile's sQ / sDO / sP / sDS reads are done
    load_rows(sQ, q, b, h, qs, BQ, Sq, H, D, ld, vec);
    load_rows(sDO, dout, b, h, qs, BQ, Sq, H, D, ld, vec);
    if (tid < BQ) {
      const int qi = qs + tid;
      sL[tid] = qi < Sq ? lse[(long)bh * Sq + qi] * kLog2e : 0.f;
      sDl[tid] = qi < Sq ? delta[(long)bh * Sq + qi] : 0.f;
    }
    __syncthreads();

    float st[4][JN], dpt[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], av[4], bq[JN], bo[JN];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sK[(ty * 4 + i) * ld + d];
        av[i] = sV[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        bq[j] = sQ[(tx + 16 * j) * ld + d];
        bo[j] = sDO[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          st[i][j] += a[i] * bq[j];
          dpt[i][j] += av[i] * bo[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int col = tx + 16 * j, qc = qs + col;
        const bool live = qc < Sq && kr < Sk && !(causal && kr > qc);
        const float p = live ? exp2f(st[i][j] * scale_log2 - sL[col]) : 0.f;
        sP[(ty * 4 + i) * ldp + col] = p;
        sDS[(ty * 4 + i) * ldp + col] = p * (dpt[i][j] - sDl[col]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = sP[(ty * 4 + i) * ldp + qq];
        dr[i] = sDS[(ty * 4 + i) * ldp + qq];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        const float o = d < D ? sDO[qq * ld + d] : 0.f;
        const float qv = d < D ? sQ[qq * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] += pr[i] * o;
          dk_acc[i][c] += dr[i] * qv;
        }
      }
    }

    if (DQ) {
      // this tile's dS k over the block's 64 keys, added into the f32 dQ
      // scratch: thread rows ty * RQ + i, columns tx + 16 c
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int row = ty * RQ + i, qi = qs + row;
        float part[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) part[c] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          const float dsv = sDS[kk * ldp + row];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int d = tx + 16 * c;
            part[c] += dsv * (d < D ? sK[kk * ld + d] : 0.f);
          }
        }
        if (qi < Sq) {
          const long base = (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int d = tx + 16 * c;
            if (d < D) atomicAdd(dq_acc + base + d, part[c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= Sk) continue;
    const long row = (((long)b * Sk + kr) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        store_out(dk, row + d, dk_acc[i][c], out_bf16);
        store_out(dv, row + d, dv_acc[i][c], out_bf16);
      }
    }
  }

  if (DQ && dq != nullptr) {
    // the last block of this (b*h) converts the head's dQ scratch
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(tickets + bh, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      for (int idx = tid; idx < Sq * D; idx += kThreads) {
        const int s = idx / D, d = idx - s * D;
        const long off = (((long)b * Sq + s) * H + h) * D + d;
        store_out(dq, off, __ldcg(dq_acc + off), out_bf16);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  float* dq_acc;
  int* tickets;
  int B, Sq, Sk, H, D, causal, out_bf16;
  float scale;
  cudaStream_t st;
};

// 16-byte staging loads need D to fill whole vectors and 16-byte aligned
// q/k/v/dO (every row then starts aligned)
template <typename T>
int vec_ok(const Args& a) {
  const uintptr_t any = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                        (uintptr_t)a.dout;
  return a.D % (16 / (int)sizeof(T)) == 0 && any % 16 == 0;
}

template <typename T, int NC, int BK>
cudaError_t launch_dq(const Args& a) {
  constexpr int BQ = 64;
  const size_t smem = sizeof(float) *
      ((size_t)(2 * BQ + 2 * BK) * (a.D + 1) + (size_t)BQ * (BK + 1));
  auto kern = flash_bwd_dq_kernel<T, NC, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, kThreads, smem, a.st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, a.dq, a.Sq, a.Sk, a.H, a.D, a.causal, a.scale,
      a.scale * kLog2e, a.out_bf16, vec_ok<T>(a));
  return cudaGetLastError();
}

template <typename T, int NC, int BQ, bool DQ>
cudaError_t launch_dkv(const Args& a) {
  constexpr int BK = 64;
  const size_t smem = sizeof(float) *
      ((size_t)(2 * BK + 2 * BQ) * (a.D + 1) + 2 * (size_t)BK * (BQ + 1) +
       2 * BQ);
  auto kern = flash_bwd_dkv_kernel<T, NC, BQ, DQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + BK - 1) / BK, a.B * a.H);
  kern<<<grid, kThreads, smem, a.st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, a.dk, a.dv, a.dq_acc, a.tickets, a.dq, a.Sq, a.Sk, a.H, a.D,
      a.causal, a.scale, a.scale * kLog2e, a.out_bf16, vec_ok<T>(a));
  return cudaGetLastError();
}

// kind: 0 = dQ, 1 = dK/dV, 2 = merged single tile
template <typename T>
cudaError_t launch_kind(int kind, const Args& a) {
  if (kind == 0) {
    if (a.D <= 64) return launch_dq<T, 4, 64>(a);
    if (a.D <= 128) return launch_dq<T, 8, 64>(a);
    return launch_dq<T, 16, 32>(a);
  }
  if (kind == 1) {
    if (a.D <= 64) return launch_dkv<T, 4, 64, false>(a);
    if (a.D <= 128) return launch_dkv<T, 8, 64, false>(a);
    return launch_dkv<T, 16, 32, false>(a);
  }
  if (a.D <= 64) return launch_dkv<T, 4, 64, true>(a);
  if (a.D <= 128) return launch_dkv<T, 8, 64, true>(a);
  return launch_dkv<T, 16, 32, true>(a);
}

int launch(int kind, const Args& a, int dtype, int out_dtype) {
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.H < 1 || a.D < 1 || a.D > 256)
    return (int)cudaErrorInvalidValue;
  if (out_dtype != DT_F32 && out_dtype != DT_BF16)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) return (int)launch_kind<float>(kind, a);
  if (dtype == DT_BF16) return (int)launch_kind<__nv_bfloat16>(kind, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entries (ops/flash_attention.py). q/dout [B, Sq, H, D], k/v
// [B, Sk, H, D], lse/delta [B*H, Sq] f32, gradients shaped like their
// inputs in out_dtype; all contiguous. dtype codes: 0 = f32, 1 = bf16.
// Each returns its launch's cudaError_t.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int B, int Sq, int Sk, int H,
                                      int D, int causal, float scale,
                                      int dtype, int out_dtype,
                                      void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, nullptr,
         B, Sq, Sk, H, D, causal, out_dtype == DT_BF16, scale,
         (cudaStream_t)stream};
  return launch(0, a, dtype, out_dtype);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int D, int causal,
                                       float scale, int dtype, int out_dtype,
                                       void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, nullptr, nullptr,
         B, Sq, Sk, H, D, causal, out_dtype == DT_BF16, scale,
         (cudaStream_t)stream};
  return launch(1, a, dtype, out_dtype);
}

// dq_acc: zeroed f32 [B, Sq, H, D] scratch; tickets: zeroed int [B*H].
// dq == NULL means the output is f32 and dq_acc is the output itself.
extern "C" int flash_attention_bwd_single_tile(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    float* dq_acc, int* tickets, int B, int Sq, int Sk, int H, int D,
    int causal, float scale, int dtype, int out_dtype, void* stream) {
  if (dq_acc == nullptr || (dq != nullptr && tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, tickets,
         B, Sq, Sk, H, D, causal, out_dtype == DT_BF16, scale,
         (cudaStream_t)stream};
  return launch(2, a, dtype, out_dtype);
}
