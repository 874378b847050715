// Flash attention dQ on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (launched by _bwd) for bf16 q/k/v/dO at head dim 64 or 128; f32 and
// other head dims keep flash_attention_bwd_dq in flash_attention_bwd.cu
// (ops/flash_attention.py: _tc_route). Same function: with the forward's
// natural-log LSE and delta = rowsum(dO * O) (given by the caller, f32),
//   P  = exp2(q k^T * scale * log2 e - lse * log2 e)
//   dS = P * (dO v^T - delta) * scale
//   dQ = dS k,
// dS rounded to bf16 before its product (the reference's
// `ds.astype(k.dtype)`), f32 accumulation, dQ written in bf16 or in f32
// (the out_dtype that ring attention passes, with its own delta). Masked
// positions (causal k > q, k >= Sk) take P = 0 by a select.
//
// Layout: every tensor keeps the public [B, S, H, D] layout, read by TMA
// through 4-D tensor maps (D, H, S, B); LSE and delta are [B*H, Sq].
//
// What bounds it on the H100: operations. 6 * B*H*Sq*Sk*D flops (halved
// when causal) against 989 TFLOP/s bf16 on the tensor cores.
//
// What the design does about it (the dK/dV kernel with the roles of the
// two sides swapped, and one product fewer):
//  * One block per (b*h, 128 queries): two consumer warpgroups of 64
//    queries each and one producer warpgroup (one thread issues TMA). Q
//    and dO are loaded once; the producer streams 64-row K and V tiles
//    into a 2-stage ring (full / empty mbarriers). When causal the stream
//    stops at the diagonal (the loop bound replaces the TPU index map's
//    min(j, i) clamp), and the first warpgroup skips the last tile, which
//    lies wholly above its diagonal. setmaxnreg moves registers from the
//    producer (24) to the consumers (240).
//  * S = Q K^T and dP = dO V^T by wgmma with both operands in shared
//    memory (K-major). dS is computed on the accumulators in registers and
//    packed to bf16 there: the accumulator layout is the A operand layout
//    of wgmma's register form, so dQ += dS K reads dS from registers and
//    K from shared memory as an MN-major B operand. dS never touches
//    memory.
//  * Each thread's two LSE * log2 e and delta rows are read once per
//    block into registers (a thread's accumulator rows never change).
//  * Only tiles on the diagonal or past Sk evaluate the mask.
//  * Blocks with the highest queries, which see the most key tiles when
//    causal, start first.
// Not yet: a 3-stage ring, overlap of the next tile's S with this tile's
// dQ product, 128-key tiles (the S and dP tiles would need 128 more
// registers a thread).
#include "common.cuh"
#include "hopper.cuh"

using namespace ptt;
using namespace ptt::hopper;

namespace {

constexpr int kBQ = 128, kBK = 64, kThreads = 384, kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DqSmem {
  static constexpr int kHalves = D / 64;
  static constexpr int kQHalf = kBQ * 128;            // bytes of one half
  static constexpr int kKHalf = kBK * 128;
  static constexpr int kQ = kHalves * kQHalf;         // Q or dO, 128 rows
  static constexpr int kKT = kHalves * kKHalf;        // a K or V tile
  static constexpr int kDO0 = kQ;
  static constexpr int kK0 = 2 * kQ;
  static constexpr int kV0 = kK0 + kStages * kKT;
  static constexpr int kBars = kV0 + kStages * kKT;   // q, full[2], empty[2]
  static constexpr int kBytes = kBars + 64 + 1024;    // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, void* __restrict__ dq,
                       int Sq, int Sk, int H, int causal, float scale,
                       float scale_log2, int out_bf16) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sDO = smem + L::kDO0;
  uint8_t* sK = smem + L::kK0;
  uint8_t* sV = smem + L::kV0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest tiles first
  int nkt = (Sk + kBK - 1) / kBK;
  if (causal) nkt = min(nkt, (q0 + kBQ - 1) / kBK + 1);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_bar, 2 * L::kQ);
      for (int c = 0; c < L::kHalves; ++c) {
        tma_load_4d(sQ + c * L::kQHalf, &tm_q, q_bar, 64 * c, h, q0, b);
        tma_load_4d(sDO + c * L::kQHalf, &tm_do, q_bar, 64 * c, h, q0, b);
      }
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kKT);
        for (int c = 0; c < L::kHalves; ++c) {
          tma_load_4d(sK + s * L::kKT + c * L::kKHalf, &tm_k, &full[s],
                      64 * c, h, kt * kBK, b);
          tma_load_4d(sV + s * L::kKT + c * L::kKHalf, &tm_v, &full[s],
                      64 * c, h, kt * kBK, b);
        }
      }
    }
  } else {
    // ---------------- consumers: queries q0 + 64 wg .. + 63 ----------------
    setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int qw0 = q0 + wg * 64;                         // this warpgroup's rows
    const int row_base = qw0 + warp * 16 + g;             // + 8 r
    const long row0 = (long)bh * Sq;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row_base + 8 * r;
      lse2[r] = qi < Sq ? lse[row0 + qi] * kLog2e : 0.f;
      dl[r] = qi < Sq ? delta[row0 + qi] : 0.f;
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    const uint8_t* q_wg = sQ + wg * 64 * 128;
    const uint8_t* do_wg = sDO + wg * 64 * 128;

    mbar_wait(q_bar, 0);
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % kStages, k0 = kt * kBK;
      mbar_wait(&full[s], (kt / kStages) & 1);
      if (causal && k0 > qw0 + 63) {        // above this warpgroup's diagonal
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      const uint8_t* k_t = sK + s * L::kKT;
      const uint8_t* v_t = sV + s * L::kKT;

      float st[32], dpt[32];
      wgmma_fence();
      nt_product<D, L::kQHalf, L::kKHalf>(st, q_wg, k_t);
      nt_product<D, L::kQHalf, L::kKHalf>(dpt, do_wg, v_t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const bool masked = k0 + kBK > Sk || (causal && k0 + kBK - 1 > qw0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * r + e;
            bool live = true;
            if (masked) {
              const int kc = k0 + 8 * j + 2 * t + e, qr = row_base + 8 * r;
              live = kc < Sk && !(causal && kc > qr);
            }
            const float p = live ? exp2f(st[idx] * scale_log2 - lse2[r]) : 0.f;
            dpt[idx] = p * (dpt[idx] - dl[r]) * scale;
          }

      // dS to bf16 in registers before the product reads it
      uint32_t dsa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(dpt, kk, dsa[kk]);
      fence_regs(dq_acc);
      wgmma_fence();
      nn_product<D, L::kKHalf>(dq_acc, dsa, k_t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row_base + 8 * r;
      if (qi >= Sq) continue;
      const long off = (((long)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float x0 = dq_acc[4 * j + 2 * r], x1 = dq_acc[4 * j + 2 * r + 1];
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(dq) + off + col) =
              __floats2bfloat162_rn(x0, x1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(dq) + off + col) =
              make_float2(x0, x1);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int Sq, int Sk, int H, int causal,
                   float scale, int out_bf16, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bshd_tensor_map(&tq, q, B, Sq, H, D, kBQ);
  if (err == cudaSuccess) err = bshd_tensor_map(&tdo, dout, B, Sq, H, D, kBQ);
  if (err == cudaSuccess) err = bshd_tensor_map(&tk, k, B, Sk, H, D, kBK);
  if (err == cudaSuccess) err = bshd_tensor_map(&tv, v, B, Sk, H, D, kBK);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dq_tc_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, DqSmem<D>::kBytes, st>>>(
      tq, tk, tv, tdo, lse, delta, dq, Sq, Sk, H, causal, scale,
      scale * kLog2e, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// C entry (ops/flash_attention.py). bf16 q/dout [B, Sq, H, D], k/v
// [B, Sk, H, D], lse/delta [B*H, Sq] f32, dq [B, Sq, H, D] in out_dtype
// (0 = f32, 1 = bf16); all contiguous, 16-byte aligned, D 64 or 128.
// Returns the launch's cudaError_t.
extern "C" int flash_attention_bwd_dq_tc(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const float* lse, const float* delta,
                                         void* dq, int B, int Sq, int Sk,
                                         int H, int D, int causal, float scale,
                                         int out_dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (out_dtype != DT_F32 && out_dtype != DT_BF16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ob = out_dtype == DT_BF16;
  if (D == 128)
    return (int)launch<128>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H,
                            causal, scale, ob, st);
  if (D == 64)
    return (int)launch<64>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H,
                           causal, scale, ob, st);
  return (int)cudaErrorInvalidValue;
}
