// Flash attention dK/dV on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py::_bwd_dkv_kernel
// (launched by _bwd) for bf16 q/k/v/dO at head dim 64 or 128; f32 and
// other head dims keep flash_attention_bwd_dkv in flash_attention_bwd.cu
// (ops/flash_attention.py: _tc_route). Same function: with the forward's
// natural-log LSE and delta = rowsum(dO * O) (given by the caller, f32),
//   P  = exp2(q k^T * scale * log2 e - lse * log2 e)
//   dS = P * (dO v^T - delta) * scale
//   dV = P^T dO,  dK = dS^T q,
// P and dS rounded to bf16 before their products (the reference's
// `p.astype(do.dtype)` and `ds.astype(q.dtype)`), f32 accumulation, dK and
// dV written in bf16 or in f32 (the out_dtype that ring attention passes,
// with its own delta). Masked positions (causal k > q, k >= Sk, q >= Sq)
// take P = 0 by a select.
//
// Layout: every tensor keeps the public [B, S, H, D] layout, read by TMA
// through 4-D tensor maps (D, H, S, B); LSE and delta are [B*H, Sq].
//
// What bounds it on the H100: operations. 8 * B*H*Sq*Sk*D flops (halved
// when causal) against 989 TFLOP/s bf16 on the tensor cores.
//
// What the design does about it:
//  * One block per (b*h, 128 keys): two consumer warpgroups of 64 keys
//    each and one producer warpgroup (one thread issues TMA). K and V are
//    loaded once; the producer streams 64-row Q and dO tiles, from the
//    diagonal on when causal, into a 2-stage ring (full / empty mbarriers).
//    setmaxnreg moves registers from the producer (24) to the consumers
//    (240): each consumer thread holds the 64 x D dK and dV accumulators
//    and the 64 x 64 S^T and dP^T tiles.
//  * S^T = K Q^T and dP^T = V dO^T by wgmma with both operands in shared
//    memory (K-major). P^T and dS^T are computed on the accumulators in
//    registers and packed to bf16 there: the accumulator layout is the A
//    operand layout of wgmma's register form, so dV += P^T dO and
//    dK += dS^T Q read P and dS from registers and Q, dO from shared memory
//    as MN-major B operands. Neither P nor dS touches memory.
//  * Each consumer warpgroup copies its tile's LSE (times log2 e) and
//    delta rows into its own double-buffered shared rows (one named
//    barrier per tile).
//  * Blocks with the lowest keys, which see the most query tiles when
//    causal, start first.
// Not yet: a 3-stage ring, overlap of the next tile's S^T with this tile's
// dV/dK products, dQ fused in (the merged kernel of row 2).
#include "common.cuh"
#include "hopper.cuh"

using namespace ptt;
using namespace ptt::hopper;

namespace {

constexpr int kBK = 128, kBQ = 64, kThreads = 384, kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvSmem {
  static constexpr int kHalves = D / 64;
  static constexpr int kKHalf = kBK * 128;            // bytes of one half
  static constexpr int kQHalf = kBQ * 128;
  static constexpr int kKV = kHalves * kKHalf;        // K or V, 128 keys
  static constexpr int kQT = kHalves * kQHalf;        // a Q or dO tile
  static constexpr int kV0 = kKV;
  static constexpr int kQ0 = 2 * kKV;
  static constexpr int kDO0 = kQ0 + kStages * kQT;
  static constexpr int kRows = kDO0 + kStages * kQT;  // [wg][buf][lse|delta][64]
  static constexpr int kBars = kRows + 2 * 2 * 2 * kBQ * 4;
  static constexpr int kBytes = kBars + 64 + 1024;    // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, void* __restrict__ dk,
                        void* __restrict__ dv, int Sq, int Sk, int H,
                        int causal, float scale, float scale_log2,
                        int out_bf16) {
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = smem + L::kV0;
  uint8_t* sQ = smem + L::kQ0;
  uint8_t* sDO = smem + L::kDO0;
  float* sRows = reinterpret_cast<float*>(smem + L::kRows);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kBK;
  const int qt0 = causal ? k0 / kBQ : 0;
  const int nqt = (Sq + kBQ - 1) / kBQ;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
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
      mbar_arrive_expect_tx(kv_bar, 2 * L::kKV);
      for (int c = 0; c < L::kHalves; ++c) {
        tma_load_4d(sK + c * L::kKHalf, &tm_k, kv_bar, 64 * c, h, k0, b);
        tma_load_4d(sV + c * L::kKHalf, &tm_v, kv_bar, 64 * c, h, k0, b);
      }
      for (int qt = qt0, i = 0; qt < nqt; ++qt, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kQT);
        for (int c = 0; c < L::kHalves; ++c) {
          tma_load_4d(sQ + s * L::kQT + c * L::kQHalf, &tm_q, &full[s],
                      64 * c, h, qt * kBQ, b);
          tma_load_4d(sDO + s * L::kQT + c * L::kQHalf, &tm_do, &full[s],
                      64 * c, h, qt * kBQ, b);
        }
      }
    }
  } else {
    // ---------------- consumers: keys k0 + 64 wg .. + 63 ----------------
    setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int key_base = k0 + wg * 64 + warp * 16 + g;    // + 8 r
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint8_t* k_wg = sK + wg * 64 * 128;
    const uint8_t* v_wg = sV + wg * 64 * 128;
    const long row0 = (long)bh * Sq;

    mbar_wait(kv_bar, 0);
    for (int qt = qt0, i = 0; qt < nqt; ++qt, ++i) {
      const int s = i % kStages, qs = qt * kBQ;
      // this tile's LSE * log2 e and delta rows, for this warpgroup
      float* rows = sRows + (wg * 2 + (i & 1)) * 2 * kBQ;
      {
        const int j = tid % kBQ, qi = qs + j;
        if (tid < kBQ)
          rows[j] = qi < Sq ? lse[row0 + qi] * kLog2e : 0.f;
        else
          rows[kBQ + j] = qi < Sq ? delta[row0 + qi] : 0.f;
      }
      named_bar_sync(1 + wg, 128);
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* q_t = sQ + s * L::kQT;
      const uint8_t* do_t = sDO + s * L::kQT;

      float st[32], dpt[32];
      wgmma_fence();
      nt_product<D, L::kKHalf, L::kQHalf>(st, k_wg, q_t);
      nt_product<D, L::kKHalf, L::kQHalf>(dpt, v_wg, do_t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * r + e, col = 8 * j + 2 * t + e;
            const int kr = key_base + 8 * r, qc = qs + col;
            const bool live = qc < Sq && kr < Sk && !(causal && kr > qc);
            const float p =
                live ? exp2f(st[idx] * scale_log2 - rows[col]) : 0.f;
            st[idx] = p;
            dpt[idx] = p * (dpt[idx] - rows[kBQ + col]) * scale;
          }

      // P^T and dS^T to bf16 in registers before the products read them
      uint32_t pa[kBQ / 16][4], dsa[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        acc_to_a(st, kk, pa[kk]);
        acc_to_a(dpt, kk, dsa[kk]);
      }
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
      nn_product<D, L::kQHalf>(dv_acc, pa, do_t);
      nn_product<D, L::kQHalf>(dk_acc, dsa, q_t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = key_base + 8 * r;
      if (kr >= Sk) continue;
      const long off = (((long)b * Sk + kr) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float k0v = dk_acc[4 * j + 2 * r], k1v = dk_acc[4 * j + 2 * r + 1];
        const float v0v = dv_acc[4 * j + 2 * r], v1v = dv_acc[4 * j + 2 * r + 1];
        if (out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(dk) + off + col) =
              __floats2bfloat162_rn(k0v, k1v);
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(dv) + off + col) =
              __floats2bfloat162_rn(v0v, v1v);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(dk) + off + col) =
              make_float2(k0v, k1v);
          *reinterpret_cast<float2*>(static_cast<float*>(dv) + off + col) =
              make_float2(v0v, v1v);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int Sq, int Sk, int H,
                   int causal, float scale, int out_bf16, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bshd_tensor_map(&tq, q, B, Sq, H, D, kBQ);
  if (err == cudaSuccess) err = bshd_tensor_map(&tdo, dout, B, Sq, H, D, kBQ);
  if (err == cudaSuccess) err = bshd_tensor_map(&tk, k, B, Sk, H, D, kBK);
  if (err == cudaSuccess) err = bshd_tensor_map(&tv, v, B, Sk, H, D, kBK);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dkv_tc_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkvSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sk + kBK - 1) / kBK);
  kern<<<grid, kThreads, DkvSmem<D>::kBytes, st>>>(
      tq, tk, tv, tdo, lse, delta, dk, dv, Sq, Sk, H, causal, scale,
      scale * kLog2e, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// C entry (ops/flash_attention.py). bf16 q/dout [B, Sq, H, D], k/v
// [B, Sk, H, D], lse/delta [B*H, Sq] f32, dk/dv [B, Sk, H, D] in out_dtype
// (0 = f32, 1 = bf16); all contiguous, 16-byte aligned, D 64 or 128.
// Returns the launch's cudaError_t.
extern "C" int flash_attention_bwd_dkv_tc(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const float* lse, const float* delta,
                                          void* dk, void* dv, int B, int Sq,
                                          int Sk, int H, int D, int causal,
                                          float scale, int out_dtype,
                                          void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (out_dtype != DT_F32 && out_dtype != DT_BF16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ob = out_dtype == DT_BF16;
  if (D == 128)
    return (int)launch<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H,
                            causal, scale, ob, st);
  if (D == 64)
    return (int)launch<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H,
                           causal, scale, ob, st);
  return (int)cudaErrorInvalidValue;
}
