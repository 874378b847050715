// Merged flash attention backward on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the TPU kernel
// paddle_tpu/ops/flash_attention.py::_bwd_single_tile_kernel (launched by
// _bwd_single_tile when the sequence is one tile each way) for bf16
// q/k/v/dO at head dim 64 or 128; f32 and other head dims keep
// flash_attention_bwd_single_tile in flash_attention_bwd.cu
// (ops/flash_attention.py: _tc_route). Same function: with the forward's
// natural-log LSE and delta = rowsum(dO * O) (given by the caller, f32),
//   P  = exp2(q k^T * scale * log2 e - lse * log2 e)
//   dS = P * (dO v^T - delta) * scale
//   dQ = dS k,  dK = dS^T q,  dV = P^T dO,
// P and dS computed once for all three and rounded to bf16 before their
// products (the reference's `p.astype(do.dtype)` and `ds.astype(q.dtype)`),
// f32 accumulation, gradients written in bf16 or in f32 (ring attention's
// out_dtype). Sq != Sk is allowed when not causal (cross attention).
// Masked positions (causal k > q, k >= Sk, q >= Sq) take P = 0 by a select.
//
// Layout: every tensor keeps the public [B, S, H, D] layout, read by TMA
// through 4-D tensor maps (D, H, S, B); LSE and delta are [B*H, Sq].
//
// What bounds it on the H100: operations. 10 * B*H*Sq*Sk*D flops (halved
// when causal) against 989 TFLOP/s bf16 on the tensor cores; next, the
// f32 dQ partial sums (below) that go through L2 atomics.
//
// What the design does about it:
//  * On the TPU one whole score tile sat in VMEM. No block here holds
//    one, so this is the dK/dV tensor-core kernel (flash_attention_bwd_
//    dkv_tc.cu) that also produces dQ: one block per (b*h, 128 keys), two
//    consumer warpgroups of 64 keys and one producer warpgroup; K and V
//    loaded once, 64-row Q and dO tiles streamed from the diagonal on
//    through a 2-stage TMA ring; S^T and dP^T by SS wgmma, P^T and dS^T
//    packed to bf16 in registers for dV += P^T dO and dK += dS^T Q (RS
//    wgmma). setmaxnreg gives the consumers 240 registers a thread.
//  * dQ: each warpgroup stores its packed dS^T rows (keys x 64 queries,
//    128-byte rows in the 128-byte swizzle) into a double-buffered shared
//    tile, 4-byte stores without bank conflicts; after a proxy fence and a
//    barrier of both warpgroups one SS wgmma per warpgroup reads it as an
//    M-major A operand: at D 128 warpgroup w takes columns 64 w .. + 63 of
//    dQ over all 128 keys, at D 64 all 64 columns over its own 64 keys, so
//    the partial is 64 x 64 f32 either way (32 registers, taken while the
//    S^T and dP^T tiles are dead). The partial is added into an f32
//    [B, Sq, H, D] scratch with 8-byte atomic adds (one per element per
//    block at D 128).
//  * One launch does all: a ticket counter per (b*h) after a __threadfence
//    lets the last block of the head convert its scratch to the output
//    dtype. With an f32 output the scratch is the output.
//  * Staging dS^T through shared memory costs a 16 KB store and one
//    64 x 64 x 128 product a warpgroup per tile; recomputing S and dP in a
//    separate dQ kernel would cost two 64 x 64 x D products and a second
//    pass over Q, K, V and dO.
// Not yet: a 3-stage ring, overlap of the next tile's S^T with this tile's
// products, dQ partials reduced in a cluster's distributed shared memory
// before the atomics.
#include "common.cuh"
#include "hopper.cuh"

using namespace ptt;
using namespace ptt::hopper;

namespace {

constexpr int kBK = 128, kBQ = 64, kThreads = 384, kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct SingleSmem {
  static constexpr int kHalves = D / 64;
  static constexpr int kKHalf = kBK * 128;            // bytes of one half
  static constexpr int kQHalf = kBQ * 128;
  static constexpr int kKV = kHalves * kKHalf;        // K or V, 128 keys
  static constexpr int kQT = kHalves * kQHalf;        // a Q or dO tile
  static constexpr int kDS = kBK * 128;               // dS^T, 128 keys x 64 q
  static constexpr int kV0 = kKV;
  static constexpr int kQ0 = 2 * kKV;
  static constexpr int kDO0 = kQ0 + kStages * kQT;
  static constexpr int kDS0 = kDO0 + kStages * kQT;   // [2][kDS]
  static constexpr int kRows = kDS0 + 2 * kDS;        // [wg][buf][lse|delta][64]
  static constexpr int kBars = kRows + 2 * 2 * 2 * kBQ * 4;
  static constexpr int kLast = kBars + 48;            // the ticket's verdict
  static constexpr int kBytes = kBars + 64 + 1024;    // + alignment slack
};

// dQ_part[64 q x 64 cols] = dS[64 q x nk keys] . K[nk keys x 64 cols]:
// dS^T rows (keys, 64 queries each) as the M-major A operand, the K half
// (keys, 64 columns each) as the MN-major B operand; both advance 16 key
// rows (2048 bytes) a k step
template <int NK16>
__device__ __forceinline__ void dq_product(float (&c)[32], const uint8_t* dst,
                                           const uint8_t* k) {
#pragma unroll
  for (int kk = 0; kk < NK16; ++kk)
    wgmma_m64n64k16_ss<1, 1>(c, desc_sw128(dst + kk * 2048, 16, 1024),
                             desc_sw128(k + kk * 2048, 16, 1024), kk > 0);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_single_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           void* __restrict__ dk, void* __restrict__ dv,
                           float* __restrict__ dq_acc,
                           int* __restrict__ tickets, void* __restrict__ dq,
                           int Sq, int Sk, int H, int causal, float scale,
                           float scale_log2, int out_bf16) {
  using L = SingleSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = smem + L::kV0;
  uint8_t* sQ = smem + L::kQ0;
  uint8_t* sDO = smem + L::kDO0;
  uint8_t* sDS = smem + L::kDS0;
  float* sRows = reinterpret_cast<float*>(smem + L::kRows);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  int* s_last = reinterpret_cast<int*>(smem + L::kLast);
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
    return;
  }

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
  // this warpgroup's dQ product: at D 128 its column half over all 128
  // keys, at D 64 every column over its own keys
  constexpr int kDqNK16 = D == 128 ? kBK / 16 : 64 / 16;
  const int dq_key0 = D == 128 ? 0 : wg * 64;
  const int dq_col0 = D == 128 ? wg * 64 : 0;
  const uint8_t* dq_k = sK + (D == 128 ? wg * L::kKHalf : 0) + dq_key0 * 128;
  // this thread's dS^T store rows: keys wg*64 + 16 warp + g + 8 r of the
  // block, each 128 bytes; 16-byte chunk j of row r sits at j ^ (r % 8)
  const int ds_row = wg * 64 + warp * 16 + g;

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
    uint8_t* ds_t = sDS + (i & 1) * L::kDS;

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
    // dS^T rows into shared memory for the dQ product: dsa[kk][2 c + r]
    // holds row ds_row + 8 r, queries 16 kk + 8 c + 2 t (+1), chunk 2 kk + c
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = ds_row + 8 * r, chunk = (2 * kk + c) ^ g;
          *reinterpret_cast<uint32_t*>(ds_t + row * 128 + chunk * 16 + 4 * t) =
              dsa[kk][2 * c + r];
        }
    fence_proxy_async();
    named_bar_sync(3, 256);               // both warpgroups' dS^T rows

    float dqp[32];
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    nn_product<D, L::kQHalf>(dv_acc, pa, do_t);
    nn_product<D, L::kQHalf>(dk_acc, dsa, q_t);
    dq_product<kDqNK16>(dqp, ds_t + dq_key0 * 128, dq_k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dqp);
    if (lane == 0) mbar_arrive(&empty[s]);

    // dqp[4 j + 2 r + e]: query qs + 16 warp + g + 8 r, column
    // dq_col0 + 8 j + 2 t + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qs + warp * 16 + g + 8 * r;
      if (qi >= Sq) continue;
      float* dst = dq_acc + (((long)b * Sq + qi) * H + h) * D + dq_col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                  make_float2(dqp[4 * j + 2 * r], dqp[4 * j + 2 * r + 1]));
    }
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

  if (dq != nullptr) {
    // the last block of this (b*h) converts the head's dQ scratch
    __threadfence();
    named_bar_sync(3, 256);
    if (threadIdx.x == 0)
      *s_last = atomicAdd(tickets + bh, 1) == (int)gridDim.y - 1;
    named_bar_sync(3, 256);
    if (*s_last) {
      // kLoads 16-byte loads in flight a thread: this tail runs in one
      // block per head, after every other block of the head is done
      constexpr int kLoads = 8;
      __threadfence();
      const int n4 = Sq * D / 4;
      for (int base = threadIdx.x; base < n4; base += 256 * kLoads) {
        float4 x[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int idx = base + u * 256, s = idx / (D / 4);
          const long off = (((long)b * Sq + s) * H + h) * D +
                           (idx - s * (D / 4)) * 4;
          if (idx < n4)
            x[u] = __ldcg(reinterpret_cast<const float4*>(dq_acc + off));
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int idx = base + u * 256, s = idx / (D / 4);
          const long off = (((long)b * Sq + s) * H + h) * D +
                           (idx - s * (D / 4)) * 4;
          if (idx >= n4) break;
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(dq) + off);
          o[0] = __floats2bfloat162_rn(x[u].x, x[u].y);
          o[1] = __floats2bfloat162_rn(x[u].z, x[u].w);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, float* dq_acc, int* tickets,
                   int B, int Sq, int Sk, int H, int causal, float scale,
                   int out_bf16, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = bshd_tensor_map(&tq, q, B, Sq, H, D, kBQ);
  if (err == cudaSuccess) err = bshd_tensor_map(&tdo, dout, B, Sq, H, D, kBQ);
  if (err == cudaSuccess) err = bshd_tensor_map(&tk, k, B, Sk, H, D, kBK);
  if (err == cudaSuccess) err = bshd_tensor_map(&tv, v, B, Sk, H, D, kBK);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_single_tc_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SingleSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sk + kBK - 1) / kBK);
  kern<<<grid, kThreads, SingleSmem<D>::kBytes, st>>>(
      tq, tk, tv, tdo, lse, delta, dk, dv, dq_acc, tickets, dq, Sq, Sk, H,
      causal, scale, scale * kLog2e, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// C entry (ops/flash_attention.py). bf16 q/dout [B, Sq, H, D], k/v
// [B, Sk, H, D], lse/delta [B*H, Sq] f32, dk/dv [B, Sk, H, D] and dq
// [B, Sq, H, D] in out_dtype (0 = f32, 1 = bf16); all contiguous, 16-byte
// aligned, D 64 or 128. dq_acc: zeroed f32 [B, Sq, H, D] scratch; tickets:
// zeroed int [B*H]. dq is NULL exactly when the output is f32: dq_acc is
// then the output itself. Returns the launch's cudaError_t.
extern "C" int flash_attention_bwd_single_tile_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    float* dq_acc, int* tickets, int B, int Sq, int Sk, int H, int D,
    int causal, float scale, int out_dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (out_dtype != DT_F32 && out_dtype != DT_BF16)
    return (int)cudaErrorInvalidValue;
  if (dq_acc == nullptr || (dq == nullptr) != (out_dtype == DT_F32) ||
      (dq != nullptr && tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(dq_acc) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ob = out_dtype == DT_BF16;
  if (D == 128)
    return (int)launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc,
                            tickets, B, Sq, Sk, H, causal, scale, ob, st);
  if (D == 64)
    return (int)launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc,
                           tickets, B, Sq, Sk, H, causal, scale, ob, st);
  return (int)cudaErrorInvalidValue;
}
