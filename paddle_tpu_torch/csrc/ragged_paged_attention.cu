// Ragged paged attention over a page-table KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/paged_attention.py::_ragged_kernel
// (launched by _ragged_attention_pallas). Same function: query t of row r
// attends every cache position <= pos0[r] + t through the row's page table,
// softmax in natural exp with f32 accumulation, scale 1/sqrt(D); pages past
// the row's last attendable position pos0 + true_len - 1 are never read; a
// query with nothing attendable returns zeros. Pools are f32 or bf16 and
// queries f32 or bf16 (a bf16 pool under f32 queries upcasts on load, as
// _gather_attend does); the output has the query dtype. Pools may also be
// int8 with per-page per-head f32 scales [P, NH] (the TPU kernel's int8
// branch): a page's values times that page's scale for the block's head,
// then the same online softmax. The null page carries scale 0, so its
// bytes read as zeros.
//
// What bounds it on the H100: bytes at decode (T = 1): every K/V element
// of the attended pages is used once, so the least time is the attended
// K/V bytes plus q/o over 3.35 TB/s. Chunk rows (T > 1, 256 in the
// engine's prefill) reuse each page across the row's queries and are
// bound by the f32 FMA rate (67 TFLOP/s, TF32 off) instead. So the two
// kinds of row take two kernels, picked by T at the launch:
//
// Decode rows (ragged_kernel, one query a block):
//  * The TPU grid walked every (row, page) step and predicated dead pages
//    off; here a block owns (row, head) and loops only over the pages its
//    query can attend (loop bound, not predication), so no byte past a
//    row's frontier is read.
//  * The block's 16 warps split the row's pages round robin, each warp
//    keeping its own running max / denominator / accumulator in f32
//    registers (online softmax, natural exp), and merge through shared
//    memory at the end: many page streams in flight per block instead of
//    one (a decode group has only R * NH blocks).
//  * K/V rows of a page are loaded 8 at a time before any is used:
//    independent loads in flight. Each lane reads its D/32 slice of a K/V
//    row straight from global memory (consecutive lanes, consecutive
//    addresses).
//  * int8 pools: a block owns one head, so a page's scale is one scalar
//    per block and page. It is folded into the score after the warp sum
//    and into the page's weights before the P.V accumulation, so the
//    inner loops multiply raw int8 values (converted to f32) and the
//    dequantized page never exists. At D a multiple of 128 a lane reads 4
//    consecutive bytes as one 32-bit word (d = 4 lane + i, and the query
//    and accumulator registers are laid out to match); other head widths
//    keep d = lane + 32 i with byte loads.
//
// Chunk rows (ragged_chunk_kernel, below): the register-tiled f32 core of
// attention_simt.cuh (online softmax in base 2), K/V pages staged in
// shared memory by cp.async, described there.
//
// Both: page 0, the null page, is an ordinary readable page; masking
// compares global positions j * ps + p against pos0 + t, never offsets in
// a page. No tensor cores yet (bf16 pools could take wgmma query tiles).
#include <algorithm>
#include <type_traits>

#include "attention_simt.cuh"

using namespace ptt;

namespace {

// Which head-dim element lane `lane` keeps in its register i. Word layout
// (int8 pools, DPL a multiple of 4): 4 consecutive elements per lane and
// 128-element group; otherwise consecutive lanes, consecutive elements.
template <bool WORDS>
__device__ __forceinline__ int dmap(int lane, int i) {
  return WORDS ? lane * 4 + (i & 3) + 128 * (i >> 2) : lane + 32 * i;
}

// One K or V row of one head into registers (f32), zeros past D or when
// the row is past the page (`ok` false). `vec`: the row is word aligned.
template <typename KT, int DPL, bool WORDS>
__device__ __forceinline__ void load_row(const KT* __restrict__ row, int lane,
                                         int D, bool ok, bool vec,
                                         float (&out)[DPL]) {
  if constexpr (WORDS) {
    if (vec) {
#pragma unroll
      for (int w = 0; w < DPL / 4; ++w) {
        const int d0 = lane * 4 + 128 * w;
        const uint32_t word =
            ok && d0 < D ? *reinterpret_cast<const uint32_t*>(row + d0) : 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          out[4 * w + b] = (float)(int8_t)(word >> (8 * b));
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = dmap<WORDS>(lane, i);
    out[i] = ok && d < D ? to_f32(row[d]) : 0.f;
  }
}

template <typename QT, typename KT, int DPL, int QW, int NW>
__global__ void __launch_bounds__(NW * 32)
ragged_kernel(const QT* __restrict__ q, const KT* __restrict__ kpool,
              const KT* __restrict__ vpool, const int* __restrict__ page_table,
              const int* __restrict__ pos0, const int* __restrict__ true_len,
              const float* __restrict__ kscale,
              const float* __restrict__ vscale, QT* __restrict__ out, int T,
              int NH, int D, int ps, int NPs, float scale, int vec) {
  constexpr bool I8 = std::is_same<KT, int8_t>::value;
  constexpr bool WORDS = I8 && DPL % 4 == 0;
  // K/V rows of a page loaded together before use, i.e. independent
  // loads in flight per lane: 8 for a decode row (one query, few
  // registers), 2 for a chunk row's 8-query tile (measured best on H100)
  constexpr int G = QW == 1 ? 8 : 2;
  __shared__ float sm_m[NW][QW];
  __shared__ float sm_l[NW][QW];
  __shared__ float sm_acc[NW][QW][DPL * 32];

  const int r = blockIdx.x, h = blockIdx.y, t0 = blockIdx.z * QW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = pos0[r];
  const int last = p0 + true_len[r] - 1;  // row's last attendable position
  const int nq = min(QW, T - t0);         // queries of this tile (>= 1)
  const int tile_last = min(last, p0 + t0 + nq - 1);
  const int n_pages = tile_last < 0 ? 0 : min(tile_last / ps + 1, NPs);

  float qr[QW][DPL], acc[QW][DPL], m[QW], l[QW];
#pragma unroll
  for (int t = 0; t < QW; ++t) {
    const long qrow = ((long)(r * T + t0 + t) * NH + h) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = dmap<WORDS>(lane, i);
      qr[t][i] = (t < nq && d < D) ? to_f32(q[qrow + d]) * scale : 0.f;
      acc[t][i] = 0.f;
    }
    m[t] = -INFINITY;
    l[t] = 0.f;
  }

  const int* tab = page_table + (long)r * NPs;
  const long row_stride = (long)NH * D;         // one token of one page
  const long page_stride = (long)ps * row_stride;
  for (int j = warp; j < n_pages; j += NW) {
    const long base = (long)tab[j] * page_stride + (long)h * D;
    const int gpos0 = j * ps;
    // int8 pools: this page's scales for head h (1 otherwise)
    float ksc = 1.f, vsc = 1.f;
    if constexpr (I8) {
      ksc = kscale[(long)tab[j] * NH + h];
      vsc = vscale[(long)tab[j] * NH + h];
    }
    // scores: after the loop lane p holds query t's score for key p
    float s[QW];
#pragma unroll
    for (int t = 0; t < QW; ++t) s[t] = -INFINITY;
    for (int pb = 0; pb < ps; pb += G) {
      float kv[G][DPL];
#pragma unroll
      for (int u = 0; u < G; ++u)
        load_row<KT, DPL, WORDS>(kpool + base + (pb + u) * row_stride, lane,
                                 D, pb + u < ps, vec != 0, kv[u]);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int p = pb + u;
#pragma unroll
        for (int t = 0; t < QW; ++t) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) dot += qr[t][i] * kv[u][i];
          dot = warp_sum(dot);
          if constexpr (I8) dot *= ksc;
          const bool ok = p < ps && t < nq && gpos0 + p <= p0 + t0 + t;
          if (lane == p) s[t] = ok ? dot : -INFINITY;
        }
      }
    }
    // online softmax over this page; s[t] becomes the page's weights
#pragma unroll
    for (int t = 0; t < QW; ++t) {
      const float mn = fmaxf(m[t], warp_max(s[t]));
      if (mn == -INFINITY) {
        s[t] = 0.f;  // nothing attendable for this query yet
      } else {
        const float alpha = expf(m[t] - mn);
        const float pe = s[t] == -INFINITY ? 0.f : expf(s[t] - mn);
        l[t] = l[t] * alpha + warp_sum(pe);
        s[t] = I8 ? pe * vsc : pe;  // the V scale rides the page's weights
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[t][i] *= alpha;
        m[t] = mn;
      }
    }
    for (int pb = 0; pb < ps; pb += G) {
      float vv[G][DPL];
#pragma unroll
      for (int u = 0; u < G; ++u)
        load_row<KT, DPL, WORDS>(vpool + base + (pb + u) * row_stride, lane,
                                 D, pb + u < ps, vec != 0, vv[u]);
#pragma unroll
      for (int u = 0; u < G; ++u) {
#pragma unroll
        for (int t = 0; t < QW; ++t) {
          // lanes past ps hold weight 0
          const float w = __shfl_sync(0xffffffffu, s[t], (pb + u) & 31);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[t][i] += w * vv[u][i];
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int t = 0; t < QW; ++t) {
    if (lane == 0) {
      sm_m[warp][t] = m[t];
      sm_l[warp][t] = l[t];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      sm_acc[warp][t][dmap<WORDS>(lane, i)] = acc[t][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nq * D; idx += NW * 32) {
    const int t = idx / D, d = idx - t * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][t]);
    float den = 0.f, num = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float mw = sm_m[w][t];
        if (mw != -INFINITY) {
          const float c = expf(mw - mx);
          den += sm_l[w][t] * c;
          num += sm_acc[w][t][d] * c;
        }
      }
    }
    out[((long)(r * T + t0 + t) * NH + h) * D + d] =
        from_f32<QT>(den > 0.f ? num / den : 0.f);
  }
}

// Chunk rows (T > 1): the register-tiled core of attention_simt.cuh. A
// block owns (row, head, query tile of 64) and walks the key positions
// its tile can attend in key tiles of 32: whole pages at page sizes 8, 16
// and 32, each page row copied through the page table into a 2-stage
// cp.async ring (tile k+1 loads while tile k computes; one barrier a
// tile). Positions past the tile's last page are zero-filled, never
// read. int8 pages: a key's page scales ride in shared memory beside the
// tile; the K scale multiplies that key's score column, the V scale its
// P column (after the row sum), so the products run on the raw values,
// converted once a tile to f32 tiles in shared memory.
// A prefill group has few blocks (R 2, T 256, 16 heads: 128, against 264
// resident on the card), so when blocks are short of two waves each
// tile's keys are split in up to max_split contiguous ranges: every split
// writes its unnormalised accumulator, m and l to the wrapper's scratch,
// and ragged_chunk_merge combines them.
template <typename QT, typename KT, class C, int NCH>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
ragged_chunk_kernel(const QT* __restrict__ q, const KT* __restrict__ kpool,
                    const KT* __restrict__ vpool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ pos0,
                    const int* __restrict__ true_len,
                    const float* __restrict__ kscale,
                    const float* __restrict__ vscale, QT* __restrict__ out,
                    float* __restrict__ part, int T, int NH, int D, int ps,
                    int NPs, float scale_log2, int vec, int nsplit) {
  using namespace simt;
  constexpr bool I8 = std::is_same<KT, int8_t>::value;
  constexpr int NTY = C::NTY, NTX = C::NTX, RM = C::RM, KN = C::KN;
  constexpr int BQ = C::BQ, BK = C::BK, NW = C::NW;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int dp = pad16(D), ldq = dp + kChunk<QT>, ldk = dp + kChunk<KT>;
  const int ldv = dp;
  float* sP = reinterpret_cast<float*>(smem_raw);  // [NW][BK][TYW RM]
  float* sKs = sP + C::P_FLOATS;                   // [2][BK] page scales
  float* sVs = sKs + 2 * BK;                       // [2][BK]
  QT* sQ = reinterpret_cast<QT*>(sVs + 2 * BK);    // [BQ][ldq]
  KT* sK = reinterpret_cast<KT*>(sQ + BQ * ldq);   // [2][BK][ldk]
  KT* sV = sK + 2 * BK * ldk;                      // [2][BK][ldv]
  // int8 pools: each landed tile is converted once to f32 tiles, which
  // the products read (16 row groups read every element)
  using CT = std::conditional_t<I8, float, KT>;
  float* sKf = reinterpret_cast<float*>(sV + 2 * BK * ldv);  // [BK][dp + 4]
  float* sVf = sKf + BK * (dp + 4);                          // [BK][dp]

  const int h = blockIdx.x, r = blockIdx.z / nsplit;
  const int sp = blockIdx.z - r * nsplit;  // this block's share of the keys
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tile first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % NTX, ty = tid / NTX;
  const int p0 = pos0[r];
  const int last = p0 + true_len[r] - 1;  // row's last attendable position
  const int nq = min(BQ, T - t0);         // queries of this tile (>= 1)
  const int tile_last = min(last, p0 + t0 + nq - 1);
  const int n_pages = tile_last < 0 ? 0 : min(tile_last / ps + 1, NPs);
  const int nkeys = n_pages * ps;  // positions of the pages read
  const long row_stride = (long)NH * D;  // one token of one page
  const int* tab = page_table + (long)r * NPs;

  const QT* qb = q + ((long)r * T + t0) * row_stride + (long)h * D;
  for (int i = warp; i < BQ; i += NW) {
    const bool ok = i < nq;
    copy_row(sQ + i * ldq, ok ? qb + i * row_stride : qb, D, dp, ok, vec,
             lane);
  }
  auto load_kv = [&](int kt, int stage) {
    for (int i = warp; i < BK; i += NW) {
      const int kp = kt * BK + i;
      const bool ok = kp < nkeys;
      const int page = ok ? tab[kp / ps] : 0;
      const long off =
          ok ? ((long)page * ps + kp % ps) * row_stride + (long)h * D : 0;
      copy_row(sK + (stage * BK + i) * ldk, kpool + off, D, dp, ok, vec,
               lane);
      copy_row(sV + (stage * BK + i) * ldv, vpool + off, D, dp, ok, vec,
               lane);
      if constexpr (I8) {
        if (lane == 0) {
          sKs[stage * BK + i] = ok ? kscale[(long)page * NH + h] : 0.f;
          sVs[stage * BK + i] = ok ? vscale[(long)page * NH + h] : 0.f;
        }
      }
    }
  };

  const int nkt = (nkeys + BK - 1) / BK;
  const int kb = sp * nkt / nsplit, ke = (sp + 1) * nkt / nsplit;
  if (kb < ke) load_kv(kb, 0);
  cp_async_commit();

  RowState<RM, NCH> st;
  st.init();
  float* sPw = sP + warp * BK * C::TYW * RM;
  for (int kt = kb; kt < ke; ++kt) {
    cp_async_wait<0>();
    // tile kt (and Q) landed for every thread, and every thread is done
    // with tile kt - 1, whose stage the next copy refills
    __syncthreads();
    if (kt + 1 < ke) {
      load_kv(kt + 1, (kt + 1 - kb) & 1);
      cp_async_commit();
    }
    const int sb = ((kt - kb) & 1) * BK;
    const CT *cK, *cV;
    int ldck, ldcv;
    if constexpr (I8) {
      for (int i = warp; i < BK; i += NW)
        for (int c = 4 * lane; c < dp; c += 128) {
          *reinterpret_cast<float4*>(sKf + i * (dp + 4) + c) =
              lds4(sK + (sb + i) * ldk + c);
          *reinterpret_cast<float4*>(sVf + i * dp + c) =
              lds4(sV + (sb + i) * ldv + c);
        }
      __syncthreads();
      cK = sKf, cV = sVf, ldck = dp + 4, ldcv = dp;
    } else {
      cK = sK + sb * ldk, cV = sV + sb * ldv, ldck = ldk, ldcv = ldv;
    }
    float s[RM][KN];
    scores<RM, KN, NTY, NTX>(sQ, ldq, cK, ldck, dp, ty, tx, s);
    float ksc[KN], vsc[KN];
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      ksc[j] = I8 ? sKs[sb + tx + NTX * j] * scale_log2 : scale_log2;
      vsc[j] = I8 ? sVs[sb + tx + NTX * j] : 1.f;
    }
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = p0 + t0 + ty + NTY * i;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int kp = k0 + tx + NTX * j;
        s[i][j] = kp < nkeys && kp <= qpos ? s[i][j] * ksc[j] : -INFINITY;
      }
    }
    softmax_update<RM, KN, NCH, NTX>(s, st);
    if constexpr (I8) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) s[i][j] *= vsc[j];
    }
    pv<RM, KN, NCH, NTY, NTX>(s, sPw, cV, ldcv, dp, ty, tx, st);
  }
  cp_async_wait<0>();  // an empty split still copied its Q tile

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = ty + NTY * i;
    if (t >= nq) continue;
    const long row = ((long)r * T + t0 + t) * NH + h;
    if (nsplit == 1) {
      const float ls = st.l[i] == 0.f ? 1.f : st.l[i];
      QT* orow = out + row * D;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = tx * 4 + 4 * NTX * c + e;
          if (d < D) orow[d] = from_f32<QT>(st.o[i][c][e] / ls);
        }
    } else {  // this split's softmax state: [D] accumulator, m, l
      float* prow = part + (row * nsplit + sp) * (D + 2);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = tx * 4 + 4 * NTX * c + e;
          if (d < D) prow[d] = st.o[i][c][e];
        }
      if (tx == 0) {
        prow[D] = st.m[i];
        prow[D + 1] = st.l[i];
      }
    }
  }
}

// Merge of a chunk row's key splits: one block per (row, query, head),
// the splits' states rescaled to their common max (base 2).
template <typename QT>
__global__ void ragged_chunk_merge(const float* __restrict__ part,
                                   QT* __restrict__ out, int D, int nsplit) {
  const long row = blockIdx.x;
  const float* pr = part + row * nsplit * (D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pr[s * (D + 2) + D]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float den = 0.f, num = 0.f;
    for (int s = 0; s < nsplit && mx != -INFINITY; ++s) {
      const float m = pr[s * (D + 2) + D];
      if (m == -INFINITY) continue;
      const float c = exp2f(m - mx);
      den += pr[s * (D + 2) + D + 1] * c;
      num += pr[s * (D + 2) + d] * c;
    }
    out[row * D + d] = from_f32<QT>(den > 0.f ? num / den : 0.f);
  }
}

// Dmax: the largest head dim of the instantiation (NCH covers it)
template <typename QT, typename KT, class C, int Dmax>
cudaError_t launch_chunk(const void* q, const void* k, const void* v,
                         const int* tab, const int* p0, const int* tl,
                         const float* ks, const float* vs, void* o,
                         float* part, int max_split, int R, int T, int NH,
                         int D, int ps, int NPs, float scale,
                         cudaStream_t st) {
  constexpr int NCH = (Dmax + 4 * C::NTX - 1) / (4 * C::NTX);
  const int nqt = (T + C::BQ - 1) / C::BQ;
  // split the keys of each (row, head, query tile) when the group has
  // too few blocks to keep two waves of resident blocks on the card
  int nsplit = 1;
  if (part != nullptr && max_split > 1) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const long blocks = (long)R * NH * nqt, want = 2L * C::MINB * sms;
    nsplit = (int)std::min<long>(
        max_split, std::max<long>(1, (want + blocks - 1) / blocks));
  }
  const bool i8 = std::is_same<KT, int8_t>::value;
  const size_t smem = C::template smem<QT, KT>(
      D, sizeof(float) * C::BK * (4 + (i8 ? 2 * simt::pad16(D) + 4 : 0)));
  cudaError_t err = cudaFuncSetAttribute(
      ragged_chunk_kernel<QT, KT, C, NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = D % simt::kChunk<QT> == 0 && D % simt::kChunk<KT> == 0 &&
                  (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  const dim3 grid(NH, nqt, R * nsplit);
  ragged_chunk_kernel<QT, KT, C, NCH><<<grid, C::THREADS, smem, st>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, tab, p0, tl, ks, vs, (QT*)o,
      part, T, NH, D, ps, NPs, scale * 1.4426950408889634f, vec, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  ragged_chunk_merge<QT><<<R * T * NH, 128, 0, st>>>(part, (QT*)o, D, nsplit);
  return cudaGetLastError();
}

template <typename QT, typename KT, int DPL>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* tab, const int* p0, const int* tl,
                     const float* ks, const float* vs, void* o, float* part,
                     int max_split, int R, int T, int NH, int D, int ps,
                     int NPs, float scale, cudaStream_t st) {
  // word loads of int8 rows: every row of a head starts word aligned
  const int vec =
      D % 4 == 0 && (uintptr_t)k % 4 == 0 && (uintptr_t)v % 4 == 0 ? 1 : 0;
  if (T == 1) {
    // decode rows: R * NH blocks only, so 16 warps per block split the
    // row's pages to keep enough page streams in flight
    constexpr int NW = 16;
    const dim3 grid(R, NH, 1);
    ragged_kernel<QT, KT, DPL, 1, NW><<<grid, NW * 32, 0, st>>>(
        (const QT*)q, (const KT*)k, (const KT*)v, tab, p0, tl, ks, vs,
        (QT*)o, T, NH, D, ps, NPs, scale, vec);
    return cudaGetLastError();
  }
  // chunk rows: above D 128 a thread keeps 2 query rows, so its output
  // patch stays at 64 registers
  if constexpr (DPL <= 2)
    return launch_chunk<QT, KT, simt::Tile128, 64>(
        q, k, v, tab, p0, tl, ks, vs, o, part, max_split, R, T, NH, D, ps,
        NPs, scale, st);
  else if constexpr (DPL <= 4)
    return launch_chunk<QT, KT, simt::Tile128, 128>(
        q, k, v, tab, p0, tl, ks, vs, o, part, max_split, R, T, NH, D, ps,
        NPs, scale, st);
  else
    return launch_chunk<QT, KT, simt::Tile256, 256>(
        q, k, v, tab, p0, tl, ks, vs, o, part, max_split, R, T, NH, D, ps,
        NPs, scale, st);
}

template <typename QT, typename KT>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* tab, const int* p0, const int* tl,
                     const float* ks, const float* vs, void* o, float* part,
                     int max_split, int R, int T, int NH, int D, int ps,
                     int NPs, float scale, cudaStream_t st) {
  if (D <= 64)
    return launch_d<QT, KT, 2>(q, k, v, tab, p0, tl, ks, vs, o, part,
                               max_split, R, T, NH, D, ps, NPs, scale, st);
  if (D <= 96)
    return launch_d<QT, KT, 3>(q, k, v, tab, p0, tl, ks, vs, o, part,
                               max_split, R, T, NH, D, ps, NPs, scale, st);
  if (D <= 128)
    return launch_d<QT, KT, 4>(q, k, v, tab, p0, tl, ks, vs, o, part,
                               max_split, R, T, NH, D, ps, NPs, scale, st);
  return launch_d<QT, KT, 8>(q, k, v, tab, p0, tl, ks, vs, o, part,
                             max_split, R, T, NH, D, ps, NPs, scale, st);
}

}  // namespace

// C entry (ops/paged_attention.py). All tensors contiguous:
//   q [R, T, NH, D], k_pool/v_pool [P, ps, NH, D], page_table [R, NPs]
//   int32, pos0/true_len [R] int32, k_scale/v_scale [P, NH] f32 (int8
//   pools; null otherwise), out [R, T, NH, D] (q dtype), scratch f32 of
//   R * T * NH * max_split * (D + 2) floats for chunk rows' key splits
//   (T > 1; null or max_split <= 1: no split).
// dtype codes: 0 = f32, 1 = bf16, 2 = int8 (pools only). Returns the
// launch's cudaError_t.
extern "C" int ragged_paged_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const int* page_table, const int* pos0,
                                      const int* true_len,
                                      const float* k_scale,
                                      const float* v_scale, void* out, int R,
                                      int T, int NH, int D, int ps, int NPs,
                                      int q_dtype, int kv_dtype, float scale,
                                      float* scratch, int max_split,
                                      void* stream) {
  if (R < 1 || T < 1 || D < 1 || D > 256 || ps < 1 || ps > 32 || NPs < 1)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == DT_INT8) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PTT_RAGGED(QC, KC, QT, KT)                                          \
  if (q_dtype == QC && kv_dtype == KC)                                      \
    return (int)launch_t<QT, KT>(q, k_pool, v_pool, page_table, pos0,       \
                                 true_len, k_scale, v_scale, out, scratch,  \
                                 max_split, R, T, NH, D, ps, NPs, scale, st);
  PTT_RAGGED(DT_F32, DT_F32, float, float)
  PTT_RAGGED(DT_F32, DT_BF16, float, __nv_bfloat16)
  PTT_RAGGED(DT_BF16, DT_BF16, __nv_bfloat16, __nv_bfloat16)
  PTT_RAGGED(DT_BF16, DT_F32, __nv_bfloat16, float)
  PTT_RAGGED(DT_F32, DT_INT8, float, int8_t)
  PTT_RAGGED(DT_BF16, DT_INT8, __nv_bfloat16, int8_t)
#undef PTT_RAGGED
  return (int)cudaErrorInvalidValue;
}
