// Flash attention for Hopper, sm_90a: forward (K1) and the two backward
// kernels (K2a dQ, K2b dK/dV).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:
//   K1  flash_fwd_kernel     <- _fa_forward :248 (body _fwd_kernel :136)
//   K2a flash_bwd_dq_kernel  <- _fa_backward :422, dQ call :500
//                               (body _dq_kernel :332)
//   K2b flash_bwd_dkv_kernel <- _fa_backward :422, dK/dV call :574
//                               (body _dkv_kernel :379)
// Same function: blockwise online-softmax attention over [B, T, H, D]
// (q, dO) and [B, T, Hkv, D] (k, v) with GQA by index (query head h reads
// kv head h / G, _bh_kv :195), bottom-right causal masking, an additive
// f32 bias [Bb*Hb, Tq|1, Tk|1] read through its broadcast dims (_bh_bias
// :201; a (B,1,1,Tk) padding mask is never materialized), masked logits
// NEG_INF = -1e30, p = 0 where the logit is <= NEG_INF / 2 (a row with no
// visible key emits zeros and lse = NEG_INF), final divide by
// max(l, 1e-30). The forward rounds P to v's dtype before P.V (bf16); the
// backward recomputes P = exp(s - lse) and works in f32; dQ leaves in q's
// dtype, dK / dV per *query* head in f32 (group-summed and cast by the
// caller, as in the reference :587-592), dS (dbias) only when asked.
//
// Design on this card. The TPU walked the key (or query) blocks as a
// sequential grid axis with m / l / acc in VMEM scratch. CUDA blocks run
// in no order, so each block owns one output tile and loops over the other
// axis itself, accumulators in registers: K1 and K2a own a 64-row query
// tile of one (batch, head) and walk key tiles up to the tile's causal
// horizon (_causal_last_kv :103); K2b owns a 64-row key tile and walks
// query tiles from the first that sees it (_causal_first_q :109), writing
// per-query-head partials with no atomics, so the result is deterministic.
// Inputs may be strided [B, T, H, D] views (q / k / v sliced out of the
// fused QKV projection) and are read in place, with ragged tails
// zero-filled and masked in the kernel. The heaviest causal query tiles
// are launched first.
//
// Bound: operations. At the training shapes (B=2, T=2048, H=16, D=128,
// causal) the forward does ~3.4e10 FLOPs on ~134 MB of q/k/v/o, K2a
// ~5.2e10 and K2b ~6.9e10.
//
// K1 runs on tensor cores (attention_tile.cuh, body _fwd_kernel :136):
// 4 warps of 16 query rows, S = Q.K^T and O += P.V on mma.sync (f32: three
// TF32 products of the hi / lo split, so f32 accuracy stays; bf16: native
// m16n8k16 with P rounded to bf16), the online softmax and the masks on
// the accumulator fragments, and K / V tiles (32 keys in f32, 64 in bf16)
// in a two-stage cp.async ring so the next tile loads while this one is
// multiplied. Q stays in shared memory at its stored type; two blocks fit
// an SM. The softmax takes exp as exp2 (one MUFU.EX2), fully visible tiles
// skip the mask, and f32 fragments come in 16-byte loads. What bounds it
// now: instruction issue, not the tensor cores: in f32 every warp splits
// every K / V element it reads (a quarter of the split work would do if a
// block split each tile once), and 8 warps an SM hide little latency.
// wgmma with TMA is the next step (ROADMAP A.1).
//
// K2a and K2b run on the same tile. K2a: a warp owns 16 query rows; per key
// tile S = Q.K^T and dP = dO.V^T, then P = exp(s - lse) and dS = P (dP -
// delta) in the accumulator fragments, dQ += dS.K. K2b: a warp owns 16 key
// rows and computes the transposed products, S^T = K.Q^T and dP^T = V.dO^T
// with lse / delta read by column, then dV += P^T.dO and dK += dS^T.Q, both
// accumulators (2 x D / 8 x 4 floats a thread) in registers. f32: S and dP
// run in one pass over D; every product is 3xTF32, with the backward's
// truncating split (split_tf32_trunc: two operations where K1's takes
// three); bf16: S and dP on native m16n8k16 (exact products, f32 sums),
// the products with P or dS 2xTF32 (an f32 value times a bf16 one), so P
// and dS are never rounded to bf16, as in the reference. Tiles read both
// as a qk B operand and as pv_tf32's B (K in K2a, Q and dO in K2b) sit at
// a row stride of 4 mod 32 floats and feed qk through ldmatrix
// (qk2_tf32_ldsm), so neither read has bank conflicts. Warps skip the
// tiles their rows cannot see; fully visible tiles skip the mask.
//
// Why two kernels: dQ sums over keys and dK / dV over queries, so one
// kernel would have to add partial dQ tiles across blocks with atomics,
// whose order changes from run to run. Two deterministic kernels, as in
// the reference, recompute S and dP in both: 7 products per visible
// (query, key) pair where a fused kernel would do 5. What bounds them:
// instruction issue and latency, as K1, at ~27 % of the tensor-core bound
// in f32: each warp splits the operands it reads, the S / dP phase its A
// fragments again every tile (without the dQ / dK / dV products the
// kernels keep 73 % / 60 % of their time), and 2 blocks of 4 warps an SM
// hide little latency. Shared memory sets that occupancy at f32, D = 128:
// Q and dO (K2a) or K and V (K2b) take 67.6 KB, K2a's one 32-key tile and
// K2b's two-stage 16-query ring 33.8 KB; K2b's accumulators take 128
// registers a thread. wgmma with TMA is the next step (ROADMAP A.1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// element strides of a [B, T, H, D] tensor (D has unit stride)
struct Rows {
  long long b, t, h;
};

struct Geom {
  int B, H, Hkv, Tq, Tk;
  int bias_b, bias_h, bias_tq, bias_tk;
  int causal;
  float scale;
  Rows q, k, v, dout;
};

// the bias page of one (batch, query head), read through its broadcast dims
struct BiasPage {
  const float* p;  // null: no bias
  int tq, tk;
  __device__ __forceinline__ float at(int qi, int kj) const {
    return p[(tq > 1 ? static_cast<long long>(qi) * tk : 0LL) +
             (tk > 1 ? kj : 0)];
  }
};

__device__ __forceinline__ BiasPage bias_page(const Geom& g,
                                              const float* bias, int b,
                                              int h) {
  BiasPage bp{nullptr, g.bias_tq, g.bias_tk};
  if (bias != nullptr)
    bp.p = bias + static_cast<long long>((b % g.bias_b) * g.bias_h +
                                         h % g.bias_h) *
                      g.bias_tq * g.bias_tk;
  return bp;
}

// (q.k) * scale + bias, or NEG_INF where the key is not visible
__device__ __forceinline__ float masked_logit(const Geom& g,
                                              const BiasPage& bp, float dot,
                                              int qi, int kj) {
  const bool ok = qi < g.Tq && kj < g.Tk &&
                  (!g.causal || kj <= qi + g.Tk - g.Tq);
  if (!ok) return kNegInf;
  float x = dot * g.scale;
  if (bp.p != nullptr) x += bp.at(qi, kj);
  return x;
}

// keys [0, key_end(q0)) can be visible to the query tile starting at q0
template <int BQ>
__device__ __forceinline__ int key_end(const Geom& g, int q0) {
  return g.causal ? min(g.Tk, q0 + BQ + g.Tk - g.Tq) : g.Tk;
}

// Stage rows [r0, r0 + ROWS) of one head of a [B, T, H, D] tensor into
// shared memory at their stored type with cp.async, row stride SD
// elements; rows at or past n are zero-filled (nothing is read for them).
template <int D, int ROWS, int SD, typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* src,
                                            long long st, int r0, int n) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kPerRow = D / V;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += attn_tile::kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * V;
    const bool ok = r0 + r < n;
    attn_tile::cp_async16(dst + r * SD + c,
                          ok ? src + (r0 + r) * st + c : src, ok);
  }
}

// ---------------------------------------------------------------- K1

// Shared-memory row strides (elements) of K1's tiles: f32 Q and K rows are
// padded to 16 mod 32 floats for the 16-byte fragment loads of qk_tf32,
// V rows to 4 mod 32 for its element loads; bf16 rows to D + 8 (ldmatrix)
template <int D, typename T>
struct FwdStrides {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int q = kF32 ? D + 16 : D + 8;
  static constexpr int k = q;
  static constexpr int v = kF32 ? D + 4 : D + 8;
};

// One block owns a 64-row query tile of one (batch, head): 4 warps of 16
// rows on tensor cores (attention_tile.cuh), K / V tiles of BK keys in a
// two-stage cp.async ring, walking keys up to the tile's causal horizon.
template <int D, int BK, typename T>
__global__ void __launch_bounds__(attn_tile::kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, Geom g) {
  namespace at = attn_tile;
  constexpr int BQ = at::kRows;
  constexpr int QS = FwdStrides<D, T>::q, KS = FwdStrides<D, T>::k,
                VS = FwdStrides<D, T>::v;
  constexpr int NT = BK / 8, ND = D / 8;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + BQ * QS;      // [2][BK][KS]
  T* v_s = k_s + 2 * BK * KS;  // [2][BK][VS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  const BiasPage bp = bias_page(g, bias, b, h);
  const T* kb = k + b * g.k.b + hk * g.k.h;
  const T* vb = v + b * g.v.b + hk * g.v.h;

  stage_async<D, BQ, QS>(q_s, q + b * g.q.b + h * g.q.h, g.q.t, q0, g.Tq);
  const int k_end = key_end<BQ>(g, q0);  // <= 0: no key is visible
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  auto load_kv = [&](int it) {
    const int st = it & 1;
    stage_async<D, BK, KS>(k_s + st * BK * KS, kb, g.k.t, it * BK, g.Tk);
    stage_async<D, BK, VS>(v_s + st * BK * VS, vb, g.v.t, it * BK, g.Tk);
  };
  if (n_tiles > 0) load_kv(0);
  at::cp_async_commit();  // group 0: Q and the first K / V tile

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const T* q_w = q_s + warp * 16 * QS;
  const int row0 = q0 + warp * 16 + gq;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1);  // overlaps this tile's products
      at::cp_async_commit();
      at::cp_async_wait<1>();
    } else {
      at::cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = k_s + (it & 1) * BK * KS;
    const T* vs = v_s + (it & 1) * BK * VS;
    const int k0 = it * BK;
    float s[NT][4];
    if constexpr (kF32) {
      at::qk_tf32<D, NT, float>(s, q_w, QS, ks, KS, lane);
    } else {
      at::qk_bf16<D, NT>(s, q_w, QS, ks, KS, lane);
    }
    // a tile every row of the block sees whole (no bias, inside the keys
    // and the causal horizon of the block's first row) needs no mask;
    // rows past Tq compute on zero queries and are never stored
    const bool whole = bp.p == nullptr && k0 + BK <= g.Tk &&
                       (!g.causal || k0 + BK - 1 <= q0 + g.Tk - g.Tq);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = whole ? s[j][e] * g.scale
                        : masked_logit(g, bp, s[j][e], row0 + (e >> 1) * 8,
                                       k0 + j * 8 + 2 * tq + (e & 1));
    at::online_softmax<NT, ND>(s, m, l, acc, kNegInf * 0.5f);
    if constexpr (kF32) {
      at::pv_tf32<D, NT, float>(acc, s, vs, VS, lane);
    } else {
      at::pv_bf16<D, NT>(acc, s, vs, VS, lane);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  at::cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float lt = at::row_total(l[rr]);
    const int qi = row0 + 8 * rr;
    if (qi >= g.Tq) continue;
    const float safe = fmaxf(lt, 1e-30f);
    T* out = o + ((static_cast<long long>(b) * g.Tq + qi) * g.H + h) * D +
             2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float x0 = acc[n][2 * rr] / safe, x1 = acc[n][2 * rr + 1] / safe;
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(out + n * 8) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(out + n * 8) = at::pack_bf16(x0, x1);
      }
    }
    if (tq == 0)
      lse[static_cast<long long>(bh) * g.Tq + qi] =
          lt > 0.f ? m[rr] + logf(safe) : kNegInf;
  }
}

// ---------------------------------------------------------------- K2

// Shared-memory row stride (elements) of the backward's tiles: f32 rows
// padded to 4 mod 32 floats, so qk2_tf32_ldsm's ldmatrix rows and
// pv_tf32's element loads of the same tile are both free of bank
// conflicts; bf16 rows to D + 8 (ldmatrix, and 4 mod 32 words likewise)
template <int D, typename T>
struct BwdStride {
  static constexpr int v = std::is_same<T, float>::value ? D + 4 : D + 8;
};

// s = A.B^T and t = C.E^T (the 16 rows of A and C, the 8 NT rows of B
// and E), all four tiles in shared memory at BwdStride: 3xTF32 in one
// pass over D for f32, native bf16 for bf16 (the products of two bf16
// values are exact, the sums f32, as in the reference)
template <int D, int NT, typename T>
__device__ __forceinline__ void qk2_bwd(float (&s)[NT][4], const T* a,
                                        const T* b, float (&t)[NT][4],
                                        const T* c, const T* e, int lane) {
  constexpr int S = BwdStride<D, T>::v;
  if constexpr (std::is_same<T, float>::value) {
    attn_tile::qk2_tf32_ldsm<D, NT>(s, a, b, t, c, e, S, lane);
  } else {
    attn_tile::qk_bf16<D, NT>(s, a, S, b, S, lane);
    attn_tile::qk_bf16<D, NT>(t, c, S, e, S, lane);
  }
}

// p = exp(x - lse) where the masked logit x is above NEG_INF / 2, else 0
// (a dead row, lse = NEG_INF, gives 0 and not 1: _bwd_p_ds)
__device__ __forceinline__ float bwd_p(float x, float lse) {
  return x > kNegInf * 0.5f ? exp2f((x - lse) * attn_tile::kLog2e) : 0.f;
}

// K2a. One block owns a 64-row query tile of one (batch, head); a warp
// owns 16 rows. Q and dO sit in shared memory; K / V tiles of BK keys
// come in with cp.async, one stage (see kDqBKF32). Per key tile: S = Q.K^T
// and dP = dO.V^T on tensor cores, P and dS = P (dP - delta) on the C
// fragments, dS to dbias when asked, dQ += dS.K (pv_tf32, K as its "V").
template <int D, int BK, typename T>
__global__ void __launch_bounds__(attn_tile::kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    float* __restrict__ dbias, Geom g) {
  namespace at = attn_tile;
  constexpr int BQ = at::kRows;
  constexpr int S = BwdStride<D, T>::v;
  constexpr int NT = BK / 8, ND = D / 8;
  extern __shared__ float4 smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + BQ * S;
  T* k_s = do_s + BQ * S;  // [BK][S]
  T* v_s = k_s + BK * S;   // [BK][S]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  const BiasPage bp = bias_page(g, bias, b, h);
  const T* kb = k + b * g.k.b + hk * g.k.h;
  const T* vb = v + b * g.v.b + hk * g.v.h;

  stage_async<D, BQ, S>(q_s, q + b * g.q.b + h * g.q.h, g.q.t, q0, g.Tq);
  stage_async<D, BQ, S>(do_s, dout + b * g.dout.b + h * g.dout.h, g.dout.t,
                        q0, g.Tq);
  const int k_end = key_end<BQ>(g, q0);  // <= 0: no key is visible
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  auto load_kv = [&](int it) {
    stage_async<D, BK, S>(k_s, kb, g.k.t, it * BK, g.Tk);
    stage_async<D, BK, S>(v_s, vb, g.v.t, it * BK, g.Tk);
  };
  if (n_tiles > 0) load_kv(0);
  at::cp_async_commit();  // group 0: Q, dO and the first K / V tile

  const int w0 = q0 + warp * 16, row0 = w0 + gq;
  // lse and delta of this thread's rows g and g + 8 (0 past Tq: those
  // rows have zero Q and dO, so their dS is 0 and they are never stored)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = row0 + 8 * rr;
    const long long r = static_cast<long long>(bh) * g.Tq + qi;
    lse_r[rr] = qi < g.Tq ? lse[r] : 0.f;
    delta_r[rr] = qi < g.Tq ? delta[r] : 0.f;
  }
  // keys at or past w_end are masked for every row of the warp
  const int w_end = key_end<16>(g, w0);
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const T* q_w = q_s + warp * 16 * S;
  const T* do_w = do_s + warp * 16 * S;

  for (int it = 0; it < n_tiles; ++it) {
    if (it > 0) {  // the last tile is consumed (the loop's end barrier)
      load_kv(it);
      at::cp_async_commit();
    }
    at::cp_async_wait<0>();
    __syncthreads();
    const int k0 = it * BK;
    if (k0 < w_end) {
      float s[NT][4], dp[NT][4];
      qk2_bwd<D, NT, T>(s, q_w, k_s, dp, do_w, v_s, lane);
      // a tile the warp's rows see whole needs no mask (K1's shortcut)
      const bool whole = bp.p == nullptr && k0 + BK <= g.Tk &&
                         (!g.causal || k0 + BK - 1 <= w0 + g.Tk - g.Tq);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          const float x =
              whole ? s[j][e] * g.scale
                    : masked_logit(g, bp, s[j][e], row0 + 8 * rr,
                                   k0 + j * 8 + 2 * tq + (e & 1));
          s[j][e] = bwd_p(x, lse_r[rr]) * (dp[j][e] - delta_r[rr]);  // dS
        }
      if (dbias != nullptr) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = row0 + 8 * (e >> 1);
            const int kj = k0 + j * 8 + 2 * tq + (e & 1);
            if (qi < g.Tq && kj < g.Tk)
              dbias[(static_cast<long long>(bh) * g.Tq + qi) * g.Tk + kj] =
                  s[j][e];
          }
      }
      at::pv_tf32<D, NT, T, true>(acc, s, k_s, S, lane);
    }
    __syncthreads();  // the tile is consumed before it is refilled
  }
  at::cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = row0 + 8 * rr;
    if (qi >= g.Tq) continue;
    T* out = dq + ((static_cast<long long>(b) * g.Tq + qi) * g.H + h) * D +
             2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float x0 = acc[n][2 * rr] * g.scale;
      const float x1 = acc[n][2 * rr + 1] * g.scale;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(out + n * 8) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(out + n * 8) = at::pack_bf16(x0, x1);
      }
    }
  }
}

// K2b. One block owns a 64-row key tile of one (batch, query head); a warp
// owns 16 key rows and computes the transposed products (rows are keys,
// columns are queries). K and V sit in shared memory; Q / dO tiles of BQ
// queries and their lse / delta come through a cp.async ring of STAGES
// (2: the next tile loads while this one is multiplied).
// Per query tile: S^T = K.Q^T and dP^T = V.dO^T on tensor cores, P^T and
// dS^T on the C fragments (lse / delta by column), dV += P^T.dO and
// dK += dS^T.Q (pv_tf32, the dO and Q tiles as its "V").
template <int D, int BQ, int STAGES, typename T>
__global__ void __launch_bounds__(attn_tile::kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Geom g) {
  namespace at = attn_tile;
  constexpr int BK = at::kRows;
  constexpr int S = BwdStride<D, T>::v;
  constexpr int NT = BQ / 8, ND = D / 8;
  extern __shared__ float4 smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + BK * S;
  T* q_s = v_s + BK * S;            // [STAGES][BQ][S]
  T* do_s = q_s + STAGES * BQ * S;  // [STAGES][BQ][S]
  float* lse_s = reinterpret_cast<float*>(do_s + STAGES * BQ * S);
  float* dl_s = lse_s + STAGES * BQ;  // lse_s, dl_s: [STAGES][BQ]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * BK;  // the first key tiles see most queries
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  const BiasPage bp = bias_page(g, bias, b, h);
  const T* qb = q + b * g.q.b + h * g.q.h;
  const T* dob = dout + b * g.dout.b + h * g.dout.h;
  const float* lse_b = lse + static_cast<long long>(bh) * g.Tq;
  const float* dl_b = delta + static_cast<long long>(bh) * g.Tq;

  stage_async<D, BK, S>(k_s, k + b * g.k.b + hk * g.k.h, g.k.t, k0, g.Tk);
  stage_async<D, BK, S>(v_s, v + b * g.v.b + hk * g.v.h, g.v.t, k0, g.Tk);
  // the first query that sees key k0 (bottom-right causal), tile-aligned
  int q_begin = 0;
  if (g.causal) {
    const int first = k0 - (g.Tk - g.Tq);
    q_begin = first > 0 ? first / BQ * BQ : 0;
  }
  const int n_tiles = q_begin < g.Tq ? (g.Tq - q_begin + BQ - 1) / BQ : 0;
  auto load_q = [&](int it) {
    const int st = it % STAGES, q0 = q_begin + it * BQ;
    stage_async<D, BQ, S>(q_s + st * BQ * S, qb, g.q.t, q0, g.Tq);
    stage_async<D, BQ, S>(do_s + st * BQ * S, dob, g.dout.t, q0, g.Tq);
    for (int i = threadIdx.x; i < 2 * BQ; i += at::kThreads) {
      const int c = i % BQ;
      const bool ok = q0 + c < g.Tq;  // zero past Tq (masked columns)
      at::cp_async4((i < BQ ? lse_s : dl_s) + st * BQ + c,
                    (i < BQ ? lse_b : dl_b) + (ok ? q0 + c : 0), ok);
    }
  };
  if (n_tiles > 0) load_q(0);
  at::cp_async_commit();  // group 0: K, V and the first query tile

  const int kw = k0 + warp * 16, key0 = kw + gq;
  // queries below w_first see none of the warp's keys
  const int w_first = g.causal ? kw - (g.Tk - g.Tq) : 0;
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const T* k_w = k_s + warp * 16 * S;
  const T* v_w = v_s + warp * 16 * S;

  for (int it = 0; it < n_tiles; ++it) {
    if (STAGES > 1 && it + 1 < n_tiles) {
      load_q(it + 1);  // overlaps this tile's products
      at::cp_async_commit();
      at::cp_async_wait<1>();
    } else {
      if (STAGES == 1 && it > 0) {
        load_q(it);
        at::cp_async_commit();
      }
      at::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it % STAGES, q0 = q_begin + it * BQ;
    const T* qs = q_s + st * BQ * S;
    const T* dos = do_s + st * BQ * S;
    if (kw < g.Tk && q0 + BQ > w_first) {
      float s[NT][4], dp[NT][4];
      qk2_bwd<D, NT, T>(s, k_w, qs, dp, v_w, dos, lane);
      // key kj is visible to query qi iff kj <= qi + Tk - Tq
      const bool whole = bp.p == nullptr && kw + 16 <= g.Tk &&
                         q0 + BQ <= g.Tq &&
                         (!g.causal || kw + 15 <= q0 + g.Tk - g.Tq);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // this thread's columns: queries j * 8 + 2 t and + 1
        const int c = j * 8 + 2 * tq;
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + st * BQ + c);
        const float2 d2 =
            *reinterpret_cast<const float2*>(dl_s + st * BQ + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = (e & 1) ? l2.y : l2.x;
          const float dl_c = (e & 1) ? d2.y : d2.x;
          const float x =
              whole ? s[j][e] * g.scale
                    : masked_logit(g, bp, s[j][e], q0 + c + (e & 1),
                                   key0 + 8 * (e >> 1));
          const float p = bwd_p(x, lse_c);
          s[j][e] = p;                       // P^T
          dp[j][e] = p * (dp[j][e] - dl_c);  // dS^T
        }
      }
      at::pv_tf32<D, NT, T, true>(dv_acc, s, dos, S, lane);
      at::pv_tf32<D, NT, T, true>(dk_acc, dp, qs, S, lane);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  at::cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kj = key0 + 8 * rr;
    if (kj >= g.Tk) continue;
    const long long row =
        ((static_cast<long long>(b) * g.Tk + kj) * g.H + h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dk + row + n * 8) = make_float2(
          dk_acc[n][2 * rr] * g.scale, dk_acc[n][2 * rr + 1] * g.scale);
      *reinterpret_cast<float2*>(dv + row + n * 8) =
          make_float2(dv_acc[n][2 * rr], dv_acc[n][2 * rr + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch

// K2a's key tiles, K2b's query tiles and its ring stages, by dtype. K2a
// loads each key tile into its one stage after the last is consumed (two
// blocks an SM overlap one's loads with the other's products): at f32, D =
// 128, a 32-key tile then fits two blocks an SM (Q and dO 67.6 KB, K and V
// 33.8 KB), where a two-stage ring would fit only 16 keys. K2b at f32
// keeps a two-stage ring of 16 queries (NT = 2: its dK and dV
// accumulators leave no registers for more columns).
constexpr int kDqBKF32 = 32, kDqBKBf16 = 64;
constexpr int kDkvBQF32 = 16, kDkvBQBf16 = 32;
constexpr int kDkvStagesF32 = 2, kDkvStagesBf16 = 1;

template <typename Kernel, typename... Args>
int launch(Kernel* kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

struct Args {
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  void *out0, *out1;  // fwd: o, lse; dq: dq, dbias; dkv: dk, dv
};

template <int D, typename T>
int run(int which, const Args& a, const Geom& g, cudaStream_t st) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* bias = static_cast<const float*>(a.bias);
  const int bh = g.B * g.H;
  if (which == 0) {
    // f32: 32-key tiles, bf16: 64 (2 blocks per SM at D = 128 either way)
    constexpr int BQ = attn_tile::kRows;
    constexpr int BK = std::is_same<T, float>::value ? 32 : 64;
    using S = FwdStrides<D, T>;
    const int smem = (BQ * S::q + 2 * BK * (S::k + S::v)) *
                     static_cast<int>(sizeof(T));
    return launch(flash_fwd_kernel<D, BK, T>,
                  dim3((g.Tq + BQ - 1) / BQ, bh), attn_tile::kThreads, smem,
                  st, q, k, v, bias,
                  static_cast<T*>(a.out0), static_cast<float*>(a.out1), g);
  }
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int S = BwdStride<D, T>::v;
  constexpr int E = static_cast<int>(sizeof(T));
  constexpr int R = attn_tile::kRows;
  if (which == 1) {
    constexpr int BK = kF32 ? kDqBKF32 : kDqBKBf16;
    return launch(flash_bwd_dq_kernel<D, BK, T>,
                  dim3((g.Tq + R - 1) / R, bh), attn_tile::kThreads,
                  (2 * R + 2 * BK) * S * E, st, q, k, v, bias, dout,
                  lse, delta, static_cast<T*>(a.out0),
                  static_cast<float*>(a.out1), g);
  }
  constexpr int BQ = kF32 ? kDkvBQF32 : kDkvBQBf16;
  constexpr int ST = kF32 ? kDkvStagesF32 : kDkvStagesBf16;
  return launch(flash_bwd_dkv_kernel<D, BQ, ST, T>,
                dim3((g.Tk + R - 1) / R, bh), attn_tile::kThreads,
                (2 * R + 2 * ST * BQ) * S * E + 2 * ST * BQ * 4, st, q, k, v,
                bias, dout, lse, delta, static_cast<float*>(a.out0),
                static_cast<float*>(a.out1), g);
}

int dispatch(int which, const Args& a, const long long* strides, int B,
             int H, int Hkv, int Tq, int Tk, int D, int bias_b, int bias_h,
             int bias_tq, int bias_tk, int causal, int dtype, float scale,
             void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((a.bias != nullptr) != (bias_b > 0) ||
      (a.bias != nullptr && (bias_h <= 0 || bias_tq <= 0 || bias_tk <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.B = B;
  g.H = H;
  g.Hkv = Hkv;
  g.Tq = Tq;
  g.Tk = Tk;
  g.bias_b = bias_b;
  g.bias_h = bias_h;
  g.bias_tq = bias_tq;
  g.bias_tk = bias_tk;
  g.causal = causal;
  g.scale = scale;
  Rows* rows[4] = {&g.q, &g.k, &g.v, &g.dout};
  for (int i = 0; i < 4; ++i)
    *rows[i] = Rows{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && dtype == 0) return run<64, float>(which, a, g, st);
  if (D == 64 && dtype == 1) return run<64, __nv_bfloat16>(which, a, g, st);
  if (D == 128 && dtype == 0) return run<128, float>(which, a, g, st);
  if (D == 128 && dtype == 1) return run<128, __nv_bfloat16>(which, a, g, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, bound with ctypes (paddle_tpu_torch/ops/cuda/build.py).
// q [B, Tq, H, D], k / v [B, Tk, Hkv, D] and dout [B, Tq, H, D] are read
// through `strides` (12 element strides: b, t, h of q, k, v, dout; D has
// unit stride; rows 16-byte aligned). bias is f32 [Bb * Hb, bias_tq,
// bias_tk] or null (then bias_b = 0). dtype: 0 = f32, 1 = bf16 (q, k, v,
// dout, o and dq share it). lse and delta are [B * H, Tq] f32. Outputs are
// contiguous: o and dq [B, Tq, H, D], dbias [B * H, Tq, Tk] f32 (written
// only on the visited tiles; null skips it), dk / dv [B, Tk, H, D] f32 per
// query head. Each launches on `stream`, never synchronises, and returns
// the launch's cudaError_t (0 on success).
extern "C" int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, const long long* strides, int B, int H, int Hkv, int Tq,
    int Tk, int D, int bias_b, int bias_h, int bias_tq, int bias_tk,
    int causal, int dtype, float scale, void* stream) {
  const Args a{q, k, v, bias, nullptr, nullptr, nullptr, o, lse};
  return dispatch(0, a, strides, B, H, Hkv, Tq, Tk, D, bias_b, bias_h,
                  bias_tq, bias_tk, causal, dtype, scale, stream);
}

extern "C" int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq,
    void* dbias, const long long* strides, int B, int H, int Hkv, int Tq,
    int Tk, int D, int bias_b, int bias_h, int bias_tq, int bias_tk,
    int causal, int dtype, float scale, void* stream) {
  const Args a{q, k, v, bias, dout, lse, delta, dq, dbias};
  return dispatch(1, a, strides, B, H, Hkv, Tq, Tk, D, bias_b, bias_h,
                  bias_tq, bias_tk, causal, dtype, scale, stream);
}

extern "C" int paddle_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int H, int Hkv, int Tq, int Tk, int D,
    int bias_b, int bias_h, int bias_tq, int bias_tk, int causal, int dtype,
    float scale, void* stream) {
  const Args a{q, k, v, bias, dout, lse, delta, dk, dv};
  return dispatch(2, a, strides, B, H, Hkv, Tq, Tk, D, bias_b, bias_h,
                  bias_tq, bias_tk, causal, dtype, scale, stream);
}
