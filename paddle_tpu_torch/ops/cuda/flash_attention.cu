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
// causal) the forward does ~3.4e10 FLOPs on ~134 MB of q/k/v/o.
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
// K2a / K2b still use f32 FMA register tiles: 256 threads form a 16 x 16
// grid; thread (ty, tx) holds rows ty + 16 i and columns tx + 16 j of each
// logits tile and, of each [rows, D] accumulator, D / 16 columns as float4
// groups (4 tx + 64 g). Tiles are staged in shared memory as f32 rows
// padded to D + 4 floats, so the 16-byte loads of a quarter warp fall in
// distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: (ty, tx) = (tid / 16, tid % 16)
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

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Stage rows [r0, r0 + ROWS) of one head of a [B, T, H, D] tensor into
// shared memory as f32, row stride D + 4; rows at or past n are zero.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long base, long long st, int r0,
                                      int n) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kPerRow = D / V;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * V;
    float* d = dst + r * (D + 4) + c;
    if (r0 + r < n) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          src + base + static_cast<long long>(r0 + r) * st + c);
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<uint4*>(d) = w;
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(
            bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
        *reinterpret_cast<float4*>(d + 4) = make_float4(
            bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two staged tiles
template <int D, int RM, int RN>
__device__ __forceinline__ void dot_tile(float (&s)[RM][RN], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = ld4(a + (ty + 16 * i) * (D + 4) + d);
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = ld4(b + (tx + 16 * j) * (D + 4) + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float x = s[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        s[i][j] = x;
      }
  }
}

// acc[i][g][e] += sum_c p[ty + 16 i][c] * m[c][64 g + 4 tx + e] for c < KC;
// p has row stride sp, m is a staged tile (row stride D + 4)
template <int D, int RM, int KC>
__device__ __forceinline__ void mm_tile(float (&acc)[RM][D / 64][4],
                                        const float* p, int sp,
                                        const float* m, int tx, int ty) {
  constexpr int DG = D / 64;
#pragma unroll 2
  for (int c = 0; c < KC; c += 4) {
    float4 pv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) pv[i] = ld4(p + (ty + 16 * i) * sp + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float4 mv[DG];
#pragma unroll
      for (int g = 0; g < DG; ++g)
        mv[g] = ld4(m + (c + cc) * (D + 4) + 64 * g + 4 * tx);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float pc = cc == 0 ? pv[i].x
                       : cc == 1 ? pv[i].y
                       : cc == 2 ? pv[i].z
                                 : pv[i].w;
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          acc[i][g][0] = fmaf(pc, mv[g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(pc, mv[g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(pc, mv[g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(pc, mv[g].w, acc[i][g][3]);
        }
      }
    }
  }
}

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

template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c,
                                       float d) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  } else {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(a)) |
                        (static_cast<uint32_t>(
                             __bfloat16_as_ushort(__float2bfloat16(b)))
                         << 16);
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16(c)) |
                        (static_cast<uint32_t>(
                             __bfloat16_as_ushort(__float2bfloat16(d)))
                         << 16);
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  }
}

// ---------------------------------------------------------------- K1

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

// ---------------------------------------------------------------- K2a

template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    float* __restrict__ dbias, Geom g) {
  constexpr int RM = BQ / 16, RN = BK / 16, DG = D / 64;
  constexpr int SD = D + 4, SP = BK + 4;
  extern __shared__ float4 smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + BQ * SD;
  float* k_s = do_s + BQ * SD;
  float* v_s = k_s + BK * SD;
  float* ds_s = v_s + BK * SD;  // [BQ][SP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  const BiasPage bp = bias_page(g, bias, b, h);

  stage<D, BQ>(q_s, q, b * g.q.b + h * g.q.h, g.q.t, q0, g.Tq);
  stage<D, BQ>(do_s, dout, b * g.dout.b + h * g.dout.h, g.dout.t, q0, g.Tq);
  float lse_r[RM], delta_r[RM], acc[RM][DG][4];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty + 16 * i;
    const long long r = static_cast<long long>(bh) * g.Tq + qi;
    lse_r[i] = qi < g.Tq ? lse[r] : 0.f;
    delta_r[i] = qi < g.Tq ? delta[r] : 0.f;
#pragma unroll
    for (int gg = 0; gg < DG; ++gg)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][gg][e] = 0.f;
  }

  const int k_end = key_end<BQ>(g, q0);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage<D, BK>(k_s, k, b * g.k.b + hk * g.k.h, g.k.t, k0, g.Tk);
    stage<D, BK>(v_s, v, b * g.v.b + hk * g.v.h, g.v.t, k0, g.Tk);
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
    dot_tile<D, RM, RN>(s, q_s, k_s, ty, tx);
    dot_tile<D, RM, RN>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float x = masked_logit(g, bp, s[i][j], qi, kj);
        const float p = x > kNegInf * 0.5f ? expf(x - lse_r[i]) : 0.f;
        const float ds = p * (dp[i][j] - delta_r[i]);
        ds_s[(ty + 16 * i) * SP + tx + 16 * j] = ds;
        if (dbias != nullptr && qi < g.Tq && kj < g.Tk)
          dbias[(static_cast<long long>(bh) * g.Tq + qi) * g.Tk + kj] = ds;
      }
    }
    __syncthreads();
    mm_tile<D, RM, BK>(acc, ds_s, SP, k_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= g.Tq) continue;
    T* out = dq + ((static_cast<long long>(b) * g.Tq + qi) * g.H + h) * D;
#pragma unroll
    for (int gg = 0; gg < DG; ++gg)
      store4<T>(out + 64 * gg + 4 * tx, acc[i][gg][0] * g.scale,
                acc[i][gg][1] * g.scale, acc[i][gg][2] * g.scale,
                acc[i][gg][3] * g.scale);
  }
}

// ---------------------------------------------------------------- K2b

template <int D, int BK, int BQ, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Geom g) {
  // rows are keys, columns are queries
  constexpr int RM = BK / 16, RN = BQ / 16, DG = D / 64;
  constexpr int SD = D + 4, SP = BQ + 4;
  extern __shared__ float4 smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + BK * SD;
  float* q_s = v_s + BK * SD;
  float* do_s = q_s + BQ * SD;
  float* p_s = do_s + BQ * SD;  // [BK][SP], P transposed
  float* ds_s = p_s + BK * SP;  // [BK][SP], dS transposed
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  const BiasPage bp = bias_page(g, bias, b, h);

  stage<D, BK>(k_s, k, b * g.k.b + hk * g.k.h, g.k.t, k0, g.Tk);
  stage<D, BK>(v_s, v, b * g.v.b + hk * g.v.h, g.v.t, k0, g.Tk);
  float dk_acc[RM][DG][4], dv_acc[RM][DG][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int gg = 0; gg < DG; ++gg)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][gg][e] = dv_acc[i][gg][e] = 0.f;

  // the first query that sees key k0 (bottom-right causal), tile-aligned
  int q_begin = 0;
  if (g.causal) {
    const int first = k0 - (g.Tk - g.Tq);
    q_begin = first > 0 ? first / BQ * BQ : 0;
  }
  for (int q0 = q_begin; q0 < g.Tq; q0 += BQ) {
    __syncthreads();
    stage<D, BQ>(q_s, q, b * g.q.b + h * g.q.h, g.q.t, q0, g.Tq);
    stage<D, BQ>(do_s, dout, b * g.dout.b + h * g.dout.h, g.dout.t, q0,
                 g.Tq);
    float lse_c[RN], delta_c[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int qj = q0 + tx + 16 * j;
      const long long r = static_cast<long long>(bh) * g.Tq + qj;
      lse_c[j] = qj < g.Tq ? lse[r] : 0.f;
      delta_c[j] = qj < g.Tq ? delta[r] : 0.f;
    }
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
    dot_tile<D, RM, RN>(s, k_s, q_s, ty, tx);
    dot_tile<D, RM, RN>(dp, v_s, do_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float x = masked_logit(g, bp, s[i][j], q0 + tx + 16 * j, kj);
        const float p = x > kNegInf * 0.5f ? expf(x - lse_c[j]) : 0.f;
        p_s[(ty + 16 * i) * SP + tx + 16 * j] = p;
        ds_s[(ty + 16 * i) * SP + tx + 16 * j] = p * (dp[i][j] - delta_c[j]);
      }
    }
    __syncthreads();
    mm_tile<D, RM, BQ>(dv_acc, p_s, SP, do_s, tx, ty);
    mm_tile<D, RM, BQ>(dk_acc, ds_s, SP, q_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= g.Tk) continue;
    const long long row = ((static_cast<long long>(b) * g.Tk + kj) * g.H + h) * D;
#pragma unroll
    for (int gg = 0; gg < DG; ++gg) {
      const int c = 64 * gg + 4 * tx;
      *reinterpret_cast<float4*>(dk + row + c) = make_float4(
          dk_acc[i][gg][0] * g.scale, dk_acc[i][gg][1] * g.scale,
          dk_acc[i][gg][2] * g.scale, dk_acc[i][gg][3] * g.scale);
      *reinterpret_cast<float4*>(dv + row + c) =
          make_float4(dv_acc[i][gg][0], dv_acc[i][gg][1], dv_acc[i][gg][2],
                      dv_acc[i][gg][3]);
    }
  }
}

// ---------------------------------------------------------------- launch

// tiles: K2a 64 query rows x 32 keys (2 blocks per SM at D = 128), K2b 64
// key rows x 32 queries (K1's tiles are chosen in run)
constexpr int kDqBQ = 64, kDqBK = 32;
constexpr int kDkvBK = 64, kDkvBQ = 32;

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
  constexpr int SD = D + 4;
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
  if (which == 1) {
    constexpr int BQ = kDqBQ, BK = kDqBK;
    const int smem = (2 * BQ * SD + 2 * BK * SD + BQ * (BK + 4)) * 4;
    return launch(flash_bwd_dq_kernel<D, BQ, BK, T>,
                  dim3((g.Tq + BQ - 1) / BQ, bh), kThreads, smem, st, q, k, v, bias,
                  dout, lse, delta, static_cast<T*>(a.out0),
                  static_cast<float*>(a.out1), g);
  }
  constexpr int BK = kDkvBK, BQ = kDkvBQ;
  const int smem = (2 * BK * SD + 2 * BQ * SD + 2 * BK * (BQ + 4)) * 4;
  return launch(flash_bwd_dkv_kernel<D, BK, BQ, T>,
                dim3((g.Tk + BK - 1) / BK, bh), kThreads, smem, st, q, k, v, bias, dout,
                lse, delta, static_cast<float*>(a.out0),
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
