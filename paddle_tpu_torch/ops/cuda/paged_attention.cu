// Fused paged attention (decode / speculative verify / tail prefill) for
// Hopper, sm_90a.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_paged_kernel :81 (the
// Pallas TPU kernel reached from paged_attention :154). Same function:
// page-table gather of K/V pages at their stored dtype (f32, bf16, or int8
// dequantized against [N, Hkv, P] absmax scales), GQA query heads folded
// into rows (row r = t * G + g reads query head h * G + g), online softmax
// over the sequence's pages, causal at start_position[s] + t per row,
// masked-logit fill = finfo(f32).min / 2, p = 0 where the logit is
// <= fill / 2 (an all-masked row emits zeros), final divide by
// max(l, 1e-30). Output is written straight into [S, T, H, D] f32. Page 0
// is the trash page: it is gathered like any page and masked by position.
//
// The TPU walked page slots as a sequential grid axis with m / l / acc in
// VMEM scratch. Here the wrapper picks one of two regimes from the shapes
// (ops/paged_attention.py::_k3_regime), since the two ends of the engine's
// calls are bound by different things.
//
// "tile" (rows = T * G >= 16: the tail prefill, verify with wide GQA):
// bound by operations (S=1, T=1024: ~4.3e9 FLOPs on ~25 MB). One block
// owns 64 folded rows of one (slot, kv head), 4 warps of 16 rows on tensor
// cores (attention_tile.cuh): q is f32 and split hi / lo, a bf16 or int8
// pool value is exact in TF32, so q.k and p.v take two TF32 products (three
// with an f32 pool); int8 scales multiply the logit (k scale) and p (v
// scale) per key, outside the products. Keys are gathered through the page
// table into a two-stage cp.async ring at their stored dtype (one 16-byte
// copy per chunk of a [P, D] page row), so the next tile loads while this
// one is multiplied. Only keys up to the tile's causal horizon are visited
// and the heaviest tiles are launched first.
//
// "split" (rows < 16: decode T=1, verify T=k+1 at G=1): bound by the bytes
// of the live K/V pages, and by latency at these sizes. Flash-decoding: the
// grid adds a split axis of kSplitKeys keys over the table width MP * P
// (never over start_position, which would need a host read), so the decode
// shape launches S * Hkv * MP * P / 64 blocks (2048 for the engine's, over
// 15x the SM count). A block stages its keys with cp.async, computes the
// logits of all its rows on f32 FMAs (a warp per 16 keys, lanes over D,
// the 16 dot products reduced together by a transposing butterfly), the
// softmax per row, and P.V with threads over (row, column); it writes a
// partial (m, l, acc[D]) to scratch the wrapper allocates. Splits past a
// slot's horizon write l = 0 and stop. A second kernel merges the partials
// of each row in split order: deterministic, no atomics. Tensor cores gain
// nothing at < 16 rows at the bytes bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

namespace at = attn_tile;

constexpr int kSplitKeys = 64;  // keys of one split (wrapper: SPLIT_KEYS)
constexpr int kSplitRows = 16;  // most rows the split regime takes

template <typename KV>
constexpr bool kScaled = std::is_same<KV, int8_t>::value;

// pool row ([N, Hkv, P] index) of `key` through the page table, or -1
// past n_keys
__device__ __forceinline__ long long pool_row(const int* table_row, int key,
                                              int n_keys, int h, int Hkv,
                                              int P) {
  if (key >= n_keys) return -1;
  return (static_cast<long long>(table_row[key / P]) * Hkv + h) * P + key % P;
}

// one 16-byte chunk of key `key`'s row (page-table gather), zero-filled
// past n_keys
template <int D, typename KV>
__device__ __forceinline__ void gather_chunk(KV* dst, const KV* pool,
                                             const int* table_row, int key,
                                             int n_keys, int h, int Hkv,
                                             int P, int c) {
  const long long row = pool_row(table_row, key, n_keys, h, Hkv, P);
  at::cp_async16(dst, pool + (row < 0 ? 0 : row) * D + c, row >= 0);
}

// ------------------------------------------------------------ tile regime

// Shared-memory row strides (elements) of the tile regime: with an f32
// pool, q and K rows are padded to 16 mod 32 floats for the 16-byte
// fragment loads of qk_tf32; otherwise q rows to 4 mod 32 and pool rows by
// 16 bytes (conflict-free element loads)
template <int D, typename KV>
struct TileStrides {
  static constexpr bool kF32 = std::is_same<KV, float>::value;
  static constexpr int q = kF32 ? D + 16 : D + 4;
  static constexpr int v = D + 16 / static_cast<int>(sizeof(KV));
  static constexpr int k = kF32 ? D + 16 : v;
};

template <int D, int BK, typename KV>
__global__ void __launch_bounds__(at::kThreads, 2)
paged_tile_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
                  const KV* __restrict__ v_pool,
                  const float* __restrict__ k_scales,
                  const float* __restrict__ v_scales,
                  const int* __restrict__ page_table,
                  const int* __restrict__ start_position,
                  float* __restrict__ out, int T, int H, int Hkv, int P,
                  int MP, float scale, float fill) {
  constexpr int BQ = at::kRows;
  constexpr int V = 16 / sizeof(KV);  // elements per 16-byte copy
  constexpr int QS = TileStrides<D, KV>::q, KS = TileStrides<D, KV>::k,
                VS = TileStrides<D, KV>::v;
  constexpr int NT = BK / 8, ND = D / 8;
  extern __shared__ float4 smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  KV* k_s = reinterpret_cast<KV*>(q_s + BQ * QS);  // [2][BK][KS]
  KV* v_s = k_s + 2 * BK * KS;                      // [2][BK][VS]
  float* ks_s = reinterpret_cast<float*>(v_s + 2 * BK * VS);  // [2][BK]
  float* vs_s = ks_s + 2 * BK;

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int G = H / Hkv, rows = T * G;
  const int start = start_position[s];
  const int* table_row = page_table + static_cast<long long>(s) * MP;

  // folded rows of the tile; rows past `rows` are zero and never stored
  for (int i = threadIdx.x; i < BQ * (D / 4); i += at::kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const int fr = tile * BQ + r;
    const bool ok = fr < rows;
    const long long off =
        ok ? ((static_cast<long long>(s) * T + fr / G) * H + h * G + fr % G) *
                     D + c
           : 0;
    at::cp_async16(q_s + r * QS + c, q + off, ok);
  }
  // keys beyond the tile's largest query position are masked for all rows
  const int last_row = min(rows, (tile + 1) * BQ) - 1;
  const int n_keys = min(start + last_row / G + 1, MP * P);
  const int n_tiles = n_keys > 0 ? (n_keys + BK - 1) / BK : 0;
  auto load_kv = [&](int it) {
    const int st = it & 1, k0 = it * BK;
    KV* kd = k_s + st * BK * KS;
    KV* vd = v_s + st * BK * VS;
    for (int i = threadIdx.x; i < BK * (D / V); i += at::kThreads) {
      const int r = i / (D / V), c = (i % (D / V)) * V;
      gather_chunk<D>(kd + r * KS + c, k_pool, table_row, k0 + r, n_keys, h,
                      Hkv, P, c);
      gather_chunk<D>(vd + r * VS + c, v_pool, table_row, k0 + r, n_keys, h,
                      Hkv, P, c);
    }
    if constexpr (kScaled<KV>) {
      for (int i = threadIdx.x; i < BK; i += at::kThreads) {
        const long long row = pool_row(table_row, k0 + i, n_keys, h, Hkv, P);
        at::cp_async4(ks_s + st * BK + i, k_scales + (row < 0 ? 0 : row),
                      row >= 0);
        at::cp_async4(vs_s + st * BK + i, v_scales + (row < 0 ? 0 : row),
                      row >= 0);
      }
    }
  };
  if (n_tiles > 0) load_kv(0);
  at::cp_async_commit();  // group 0: q and the first K / V tile

  const int fr0 = tile * BQ + warp * 16 + gq;  // this thread's rows: +0, +8
  const int qpos[2] = {start + fr0 / G, start + (fr0 + 8) / G};
  float m[2] = {fill, fill}, l[2] = {0.f, 0.f}, acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* q_w = q_s + warp * 16 * QS;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1);  // overlaps this tile's products
      at::cp_async_commit();
      at::cp_async_wait<1>();
    } else {
      at::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1, k0 = it * BK;
    float sc[NT][4];
    at::qk_tf32<D, NT, KV>(sc, q_w, QS, k_s + st * BK * KS, KS, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = j * 8 + 2 * tq + (e & 1);
        const int key = k0 + kc;
        float x = sc[j][e] * scale;
        if constexpr (kScaled<KV>) x *= ks_s[st * BK + kc];
        sc[j][e] = key < n_keys && key <= qpos[e >> 1] ? x : fill;
      }
    at::online_softmax<NT, ND>(sc, m, l, acc, fill * 0.5f);
    if constexpr (kScaled<KV>) {
      // l keeps the unscaled p; the v scale of each key multiplies p
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] *= vs_s[st * BK + j * 8 + 2 * tq + (e & 1)];
    }
    at::pv_tf32<D, NT, KV>(acc, sc, v_s + st * BK * VS, VS, lane);
    __syncthreads();  // the stage is consumed before it is refilled
  }
  at::cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float lt = at::row_total(l[rr]);
    const int fr = fr0 + 8 * rr;
    if (fr >= rows) continue;
    const float safe = fmaxf(lt, 1e-30f);
    float* o = out +
               ((static_cast<long long>(s) * T + fr / G) * H + h * G + fr % G) *
                   D +
               2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(o + n * 8) =
          make_float2(acc[n][2 * rr] / safe, acc[n][2 * rr + 1] / safe);
  }
}

// ------------------------------------------------------------ split regime

// One stage of transpose_sum16: lanes whose bit 2 HALF is set keep the
// upper half of v, the others the lower half, each adding its partner's
// copy of the half it keeps (HALF is a template argument, so every index
// is a constant and v stays in registers)
template <int HALF>
__device__ __forceinline__ void butterfly_stage(float (&v)[16], int lane) {
  const bool up = lane & (2 * HALF);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = up ? v[i + HALF] : v[i];
    const float give = up ? v[i] : v[i + HALF];
    v[i] = keep + __shfl_xor_sync(at::kFull, give, 2 * HALF);
  }
  if constexpr (HALF > 1) butterfly_stage<HALF / 2>(v, lane);
}

// Sum v[0..15] over the warp by a transposing butterfly (16 shuffles, not
// 16 x 5): lane L returns the total of v[key_of(L)], with
// key_of(L) = 8 b4 + 4 b3 + 2 b2 + b1 for the bits b of L.
__device__ __forceinline__ float transpose_sum16(float (&v)[16], int lane) {
  butterfly_stage<8>(v, lane);
  return v[0] + __shfl_xor_sync(at::kFull, v[0], 1);
}

template <int D, typename KV>
__global__ void __launch_bounds__(at::kThreads)
paged_split_kernel(const float* __restrict__ q, const KV* __restrict__ k_pool,
                   const KV* __restrict__ v_pool,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales,
                   const int* __restrict__ page_table,
                   const int* __restrict__ start_position,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int T, int H, int Hkv, int P, int MP, int nsplit,
                   float scale, float fill) {
  constexpr int V = 16 / sizeof(KV);
  constexpr int SD = D + V;
  constexpr int PS = kSplitKeys + 1;  // logits / p rows, padded
  constexpr int E = D / 32;
  extern __shared__ float4 smem[];
  float* q_s = reinterpret_cast<float*>(smem);               // [16][D]
  float* p_s = q_s + kSplitRows * D;                         // [16][PS]
  float* ks_s = p_s + kSplitRows * PS;                       // [keys]
  float* vs_s = ks_s + kSplitKeys;
  KV* k_s = reinterpret_cast<KV*>(vs_s + kSplitKeys);        // [keys][SD]
  KV* v_s = k_s + kSplitKeys * SD;

  const int split = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = H / Hkv, rows = T * G;
  const int start = start_position[s];
  const int* table_row = page_table + static_cast<long long>(s) * MP;
  const int n_keys = min(start + (rows - 1) / G + 1, MP * P);
  const int k0 = split * kSplitKeys;
  // partial (row r) of this split: acc at [.., split, r, D], (m, l) beside
  const long long part = ((static_cast<long long>(s) * Hkv + h) * nsplit +
                          split) * rows;
  if (k0 >= n_keys) {  // wholly past the slot's horizon: an l = 0 partial
    if (threadIdx.x < rows) {
      part_ml[(part + threadIdx.x) * 2] = fill;
      part_ml[(part + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }

  for (int i = threadIdx.x; i < rows * (D / 4); i += at::kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    at::cp_async16(
        q_s + r * D + c,
        q + ((static_cast<long long>(s) * T + r / G) * H + h * G + r % G) *
                    D + c,
        true);
  }
  for (int i = threadIdx.x; i < kSplitKeys * (D / V); i += at::kThreads) {
    const int r = i / (D / V), c = (i % (D / V)) * V;
    gather_chunk<D>(k_s + r * SD + c, k_pool, table_row, k0 + r, n_keys, h,
                    Hkv, P, c);
    gather_chunk<D>(v_s + r * SD + c, v_pool, table_row, k0 + r, n_keys, h,
                    Hkv, P, c);
  }
  if constexpr (kScaled<KV>) {
    for (int i = threadIdx.x; i < kSplitKeys; i += at::kThreads) {
      const long long row = pool_row(table_row, k0 + i, n_keys, h, Hkv, P);
      at::cp_async4(ks_s + i, k_scales + (row < 0 ? 0 : row), row >= 0);
      at::cp_async4(vs_s + i, v_scales + (row < 0 ? 0 : row), row >= 0);
    }
  }
  at::cp_async_commit();
  at::cp_async_wait<0>();
  __syncthreads();

  // logits: warp w takes keys 16 w .. 16 w + 15 of the split for all rows
  const int kw = warp * 16;
  const int my_key = 8 * ((lane >> 4) & 1) + 4 * ((lane >> 3) & 1) +
                     2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);
  for (int r = 0; r < rows; ++r) {
    float qv[E];
#pragma unroll
    for (int i = 0; i < E; ++i) qv[i] = q_s[r * D + lane + 32 * i];
    float part_dot[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const KV* kr = k_s + (kw + c) * SD + lane;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) acc += qv[i] * at::elem(kr + 32 * i);
      part_dot[c] = acc;
    }
    const float dot = transpose_sum16(part_dot, lane);
    if ((lane & 1) == 0) {
      const int kc = kw + my_key, key = k0 + kc;
      float x = dot * scale;
      if constexpr (kScaled<KV>) x *= ks_s[kc];
      p_s[r * PS + kc] = key < n_keys && key <= start + r / G ? x : fill;
    }
  }
  __syncthreads();

  // softmax of each row over the split's keys (two per lane)
  for (int r = warp; r < rows; r += at::kWarps) {
    const float x0 = p_s[r * PS + lane], x1 = p_s[r * PS + lane + 32];
    float mx = fmaxf(x0, x1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(at::kFull, mx, o));
    const float p0 = x0 > fill * 0.5f ? expf(x0 - mx) : 0.f;
    const float p1 = x1 > fill * 0.5f ? expf(x1 - mx) : 0.f;
    float ls = p0 + p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(at::kFull, ls, o);
    // l keeps the unscaled p; the v scale of each key multiplies p
    p_s[r * PS + lane] = kScaled<KV> ? p0 * vs_s[lane] : p0;
    p_s[r * PS + lane + 32] = kScaled<KV> ? p1 * vs_s[lane + 32] : p1;
    if (lane == 0) {
      part_ml[(part + r) * 2] = mx;
      part_ml[(part + r) * 2 + 1] = ls;
    }
  }
  __syncthreads();

  // acc[r][d] = sum_c p[r][c] v[c][d], threads over (row, column)
  for (int i = threadIdx.x; i < rows * D; i += at::kThreads) {
    const int r = i / D, d = i % D;
    const float* pr = p_s + r * PS;
    float acc = 0.f;
#pragma unroll 16
    for (int c = 0; c < kSplitKeys; ++c)
      acc += pr[c] * at::elem(v_s + c * SD + d);
    part_acc[(part + r) * D + d] = acc;
  }
}

// Merge the partials of one (slot, kv head, row) in split order; splits
// with l = 0 are skipped, so a row no key reaches emits zeros.
template <int D>
__global__ void __launch_bounds__(D)
paged_merge_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   float* __restrict__ out, int T, int H, int Hkv, int nsplit,
                   float fill) {
  const int r = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int d = threadIdx.x;
  const int G = H / Hkv, rows = T * G;
  const long long base =
      (static_cast<long long>(s) * Hkv + h) * nsplit * rows + r;
  float mx = fill;
  for (int i = 0; i < nsplit; ++i) {
    const float* ml = part_ml + (base + static_cast<long long>(i) * rows) * 2;
    if (ml[1] > 0.f) mx = fmaxf(mx, ml[0]);
  }
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    const long long p = base + static_cast<long long>(i) * rows;
    const float li = part_ml[p * 2 + 1];
    if (li > 0.f) {
      const float w = expf(part_ml[p * 2] - mx);
      l += w * li;
      acc += w * part_acc[p * D + d];
    }
  }
  out[((static_cast<long long>(s) * T + r / G) * H + h * G + r % G) * D + d] =
      acc / fmaxf(l, 1e-30f);
}

// ------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Call {
  const void *q, *k_pool, *v_pool, *k_scales, *v_scales, *page_table,
      *start_position;
  void *out, *scratch;
  int S, T, H, Hkv, P, MP, nsplit;
  float scale, fill;
};

template <int D, typename KV>
int launch(const Call& c, cudaStream_t stream) {
  const int rows = c.T * (c.H / c.Hkv);
  const float* q = static_cast<const float*>(c.q);
  const KV* kp = static_cast<const KV*>(c.k_pool);
  const KV* vp = static_cast<const KV*>(c.v_pool);
  const float* ks = static_cast<const float*>(c.k_scales);
  const float* vs = static_cast<const float*>(c.v_scales);
  const int* table = static_cast<const int*>(c.page_table);
  const int* start = static_cast<const int*>(c.start_position);
  float* out = static_cast<float*>(c.out);
  constexpr int SD = D + 16 / static_cast<int>(sizeof(KV));
  cudaError_t e;
  if (c.nsplit == 0) {
    // f32 pools: 32-key tiles, else 64 (2 blocks per SM at D = 128)
    constexpr int BK = std::is_same<KV, float>::value ? 32 : 64;
    using TS = TileStrides<D, KV>;
    const int smem = at::kRows * TS::q * 4 +
                     2 * BK * (TS::k + TS::v) * static_cast<int>(sizeof(KV)) +
                     4 * BK * 4;
    auto* kernel = paged_tile_kernel<D, BK, KV>;
    if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
    const dim3 grid((rows + at::kRows - 1) / at::kRows, c.Hkv, c.S);
    kernel<<<grid, at::kThreads, smem, stream>>>(
        q, kp, vp, ks, vs, table, start, out, c.T, c.H, c.Hkv, c.P, c.MP,
        c.scale, c.fill);
    return static_cast<int>(cudaGetLastError());
  }
  if (rows > kSplitRows || c.scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_acc = static_cast<float*>(c.scratch);
  float* part_ml = part_acc + static_cast<long long>(c.S) * c.Hkv * c.nsplit *
                                  rows * D;
  const int smem = (kSplitRows * D + kSplitRows * (kSplitKeys + 1) +
                    2 * kSplitKeys) * 4 +
                   2 * kSplitKeys * SD * static_cast<int>(sizeof(KV));
  auto* kernel = paged_split_kernel<D, KV>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  kernel<<<dim3(c.nsplit, c.Hkv, c.S), at::kThreads, smem, stream>>>(
      q, kp, vp, ks, vs, table, start, part_acc, part_ml, c.T, c.H, c.Hkv,
      c.P, c.MP, c.nsplit, c.scale, c.fill);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  paged_merge_kernel<D><<<dim3(rows, c.Hkv, c.S), D, 0, stream>>>(
      part_acc, part_ml, out, c.T, c.H, c.Hkv, c.nsplit, c.fill);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_dtype(int kv_dtype, const Call& c, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<D, float>(c, stream);
    case 1:
      return launch<D, __nv_bfloat16>(c, stream);
    case 2:
      return launch<D, int8_t>(c, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (paddle_tpu_torch/ops/cuda/build.py).
// kv_dtype: 0 = f32, 1 = bf16, 2 = int8 (then k_scales / v_scales are
// [N, Hkv, P] f32, else both null). nsplit = 0 runs the tile regime;
// nsplit > 0 runs the split regime over the nsplit = ceil(MP * P / 64)
// splits of 64 keys (any other count is refused, so the wrapper's
// SPLIT_KEYS cannot drift from kSplitKeys) and its merge, with `scratch`
// f32 of S * Hkv * nsplit * T * G * (D + 2) elements. q must be 16-byte
// aligned.
// Launches on `stream` and returns the launch's cudaError_t (0 on
// success); it never synchronises.
extern "C" int paddle_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* start_position, void* out, void* scratch, int S, int T,
    int H, int Hkv, int P, int D, int MP, int kv_dtype, int nsplit,
    float scale, float fill, void* stream) {
  if (S <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || P <= 0 || MP <= 0 ||
      S > 65535 || Hkv > 65535 || nsplit < 0 ||
      (nsplit > 0 && nsplit != (MP * P + kSplitKeys - 1) / kSplitKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((k_scales == nullptr) != (v_scales == nullptr) ||
      (k_scales != nullptr) != (kv_dtype == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{q,   k_pool, v_pool, k_scales, v_scales, page_table,
               start_position, out, scratch, S, T, H, Hkv, P, MP, nsplit,
               scale, fill};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return dispatch_dtype<64>(kv_dtype, c, st);
  if (D == 128) return dispatch_dtype<128>(kv_dtype, c, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
