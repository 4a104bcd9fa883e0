// Fused paged attention (decode / speculative verify / tail prefill) for
// Hopper, sm_90a.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_paged_kernel (the
// Pallas TPU kernel reached from paged_attention :154). Same function:
// page-table gather of K/V pages at their stored dtype (f32, bf16, or int8
// dequantized against [N, Hkv, P] absmax scales), GQA query heads folded
// into rows (row r = t * G + g reads query head h * G + g), online softmax
// over the sequence's pages, causal at start_position[s] + t per row,
// masked-logit fill = finfo(f32).min / 2, p = 0 where the logit is
// <= fill / 2 (an all-masked row emits zeros), final divide by
// max(l, 1e-30). Output is written straight into [S, T, H, D] f32.
//
// Design on this card: one thread block per (row tile, kv head, slot).
// The TPU walked page slots as a sequential grid axis with m / l / acc in
// VMEM scratch; here the block loops over its keys itself, kChunk at a
// time gathered through the page table (a chunk may span pages), and keeps
// m / l / acc in registers (each warp owns up to kRowsPerWarp rows, each
// lane D / 32 columns of a row). Only live keys are visited: keys past the
// largest query position of the tile are masked for every row of it, so
// skipping them changes no result. Rows are tiled across
// blockIdx.x because a prefill bucket (S = 1, T up to max_length) does not
// fit one block.
//
// Bound: HBM bytes of the live K/V pages (plus int8 scales); QK and PV are
// f32 FMA. Each chunk of keys is staged through shared memory with 16-byte
// loads by the whole block and dequantized in registers. A later change
// moves QK / PV to tensor cores and pipelines the page loads with
// cp.async / TMA so loads overlap the math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowTile = kWarps * kRowsPerWarp;  // folded rows per block
constexpr int kChunk = 32;  // keys staged in shared memory per iteration

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <int D, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const float* __restrict__ q,
                       const KV* __restrict__ k_pool,
                       const KV* __restrict__ v_pool,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ page_table,
                       const int* __restrict__ start_position,
                       float* __restrict__ out, int T, int H, int Hkv, int P,
                       int MP, float scale, float fill) {
  constexpr int E = D / 32;  // columns of a row held by each lane
  // raw bytes: a __shared__ array of a class type (bf16) may not be
  // declared with a constructor
  __shared__ __align__(16) unsigned char k_raw[kChunk * D * sizeof(KV)];
  __shared__ __align__(16) unsigned char v_raw[kChunk * D * sizeof(KV)];
  KV* k_s = reinterpret_cast<KV*>(k_raw);
  KV* v_s = reinterpret_cast<KV*>(v_raw);
  __shared__ float ks_s[kChunk];
  __shared__ float vs_s[kChunk];
  __shared__ long long row_s[kChunk];

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int G = H / Hkv;
  const int rows = T * G;
  const int start = start_position[s];
  const bool has_scales = k_scales != nullptr;

  float qr[kRowsPerWarp][E];
  float acc[kRowsPerWarp][E];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
  size_t row_off[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    // rows interleave across warps so a short tile (decode) spreads over
    // all of them
    const int r = tile * kRowTile + rr * kWarps + warp;
    live[rr] = r < rows;
    const int t = r / G;
    const int hq = h * G + r % G;
    qpos[rr] = start + t;
    row_off[rr] = ((static_cast<size_t>(s) * T + t) * H + hq) * D;
    m[rr] = fill;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      qr[rr][i] = live[rr] ? q[row_off[rr] + lane + 32 * i] : 0.f;
      acc[rr][i] = 0.f;
    }
  }

  // keys beyond the tile's largest query position are masked for all rows
  const int last_row = min(rows, (tile + 1) * kRowTile) - 1;
  const int n_keys = min(start + last_row / G + 1, MP * P);
  constexpr int kVec = 16 / sizeof(KV);    // elements per 16-byte load
  constexpr int kRowVecs = D / kVec;       // 16-byte loads per key row
  uint4* kdst = reinterpret_cast<uint4*>(k_raw);
  uint4* vdst = reinterpret_cast<uint4*>(v_raw);

  for (int base = 0; base < n_keys; base += kChunk) {
    __syncthreads();  // the previous chunk has been consumed
    if (threadIdx.x < kChunk) {
      // pool row of each key of the chunk (page-table gather); -1 past the
      // horizon, where the staged key / value are zero and masked
      const int key = base + threadIdx.x;
      long long row = -1;
      if (key < n_keys) {
        const int page = page_table[static_cast<size_t>(s) * MP + key / P];
        row = (static_cast<long long>(page) * Hkv + h) * P + key % P;
      }
      row_s[threadIdx.x] = row;
      if (has_scales) {
        ks_s[threadIdx.x] = row < 0 ? 0.f : k_scales[row];
        vs_s[threadIdx.x] = row < 0 ? 0.f : v_scales[row];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * kRowVecs; i += blockDim.x) {
      const long long row = row_s[i / kRowVecs];
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (row >= 0) {
        kv = reinterpret_cast<const uint4*>(k_pool + row * D)[i % kRowVecs];
        vv = reinterpret_cast<const uint4*>(v_pool + row * D)[i % kRowVecs];
      }
      kdst[i] = kv;
      vdst[i] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      if (!live[rr]) continue;  // uniform across the warp
      // branch-free over the chunk: the kChunk warp reductions are
      // independent and interleave
      float sc[kChunk];
      float m_cur = fill;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float kscale = has_scales ? ks_s[c] : 1.f;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          float kv = to_f32(k_s[c * D + lane + 32 * i]);
          if (has_scales) kv *= kscale;
          part += qr[rr][i] * kv;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        sc[c] = base + c <= qpos[rr] ? part * scale : fill;
        m_cur = fmaxf(m_cur, sc[c]);
      }
      const float m_new = fmaxf(m[rr], m_cur);
      const float alpha = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[rr][i] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        // a still all-masked row would get exp(fill - fill) = 1; gate on
        // the raw logit so it contributes l = 0 and emits zeros
        const float p = sc[c] > fill * 0.5f ? expf(sc[c] - m_new) : 0.f;
        const float vscale = has_scales ? vs_s[c] : 1.f;
        psum += p;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          float vv = to_f32(v_s[c * D + lane + 32 * i]);
          if (has_scales) vv *= vscale;
          acc[rr][i] += p * vv;
        }
      }
      l[rr] = alpha * l[rr] + psum;
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (!live[rr]) continue;
    const float safe = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < E; ++i)
      out[row_off[rr] + lane + 32 * i] = acc[rr][i] / safe;
  }
}

template <int D, typename KV>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* k_scales, const void* v_scales,
            const void* page_table, const void* start_position, void* out,
            int S, int T, int H, int Hkv, int P, int MP, float scale,
            float fill, cudaStream_t stream) {
  const int rows = T * (H / Hkv);
  const dim3 grid((rows + kRowTile - 1) / kRowTile, Hkv, S);
  paged_attention_kernel<D, KV><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int*>(page_table),
      static_cast<const int*>(start_position), static_cast<float*>(out), T,
      H, Hkv, P, MP, scale, fill);
}

template <int D>
int dispatch_dtype(int kv_dtype, const void* q, const void* k_pool,
                   const void* v_pool, const void* k_scales,
                   const void* v_scales, const void* page_table,
                   const void* start_position, void* out, int S, int T, int H,
                   int Hkv, int P, int MP, float scale, float fill,
                   cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      launch<D, float>(q, k_pool, v_pool, k_scales, v_scales, page_table,
                       start_position, out, S, T, H, Hkv, P, MP, scale, fill,
                       stream);
      return 0;
    case 1:
      launch<D, __nv_bfloat16>(q, k_pool, v_pool, k_scales, v_scales,
                               page_table, start_position, out, S, T, H, Hkv,
                               P, MP, scale, fill, stream);
      return 0;
    case 2:
      launch<D, int8_t>(q, k_pool, v_pool, k_scales, v_scales, page_table,
                        start_position, out, S, T, H, Hkv, P, MP, scale, fill,
                        stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes (paddle_tpu_torch/ops/cuda/build.py).
// kv_dtype: 0 = f32, 1 = bf16, 2 = int8 (then k_scales / v_scales are
// [N, Hkv, P] f32, else both null). Launches on `stream` and returns the
// launch's cudaError_t (0 on success); it never synchronises.
extern "C" int paddle_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* start_position, void* out, int S, int T, int H, int Hkv,
    int P, int D, int MP, int kv_dtype, float scale, float fill,
    void* stream) {
  if (S <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || P <= 0 || MP <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((k_scales == nullptr) != (v_scales == nullptr) ||
      (k_scales != nullptr) != (kv_dtype == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (D == 64) {
    rc = dispatch_dtype<64>(kv_dtype, q, k_pool, v_pool, k_scales, v_scales,
                            page_table, start_position, out, S, T, H, Hkv, P,
                            MP, scale, fill, st);
  } else if (D == 128) {
    rc = dispatch_dtype<128>(kv_dtype, q, k_pool, v_pool, k_scales, v_scales,
                             page_table, start_position, out, S, T, H, Hkv, P,
                             MP, scale, fill, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
