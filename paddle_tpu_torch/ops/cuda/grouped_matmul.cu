// Grouped (per-expert) matmul for Hopper, sm_90a: the forward (K4a, also
// run on rhs^T for the input gradient) and the weight gradient (K4b).
//
// Replaces paddle_tpu/ops/pallas/grouped_matmul.py:
//   K4a gmm_fwd_kernel  <- _gmm_forward :134 (body _fwd_kernel :116)
//   K4b gmm_drhs_kernel <- _gmm_drhs :182 (body _drhs_kernel :164)
// Same function: over rows sorted by group, out[r] = lhs[r] @ rhs[g(r)]
// with lhs [M, K], rhs [G, K, N] and runtime group sizes (given here as
// their exclusive cumsum offs [G + 1], computed on the device); rows past
// offs[G] are padding and come out as zeros; products accumulate in f32 and
// the output takes lhs's dtype. K4b: drhs[g] = lhs_g^T @ dout_g in f32
// [G, K, N]; an empty group's drhs is zero.
//
// Design on this card. The TPU walked a precomputed visit schedule
// (_build_schedule :53, one visit per (row tile, group) pair) as a
// sequential grid axis, carrying the sum in VMEM. Here each block owns one
// output tile and walks what it needs itself, with the sum in registers:
// a K4a block owns a 128 x 128 tile of out, finds the groups that overlap
// its rows by a binary search of offs, and runs one pass over K for each,
// rows outside the group's range masked to zero (a tile inside one group
// makes one pass, a boundary tile one per group it meets); a K4b block owns
// a 128 x 128 tile of one group's drhs[g] and walks that group's rows. No
// atomics, so the result is deterministic, and group sizes never reach the
// host. Operands are read through element strides, so dlhs reads rhs^T as a
// view (for a 1.9 GB expert weight a copy would cost more than the kernel's
// own bytes); element offsets are 64-bit.
//
// Bound: operations. At the Mixtral 8x7B expert shapes (M 8192 routed rows,
// K 4096, N 14336) each call does 9.6e11 f32 FLOPs on ~0.5-2.4 GB, so the
// card's f32 FMA rate is the limit. Each block stages 16-deep slices of
// both operands in shared memory (double-buffered: the next slice is loaded
// into registers while the current one is multiplied), and each of its 256
// threads accumulates an 8 x 8 register tile from two 16-byte shared loads
// per operand per step: 64 FMAs for four loads. A later change moves the
// products to tensor cores (wgmma in bf16 / TF32 where the caller allows
// it) and the slice loads to TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16: (ty, tx) = (tid / 16, tid % 16)
constexpr int kTile = 128;     // output tile edge, both dims
constexpr int kDepth = 16;     // reduction slice staged per step
constexpr int kLd = kTile + 4;  // shared row stride in floats
constexpr int kStage = kDepth * kLd;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ float to_float(T x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

// four consecutive elements (16-byte aligned f32, 8-byte aligned bf16)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                       bf16_hi(w.y));
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One operand of a tile product: element (r, o), r along the reduction and
// o along the output tile, lies at base[r * sr + o * so]; it reads as zero
// outside r in [r_lo, r_hi) or o in [o_lo, o_hi).
template <typename T>
struct Operand {
  const T* base;
  long long sr, so;
  int r_lo, r_hi, o_lo, o_hi;

  __device__ __forceinline__ bool in(int r, int o) const {
    return r >= r_lo && r < r_hi && o >= o_lo && o < o_hi;
  }
  __device__ __forceinline__ float at(int r, int o) const {
    return in(r, o) ? to_float(base[static_cast<long long>(r) * sr +
                                    static_cast<long long>(o) * so])
                    : 0.f;
  }
};

// A [kDepth, kTile] slice of an operand, held in registers between its
// load from device memory and its store to shared memory (as s[r][o]).
// RC: the operand is contiguous along the reduction (each thread reads four
// reductions of one output index); else along the output (four outputs of
// one reduction). VEC: those four are read as one vector, which the caller
// allows only when the contiguous stride is 1, every other stride and the
// base are aligned, and the contiguous range's ends are multiples of 4.
template <bool RC, bool VEC, typename T>
struct Slice {
  float4 v[2];

  __device__ __forceinline__ void load(const Operand<T>& op, int r0,
                                       int o0) {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = RC ? r0 + (t % 4) * 4 : r0 + t / 32 + 8 * i;
      const int o = RC ? o0 + t / 4 + 64 * i : o0 + (t % 32) * 4;
      if (VEC) {
        v[i] = op.in(r, o)
                   ? load4(op.base + static_cast<long long>(r) * op.sr +
                           static_cast<long long>(o) * op.so)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (RC) {
        v[i] = make_float4(op.at(r, o), op.at(r + 1, o), op.at(r + 2, o),
                           op.at(r + 3, o));
      } else {
        v[i] = make_float4(op.at(r, o), op.at(r, o + 1), op.at(r, o + 2),
                           op.at(r, o + 3));
      }
    }
  }

  __device__ __forceinline__ void store(float* s) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (RC) {
        const int r = (t % 4) * 4, o = t / 4 + 64 * i;
        s[r * kLd + o] = v[i].x;
        s[(r + 1) * kLd + o] = v[i].y;
        s[(r + 2) * kLd + o] = v[i].z;
        s[(r + 3) * kLd + o] = v[i].w;
      } else {
        const int r = t / 32 + 8 * i, o = (t % 32) * 4;
        *reinterpret_cast<float4*>(s + r * kLd + o) = v[i];
      }
    }
  }
};

// acc[i][j] += sum over r in [r_begin, r_end) of a(r, oa0 + row(i)) *
// b(r, ob0 + col(j)), with row(i) = 4 ty + i (i < 4) or 64 + 4 ty + i - 4,
// col(j) likewise in tx. sa / sb hold two stages each. Every thread of the
// block calls it with the same arguments (it synchronises the block).
template <bool RCA, bool RCB, bool VEC, typename T>
__device__ __forceinline__ void accumulate(float (&acc)[8][8],
                                           const Operand<T>& a,
                                           const Operand<T>& b, int r_begin,
                                           int r_end, int oa0, int ob0,
                                           float* sa, float* sb) {
  const int steps = (r_end - r_begin + kDepth - 1) / kDepth;
  if (steps <= 0) return;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  Slice<RCA, VEC, T> la;
  Slice<RCB, VEC, T> lb;
  la.load(a, r_begin, oa0);
  lb.load(b, r_begin, ob0);
  la.store(sa);
  lb.store(sb);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = (s & 1) * kStage;
    const bool more = s + 1 < steps;
    if (more) {
      la.load(a, r_begin + (s + 1) * kDepth, oa0);
      lb.load(b, r_begin + (s + 1) * kDepth, ob0);
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float* pa = sa + cur + kk * kLd;
      const float* pb = sb + cur + kk * kLd;
      const float4 a0 = ld4(pa + 4 * ty), a1 = ld4(pa + 64 + 4 * ty);
      const float4 b0 = ld4(pb + 4 * tx), b1 = ld4(pb + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      const int nxt = ((s + 1) & 1) * kStage;
      la.store(sa + nxt);
      lb.store(sb + nxt);
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16(x);
  }
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

// Write the block's tile to out (row stride ld): rows [row0, row_end) and
// columns [col0, col_end) of it exist. VEC: ld and col0 are multiples of 4.
template <bool VEC, typename T>
__device__ __forceinline__ void write_tile(T* out, long long ld, int row0,
                                           int row_end, int col0,
                                           int col_end,
                                           const float (&acc)[8][8]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= row_end) continue;
    T* dst = out + static_cast<long long>(row) * ld;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 64 * h + 4 * tx;
      if (VEC && col + 3 < col_end) {
        store4(dst + col, acc[i][4 * h], acc[i][4 * h + 1],
               acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < col_end)
            dst[col + e] = from_float<T>(acc[i][4 * h + e]);
      }
    }
  }
}

// ---------------------------------------------------------------- K4a

// Two blocks per SM: left free, ptxas gives the f32 variant that reads rhs
// along n 163 registers (one block per SM); capped at 128 it spills a
// little and runs 17 % faster on the card (NVIDIA H100 80GB HBM3 at
// 700 W), while K4b measured 3 % slower under the same cap.
template <bool RCB, bool VEC, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_fwd_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                   const int* __restrict__ offs, T* __restrict__ out,
                   long long lhs_sm, long long lhs_sk, long long rhs_sg,
                   long long rhs_sk, long long rhs_sn, int M, int K, int N,
                   int G) {
  __shared__ __align__(16) float sa[2 * kStage];
  __shared__ __align__(16) float sb[2 * kStage];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int m_end = min(m0 + kTile, M);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // the first group whose rows end past m0
  int lo = 0, hi = G;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(offs + mid + 1) > m0) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  for (int g = lo; g < G; ++g) {
    const int gs = __ldg(offs + g), ge = __ldg(offs + g + 1);
    if (gs >= m_end) break;
    const int rs = max(gs, m0), re = min(ge, m_end);
    if (rs >= re) continue;  // empty group
    // a(k, m) = lhs[m, k] for the group's rows; b(k, n) = rhs[g, k, n]
    const Operand<T> a{lhs, lhs_sk, lhs_sm, 0, K, rs, re};
    const Operand<T> b{rhs + static_cast<long long>(g) * rhs_sg, rhs_sk,
                       rhs_sn, 0, K, 0, N};
    accumulate<true, RCB, VEC>(acc, a, b, 0, K, m0, n0, sa, sb);
  }
  // rows of no group (the padding tail) keep acc = 0
  write_tile<VEC>(out, N, m0, m_end, n0, min(n0 + kTile, N), acc);
}

// ---------------------------------------------------------------- K4b

template <bool VEC, typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_drhs_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
                    const int* __restrict__ offs, float* __restrict__ drhs,
                    long long lhs_sm, long long lhs_sk, long long dout_sm,
                    long long dout_sn, int M, int K, int N) {
  __shared__ __align__(16) float sa[2 * kStage];
  __shared__ __align__(16) float sb[2 * kStage];
  const int g = blockIdx.z;
  const int k0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int rs = min(__ldg(offs + g), M), re = min(__ldg(offs + g + 1), M);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // a(r, k) = lhs[r, k], b(r, n) = dout[r, n] over the group's rows r
  const Operand<T> a{lhs, lhs_sm, lhs_sk, rs, re, 0, K};
  const Operand<T> b{dout, dout_sm, dout_sn, rs, re, 0, N};
  accumulate<false, false, VEC>(acc, a, b, rs, re, k0, n0, sa, sb);
  // an empty group writes its zeros
  write_tile<VEC>(drhs + static_cast<long long>(g) * K * N, N, k0,
                  min(k0 + kTile, K), n0, min(n0 + kTile, N), acc);
}

template <typename T>
cudaError_t launch_fwd(const void* lhs, const void* rhs, const int* offs,
                       void* out, const long long* st, int M, int K, int N,
                       int G, int rhs_k_contig, int vec,
                       cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  const T* l = static_cast<const T*>(lhs);
  const T* r = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
#define PADDLE_GMM_FWD(RCB, VEC)                                           \
  gmm_fwd_kernel<RCB, VEC, T><<<grid, kThreads, 0, stream>>>(              \
      l, r, offs, o, st[0], st[1], st[2], st[3], st[4], M, K, N, G)
  if (rhs_k_contig) {
    if (vec) {
      PADDLE_GMM_FWD(true, true);
    } else {
      PADDLE_GMM_FWD(true, false);
    }
  } else {
    if (vec) {
      PADDLE_GMM_FWD(false, true);
    } else {
      PADDLE_GMM_FWD(false, false);
    }
  }
#undef PADDLE_GMM_FWD
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_drhs(const void* lhs, const void* dout, const int* offs,
                        float* drhs, const long long* st, int M, int K,
                        int N, int G, int vec, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile, G);
  const T* l = static_cast<const T*>(lhs);
  const T* d = static_cast<const T*>(dout);
  if (vec) {
    gmm_drhs_kernel<true, T><<<grid, kThreads, 0, stream>>>(
        l, d, offs, drhs, st[0], st[1], st[2], st[3], M, K, N);
  } else {
    gmm_drhs_kernel<false, T><<<grid, kThreads, 0, stream>>>(
        l, d, offs, drhs, st[0], st[1], st[2], st[3], M, K, N);
  }
  return cudaGetLastError();
}

}  // namespace

// out [M, N] (lhs's dtype, contiguous) = grouped lhs [M, K] @ rhs [G, K, N].
// strides: lhs (m, k), rhs (g, k, n), in elements. dtype 0 = f32, 1 = bf16.
// rhs_k_contig: rhs is read along k (a transposed view); vec: see Slice.
// The caller guarantees M, N >= 1.
extern "C" int paddle_grouped_matmul_fwd(const void* lhs, const void* rhs,
                                         const int* offs, void* out,
                                         const long long* strides, int M,
                                         int K, int N, int G, int dtype,
                                         int rhs_k_contig, int vec,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(lhs, rhs, offs, out, strides, M, K, N, G,
                             rhs_k_contig, vec, s);
  return launch_fwd<__nv_bfloat16>(lhs, rhs, offs, out, strides, M, K, N, G,
                                   rhs_k_contig, vec, s);
}

// drhs [G, K, N] f32 (contiguous): drhs[g] = lhs_g^T @ dout_g over the rows
// of group g. strides: lhs (m, k), dout (m, n). The caller guarantees
// G, K, N >= 1.
extern "C" int paddle_grouped_matmul_drhs(const void* lhs, const void* dout,
                                          const int* offs, void* drhs,
                                          const long long* strides, int M,
                                          int K, int N, int G, int dtype,
                                          int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(drhs);
  if (dtype == 0)
    return launch_drhs<float>(lhs, dout, offs, d, strides, M, K, N, G, vec,
                              s);
  return launch_drhs<__nv_bfloat16>(lhs, dout, offs, d, strides, M, K, N, G,
                                    vec, s);
}
