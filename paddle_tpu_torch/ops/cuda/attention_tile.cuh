// Tensor-core attention tile for Hopper, sm_90a, shared by the flash
// forward and backward (K1, K2a, K2b, flash_attention.cu) and the tile
// regime of paged attention (K3, paged_attention.cu).
//
// A warp owns 16 query rows. S = Q.K^T and O += P.V run on mma.sync:
// m16n8k8 TF32 for f32 operands, m16n8k16 bf16 where both operands are
// bf16. The logits tile stays in the accumulator fragments, where the
// online softmax, the masks and the fill / NEG_INF gates operate; its C
// fragment is reused as the A operand of P.V without passing through
// shared memory. Q sits in shared memory (split on fragment load, so it
// costs no registers); K / V tiles come into a double-buffered ring with
// 16-byte cp.async, so the next tile loads while this one is multiplied.
//
// f32 accuracy on TF32 tensor cores, by splitting: x = hi + lo with
// hi = x rounded to TF32 as cvt.rna.tf32.f32 does (see tf32_rna; the
// backward truncates instead, split_tf32_trunc) and
// lo = x - hi, exact in f32 and at most 2^-11 |x|; the tensor core reads
// lo's top 19 bits (TF32), so hi + lo stands for x to 2^-21 |x|. A product
// of two f32 operands takes three TF32 products (lo.hi + hi.lo + hi.hi,
// the small terms first); where one operand is exact in TF32 (bf16 and
// int8 values: at most 8 significant bits) it takes two (lo.b + hi.b).
// The dropped lo.lo term is below 2^-22 of the product, so the result
// keeps f32 accuracy, where one TF32 pass (2^-11) would not.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 / k16"),
// with g = lane / 4 and t = lane % 4:
//   C (16 x 8, f32): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//   TF32 A (16 x 8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   TF32 B (8 x 8):  b0 (k=t, n=g), b1 (k=t+4, n=g)
//   bf16 A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)
//   bf16 B (16 x 8):  b0 (k=2t..2t+1, n=g), b1 (k=2t+8..2t+9, n=g)
// In TF32 P.V the C fragment of an 8-key n-tile holds keys 2t and 2t+1,
// while the A fragment wants k = t and t+4: the product sums over keys, so
// logical k = t is mapped to key 2t and k = t+4 to key 2t+1, and the B
// fragment reads V at the same keys.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace attn_tile {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows of a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ async copies

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ elements

// one stored element as f32 (exact for all three types)
__device__ __forceinline__ float elem(const float* p) { return *p; }
__device__ __forceinline__ float elem(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
}
__device__ __forceinline__ float elem(const int8_t* p) {
  return static_cast<float>(*p);
}

// cvt.rna.tf32.f32 in two full-rate integer operations (the conversion
// instruction issues at a fraction of the rate and, at ~2 per mma, set the
// kernels' pace): add half of the 13 dropped mantissa bits to the
// magnitude, then clear them, so ties round away from zero as cvt.rna does
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi rounded to TF32, lo the exact remainder (the tensor
// core drops its low 13 bits; rounding it first would cost two more
// operations per operand, on the kernels' busiest path, for 2^-22)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The backward's split (K2a, K2b): hi = x itself, whose top 19 bits the
// tensor core reads (x truncated to TF32), and lo = x - trunc(x), exact.
// Two operations where split_tf32 takes three, on the backward's busiest
// path; |lo| < 2^-10 |x|, so hi + lo stands for x to 2^-20 |x| and the
// dropped lo.lo term is below 2^-20 of the product: f32 accuracy still
// (one TF32 pass reads x to 2^-10).
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

template <bool kTrunc>
__device__ __forceinline__ void split_tf32_as(float x, uint32_t& hi,
                                              uint32_t& lo) {
  if constexpr (kTrunc) {
    split_tf32_trunc(x, hi, lo);
  } else {
    split_tf32(x, hi, lo);
  }
}

// two bf16 (lo = the smaller k index) in one register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 b16 matrices from shared memory in one instruction: lane l
// gives the address of row l % 8 of matrix l / 8 (16-byte aligned); matrix
// i lands in r[i], thread t holding row t / 4, columns 2 (t % 4) .. + 1
// (with .trans: column t / 4, rows 2 (t % 4) .. + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// ------------------------------------------------------------ mma

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A . B at f32 accuracy: A given split (ah + al); B (two f32 values of
// type BT's range) split too when BT is float (split_tf32, or
// split_tf32_trunc with kTrunc), else exact in TF32
template <typename BT, bool kTrunc = false>
__device__ __forceinline__ void mma_f32acc(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
#ifdef ATTN_TILE_ONE_PASS
  // accuracy control only (scripts/tf32_one_pass_control.py builds it):
  // one TF32 product, the split's lo terms dropped
  uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1), l0, l1;
  if constexpr (std::is_same<BT, float>::value) {
    split_tf32_as<kTrunc>(b0, h0, l0);
    split_tf32_as<kTrunc>(b1, h1, l1);
  }
  mma_tf32(c, ah, h0, h1);
#else
  if constexpr (std::is_same<BT, float>::value) {
    uint32_t h0, l0, h1, l1;
    split_tf32_as<kTrunc>(b0, h0, l0);
    split_tf32_as<kTrunc>(b1, h1, l1);
    mma_tf32(c, al, h0, h1);
    mma_tf32(c, ah, l0, l1);
    mma_tf32(c, ah, h0, h1);
  } else {
    const uint32_t e0 = __float_as_uint(b0), e1 = __float_as_uint(b1);
    mma_tf32(c, al, e0, e1);
    mma_tf32(c, ah, e0, e1);
  }
#endif
}

// ------------------------------------------------------------ products

// s[j] = Q[16 rows] . K[8 j .. 8 j + 7]^T over D, TF32 at f32 accuracy.
// q: the warp's first row in shared memory, f32, row stride qs;
// k: the key tile's first row, stored type KT, row stride ks.
// With an f32 K each thread reads 4 consecutive d of a row in one 16-byte
// load and feeds two k8 steps from it: step s maps logical k = t, t + 4 to
// d = 16 c + 4 t + 2 s, + 1 in both operands (the product sums over d, so
// any common order is exact). qs and ks must then be 16 mod 32 floats, so
// the 16-byte loads of a quarter warp fall in distinct banks. Other pool
// types read one element at a time (qs = 4 mod 32).
template <int D, int NT, typename KT>
__device__ __forceinline__ void qk_tf32(float (&s)[NT][4], const float* q,
                                        int qs, const KT* k, int ks,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if constexpr (std::is_same<KT, float>::value) {
#pragma unroll 2
    for (int c = 0; c < D; c += 16) {
      const float4 qa = *reinterpret_cast<const float4*>(q + g * qs + c +
                                                         4 * t);
      const float4 qb = *reinterpret_cast<const float4*>(
          q + (g + 8) * qs + c + 4 * t);
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      split_tf32(qa.x, ah0[0], al0[0]);
      split_tf32(qb.x, ah0[1], al0[1]);
      split_tf32(qa.y, ah0[2], al0[2]);
      split_tf32(qb.y, ah0[3], al0[3]);
      split_tf32(qa.z, ah1[0], al1[0]);
      split_tf32(qb.z, ah1[1], al1[1]);
      split_tf32(qa.w, ah1[2], al1[2]);
      split_tf32(qb.w, ah1[3], al1[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 kb = *reinterpret_cast<const float4*>(
            k + (j * 8 + g) * ks + c + 4 * t);
        mma_f32acc<float>(s[j], ah0, al0, kb.x, kb.y);
        mma_f32acc<float>(s[j], ah1, al1, kb.z, kb.w);
      }
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t ah[4], al[4];
      split_tf32(q[g * qs + kk + t], ah[0], al[0]);
      split_tf32(q[(g + 8) * qs + kk + t], ah[1], al[1]);
      split_tf32(q[g * qs + kk + t + 4], ah[2], al[2]);
      split_tf32(q[(g + 8) * qs + kk + t + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const KT* kr = k + (j * 8 + g) * ks + kk + t;
        mma_f32acc<KT>(s[j], ah, al, elem(kr), elem(kr + 4));
      }
    }
  }
}

// Two products in one pass over D, s[j] = A . B[8 j ..]^T and t[j] =
// C . E[8 j ..]^T (the backward's S and dP), TF32 at f32 accuracy by the
// backward's split (split_tf32_trunc); all four tiles f32 in shared memory
// with one row stride st of 4 mod 8 floats. Fragments come through
// ldmatrix, which moves 32-bit elements as b16 pairs: lane l of an 8 x
// 4-float matrix gets (row l / 4, column l % 4), the TF32 A and B fragment
// layout; one x4 gives A for one k8 step, or B of one n-tile for two. That
// stride keeps both these row reads and pv_tf32's element loads of the same
// tile (keys 2t, 2t + 1, column g) free of bank conflicts, where qk_tf32's
// 16-byte loads want 16 mod 32: the backward reads K (K2a), Q and dO (K2b)
// both ways. Two products in one loop give a warp twice the independent
// accumulator chains and loads in flight of one.
template <int D, int NT>
__device__ __forceinline__ void qk2_tf32_ldsm(float (&s)[NT][4],
                                              const float* a, const float* b,
                                              float (&t)[NT][4],
                                              const float* c, const float* e,
                                              int st, int lane) {
  const int lr = lane & 7, lm = lane >> 3;  // row of matrix lm
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = t[j][i] = 0.f;
  // A: matrices (rows 0-7 | 8-15) x (k 0-3 | 4-7) as a0..a3
  const int ao = ((lm & 1) * 8 + lr) * st + (lm >> 1) * 4;
  // B of one n-tile: k 0-3 | 4-7 (step kk), 8-11 | 12-15 (step kk + 8)
  const int bo = lr * st + lm * 4;
  // A's four x4 loads of a 16-wide chunk: a at kk, kk + 8; c at kk, kk + 8
  const float* arow[4] = {a + ao, a + ao + 8, c + ao, c + ao + 8};
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t r[4];
      ldsm_x4(r, arow[m] + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32_trunc(__uint_as_float(r[i]), hi[m][i], lo[m][i]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bb[4], ee[4];
      ldsm_x4(bb, b + bo + j * 8 * st + kk);
      ldsm_x4(ee, e + bo + j * 8 * st + kk);
      mma_f32acc<float, true>(s[j], hi[0], lo[0], __uint_as_float(bb[0]),
                              __uint_as_float(bb[1]));
      mma_f32acc<float, true>(t[j], hi[2], lo[2], __uint_as_float(ee[0]),
                              __uint_as_float(ee[1]));
      mma_f32acc<float, true>(s[j], hi[1], lo[1], __uint_as_float(bb[2]),
                              __uint_as_float(bb[3]));
      mma_f32acc<float, true>(t[j], hi[3], lo[3], __uint_as_float(ee[2]),
                              __uint_as_float(ee[3]));
    }
  }
}

// o += P . V[8 NT keys, D], TF32 at f32 accuracy; p is the C fragment of
// the logits tile after the softmax (f32 probabilities); kTrunc: the
// backward's split
template <int D, int NT, typename VT, bool kTrunc = false>
__device__ __forceinline__ void pv_tf32(float (&o)[D / 8][4],
                                        const float (&p)[NT][4],
                                        const VT* v, int vs, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[4], al[4];
    split_tf32_as<kTrunc>(p[j][0], ah[0], al[0]);  // (g, key 2t)
    split_tf32_as<kTrunc>(p[j][2], ah[1], al[1]);  // (g + 8, key 2t)
    split_tf32_as<kTrunc>(p[j][1], ah[2], al[2]);  // (g, key 2t + 1)
    split_tf32_as<kTrunc>(p[j][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
    const VT* v0 = v + (j * 8 + 2 * t) * vs + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      mma_f32acc<VT, kTrunc>(o[n], ah, al, elem(v0 + n * 8),
                             elem(v0 + vs + n * 8));
  }
}

// s[j] = Q . K^T on bf16 tensor cores (f32 accumulation); fragments come
// through ldmatrix (rows 16-byte aligned): Q's A fragment in one x4, the B
// fragments of two key n-tiles in another
template <int D, int NT>
__device__ __forceinline__ void qk_bf16(float (&s)[NT][4],
                                        const __nv_bfloat16* q, int qs,
                                        const __nv_bfloat16* k, int ks,
                                        int lane) {
  static_assert(NT % 2 == 0, "B fragments load two n-tiles at a time");
  const int lr = lane & 7, lm = lane >> 3;  // row of matrix lm
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15), row-major as a0..a3
  const __nv_bfloat16* qrow = q + ((lm & 1) * 8 + lr) * qs + (lm >> 1) * 8;
  // B of n-tiles j, j + 1: (keys of j | j + 1) x (k 0-7 | 8-15)
  const __nv_bfloat16* krow = k + ((lm >> 1) * 8 + lr) * ks + (lm & 1) * 8;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, qrow + kk);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, krow + j * 8 * ks + kk);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

// o += bf16(P) . V on bf16 tensor cores: P is rounded to bf16 (v's type)
// before the product, as the reference does; V's B fragments of two
// column n-tiles come through one transposing ldmatrix
template <int D, int NT>
__device__ __forceinline__ void pv_bf16(float (&o)[D / 8][4],
                                        const float (&p)[NT][4],
                                        const __nv_bfloat16* v, int vs,
                                        int lane) {
  static_assert(NT % 2 == 0, "bf16 P.V takes 16 keys per step");
  const int lr = lane & 7, lm = lane >> 3;
  // (keys 0-7 | 8-15 of the step) x (columns of n-tile n | n + 1)
  const __nv_bfloat16* vrow = v + ((lm & 1) * 8 + lr) * vs + (lm >> 1) * 8;
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * jj][0], p[2 * jj][1]);
    a[1] = pack_bf16(p[2 * jj][2], p[2 * jj][3]);
    a[2] = pack_bf16(p[2 * jj + 1][0], p[2 * jj + 1][1]);
    a[3] = pack_bf16(p[2 * jj + 1][2], p[2 * jj + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, vrow + jj * 16 * vs + n * 8);
      mma_bf16(o[n], a, b[0], b[1]);
      mma_bf16(o[n + 1], a, b[2], b[3]);
    }
  }
}

// ------------------------------------------------------------ softmax

// Online-softmax step on the fragments. s holds this tile's masked logits
// (masked = the caller's fill); rows g (rr = 0: c0, c1) and g + 8 (rr = 1:
// c2, c3) of each n-tile. m is the running row max (shared by the 4
// threads of a row), l this thread's share of the running row sum. On
// return s holds p = exp(s - m_new), 0 where the logit is <= gate (so a
// row that is still all-masked contributes nothing), and o is rescaled.
template <int NT, int ND>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&o)[ND][4],
                                               float gate) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = m[rr];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    // exp(x) as exp2(x log2 e): one multiply and the MUFU.EX2 instruction
    const float alpha = exp2f((m[rr] - mx) * kLog2e);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
        const float x = s[j][e];
        const float p = x > gate ? exp2f((x - mx) * kLog2e) : 0.f;
        s[j][e] = p;
        ps += p;
      }
    l[rr] = alpha * l[rr] + ps;
    m[rr] = mx;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][2 * rr] *= alpha;
      o[n][2 * rr + 1] *= alpha;
    }
  }
}

// the full row sum from the 4 threads that share a row
__device__ __forceinline__ float row_total(float l) {
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  return l;
}

}  // namespace attn_tile
