// Grouped (per-expert) matmul for Hopper, sm_90a, on tensor cores: the
// forward (K4a, also run on rhs^T for the input gradient) and the weight
// gradient (K4b).
//
// Replaces paddle_tpu/ops/pallas/grouped_matmul.py:
//   K4a gmm_fwd_kernel  <- _gmm_forward :134 (call :156, body _fwd_kernel
//                          :116)
//   K4b gmm_drhs_kernel <- _gmm_drhs :182 (call :201, body _drhs_kernel
//                          :164)
// Same function: over rows sorted by group, out[r] = lhs[r] @ rhs[g(r)]
// with lhs [M, K], rhs [G, K, N] and runtime group sizes (given here as
// their exclusive cumsum offs [G + 1], computed on the device); rows past
// offs[G] are padding and come out as zeros; products accumulate in f32 and
// the output takes lhs's dtype. K4b: drhs[g] = lhs_g^T @ dout_g in f32
// [G, K, N]; an empty group's drhs is zero.
//
// Bound: operations. At the Mixtral 8x7B expert shapes (M 8192 routed rows,
// K 4096, N 14336) each call does 9.62e11 FLOPs on 0.5-2.4 GB: 0.97 ms on
// the bf16 tensor cores (989 TFLOP/s) against 0.15-0.7 ms of HBM time. An
// f32-accurate product takes three TF32 products (below): 5.8 ms at the
// TF32 peak (495 TFLOP/s), 9.0 ms at the 321 TFLOP/s at which mma.sync
// issues m16n8k8 on this card.
//
// Design on this card.
// - The walk. The TPU walked a precomputed visit schedule (_build_schedule
//   :53, one visit per (row tile, group) pair) as a sequential grid axis.
//   Here each block owns one output tile and walks what it needs itself,
//   the sum in registers: a K4a block finds the first group that meets its
//   rows by a binary search of offs and runs one pass over K for each group
//   it meets (a boundary tile makes several); a K4b block owns a tile of
//   one group's drhs[g] and walks that group's rows. No atomics, so the
//   result is deterministic, and group sizes never reach the host.
//   Operands are read through element strides, so dlhs reads rhs^T as a
//   view (for a 1.9 GB expert weight a copy would cost more than the
//   kernel's own bytes); element offsets are 64-bit. K4a blocks run in
//   bands of kGroupM row tiles, down the rows first, so that the blocks in
//   flight share rhs column stripes and a band's lhs rows stay in L2.
// - Loads. A ring of shared-memory stages filled by 16-byte cp.async with
//   zero-fill: rows outside the visit's group, K4b's reduction tail that
//   runs into the next group, and ragged K and N edges read as zero, so
//   every product is a whole tile. Operands whose rows are not 16-byte
//   aligned (K or N not a multiple of 16 bytes) take element copies into
//   the same tiles. TMA would spare the threads the address arithmetic but
//   cannot mask a group boundary inside a tile; it is left for later.
// - bf16: wgmma m64n128k16 (f32 accumulators in registers, both operands
//   from shared memory through descriptors). Two warpgroups each own 64
//   rows of a 128 x 256 block tile. The tiles sit in wgmma's canonical
//   swizzled layouts, written so by the cp.async stores: K-major operands
//   (lhs, dout in dlhs, the rhs^T view) as 128-byte rows of 64 reductions,
//   MN-major ones (rhs in K4a, lhs^T and dout in K4b) as 64-column atoms
//   read with wgmma's transpose bit. What holds it back is the cp.async
//   feed (every thread copying 16 bytes at a time, a block barrier each
//   stage): on the card it runs 1.5x faster without its loads, and neither
//   a deeper ring nor a taller tile with less feed per output helped
//   (scripts/gmm_variants.py). TMA loads from a producer warp, multicast
//   across a cluster, are the way on.
// - f32: mma.sync m16n8k8 on TF32 at f32 accuracy, three products of a
//   hi / lo split (attention_tile.cuh::split_tf32_trunc: hi = x, whose top
//   19 bits the tensor core reads; lo = x - trunc(x)). TF32 wgmma takes
//   only K-major operands, and three of the four here are MN-major. Each of
//   the 8 warps owns a 64 x 32 tile, so a split A fragment feeds 4 n-tiles
//   and a split B fragment 4 m-tiles; fragments are read by scalar loads
//   from tiles padded so that a warp's loads hit 32 distinct banks. Each
//   stage sums in fresh registers that join the running sum by an f32 add
//   (f32_stage_product): the tensor core's own accumulation drifts with K.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

namespace at = attn_tile;
using bf16 = __nv_bfloat16;

constexpr int kGroupM = 8;  // K4a: row tiles of a band

// bf16 on wgmma: 128-row block tiles (a warpgroup per 64 rows), 64
// reductions a stage; the columns and the ring's depth per kernel
constexpr int kBf16TileM = 128, kBf16Depth = 64;
constexpr int kBf16FwdN = 256, kBf16FwdStages = 4;
constexpr int kBf16DrhsN = 256, kBf16DrhsStages = 4;
constexpr int kBf16Threads = kBf16TileM / 64 * 128;
// f32 on mma.sync (3xTF32): 128 x 128 block tiles of 2 x 4 warps, 32
// reductions a stage
constexpr int kF32TileM = 128, kF32TileN = 128, kF32Depth = 32;
constexpr int kF32Stages = 3, kF32MinBlocks = 1;
constexpr int kF32Threads = 256;

template <typename T>
constexpr int kThreadsOf =
    std::is_same<T, float>::value ? kF32Threads : kBf16Threads;

// ----------------------------------------------------------- operands

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
  __device__ __forceinline__ const T* at(int r, int o) const {
    return base + static_cast<long long>(r) * sr +
           static_cast<long long>(o) * so;
  }
};

// Shared-memory layouts of an R x O tile (r along the reduction, o along
// the output): the byte offset of element (r, o).
//
// bf16, wgmma's canonical layouts. K-major: one row per output index
// holding the tile's R reductions, under the swizzle of the row's width
// (R = 64: 128-byte rows, the 16-byte chunk c of row o at c ^ (o % 8), in
// 1024-byte atoms of 8 rows; R = 32: 64-byte rows, chunk c at
// c ^ ((o / 2) % 4), in 512-byte atoms). MN-major: one row per reduction
// index holding 64 outputs under the 128-byte swizzle (chunk c of row r at
// c ^ (r % 8)), the tile's outputs in atoms of 64 columns, each R rows deep.
template <int R, int O>
struct SwKM {
  static_assert(R == 64 || R == 32, "128- or 64-byte swizzle rows");
  static constexpr int kRow = R * 2;  // bytes of a row
  static constexpr int kBytes = O * kRow;
  __device__ __forceinline__ static int off(int r, int o) {
    const int sw = R == 64 ? o & 7 : (o >> 1) & 3;
    return o * kRow + (((r >> 3) ^ sw) << 4) + (r & 7) * 2;
  }
  // wgmma's view of outputs [o0, ...) x reductions [16 k, 16 k + 16)
  __device__ __forceinline__ static uint64_t desc(const char* s, int o0,
                                                  int k);
};
template <int R, int O>
struct SwMN {
  static_assert(O % 64 == 0, "MN-major tiles are whole 64-column atoms");
  static constexpr int kAtom = R * 128;  // bytes of one 64-column atom
  static constexpr int kBytes = R * O * 2;
  __device__ __forceinline__ static int off(int r, int o) {
    return (o >> 6) * kAtom + r * 128 + ((((o >> 3) ^ r) & 7) << 4) +
           (o & 7) * 2;
  }
  __device__ __forceinline__ static uint64_t desc(const char* s, int o0,
                                                  int k);
};
// f32, rows padded so that the fragment loads of a warp hit 32 banks:
// K-major rows of R + 4 floats (4 mod 32), MN-major rows of O + 8 (8 mod 32)
template <int R, int O>
struct PadKM {
  static constexpr int kLd = R + 4;
  static constexpr int kBytes = O * kLd * 4;
  __device__ __forceinline__ static int off(int r, int o) {
    return (o * kLd + r) * 4;
  }
};
template <int R, int O>
struct PadMN {
  static constexpr int kLd = O + 8;
  static constexpr int kBytes = R * kLd * 4;
  __device__ __forceinline__ static int off(int r, int o) {
    return (r * kLd + o) * 4;
  }
};

// Copy reduction rows [r0, r0 + R) x outputs [o0, o0 + O) of op into the
// tile at s (layout L), zero where op reads as zero. KM: op's reduction is
// the contiguous dim, else its output is. VEC: 16-byte cp.async of whole
// chunks (the wrapper allows it only when the contiguous dim has unit
// stride, its extent and every other stride are multiples of a chunk and
// the base is 16-byte aligned, so that a chunk lies all inside or all
// outside the range); else element copies (f32 by 4-byte cp.async, bf16 by
// plain loads and stores).
template <typename T, bool KM, bool VEC, int R, int O, class L>
__device__ __forceinline__ void load_tile(char* s, const Operand<T>& op,
                                          int r0, int o0) {
  constexpr int C = 16 / sizeof(T), NT = kThreadsOf<T>;
  if constexpr (VEC) {
    // the tile as lines along the contiguous dim (outputs if KM, else
    // reductions), kRun chunks a line; the block takes kLines lines a pass
    constexpr int kRun = (KM ? R : O) / C;
    constexpr int kLines = NT / kRun, kAll = KM ? O : R;
    constexpr int kPasses = (kAll + kLines - 1) / kLines;
    static_assert(NT % kRun == 0, "whole lines a pass");
    const int line0 = threadIdx.x / kRun, cc = (threadIdx.x % kRun) * C;
    const long long ls = KM ? op.so : op.sr;  // the line stride
    const int l0 = (KM ? o0 : r0) + line0, c0 = (KM ? r0 : o0) + cc;
    const int l_lo = KM ? op.o_lo : op.r_lo, l_hi = KM ? op.o_hi : op.r_hi;
    const bool c_ok = KM ? (c0 >= op.r_lo && c0 < op.r_hi)
                         : (c0 >= op.o_lo && c0 < op.o_hi);
    const T* p = op.base + static_cast<long long>(l0) * ls + c0;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int line = line0 + i * kLines;
      if (kAll % kLines != 0 && line >= kAll) break;
      const int l = l0 + i * kLines;
      const bool ok = c_ok && l >= l_lo && l < l_hi;
      at::cp_async16(s + (KM ? L::off(cc, line) : L::off(line, cc)),
                     ok ? p + static_cast<long long>(i) * kLines * ls
                        : op.base,
                     ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * O; e += NT) {
      const int r = KM ? e % R : e / O;
      const int o = KM ? e / R : e % O;
      const bool ok = op.in(r0 + r, o0 + o);
      if constexpr (std::is_same<T, float>::value) {
        at::cp_async4(s + L::off(r, o), ok ? op.at(r0 + r, o0 + o) : op.base,
                      ok);
      } else {
        *reinterpret_cast<uint16_t*>(s + L::off(r, o)) =
            ok ? *reinterpret_cast<const uint16_t*>(op.at(r0 + r, o0 + o))
               : uint16_t{0};
      }
    }
  }
}

// 1024-byte aligned start of the dynamic shared memory (the swizzle atoms'
// alignment; the launch adds the slack)
__device__ __forceinline__ char* aligned_smem(char* raw) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(raw));
  return raw + ((1024u - (a & 1023u)) & 1023u);
}

template <int A, int B>
__device__ __forceinline__ void zero(float (&x)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) x[i][j] = 0.f;
}
template <int A, int B, int C>
__device__ __forceinline__ void zero(float (&x)[A][B][C]) {
#pragma unroll
  for (int i = 0; i < A; ++i) zero(x[i]);
}

// ------------------------------------------------------------ wgmma (bf16)

// A shared-memory matrix descriptor: the start address and the leading /
// stride byte offsets, each in 16-byte units, and the swizzle (1: 128-byte,
// 2: 64-byte). K-major tiles: the stride offset steps 8 rows (one atom),
// the leading one is unused. MN-major: the leading offset steps one
// 64-column atom along the outputs, the stride offset 8 reduction rows.
__device__ __forceinline__ uint64_t gmma_desc(const char* p, int lbo,
                                              int sbo, int swizzle) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3ffffu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

template <int R, int O>
__device__ __forceinline__ uint64_t SwKM<R, O>::desc(const char* s, int o0,
                                                     int k) {
  return gmma_desc(s + o0 * kRow + k * 32, 16, 8 * kRow, R == 64 ? 1 : 2);
}
template <int R, int O>
__device__ __forceinline__ uint64_t SwMN<R, O>::desc(const char* s, int o0,
                                                     int k) {
  return gmma_desc(s + (o0 >> 6) * kAtom + k * 16 * 128, kAtom, 1024, 1);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// writes through the generic proxy (cp.async, st.shared) made visible to
// wgmma's reads through the async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across the
// asynchronous products
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] += A (64 x 16, descriptor da) . B (16 x 128, descriptor db);
// kTransA / kTransB: the operand is MN-major. d's layout is mma.sync's C
// fragment repeated over 16 n-tiles of 8: warp w of the warpgroup holds
// rows 16 w + g and 16 w + g + 8 (g = lane / 4), d[4 q + e] at column
// 8 q + 2 (lane % 4) + (e & 1), the second row for e >= 2.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// One pass of a bf16 block over reductions [r_begin, r_end): acc (the
// warpgroup's 64 rows x BN columns) += a(r, oa0 + rows) . b(r, ob0 + cols).
// AKM / BKM: a / b K-major. A ring of S stages with S - 2 tiles loading
// ahead of the one multiplied, so that one k-tile's products stay in
// flight while the next tile's loads are issued. Every thread of the block
// calls it with the same arguments.
template <int BN, int S, bool AKM, bool BKM, bool VEC>
__device__ __forceinline__ void bf16_pass(float (&acc)[BN / 128][64],
                                          const Operand<bf16>& a,
                                          const Operand<bf16>& b,
                                          int r_begin, int r_end, int oa0,
                                          int ob0, char* smem) {
  constexpr int R = kBf16Depth;
  using LA = std::conditional_t<AKM, SwKM<R, kBf16TileM>,
                                SwMN<R, kBf16TileM>>;
  using LB = std::conditional_t<BKM, SwKM<R, BN>, SwMN<R, BN>>;
  constexpr int kStage = LA::kBytes + LB::kBytes;
  static_assert(S >= 3, "one stage multiplied, one in flight, one loading");
  const int steps = (r_end - r_begin + R - 1) / R;
  if (steps <= 0) return;
  __syncthreads();  // the previous pass's products are done with the ring
  auto load = [&](int s) {
    if (s < steps) {
      char* st = smem + (s % S) * kStage;
      load_tile<bf16, AKM, VEC, R, kBf16TileM, LA>(st, a, r_begin + s * R,
                                                   oa0);
      load_tile<bf16, BKM, VEC, R, BN, LB>(st + LA::kBytes, b,
                                           r_begin + s * R, ob0);
    }
    at::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < S - 2; ++s) load(s);
  const int wg = threadIdx.x / 128;
  for (int s = 0; s < steps; ++s) {
    at::cp_async_wait<S - 3>();
    fence_async_shared();
    // tile s is in every thread's view, and the products of tile s - 2
    // are done in both warpgroups: its stage may be refilled
    __syncthreads();
    load(s + S - 2);
    const char* sa = smem + (s % S) * kStage;
    const char* sb = sa + LA::kBytes;
#pragma unroll
    for (int j = 0; j < BN / 128; ++j) acc_fence(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < R / 16; ++k) {
      const uint64_t da = LA::desc(sa, wg * 64, k);
#pragma unroll
      for (int j = 0; j < BN / 128; ++j)
        wgmma_m64n128k16<AKM ? 0 : 1, BKM ? 0 : 1>(
            acc[j], da, LB::desc(sb, j * 128, k));
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < BN / 128; ++j) acc_fence(acc[j]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < BN / 128; ++j) acc_fence(acc[j]);
}

template <int BN, int S>
constexpr int bf16_smem() {
  return S * (kBf16TileM * kBf16Depth + kBf16Depth * BN) * 2 + 1024;
}

// ------------------------------------------------------ mma.sync (f32)

// acc (the warp's 64 x 32 tile: m-tiles i, n-tiles j) += the stage's
// product over kF32Depth reductions, each a 3xTF32 product (lo.hi + hi.lo
// + hi.hi, the small terms first) of split fragments read from the padded
// tiles sa (layout LA) and sb (LB). The tensor core's f32 accumulation does
// not round to nearest, and its error over thousands of accumulations grows
// with K (3.2e-5 of max|out| at K = 4096 on this card, past GMM_TOL): the
// stage sums into part, from zero, and part joins acc by an f32 add.
template <bool AKM, bool BKM, class LA, class LB>
__device__ __forceinline__ void f32_stage_product(float (&acc)[4][4][4],
                                                  const float* sa,
                                                  const float* sb, int wm,
                                                  int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[4][4][4];
  zero(part);
  auto ael = [&](int r, int o) {
    return AKM ? sa[o * LA::kLd + r] : sa[r * LA::kLd + o];
  };
  auto bel = [&](int r, int o) {
    return BKM ? sb[o * LB::kLd + r] : sb[r * LB::kLd + o];
  };
#pragma unroll
  for (int kk = 0; kk < kF32Depth; kk += 8) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 32 * wn + 8 * j + g;
      at::split_tf32_trunc(bel(kk + t, n), bh[j][0], bl[j][0]);
      at::split_tf32_trunc(bel(kk + t + 4, n), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 64 * wm + 16 * i + g;
      uint32_t ah[4], al[4];
      at::split_tf32_trunc(ael(kk + t, m), ah[0], al[0]);
      at::split_tf32_trunc(ael(kk + t, m + 8), ah[1], al[1]);
      at::split_tf32_trunc(ael(kk + t + 4, m), ah[2], al[2]);
      at::split_tf32_trunc(ael(kk + t + 4, m + 8), ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        at::mma_tf32(part[i][j], al, bh[j][0], bh[j][1]);
        at::mma_tf32(part[i][j], ah, bl[j][0], bl[j][1]);
        at::mma_tf32(part[i][j], ah, bh[j][0], bh[j][1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// One pass of an f32 block over reductions [r_begin, r_end), as bf16_pass
// (same arguments); a ring of kF32Stages stages, S - 1 tiles loading ahead.
template <bool AKM, bool BKM, bool VEC>
__device__ __forceinline__ void f32_pass(float (&acc)[4][4][4],
                                         const Operand<float>& a,
                                         const Operand<float>& b,
                                         int r_begin, int r_end, int oa0,
                                         int ob0, char* smem) {
  constexpr int R = kF32Depth, S = kF32Stages;
  using LA = std::conditional_t<AKM, PadKM<R, kF32TileM>,
                                PadMN<R, kF32TileM>>;
  using LB = std::conditional_t<BKM, PadKM<R, kF32TileN>,
                                PadMN<R, kF32TileN>>;
  constexpr int kStage = LA::kBytes + LB::kBytes;
  const int steps = (r_end - r_begin + R - 1) / R;
  if (steps <= 0) return;
  __syncthreads();  // the previous pass is done with the ring
  auto load = [&](int s) {
    if (s < steps) {
      char* st = smem + (s % S) * kStage;
      load_tile<float, AKM, VEC, R, kF32TileM, LA>(st, a, r_begin + s * R,
                                                   oa0);
      load_tile<float, BKM, VEC, R, kF32TileN, LB>(st + LA::kBytes, b,
                                                   r_begin + s * R, ob0);
    }
    at::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) load(s);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int s = 0; s < steps; ++s) {
    at::cp_async_wait<S - 2>();
    __syncthreads();  // tile s is in view; tile s - 1's stage is free
    load(s + S - 1);
    const char* st = smem + (s % S) * kStage;
    f32_stage_product<AKM, BKM, LA, LB>(
        acc, reinterpret_cast<const float*>(st),
        reinterpret_cast<const float*>(st + LA::kBytes), warp / 4, warp % 4,
        lane);
  }
  at::cp_async_wait<0>();
}

constexpr int f32_smem() {
  // the larger layout of either orientation, for each operand (+ the
  // alignment slack of aligned_smem)
  return 1024 + kF32Stages *
         ((kF32TileM * (kF32Depth + 4) > kF32Depth * (kF32TileM + 8)
               ? kF32TileM * (kF32Depth + 4)
               : kF32Depth * (kF32TileM + 8)) +
          (kF32TileN * (kF32Depth + 4) > kF32Depth * (kF32TileN + 8)
               ? kF32TileN * (kF32Depth + 4)
               : kF32Depth * (kF32TileN + 8))) *
         4;
}

// ------------------------------------------------------------ epilogue

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16(x);
  }
}

// out[row, col], out[row, col + 1] (row stride ld) where they exist; VEC:
// ld and col are even and col_end a multiple of 8, so the pair is one store
template <typename T, bool VEC>
__device__ __forceinline__ void store2(T* out, long long ld, int row,
                                       int col, int row_end, int col_end,
                                       float v0, float v1) {
  if (row >= row_end || col >= col_end) return;
  T* p = out + static_cast<long long>(row) * ld + col;
  if (VEC) {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    }
  } else {
    p[0] = from_float<T>(v0);
    if (col + 1 < col_end) p[1] = from_float<T>(v1);
  }
}

// the block's tile from wgmma fragments (two warpgroups of 64 rows) to out
template <int BN, typename T, bool VEC>
__device__ __forceinline__ void write_wg_tile(
    T* out, long long ld, int row0, int row_end, int col0, int col_end,
    const float (&acc)[BN / 128][64]) {
  const int lane = threadIdx.x % 32;
  const int row = row0 + 64 * (threadIdx.x / 128) +
                  16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 128; ++j)
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int col = col0 + 128 * j + 8 * q + 2 * (lane % 4);
      store2<T, VEC>(out, ld, row, col, row_end, col_end, acc[j][4 * q],
                     acc[j][4 * q + 1]);
      store2<T, VEC>(out, ld, row + 8, col, row_end, col_end,
                     acc[j][4 * q + 2], acc[j][4 * q + 3]);
    }
}

// the block's tile from mma.sync fragments (2 x 4 warps of 64 x 32) to out
template <typename T, bool VEC>
__device__ __forceinline__ void write_warp_tile(T* out, long long ld,
                                               int row0, int row_end,
                                               int col0, int col_end,
                                               const float (&acc)[4][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 64 * (warp / 4) + 16 * i + lane / 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 32 * (warp % 4) + 8 * j + 2 * (lane % 4);
      store2<T, VEC>(out, ld, row, col, row_end, col_end, acc[i][j][0],
                     acc[i][j][1]);
      store2<T, VEC>(out, ld, row + 8, col, row_end, col_end, acc[i][j][2],
                     acc[i][j][3]);
    }
  }
}

// ---------------------------------------------------------------- K4a

// block bid's (row tile, column tile): bands of kGroupM row tiles, each
// walked down its rows for one column tile before the next
__device__ __forceinline__ void raster(int bid, int mt, int nt, int& mi,
                                       int& ni) {
  const int per_band = kGroupM * nt;
  const int band = bid / per_band;
  const int first = band * kGroupM;
  const int rows = min(mt - first, kGroupM);
  const int i = bid - band * per_band;
  mi = first + i % rows;
  ni = i / rows;
}

// the first group whose rows end past m0
__device__ __forceinline__ int first_group(const int* offs, int G, int m0) {
  int lo = 0, hi = G;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(offs + mid + 1) > m0) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

struct FwdArgs {
  const void *lhs, *rhs;
  const int* offs;
  void* out;
  long long lhs_sm, lhs_sk, rhs_sg, rhs_sk, rhs_sn;
  int M, K, N, G;
};

// BKM: rhs is read along k (the rhs^T view of dlhs), else along n
template <typename T, bool BKM, bool VEC>
__global__ void __launch_bounds__(
    kThreadsOf<T>, std::is_same<T, float>::value ? kF32MinBlocks : 1)
    gmm_fwd_kernel(const FwdArgs p) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int BM = kBf16 ? kBf16TileM : kF32TileM;
  constexpr int BN = kBf16 ? kBf16FwdN : kF32TileN;
  extern __shared__ char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  int mi, ni;
  raster(blockIdx.x, (p.M + BM - 1) / BM, (p.N + BN - 1) / BN, mi, ni);
  const int m0 = mi * BM, n0 = ni * BN;
  const int m_end = min(m0 + BM, p.M);
  const T* lhs = static_cast<const T*>(p.lhs);
  const T* rhs = static_cast<const T*>(p.rhs);
  T* out = static_cast<T*>(p.out);
  std::conditional_t<kBf16, float[BN / 128][64], float[4][4][4]> acc;
  zero(acc);
  for (int g = first_group(p.offs, p.G, m0); g < p.G; ++g) {
    const int gs = __ldg(p.offs + g), ge = __ldg(p.offs + g + 1);
    if (gs >= m_end) break;
    const int rs = max(gs, m0), re = min(ge, m_end);
    if (rs >= re) continue;  // empty group
    // a(k, m) = lhs[m, k] for the group's rows; b(k, n) = rhs[g, k, n]
    const Operand<T> a{lhs, p.lhs_sk, p.lhs_sm, 0, p.K, rs, re};
    const Operand<T> b{rhs + static_cast<long long>(g) * p.rhs_sg, p.rhs_sk,
                       p.rhs_sn, 0, p.K, 0, p.N};
    if constexpr (kBf16) {
      bf16_pass<BN, kBf16FwdStages, true, BKM, VEC>(acc, a, b, 0, p.K, m0,
                                                    n0, smem);
    } else {
      f32_pass<true, BKM, VEC>(acc, a, b, 0, p.K, m0, n0, smem);
    }
  }
  // rows of no group (the padding tail) keep acc = 0
  if constexpr (kBf16) {
    write_wg_tile<BN, T, VEC>(out, p.N, m0, m_end, n0, p.N, acc);
  } else {
    write_warp_tile<T, VEC>(out, p.N, m0, m_end, n0, p.N, acc);
  }
}

// ---------------------------------------------------------------- K4b

struct DrhsArgs {
  const void *lhs, *dout;
  const int* offs;
  float* drhs;
  long long lhs_sm, lhs_sk, dout_sm, dout_sn;
  int M, K, N;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(
    kThreadsOf<T>, std::is_same<T, float>::value ? kF32MinBlocks : 1)
    gmm_drhs_kernel(const DrhsArgs p) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int BM = kBf16 ? kBf16TileM : kF32TileM;
  constexpr int BN = kBf16 ? kBf16DrhsN : kF32TileN;
  extern __shared__ char smem_raw[];
  char* smem = aligned_smem(smem_raw);
  const int g = blockIdx.z;
  const int k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rs = min(__ldg(p.offs + g), p.M);
  const int re = min(__ldg(p.offs + g + 1), p.M);
  std::conditional_t<kBf16, float[BN / 128][64], float[4][4][4]> acc;
  zero(acc);
  // a(r, k) = lhs[r, k], b(r, n) = dout[r, n] over the group's rows r
  const Operand<T> a{static_cast<const T*>(p.lhs), p.lhs_sm, p.lhs_sk, rs, re,
                     0, p.K};
  const Operand<T> b{static_cast<const T*>(p.dout), p.dout_sm, p.dout_sn, rs,
                     re, 0, p.N};
  float* out = p.drhs + static_cast<long long>(g) * p.K * p.N;
  if constexpr (kBf16) {
    bf16_pass<BN, kBf16DrhsStages, false, false, VEC>(acc, a, b, rs, re, k0,
                                                      n0, smem);
    write_wg_tile<BN, float, VEC>(out, p.N, k0, p.K, n0, p.N, acc);
  } else {
    f32_pass<false, false, VEC>(acc, a, b, rs, re, k0, n0, smem);
    // an empty group writes its zeros
    write_warp_tile<float, VEC>(out, p.N, k0, p.K, n0, p.N, acc);
  }
}

template <typename Kernel, typename A>
int launch(Kernel* kernel, dim3 grid, int nt, int smem,
           cudaStream_t stream, const A& args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, nt, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const FwdArgs& a, int rhs_k_contig, int vec,
               cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int BM = kBf16 ? kBf16TileM : kF32TileM;
  constexpr int BN = kBf16 ? kBf16FwdN : kF32TileN;
  constexpr int smem =
      kBf16 ? bf16_smem<kBf16FwdN, kBf16FwdStages>() : f32_smem();
  const long long blocks = static_cast<long long>((a.M + BM - 1) / BM) *
                           ((a.N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  constexpr int NT = kThreadsOf<T>;
  if (rhs_k_contig) {
    return vec ? launch(gmm_fwd_kernel<T, true, true>, grid, NT, smem,
                        stream, a)
               : launch(gmm_fwd_kernel<T, true, false>, grid, NT, smem,
                        stream, a);
  }
  return vec ? launch(gmm_fwd_kernel<T, false, true>, grid, NT, smem, stream,
                      a)
             : launch(gmm_fwd_kernel<T, false, false>, grid, NT, smem,
                      stream, a);
}

template <typename T>
int launch_drhs(const DrhsArgs& a, int G, int vec, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int BM = kBf16 ? kBf16TileM : kF32TileM;
  constexpr int BN = kBf16 ? kBf16DrhsN : kF32TileN;
  constexpr int smem =
      kBf16 ? bf16_smem<kBf16DrhsN, kBf16DrhsStages>() : f32_smem();
  const dim3 grid((a.N + BN - 1) / BN, (a.K + BM - 1) / BM, G);
  constexpr int NT = kThreadsOf<T>;
  return vec ? launch(gmm_drhs_kernel<T, true>, grid, NT, smem, stream, a)
             : launch(gmm_drhs_kernel<T, false>, grid, NT, smem, stream, a);
}

}  // namespace

// out [M, N] (lhs's dtype, contiguous) = grouped lhs [M, K] @ rhs [G, K, N].
// strides: lhs (m, k), rhs (g, k, n), in elements. dtype 0 = f32, 1 = bf16.
// rhs_k_contig: rhs is read along k (a transposed view); vec: every operand
// moves in 16-byte chunks (see load_tile). The caller guarantees M, N >= 1.
extern "C" int paddle_grouped_matmul_fwd(const void* lhs, const void* rhs,
                                         const int* offs, void* out,
                                         const long long* strides, int M,
                                         int K, int N, int G, int dtype,
                                         int rhs_k_contig, int vec,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{lhs,        rhs,        offs,       out, strides[0],
                  strides[1], strides[2], strides[3], strides[4], M,
                  K,          N,          G};
  if (dtype == 0) return launch_fwd<float>(a, rhs_k_contig, vec, s);
  return launch_fwd<bf16>(a, rhs_k_contig, vec, s);
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
  const DrhsArgs a{lhs,        dout,       offs,
                   static_cast<float*>(drhs),
                   strides[0], strides[1], strides[2], strides[3],
                   M,          K,          N};
  if (dtype == 0) return launch_drhs<float>(a, G, vec, s);
  return launch_drhs<bf16>(a, G, vec, s);
}
