// Warpgroup products on the tensor cores in TF32, made float32-accurate by
// the 3xTF32 split, for the flip and exchange suffix passes: K3/K4/B6
// (csrc/tfim_flip.cu), B10/B11 (csrc/j1j2_exchange.cu) and B15/B16
// (csrc/mdrnn_flip.cu).  The first H100 design of K3 and B10/B11 (past
// pad8(U) = 56) and B15/B16 take W_h^T as A and the states as B, below;
// the turned-around passes the states as A from registers and W_h as B
// (wgmma_tf32_rs, rs_issue, at the end).
//
// Each operand x = hi + lo, with hi = x with its low 13 mantissa bits
// cleared and lo = (x - hi) cleared the same way (B10/B11: hi rounded to
// nearest, split_tf32_nearest); a k-step of 8 takes
// lo.hi, then hi.lo, then hi.hi into float32 accumulators.  A (64 rows per
// tile, the weights) comes from registers in the m16n8k8 A-fragment order
// of each warp's 16 rows, loaded per k-step from a fragment table in
// [k-step][tile][warp][lane][4] order and split there; B (8 rows of K per
// k-step, N columns) from shared memory in wgmma's core-matrix layout
// without swizzle, in two parts: the value itself, whose TF32 part the
// tensor cores read, and its remainder lo.  The accumulators of tile m sit
// in d[m]: d[m][4 cb + 2 rh + v] is row 16 warp + g + 8 rh, column
// 8 cb + 2 t + v, for lane = 4 g + t.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rnnwf {

constexpr int kGateRows = 64;  // rows per wgmma tile (its M)

__host__ __device__ inline int pad8(int u) { return (u + 7) & ~7; }
__host__ __device__ inline int pad64(int u) {
  return (u + kGateRows - 1) / kGateRows * kGateRows;
}

// x = hi + lo, each a TF32 value (the low 13 of float32's 23 mantissa bits
// cleared): hi is x cut to TF32, lo the rest cut the same way.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// x rounded to TF32 to nearest (ties away from zero), as a float.
__device__ __forceinline__ float round_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo to nearest: hi is x rounded to TF32, lo the exact remainder
// x - hi, whose TF32 part (its low 13 bits ignored) the tensor cores read.
// split_tf32's two cuts both round towards zero, so every operand, and every
// product, comes out a little short of its value, by ~2^-21 on average: a
// bias that sums over the sites of a long suffix (~4e-5 of the J1-J2 local
// energy at 1000 sites).  Here lo takes either sign, so its cut and the
// dropped lo.lo are unbiased.
__device__ __forceinline__ void split_tf32_nearest(float x, uint32_t& hi, uint32_t& lo) {
  const float h = round_tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// The remainder lo of split_tf32, as a float.
__device__ __forceinline__ float tf32_lo(float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  return __uint_as_float(lo);
}

// Shared-memory matrix descriptor of wgmma for a K-major operand without
// swizzle: start address, the byte step between 8 x 16-byte core matrices
// along K (lbo) and along the 8-row groups (sbo).
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// Offset of (column n, row k) of a B operand of K extent kp: 8 x 4 core
// matrices, contiguous along k (lbo = 128 bytes), groups of 8 columns
// kp * 8 floats apart (sbo = kp * 32 bytes).
__device__ __forceinline__ int state_at(int n, int k, int kp) {
  return (n >> 3) * (kp * 8) + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// d += a . b for the warpgroup's 64 x N tile: a (64 x 8, TF32) in
// registers, the m16n8k8 A fragment of each warp's 16 rows; b (8 x N) in
// shared memory; d as the m16n8 accumulators of each warp's rows for the
// N / 8 column blocks.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t b) {
  static_assert(N == 32, "wgmma_tf32 takes N = 32");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Keeps the compiler from moving an access to r across an asynchronous
// wgmma that reads or writes it.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// The A fragments of k-step ks for the MT tiles, one 16-byte load per tile
// from the fragment table, split in registers (kNearest: split_tf32_nearest,
// for a B operand stored as its rounded part and exact remainder).
template <int MT, bool kNearest = false>
__device__ __forceinline__ void load_a(const float* wfrag, int ks, int warp, int lane,
                                       uint32_t (&hi)[MT][4], uint32_t (&lo)[MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float4 a =
        reinterpret_cast<const float4*>(wfrag)[((ks * MT + m) * 4 + warp) * 32 + lane];
    const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kNearest) {
        split_tf32_nearest(v[i], hi[m][i], lo[m][i]);
      } else {
        split_tf32(v[i], hi[m][i], lo[m][i]);
      }
    }
  }
}

// One k-step's three products for the MT tiles as one wgmma group: lo.hi,
// then hi.lo, then hi.hi.  b_hi / b_lo: the two parts of B, sbo the byte
// step between its 8-column groups.
template <int MT, int N>
__device__ __forceinline__ void issue_k_step(float (&d)[MT][N / 2], const uint32_t (&hi)[MT][4],
                                             const uint32_t (&lo)[MT][4], const float* b_hi,
                                             const float* b_lo, uint32_t sbo, int ks) {
  const uint64_t dhi = smem_desc(b_hi + ks * 64, 128, sbo);
  const uint64_t dlo = smem_desc(b_lo + ks * 64, 128, sbo);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int m = 0; m < MT; ++m) wgmma_tf32<N>(d[m], lo[m], dhi);
#pragma unroll
  for (int m = 0; m < MT; ++m) wgmma_tf32<N>(d[m], hi[m], dlo);
#pragma unroll
  for (int m = 0; m < MT; ++m) wgmma_tf32<N>(d[m], hi[m], dhi);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most kPending wgmma groups are pending; the fragments of
// the groups that finished stay live up to here.
template <int kPending, int MT>
__device__ __forceinline__ void wait_groups(uint32_t (&hi)[MT][4], uint32_t (&lo)[MT][4]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) { pin(hi[m][i]); pin(lo[m][i]); }
}

template <int MT, int N>
__device__ __forceinline__ void pin_all(float (&d)[MT][N / 2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) pin(d[m][i]);
}

// d += A . B over the k-steps [ks0, ks1) (at least one), whole warpgroup,
// the A fragments loaded from the table per k-step: k-steps in pairs with
// two fragment sets, so that the loads of one k-step overlap the previous
// k-step's products.  after_issue() runs once, while the first k-step's
// products are in flight.  Returns with every product done and d readable.
template <int MT, int N, bool kNearest = false, typename AfterIssue>
__device__ __forceinline__ void product_k_steps(float (&d)[MT][N / 2], const float* wfrag,
                                                const float* b_hi, const float* b_lo,
                                                uint32_t sbo, int ks0, int ks1, int warp,
                                                int lane, AfterIssue&& after_issue) {
  uint32_t hi0[MT][4], lo0[MT][4], hi1[MT][4] = {}, lo1[MT][4] = {};
  load_a<MT, kNearest>(wfrag, ks0, warp, lane, hi0, lo0);
  for (int ks = ks0; ks < ks1; ks += 2) {
    issue_k_step<MT, N>(d, hi0, lo0, b_hi, b_lo, sbo, ks);
    if (ks == ks0) after_issue();
    if (ks + 1 < ks1) {
      wait_groups<1, MT>(hi1, lo1);
      load_a<MT, kNearest>(wfrag, ks + 1, warp, lane, hi1, lo1);
      issue_k_step<MT, N>(d, hi1, lo1, b_hi, b_lo, sbo, ks + 1);
    }
    if (ks + 2 < ks1) {
      wait_groups<1, MT>(hi0, lo0);
      load_a<MT, kNearest>(wfrag, ks + 2, warp, lane, hi0, lo0);
    }
  }
  wait_groups<0, MT>(hi0, lo0);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) { pin(hi1[m][i]); pin(lo1[m][i]); }
  pin_all<MT, N>(d);
}

// The A fragments of k-steps 0..KA-1 from the table, split, to be held in
// registers for a whole kernel (those past ks_n zero).
template <int KA, int MT>
__device__ __forceinline__ void load_a_all(const float* wfrag, int ks_n, int warp, int lane,
                                           uint32_t (&hi)[KA][MT][4], uint32_t (&lo)[KA][MT][4]) {
#pragma unroll
  for (int ks = 0; ks < KA; ++ks) {
    if (ks < ks_n) {
      load_a<MT>(wfrag, ks, warp, lane, hi[ks], lo[ks]);
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) { hi[ks][m][i] = 0u; lo[ks][m][i] = 0u; }
    }
  }
}

// d += A . B over the k-steps [ks0, ks1) (at least one, ks1 <= KA), whole
// warpgroup, from A fragments held in registers: every k-step issued back
// to back as one wgmma group (the accumulator chain needs no fence between
// them), then one wait.  after_issue() runs while the products are in
// flight.  Returns with every product done and d readable.
template <int KA, int MT, int N, typename AfterIssue>
__device__ __forceinline__ void product_held_a(float (&d)[MT][N / 2],
                                               const uint32_t (&hi)[KA][MT][4],
                                               const uint32_t (&lo)[KA][MT][4],
                                               const float* b_hi, const float* b_lo,
                                               uint32_t sbo, int ks0, int ks1,
                                               AfterIssue&& after_issue) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < KA; ++ks) {
    if (ks >= ks0 && ks < ks1) {
      const uint64_t dhi = smem_desc(b_hi + ks * 64, 128, sbo);
      const uint64_t dlo = smem_desc(b_lo + ks * 64, 128, sbo);
#pragma unroll
      for (int m = 0; m < MT; ++m) wgmma_tf32<N>(d[m], lo[ks][m], dhi);
#pragma unroll
      for (int m = 0; m < MT; ++m) wgmma_tf32<N>(d[m], hi[ks][m], dlo);
#pragma unroll
      for (int m = 0; m < MT; ++m) wgmma_tf32<N>(d[m], hi[ks][m], dhi);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  after_issue();
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  pin_all<MT, N>(d);
}

// ---- The turned-around product of K3/K4/B6's suffix pass (csrc/tfim_flip.cu):
// d += a . b for the warpgroup's 64 x N tile, N = 24 KS (KS = 1..7): a
// (64 x 8, TF32) the m16n8k8 A fragment of each warp's 16 rows, in
// registers; b (8 x N) in shared memory; d[4 cb + 2 rh + v] as above.
#define RNNWF_ACC4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define RNNWF_ACC12(i) RNNWF_ACC4(i), RNNWF_ACC4((i) + 4), RNNWF_ACC4((i) + 8)

template <int KS>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[12 * KS], const uint32_t (&a)[4],
                                              uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<1>(float (&d)[12], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
               "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
               : RNNWF_ACC12(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<2>(float (&d)[24], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23"
               "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
               : RNNWF_ACC12(0), RNNWF_ACC12(12)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<3>(float (&d)[36], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35"
               "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
               : RNNWF_ACC12(0), RNNWF_ACC12(12), RNNWF_ACC12(24)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<4>(float (&d)[48], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
               "%47"
               "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
               : RNNWF_ACC12(0), RNNWF_ACC12(12), RNNWF_ACC12(24), RNNWF_ACC12(36)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<5>(float (&d)[60], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
               "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
               "}, {%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
               : RNNWF_ACC12(0), RNNWF_ACC12(12), RNNWF_ACC12(24), RNNWF_ACC12(36),
                 RNNWF_ACC12(48)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<6>(float (&d)[72], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
               "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
               "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
               "}, {%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
               : RNNWF_ACC12(0), RNNWF_ACC12(12), RNNWF_ACC12(24), RNNWF_ACC12(36),
                 RNNWF_ACC12(48), RNNWF_ACC12(60)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<7>(float (&d)[84], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %89, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n168k8.f32.tf32.tf32 {"
               "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
               "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
               "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
               "%77, %78, %79, %80, %81, %82, %83"
               "}, {%84, %85, %86, %87}, %88, p, 1, 1;\n}\n"
               : RNNWF_ACC12(0), RNNWF_ACC12(12), RNNWF_ACC12(24), RNNWF_ACC12(36),
                 RNNWF_ACC12(48), RNNWF_ACC12(60), RNNWF_ACC12(72)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef RNNWF_ACC12
#undef RNNWF_ACC4

// The turned-around suffix passes (K3/K4/B6's flip_suffix_rs_kernel,
// csrc/tfim_flip.cu; B10/B11's exchange_suffix_rs_kernel,
// csrc/j1j2_exchange.cu): KS = pad8(U) / 8 octets of units, N = 24 KS
// columns, at most kRsSteps (past it the accumulators outgrow the
// registers), kRsGroups warpgroups a persistent block.
constexpr int kRsSteps = 7;
constexpr int kRsGroups = 2;
__host__ __device__ inline int rs_steps(int u) { return pad8(u) / 8; }

// Floats of W_h's table (one part): Kp x 24 KS.
__host__ __device__ constexpr int rs_table_floats(int ks) { return 24 * ks * 8 * ks; }

// The item that slot `slot` of `slots` takes in round `round`: the slots
// walk the items in order, in rounds of the slots, every other round
// reversed, so that the longest suffixes (first) spread over the card.
__device__ __forceinline__ int rs_slot_tile(int round, int slots, int slot) {
  return round * slots + ((round & 1) ? slots - 1 - slot : slot);
}

// A turned-around pass's persistent grid: as many blocks of kRsGroups
// warpgroups as fit on the card with `smem` bytes each (set as the
// kernel's dynamic shared memory), or fewer where `items` would leave
// slots idle.
template <typename Kernel>
inline cudaError_t rs_persistent_grid(Kernel kernel, size_t smem, int64_t items, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  constexpr int threads = kRsGroups * 128;  // a warpgroup is 128 threads
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t full = static_cast<int64_t>(per_sm) * sms;
  const int64_t fill = (items + kRsGroups - 1) / kRsGroups;
  *grid = static_cast<int>(fill < full ? fill : full);
  return cudaSuccess;
}

// W_h as the B operand in two parts (hi, whose TF32 part the tensor cores
// read, and the remainder lo), each Kp x N in the core-matrix layout
// (state_at with N columns); the input gates wx[x] + bx [octet][gate][unit
// of the octet][x]; b_h [octet][gate][unit of the octet]; padding entries
// zero, whole block.  Entry i of a table is (column n, row k) of
// state_at(n, k, Kp): column n is gate (n / 8) % 3 of unit 8 (n / 24) +
// n % 8, row k unit 8 (k / 8) + 2 (k % 4) + (k / 4) % 2, so that a thread's
// A fragment of k-step j holds the units 8 j + 2 t + v whose gates its
// accumulators hold.  kNearest: split_tf32_nearest, else split_tf32.
template <int KS, bool kNearest>
__device__ __forceinline__ void rs_gru_tables(float* whi, float* wlo, float* gxs, float* bhs,
                                              const float* wx, const float* wh, const float* bx,
                                              const float* bh, int u) {
  constexpr int KP = 8 * KS;
  const int g3 = 3 * u;
  for (int i = threadIdx.x; i < rs_table_floats(KS); i += blockDim.x) {
    const int grp = i / (KP * 8), rem = i - grp * (KP * 8);
    const int k = 4 * (rem >> 5) + (rem & 3);
    const int un = 8 * (grp / 3) + ((rem >> 2) & 7);
    const int uk = 8 * (k >> 3) + 2 * (k & 3) + ((k >> 2) & 1);
    const float v = (uk < u && un < u) ? wh[uk * g3 + (grp % 3) * u + un] : 0.0f;
    uint32_t hi, lo;
    if constexpr (kNearest) {
      split_tf32_nearest(v, hi, lo);
    } else {
      split_tf32(v, hi, lo);
    }
    whi[i] = __uint_as_float(hi);
    wlo[i] = __uint_as_float(lo);
  }
  for (int i = threadIdx.x; i < 24 * KS; i += blockDim.x) {
    const int unit = 8 * (i / 24) + i % 8, col = ((i / 8) % 3) * u + unit;
    const bool ok = unit < u;
    bhs[i] = ok ? bh[col] : 0.0f;
    gxs[2 * i] = ok ? wx[col] + bx[col] : 0.0f;
    gxs[2 * i + 1] = ok ? wx[g3 + col] + bx[col] : 0.0f;
  }
}

// One site's products of a turned-around suffix pass, whole warpgroup:
// d += H . W_h over the KS k-steps, each as H_hi . W_lo, H_lo . W_hi,
// H_hi . W_hi, all issued as one wgmma group.  h (whose TF32 part the
// tensor cores read) and lo are the A fragments; the caller waits.
template <int KS>
__device__ __forceinline__ void rs_issue(float (&d)[12 * KS], const float (&h)[KS][4],
                                         const float (&lo)[KS][4], const float* whi,
                                         const float* wlo) {
  constexpr uint32_t sbo = 8 * KS * 32;  // bytes between 8-column groups
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const uint32_t ah[4] = {__float_as_uint(h[j][0]), __float_as_uint(h[j][1]),
                            __float_as_uint(h[j][2]), __float_as_uint(h[j][3])};
    const uint32_t al[4] = {__float_as_uint(lo[j][0]), __float_as_uint(lo[j][1]),
                            __float_as_uint(lo[j][2]), __float_as_uint(lo[j][3])};
    const uint64_t dhi = smem_desc(whi + j * 64, 128, sbo);
    const uint64_t dlo = smem_desc(wlo + j * 64, 128, sbo);
    wgmma_tf32_rs<KS>(d, ah, dlo);
    wgmma_tf32_rs<KS>(d, al, dhi);
    wgmma_tf32_rs<KS>(d, ah, dhi);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

}  // namespace rnnwf
