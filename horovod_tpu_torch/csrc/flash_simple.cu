// Flash attention for what the wgmma kernels (flash_fwd.cu, flash_bwd.cu)
// do not take: fp32 inputs at any head dim up to 256, and bf16 inputs at a
// head dim above 128.  Three kernels, the forward, dQ and dK/dV, all on the
// tensor cores (`mma.sync`, or `wgmma` for bf16) fed by asynchronous copies.
//
// Replaces the same Pallas TPU kernels as the wgmma kernels, at these
// dtypes and widths: `_fwd_kernel` (horovod_tpu/ops/flash_attention.py:85,
// launched at :157), `_bwd_dq_kernel` (:185, launched at :300) and
// `_bwd_dkv_kernel` (:224, launched at :328).  The Pallas kernels take any
// dtype and any head dim up to 256 (`supported`, :512); the JAX package's
// Llama configs train in fp32 (`LlamaConfig.tiny`, head dim 16) and bf16.
//
// fp32 is computed to fp32 accuracy, as PyTorch's own fp32 products on
// the card (`allow_tf32` False) and the JAX package's fp32 math on the CPU
// are.  Hopper's tensor cores take fp32 only as TF32 (10 mantissa bits, 495
// TFLOP/s against 67 TFLOP/s of fp32 FMAs on the CUDA cores), so all three
// kernels multiply in 3xTF32: each operand x is split into hi =
// x rounded to TF32 (to nearest) and lo = x - hi, and a product is lo.hi +
// hi.lo + hi.hi (lo.lo, below 2^-22 of it, is dropped), summed in fp32.
// That is fp32's accuracy at three TF32 products, not TF32's, whatever
// `allow_tf32` says.  bf16 at DP = 256 multiplies bf16 on the tensor cores
// with fp32 sums, the numerics of the wgmma kernels: p and dS rounded to
// bf16 before the products that take them.
//
// What bounds them: operations.  At the Llama-2-7B training shape in fp32
// (B=1, S=4096, H=32, D=128, causal) the forward's two causal S x S x D
// products are 137 GFLOP: 0.83 ms as three TF32 products at 495 TFLOP/s
// (2.05 ms as fp32 FMAs at 67), against 0.08 ms to move q, k, v and o once
// at 3.35 TB/s; dQ's three products 1.25 ms (less the few percent of dP
// it sums in fp32 FMAs, below), dK/dV's four 1.67 ms.  bf16 at D = 256
// (S 2048, H 16, causal) is 0.035 ms (forward), 0.052 (dQ) and 0.070
// (dK/dV) at 989 TFLOP/s.
//
// The design of the fp32 kernels (and of bf16 dK/dV at DP = 256):
// - `mma.sync` (m16n8k8 TF32 for fp32, m16n8k16 bf16), each warp a 16-row
//   slice of the tile.  Not `wgmma`: it takes TF32 only K-major in both
//   operands, so P.V, dS.K, P^T.dO and dS^T.Q would need V^T, K^T, dO^T
//   and Q^T in shared memory twice over (hi and lo), more than 227 KB at
//   DP = 128; and at DP = 256 a 64-row wgmma tile's dK and dV accumulators
//   are 256 registers a thread, past the 255 a thread has.  Where a wgmma
//   accumulator fits, bf16 at DP = 256, the forward and dQ are wgmma
//   kernels (`wg256` and `wgdq`, below, on flash_fwd.cu's and
//   flash_bwd.cu's designs).  The dK/dV kernel splits each 16-key slice
//   between a pair of warps: one computes S^T = K Q^T, P^T and dV += P^T
//   dO, the other dP^T = V dO^T, dS^T and dK += dS^T Q, taking P^T from
//   its partner through shared memory (a named barrier of the pair), so
//   each holds one DP-wide accumulator;
// - dQ is the forward's kernel with one product more and no online
//   softmax (lse and delta are given): Q and dO stay in shared memory, the
//   K and V tiles stream, S = Q K^T and dP = dO V^T are two `mma_nt`, and
//   dS = P (dP - delta) scale, computed in their C fragments, is the A
//   operand of dQ += dS K (`mma_nn`, K in the forward's V's place).  A CTA
//   owns its query rows, so there are no sums across CTAs and no atomics.
//   On the key tiles the mask cuts (the causal diagonal's, and a ragged
//   last tile), dP is summed on the CUDA cores as the plain versions sum
//   it, one fp32 FMA chain an element over the head dim (`fma_nt`): the
//   first row of a causal sequence sees one key, p = 1 and delta = dO . O
//   = dP there, so dS is the rounding of those two sums alone, and dQ
//   carries it.  With dP in any other order (3xTF32's, or an fp64
//   evaluation's) such rows sat up to 2.3e-4 of a row's scale off the
//   plain version's on an H100 at the 7B shape, against a bar of 1e-5; in
//   its order they sit within 7e-6.  The mask cuts one or two of the key
//   tiles a warp walks, a few percent of them at training lengths;
// - streamed tiles (K and V in the forward and dQ; 64-row Q, dO, lse and
//   delta in dK/dV) come through a ring of two stages with 16-byte
//   `cp.async` copies (4-byte for lse and delta): one barrier a tile
//   publishes tile j and frees the stage of tile j - 1, which tile j + 1
//   then loads while tile j is multiplied; rows past S arrive as zeros (a
//   copy of 0 source bytes);
// - P (dS in dQ) never goes through shared memory in the forward and dQ:
//   the score accumulator is the A operand of the next product.  For TF32
//   the C fragment holds columns 2t, 2t + 1 where the A fragment wants t,
//   t + 4, so the k index of P.V is permuted (slot t is key 2t, slot t + 4
//   key 2t + 1) and V's (K's) rows are read in the same order;
// - fp32 tiles are read as 16-byte vectors: an A or B fragment of an
//   S = A B^T product two k-steps at a time (slots t, t + 4 hold head-dim
//   columns 4t, 4t + 1 and then 4t + 2, 4t + 3), and a B fragment of P.V
//   four n-blocks at a time (n-block j of a 32-column group holds columns
//   4g + j, so a lane's output is 8 consecutive columns).  The 16-byte
//   chunks of a row are XOR-swizzled by (r & 6) ^ ((r & 1) << 2), which
//   makes both access patterns free of bank conflicts; bf16 tiles are read
//   with `ldmatrix` (transposed for V, dO and Q as the B of P.V-shaped
//   products) under the usual r & 7 swizzle;
// - hi and lo are split in registers as each fragment is read, hi by an
//   integer add and mask (`split`);
// - the tensor cores round their fp32 sums toward zero, a bias that grows
//   with the length of a chain of sums: into one accumulator over 4096 keys
//   it put a row 6e-5 off the plain version on an H100 (the bar is 1e-5).
//   So the cross terms lo.hi + hi.lo sum apart from hi.hi, each key tile's
//   P.V (dS.K, P^T.dO, dS^T.Q) sums from zero and is added in a rounded
//   fp32 add, and the head-dim sums of S (and dP) run in chains of at most
//   128 columns;
// - the online softmax, base-2 exponentials and lse = m ln 2 + log l, of
//   flash_fwd.cu; a key past S gets p = 0, a row past S is never stored,
//   the causal mask is applied on the diagonal tiles only and a warp (a
//   pair in dK/dV) skips a tile wholly above its rows;
// - dK/dV keeps its keys resident and walks the GQA group's q heads and the
//   query tiles from the causal diagonal to S, summing in registers in a
//   fixed order: no atomics, so two launches give the same bits.
// Tiles (rows x DP): forward 128 query rows and 64-key K/V tiles, dK/dV 64
// keys and 64-row Q/dO tiles; fp32 at DP = 256 halves both (4 warps, or 2
// pairs).  dQ holds Q and dO, so its key tiles narrow: 128 query rows and
// 64-key tiles up to DP = 64, 32-key tiles at 128, 64 rows and 16-key
// tiles at 256 (`DqCfg`).  At most 225 KB of shared memory (`wgdq`), one
// CTA an SM.
// bf16 at DP = 256, forward and dK/dV on `mma.sync` (H100 80GB HBM3, 700
// W; S 2048, H 16): 0.268 and 0.428 ms; the wgmma forward 0.134.
//
// What was tried on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md), at
// the 7B shape in fp32, forward / dK/dV: hi and lo by `cvt.rna.tf32.f32`
// 3.40 / 8.60 ms (cvt compiles to four instructions with inf and NaN
// guards, and the splits held the issue slots); hi by an integer add and
// mask, lo unrounded 2.70 / 5.48 (the same worst rows); hi by Veltkamp's
// fp32 split 3.09 / 6.26; each streamed tile split once into hi and lo
// tiles for all warps (32-row tiles to fit) 3.02 / 6.04.
//
// Head dims: DP is 32, 64, 128 or 256; the wrapper zero-pads D up to the
// next of them (zero columns add 0 to every score and give zero columns of
// o, dq, dk and dv).
//
// Plain C entry points, bound from Python with ctypes: each launch goes on
// the stream it is handed, allocates nothing and returns the cudaError_t.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

// ----------------------------------------------------- asynchronous copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Copy 16 (or 4) bytes; bytes past src_bytes are written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Named barriers of a pair of warps (ids 1..15; 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// The swizzle of the 16-byte chunks of row r of a tile (low 3 bits of the
// chunk index): conflict-free for the fp32 fragment loads below, and for
// ldmatrix in bf16.
template <typename T> __device__ __forceinline__ int swz(int r);
template <> __device__ __forceinline__ int swz<float>(int r) { return (r & 6) ^ ((r & 1) << 2); }
template <> __device__ __forceinline__ int swz<bf16>(int r) { return r & 7; }

// dst [R, DP] (rows DP elements apart, chunks swizzled) = rows 0 .. rows -
// 1 of src, `stride` elements apart, and zeros below them: NT threads each
// issue 16-byte cp.async copies (not committed here).
template <int DP, int R, int NT, typename T>
__device__ __forceinline__ void async_tile(T* dst, const T* src, size_t stride, int rows) {
  constexpr int E = 16 / sizeof(T), C = DP / E;
  static_assert(C >= 8, "the swizzle needs 8 chunks a row");
#pragma unroll
  for (int i0 = 0; i0 < R * C; i0 += NT) {
    const int i = i0 + threadIdx.x;
    if ((R * C) % NT == 0 || i < R * C) {
      const int r = i / C, c = i % C;
      const bool ok = r < rows;
      cp_async16(dst + r * DP + ((c ^ swz<T>(r)) * E), src + (size_t)(ok ? r : 0) * stride + c * E,
                 ok ? 16 : 0);
    }
  }
}

// ---------------------------------------------------- tensor-core products

// x = hi + lo for 3xTF32: hi is x rounded to TF32, to nearest with ties
// away from zero (half of the 13 dropped bits added, then cleared: what
// cvt.rna.tf32.f32 gives a finite x, in two integer instructions where
// cvt compiles to four with guards for inf and NaN), and lo = x - hi,
// exact.  The tensor cores read lo's top 11 significant bits; rounding lo
// as well changed no worst row on the card and cost a third of dK/dV's
// time.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// a . b in 3xTF32: hi . hi into d, the two small cross terms into dl.
// The tensor cores round each fp32 sum toward zero, a bias that grows with
// the number of sums in a chain (6e-5 of a row after 4096 keys into one
// accumulator on an H100); keeping the cross terms apart makes the chain
// of large sums a third as long, and their own errors are 2^-11 smaller.
__device__ __forceinline__ void mma3(float (&d)[4], float (&dl)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32(dl, al, bh0, bh1);
  mma_tf32(dl, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

template <int N>
__device__ __forceinline__ void zero_frags(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// The accumulator of a warp's 16 x 8 n-block, m16n8 C fragment: lane 4 g +
// t holds (row g, column 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// acc[j] += A[m0 + 0..15][:] . B[n0 + 8 j + 0..7][:]^T over DP columns,
// j < NJ: A and B tiles in shared memory, m0 and n0 multiples of 8.
// fp32: both operands are split as they are read.  A lane reads 4 columns
// of a row at a time, which are two k-steps (slots t, t + 4 = columns 4t,
// 4t + 1, then 4t + 2, 4t + 3); rows m0 + g, m0 + g + 8 and n0 + 8 j + g
// share one swizzle.  acc holds zeros on entry; the hi . hi sums run in
// chains of at most 128 columns, each added to acc in a rounded fp32 add.
template <int DP, int NJ>
__device__ __forceinline__ void mma_nt(float (&acc)[NJ][4], const float* a, int m0,
                                       const float* b, int n0) {
  constexpr int kChains = DP > 128 ? DP / 128 : 1, kSteps = DP / 16 / kChains;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sw = swz<float>(g);
  const float* ar = a + (m0 + g) * DP;
  const float* br = b + (n0 + g) * DP;
  float lo[NJ][4];
  zero_frags(lo);
  // Columns 16 s .. 16 s + 15 of every product into hi and lo.
  auto step = [&](float (&hi)[NJ][4], int s) {
    const int c = ((4 * s + t) ^ sw) * 4;
    const float4 x = *reinterpret_cast<const float4*>(ar + c);
    const float4 y = *reinterpret_cast<const float4*>(ar + 8 * DP + c);
    uint32_t ah[2][4], al[2][4];
    split(x.x, ah[0][0], al[0][0]);
    split(y.x, ah[0][1], al[0][1]);
    split(x.y, ah[0][2], al[0][2]);
    split(y.y, ah[0][3], al[0][3]);
    split(x.z, ah[1][0], al[1][0]);
    split(y.z, ah[1][1], al[1][1]);
    split(x.w, ah[1][2], al[1][2]);
    split(y.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 z = *reinterpret_cast<const float4*>(br + j * 8 * DP + c);
      uint32_t bh[4], bl[4];
      split(z.x, bh[0], bl[0]);
      split(z.y, bh[1], bl[1]);
      split(z.z, bh[2], bl[2]);
      split(z.w, bh[3], bl[3]);
      mma3(hi[j], lo[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
      mma3(hi[j], lo[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
    }
  };
  if constexpr (kChains == 1) {
#pragma unroll 2
    for (int s = 0; s < kSteps; ++s) step(acc, s);
  } else {
#pragma unroll
    for (int ch = 0; ch < kChains; ++ch) {
      float hi[NJ][4];
      zero_frags(hi);
#pragma unroll 2
      for (int s = ch * kSteps; s < (ch + 1) * kSteps; ++s) step(hi, s);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += hi[j][e];
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += lo[j][e];
}
// acc = A[m0 + 0..15][:] . B[8 j + 0..7][:]^T over DP columns, j < NJ, in
// the C fragment's layout, on the CUDA cores: each element one chain of
// fp32 FMAs over the head dim in order, from zero.  That is how the plain
// versions' fp32 product sums each element (cuBLAS's fp32 GEMM on the
// card; MKL's and XLA's on the CPU), and dQ takes dP this way on the tiles
// the mask cuts (see flash_simple_dq_kernel).  A lane reads 16-byte chunks
// of its two rows and of its two keys a block (rows g, g + 8, keys 8 j +
// 2t, 8 j + 2t + 1).
template <int DP, int NJ>
__device__ __forceinline__ void fma_nt(float (&acc)[NJ][4], const float* a, int m0,
                                       const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sa = swz<float>(g), sb0 = swz<float>(2 * t), sb1 = swz<float>(2 * t + 1);
  const float* a0 = a + (m0 + g) * DP;
  const float* a1 = a0 + 8 * DP;
#pragma unroll 2
  for (int c = 0; c < DP / 4; ++c) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + ((c ^ sa) << 2));
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + ((c ^ sa) << 2));
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* br = b + (8 * j + 2 * t) * DP;
      const float4 y0 = *reinterpret_cast<const float4*>(br + ((c ^ sb0) << 2));
      const float4 y1 = *reinterpret_cast<const float4*>(br + DP + ((c ^ sb1) << 2));
      acc[j][0] = fmaf(x0.w, y0.w, fmaf(x0.z, y0.z, fmaf(x0.y, y0.y, fmaf(x0.x, y0.x, acc[j][0]))));
      acc[j][1] = fmaf(x0.w, y1.w, fmaf(x0.z, y1.z, fmaf(x0.y, y1.y, fmaf(x0.x, y1.x, acc[j][1]))));
      acc[j][2] = fmaf(x1.w, y0.w, fmaf(x1.z, y0.z, fmaf(x1.y, y0.y, fmaf(x1.x, y0.x, acc[j][2]))));
      acc[j][3] = fmaf(x1.w, y1.w, fmaf(x1.z, y1.z, fmaf(x1.y, y1.y, fmaf(x1.x, y1.x, acc[j][3]))));
    }
  }
}
// bf16: ldmatrix of A's 16 x 16 block and two n-blocks of B a k-step.
template <int DP, int NJ>
__device__ __forceinline__ void mma_nt(float (&acc)[NJ][4], const bf16* a, int m0,
                                       const bf16* b, int n0) {
  static_assert(NJ % 2 == 0, "n-blocks go in pairs");
  const int lane = threadIdx.x & 31;
  const int ar = m0 + (lane & 15), ac = lane >> 4;
  const int br = n0 + (lane & 7) + ((lane >> 4) << 3), bc = (lane >> 3) & 1;
#pragma unroll 4
  for (int s = 0; s < DP / 16; ++s) {
    uint32_t af[4];
    ldsm_x4(af, a + ar * DP + (((2 * s + ac) ^ (ar & 7)) << 3));
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t bfr[4];
      ldsm_x4(bfr, b + (br + 16 * jp) * DP + (((2 * s + bc) ^ (br & 7)) << 3));
      mma_bf16(acc[2 * jp], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * jp + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc += P . X[k0 + 0..8 NK - 1][:], P the warp's 16 x 8 NK score
// accumulator (p[kb] the C fragment of keys k0 + 8 kb ..) and X a tile in
// shared memory, k0 a multiple of 8.
// fp32: X is split as it is read.  A slot t is key 2t and slot t + 4 key
// 2t + 1 (the C fragment's own columns), so X's rows 2t and 2t + 1 are
// read in that order; n-block j of a 32-column group G holds columns
// 32 G + 4 g + j, so a lane reads 4 n-blocks' B in one 16-byte load, and
// its outputs are columns 32 G + 8 t .. + 7 (store_rows).  Each group's
// product over this tile is summed from zero and added to acc in an
// ordinary, rounded fp32 add: the truncated chains are one tile long.
template <int DP, int NK>
__device__ __forceinline__ void mma_nn(float (&acc)[DP / 8][4], const float (&p)[NK][4],
                                       const float* x, int k0) {
  // P split once where registers allow (DP <= 128), else at each use.
  constexpr bool kPresplit = DP <= 128;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int s0 = swz<float>(2 * t), s1 = swz<float>(2 * t + 1);
  uint32_t ph[kPresplit ? NK : 1][4], pl[kPresplit ? NK : 1][4];
  auto split_p = [&](int kb, uint32_t (&h)[4], uint32_t (&l)[4]) {
    split(p[kb][0], h[0], l[0]);
    split(p[kb][2], h[1], l[1]);
    split(p[kb][1], h[2], l[2]);
    split(p[kb][3], h[3], l[3]);
  };
  if constexpr (kPresplit) {
#pragma unroll
    for (int kb = 0; kb < NK; ++kb) split_p(kb, ph[kb], pl[kb]);
  }
#pragma unroll
  for (int G = 0; G < DP / 32; ++G) {
    float part[4][4], lo[4][4];
    zero_frags(part);
    zero_frags(lo);
#pragma unroll
    for (int kb = 0; kb < NK; ++kb) {
      const int i = kPresplit ? kb : 0;
      if constexpr (!kPresplit) split_p(kb, ph[0], pl[0]);
      const float* r0 = x + (k0 + 8 * kb + 2 * t) * DP;
      const float4 u = *reinterpret_cast<const float4*>(r0 + ((8 * G + g) ^ s0) * 4);
      const float4 w = *reinterpret_cast<const float4*>(r0 + DP + ((8 * G + g) ^ s1) * 4);
      const float uv[4] = {u.x, u.y, u.z, u.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bh0, bl0, bh1, bl1;
        split(uv[jj], bh0, bl0);
        split(wv[jj], bh1, bl1);
        mma3(part[jj], lo[jj], ph[i], pl[i], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * G + jj][e] += part[jj][e] + lo[jj][e];
  }
}
// bf16: P packed to bf16 two n-blocks at a time (one k16 step), X's B
// fragments by transposed ldmatrix.
template <int DP, int NK>
__device__ __forceinline__ void mma_nn(float (&acc)[DP / 8][4], const float (&p)[NK][4],
                                       const bf16* x, int k0) {
  static_assert(NK % 2 == 0, "keys go in 16s");
  const int lane = threadIdx.x & 31;
  const int xr = (lane & 7) + (((lane >> 3) & 1) << 3), xc = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    const uint32_t af[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const int r = k0 + 16 * kk + xr;
#pragma unroll
    for (int jp = 0; jp < DP / 16; ++jp) {
      uint32_t bfr[4];
      ldsm_x4_t(bfr, x + r * DP + (((2 * jp + xc) ^ (r & 7)) << 3));
      mma_bf16(acc[2 * jp], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * jp + 1], af, bfr[2], bfr[3]);
    }
  }
}

// A lane's two rows of an mma_nn accumulator, times mul0 and mul1, to the
// row pointers d0 (row g) and d1 (row g + 8); a null pointer skips a row.
template <int DP>
__device__ __forceinline__ void store_rows(float* d0, float* d1, const float (&acc)[DP / 8][4],
                                           float mul0, float mul1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int G = 0; G < DP / 32; ++G) {
    const float(&a)[4] = acc[4 * G];
    const float(&b)[4] = acc[4 * G + 1];
    const float(&c)[4] = acc[4 * G + 2];
    const float(&d)[4] = acc[4 * G + 3];
    if (d0 != nullptr) {
      *reinterpret_cast<float4*>(d0 + 32 * G + 8 * t) =
          make_float4(a[0] * mul0, b[0] * mul0, c[0] * mul0, d[0] * mul0);
      *reinterpret_cast<float4*>(d0 + 32 * G + 8 * t + 4) =
          make_float4(a[1] * mul0, b[1] * mul0, c[1] * mul0, d[1] * mul0);
    }
    if (d1 != nullptr) {
      *reinterpret_cast<float4*>(d1 + 32 * G + 8 * t) =
          make_float4(a[2] * mul1, b[2] * mul1, c[2] * mul1, d[2] * mul1);
      *reinterpret_cast<float4*>(d1 + 32 * G + 8 * t + 4) =
          make_float4(a[3] * mul1, b[3] * mul1, c[3] * mul1, d[3] * mul1);
    }
  }
}
template <int DP>
__device__ __forceinline__ void store_rows(bf16* d0, bf16* d1, const float (&acc)[DP / 8][4],
                                           float mul0, float mul1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (d0 != nullptr)
      *reinterpret_cast<uint32_t*>(d0 + 8 * j + 2 * t) =
          pack_bf16(acc[j][0] * mul0, acc[j][1] * mul0);
    if (d1 != nullptr)
      *reinterpret_cast<uint32_t*>(d1 + 8 * j + 2 * t) =
          pack_bf16(acc[j][2] * mul1, acc[j][3] * mul1);
  }
}

// The (b * heads + head) index of this CTA (flash::head_grid).
__device__ __forceinline__ int head_index() { return blockIdx.y + gridDim.y * blockIdx.z; }

// ------------------------------------------------------------ forward, fp32

// 8 warps of 16 query rows and 64-key tiles; at DP = 256 (64 KB a 64-row
// tile) 4 warps and 32-key tiles.  Shared memory: Q, then two stages of K
// and V.
template <int DP> struct FwdCfg {
  static constexpr bool kWide = DP == 256;
  static constexpr int kWarps = kWide ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 16 * kWarps;
  static constexpr int BK = kWide ? 32 : 64;
  static constexpr size_t kSmem = (size_t)(BQ + 4 * BK) * DP * sizeof(float);
  static_assert(kSmem <= kMaxSmem, "tiles must fit a CTA");
};

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(FwdCfg<DP>::kThreads, 1)
flash_simple_fwd_kernel(const float* __restrict__ q,   // [B, S, H, DP]
                        const float* __restrict__ k,   // [B, S, KV, DP]
                        const float* __restrict__ v,   // [B, S, KV, DP]
                        float* __restrict__ o,         // [B, S, H, DP]
                        float* __restrict__ lse,       // [B, H, S]
                        int B, int S, int H, int KV, float scale_log2) {
  using T = float;
  using C = FwdCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::kThreads, NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kv_s = qs + BQ * DP;  // stage st: K at kv_s + 2 st BK DP, V after it

  const int bh = head_index();
  if (bh >= B * H) return;
  const int b = bh / H, h = bh % H, g = h / (H / KV);
  const int n_q = (S + BQ - 1) / BQ;
  const int qi = CAUSAL ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qi * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;
  const int m0 = 16 * warp;                 // the warp's rows in the tile
  const int row0 = q0 + m0 + (lane >> 2);   // this lane's rows: row0, row0 + 8
  const size_t qs_stride = (size_t)H * DP, kv_stride = (size_t)KV * DP;
  const T* k_bg = k + (size_t)b * S * kv_stride + (size_t)g * DP;
  const T* v_bg = v + (size_t)b * S * kv_stride + (size_t)g * DP;
  const int n_k = (S + BK - 1) / BK;
  const int n_kv = CAUSAL ? min(n_k, (q0 + BQ - 1) / BK + 1) : n_k;

  auto load_kv = [&](int it) {
    T* ks = kv_s + (it & 1) * 2 * BK * DP;
    const int k0 = it * BK, rows = min(BK, S - k0);
    async_tile<DP, BK, NT>(ks, k_bg + (size_t)k0 * kv_stride, kv_stride, rows);
    async_tile<DP, BK, NT>(ks + BK * DP, v_bg + (size_t)k0 * kv_stride, kv_stride, rows);
  };
  async_tile<DP, BQ, NT>(qs, q + ((size_t)b * S + q0) * qs_stride + (size_t)h * DP, qs_stride,
                         min(BQ, S - q0));
  load_kv(0);
  cp_async_commit();

  float acc[DP / 8][4];
  zero_frags(acc);
  float m_0 = kNegInf, m_1 = kNegInf;  // running max (base 2) of rows row0, row0 + 8
  float l_0 = 0.f, l_1 = 0.f;          // this lane's part of their running sums

  for (int it = 0; it < n_kv; ++it) {
    cp_async_wait<0>();
    // Tile it has landed for every thread, and every thread is done with
    // tile it - 1: its stage takes tile it + 1, loaded while this one is
    // multiplied.
    __syncthreads();
    if (it + 1 < n_kv) load_kv(it + 1);
    cp_async_commit();
    const int k0 = it * BK;
    const T* ks = kv_s + (it & 1) * 2 * BK * DP;
    // A key tile wholly after the warp's last row adds nothing to it.
    if (!CAUSAL || k0 <= q0 + m0 + 15) {
      float s[NJ][4];
      zero_frags(s);
      mma_nt<DP, NJ>(s, qs, m0, ks, 0);
      const bool edge = (CAUSAL && k0 + BK - 1 > q0 + m0) || k0 + BK > S;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          const int key = k0 + 8 * j + 2 * t4 + (e & 1), row = row0 + 8 * (e >> 1);
          if (edge && (key >= S || (CAUSAL && key > row))) x = kNegInf;
          s[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      const float mn0 = fmaxf(m_0, quad_max(mx0)), mn1 = fmaxf(m_1, quad_max(mx1));
      const float alpha0 = exp2f(m_0 - mn0), alpha1 = exp2f(m_1 - mn1);
      m_0 = mn0;
      m_1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j][0] = exp2f(s[j][0] - mn0);
        s[j][1] = exp2f(s[j][1] - mn0);
        s[j][2] = exp2f(s[j][2] - mn1);
        s[j][3] = exp2f(s[j][3] - mn1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l_0 = l_0 * alpha0 + sum0;
      l_1 = l_1 * alpha1 + sum1;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[j][0] *= alpha0;
        acc[j][1] *= alpha0;
        acc[j][2] *= alpha1;
        acc[j][3] *= alpha1;
      }
      mma_nn<DP, NJ>(acc, s, ks + BK * DP, 0);  // O += P V
    }
  }

  l_0 = fmaxf(quad_sum(l_0), 1e-30f);
  l_1 = fmaxf(quad_sum(l_1), 1e-30f);
  T* o_row = o + ((size_t)b * S + row0) * qs_stride + (size_t)h * DP;
  store_rows<DP>(row0 < S ? o_row : nullptr, row0 + 8 < S ? o_row + 8 * qs_stride : nullptr, acc,
                 1.f / l_0, 1.f / l_1);
  if (t4 == 0) {
    float* lse_row = lse + (size_t)bh * S;
    if (row0 < S) lse_row[row0] = m_0 * kLn2 + logf(l_0);
    if (row0 + 8 < S) lse_row[row0 + 8] = m_1 * kLn2 + logf(l_1);
  }
}

// ------------------------------------------------ forward, bf16 at DP = 256

// bf16 at DP = 256 on `wgmma`, as flash_fwd.cu does at D <= 128: a CTA of
// two consumer warpgroups of 64 query rows and a producer warpgroup whose
// one thread keeps TMA loads of K and V in flight (4-D tensor maps over
// (D, heads, S, B), 64-column boxes, 128-byte swizzle), the producer's
// registers handed to the consumers (`setmaxnreg`).  A 64-row warpgroup's
// fp32 O accumulator at D = 256 is 128 registers a thread, so the key
// tiles are 64 wide (S 32 registers, P 16) where flash_fwd.cu's are 128,
// and the ring has two stages: Q (64 KB) and two stages of K and V (64
// KB each) are 192 KB.  S = Q K^T is `wgmma.m64n64k16` with both operands
// in shared memory; O += P V is two `wgmma.m64n128k16` (one a 128-column
// half of V) with P from registers, rounded to bf16 from the S
// accumulator, and V as the transposed (MN-major) operand.  The consumers
// take turns to issue (named barriers), so one's softmax overlaps the
// other's products; the numerics are flash_fwd.cu's.
namespace wg256 {

constexpr int kD = 256;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int BQ = 64 * kConsumers;                  // query rows a CTA
constexpr int BK = 64;                               // keys a K/V tile
constexpr int kStages = 2;
constexpr int kBoxQ = 128 * BQ;                      // a 64-column box of Q
constexpr int kBoxK = 128 * BK;                      // a 64-column box of K or V
constexpr int kTileQ = (kD / 64) * kBoxQ;            // 64 KB
constexpr int kTileK = (kD / 64) * kBoxK;            // 32 KB
constexpr int kBar = kTileQ + 2 * kStages * kTileK;  // barriers after the tiles
constexpr size_t kSmem = kBar + 8 * (1 + 3 * kStages) + 1024;
static_assert(kSmem <= kMaxSmem, "tiles must fit a CTA");

// Named as the fp32 forward is, so a profile's flash_simple_fwd time
// counts both.
template <bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_simple_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,  // [B, S, H, 256]
                        const __grid_constant__ CUtensorMap tm_k,  // [B, S, KV, 256]
                        const __grid_constant__ CUtensorMap tm_v,  // [B, S, KV, 256]
                        bf16* __restrict__ o,                      // [B, S, H, 256]
                        float* __restrict__ lse,                   // [B, H, S]
                        int B, int S, int H, int KV, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kBar);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + kStages;
  uint64_t* empty = bar + 1 + 2 * kStages;
  unsigned char* q_s = smem;
  unsigned char* k_s = smem + kTileQ;
  unsigned char* v_s = smem + kTileQ + kStages * kTileK;

  const int n_q = (S + BQ - 1) / BQ;
  const int qi = CAUSAL ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = head_index();
  if (bh >= B * H) return;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int n_k = (S + BK - 1) / BK;
  const int n_kv = CAUSAL ? min(n_k, (qi * BQ + BQ - 1) / BK + 1) : n_k;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, kConsumers * 4);  // one arrival a consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread keeps the ring full.
    hopper::reg_dealloc<24>();
    if (threadIdx.x == kConsumers * 128) {
      hopper::mbar_expect_tx(q_full, kTileQ);
#pragma unroll
      for (int x = 0; x < kD / 64; ++x)
        hopper::tma_load_4d(q_s + x * kBoxQ, &tm_q, q_full, 64 * x, h, qi * BQ, b);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        hopper::mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(k_full + st, kTileK);
#pragma unroll
        for (int x = 0; x < kD / 64; ++x)
          hopper::tma_load_4d(k_s + st * kTileK + x * kBoxK, &tm_k, k_full + st, 64 * x, g,
                              it * BK, b);
        hopper::mbar_expect_tx(v_full + st, kTileK);
#pragma unroll
        for (int x = 0; x < kD / 64; ++x)
          hopper::tma_load_4d(v_s + st * kTileK + x * kBoxK, &tm_v, v_full + st, 64 * x, g,
                              it * BK, b);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows qi * BQ + 64 wg .. + 63.
    hopper::reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, t4 = lane & 3;
    const int row_min = qi * BQ + wg * 64;            // the warpgroup's first row
    const int row0 = row_min + warp * 16 + gr;        // and row0 + 8

    float o0[64], o1[64];  // columns 0-127 and 128-255
#pragma unroll
    for (int i = 0; i < 64; ++i) o0[i] = o1[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // running max (base 2) of rows row0, row0 + 8
    float l0 = 0.f, l1 = 0.f;          // this lane's part of the running sums

    // As flash_fwd.cu: while the tensor cores run S(it + 1) = Q K(it + 1)^T
    // and O += P(it) V(it), this warpgroup takes the softmax of S(it + 1).
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    auto issue_s = [&](int it) {
      const unsigned char* k_t = k_s + (it % kStages) * kTileK;
      hopper::mbar_wait(k_full + it % kStages, (it / kStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int off = (kk % 4) * 32;
        hopper::wgmma_m64n64k16_ss(
            s, hopper::desc_sw128(q_s + (kk / 4) * kBoxQ + wg * 64 * 128 + off, 16, 1024),
            hopper::desc_sw128(k_t + (kk / 4) * kBoxK + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
    };
    auto issue_pv = [&](int it) {
      const unsigned char* v_t = v_s + (it % kStages) * kTileK;
      hopper::mbar_wait(v_full + it % kStages, (it / kStages) & 1);
      hopper::reg_fence(o0);
      hopper::reg_fence(o1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        hopper::wgmma_m64n128k16_rs_tb(
            o0, pa[kk], hopper::desc_sw128(v_t + kk * 16 * 128, kBoxK, 1024), 1);
        hopper::wgmma_m64n128k16_rs_tb(
            o1, pa[kk], hopper::desc_sw128(v_t + 2 * kBoxK + kk * 16 * 128, kBoxK, 1024), 1);
      }
      hopper::wgmma_commit();
    };
    // Softmax of S(it) in place, as flash_fwd.cu's.
    auto softmax = [&](int it, float& alpha0, float& alpha1) {
      hopper::reg_fence(s);
      const int key0 = it * BK;
      if ((CAUSAL && key0 + BK - 1 > row_min) || key0 + BK > S) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = key0 + 8 * j + 2 * t4 + (e & 1);
            const int row = row0 + ((e >> 1) << 3);
            if (col >= S || (CAUSAL && col > row)) s[4 * j + e] = kNegInf;
          }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      mx1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      alpha0 = exp2_approx(m0 - mx0);
      alpha1 = exp2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = exp2_approx(fmaf(s[4 * j], scale_log2, -m0));
        s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], scale_log2, -m0));
        s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], scale_log2, -m1));
        s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], scale_log2, -m1));
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
    };
    auto to_pa = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto release = [&](int it) {
      if (lane == 0) hopper::mbar_arrive(empty + it % kStages);
    };
    auto rescale = [&](float a0, float a1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o0[4 * j] *= a0;
        o0[4 * j + 1] *= a0;
        o0[4 * j + 2] *= a1;
        o0[4 * j + 3] *= a1;
        o1[4 * j] *= a0;
        o1[4 * j + 1] *= a0;
        o1[4 * j + 2] *= a1;
        o1[4 * j + 3] *= a1;
      }
    };

    const int other = 1 - wg;
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(256) : "memory");
    };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + other), "n"(256) : "memory");
    };
    if (wg == 1) asm volatile("bar.arrive %0, %1;\n" ::"r"(1), "n"(256) : "memory");

    hopper::mbar_wait(q_full, 0);
    float alpha0, alpha1;
    turn_wait();
    issue_s(0);
    turn_pass();
    hopper::wgmma_wait<0>();
    softmax(0, alpha0, alpha1);  // O is still 0: no rescale
    to_pa();
    for (int it = 0; it + 1 < n_kv; ++it) {
      turn_wait();
      issue_s(it + 1);
      issue_pv(it);             // reads pa until it lands
      turn_pass();
      hopper::wgmma_wait<1>();  // S(it + 1) has landed in s
      softmax(it + 1, alpha0, alpha1);
      hopper::wgmma_wait<0>();  // P(it) V(it) has landed in o0, o1
      hopper::reg_fence(o0);
      hopper::reg_fence(o1);
      release(it);
      rescale(alpha0, alpha1);
      to_pa();
    }
    turn_wait();
    issue_pv(n_kv - 1);
    if (wg == 0) turn_pass();  // warpgroup 1 took the first turn's pass
    hopper::wgmma_wait<0>();
    hopper::reg_fence(o0);
    hopper::reg_fence(o1);
    release(n_kv - 1);

    l0 = fmaxf(quad_sum(l0), 1e-30f);
    l1 = fmaxf(quad_sum(l1), 1e-30f);
    const float s0 = 1.f / l0, s1 = 1.f / l1;
    const size_t q_stride = (size_t)H * kD;
    bf16* o_row = o + ((size_t)b * S + row0) * q_stride + (size_t)h * kD;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t4;
      if (row0 < S) {
        *reinterpret_cast<uint32_t*>(o_row + col) = pack_bf16(o0[4 * j] * s0, o0[4 * j + 1] * s0);
        *reinterpret_cast<uint32_t*>(o_row + 128 + col) =
            pack_bf16(o1[4 * j] * s0, o1[4 * j + 1] * s0);
      }
      if (row0 + 8 < S) {
        *reinterpret_cast<uint32_t*>(o_row + 8 * q_stride + col) =
            pack_bf16(o0[4 * j + 2] * s1, o0[4 * j + 3] * s1);
        *reinterpret_cast<uint32_t*>(o_row + 8 * q_stride + 128 + col) =
            pack_bf16(o1[4 * j + 2] * s1, o1[4 * j + 3] * s1);
      }
    }
    if (t4 == 0) {
      float* lse_row = lse + (size_t)bh * S;
      if (row0 < S) lse_row[row0] = m0 * kLn2 + logf(l0);
      if (row0 + 8 < S) lse_row[row0 + 8] = m1 * kLn2 + logf(l1);
    }
  }
}

template <bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int H, int KV, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t e = hopper::make_map(&mq, q, B, S, H, kD, BQ);
  if (e == cudaSuccess) e = hopper::make_map(&mk, k, B, S, KV, kD, BK);
  if (e == cudaSuccess) e = hopper::make_map(&mv, v, B, S, KV, kD, BK);
  if (e != cudaSuccess) return e;
  auto kernel = flash_simple_fwd_kernel<CAUSAL>;
  e = allow_smem(kernel, kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<head_grid((S + BQ - 1) / BQ, B * H), kThreads, kSmem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, B, S, H, KV, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace wg256

// ------------------------------------------------------------------- dK/dV

// Pairs of warps over 16-key slices: 4 pairs (64 keys) and 64-row Q/dO
// tiles; fp32 at DP = 256 2 pairs and 32-row tiles.  Shared memory: K and
// V, two stages of (Q, dO, lse, delta), and each pair's P^T exchange.
template <int DP, typename T> struct DkvCfg {
  static constexpr bool kWide = sizeof(T) == 4 && DP == 256;
  static constexpr int kPairs = kWide ? 2 : 4;
  static constexpr int kThreads = 64 * kPairs;
  static constexpr int BKEY = 16 * kPairs;
  static constexpr int BQ = kWide ? 32 : 64;
  static constexpr size_t kKV = 2 * (size_t)BKEY * DP * sizeof(T);
  static constexpr size_t kStage = 2 * (size_t)BQ * DP * sizeof(T) + 2 * BQ * sizeof(float);
  static constexpr size_t kSmem = kKV + 2 * kStage + (size_t)kPairs * 16 * BQ * sizeof(float);
  static_assert(kSmem <= kMaxSmem, "tiles must fit a CTA");
};

template <int DP, typename T, bool CAUSAL>
__global__ void __launch_bounds__(DkvCfg<DP, T>::kThreads, 1)
flash_simple_dkv_kernel(const T* __restrict__ q,        // [B, S, H, DP]
                        const T* __restrict__ k,        // [B, S, KV, DP]
                        const T* __restrict__ v,        // [B, S, KV, DP]
                        const T* __restrict__ dout,     // [B, S, H, DP]
                        const float* __restrict__ lse,  // [B, H, S]
                        const float* __restrict__ delta,
                        T* __restrict__ dk,             // [B, S, KV, DP]
                        T* __restrict__ dv,             // [B, S, KV, DP]
                        int B, int S, int H, int KV, float scale, float scale_log2) {
  using C = DkvCfg<DP, T>;
  constexpr int BQ = C::BQ, BKEY = C::BKEY, NT = C::kThreads, NJ = BQ / 8, NP = C::kPairs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BKEY * DP;
  unsigned char* stages = smem_raw + C::kKV;
  // pex[(pair * NJ + j) * 32 + lane]: the C fragment of n-block j of the
  // pair's P^T, in the order its lanes hold it.
  float4* pex = reinterpret_cast<float4*>(stages + 2 * C::kStage);
  auto q_s = [&](int st) { return reinterpret_cast<T*>(stages + st * C::kStage); };
  auto do_s = [&](int st) { return q_s(st) + BQ * DP; };
  auto lse_s = [&](int st) { return reinterpret_cast<float*>(do_s(st) + BQ * DP); };
  auto dl_s = [&](int st) { return lse_s(st) + BQ; };

  const int bg = head_index();
  if (bg >= B * KV) return;
  const int b = bg / KV, g = bg % KV, rep = H / KV;
  const int k0 = blockIdx.x * BKEY;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;
  const int pair = warp % NP;
  const bool first = warp < NP;  // S^T, P^T and dV; its partner dP^T, dS^T and dK
  const int km = 16 * pair;      // the pair's keys in the tile
  const int key0 = k0 + km + (lane >> 2);  // this lane's keys: key0, key0 + 8
  const size_t qs_stride = (size_t)H * DP, kv_stride = (size_t)KV * DP;
  const size_t kv_off = ((size_t)b * S + k0) * kv_stride + (size_t)g * DP;
  const int n_t = (S + BQ - 1) / BQ;
  const int t0 = CAUSAL ? k0 / BQ : 0;  // the first query tile reaching a key
  const int per_head = n_t - t0;
  const int n_items = rep * per_head;   // (q head, query tile), heads outer

  auto load_item = [&](int i) {
    const int h = g * rep + i / per_head, qq0 = (t0 + i % per_head) * BQ;
    const int rows = min(BQ, S - qq0), st = i & 1;
    const size_t q_off = ((size_t)b * S + qq0) * qs_stride + (size_t)h * DP;
    async_tile<DP, BQ, NT>(q_s(st), q + q_off, qs_stride, rows);
    async_tile<DP, BQ, NT>(do_s(st), dout + q_off, qs_stride, rows);
    const size_t r_off = ((size_t)b * H + h) * S + qq0;
    for (int x = threadIdx.x; x < 2 * BQ; x += NT) {
      const int r = x % BQ;
      const bool ok = r < rows;
      cp_async4((x < BQ ? lse_s(st) : dl_s(st)) + r, (x < BQ ? lse : delta) + r_off + (ok ? r : 0),
                ok ? 4 : 0);
    }
  };
  const int krows = min(BKEY, S - k0);
  async_tile<DP, BKEY, NT>(ks, k + kv_off, kv_stride, krows);
  async_tile<DP, BKEY, NT>(vs, v + kv_off, kv_stride, krows);
  load_item(0);
  cp_async_commit();

  float acc[DP / 8][4];  // dV (first warp of a pair) or dK
  zero_frags(acc);
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<0>();
    // Item i has landed for every thread, and every thread is done with
    // item i - 1 (its stage and pex): its stage takes item i + 1, loaded
    // while this one is multiplied.
    __syncthreads();
    if (i + 1 < n_items) load_item(i + 1);
    cp_async_commit();
    const int st = i & 1, qq0 = (t0 + i % per_head) * BQ;
    // A query tile wholly before the pair's first key adds nothing to it.
    if (CAUSAL && qq0 + BQ - 1 < k0 + km) continue;
    float s[NJ][4];
    zero_frags(s);
    if (first) {
      mma_nt<DP, NJ>(s, ks, km, q_s(st), 0);  // S^T = K Q^T
      // p = 2^(s * scale log2 e - lse log2 e), 0 for a query past S or
      // before the key (keys past S are never stored).
      const bool edge = (CAUSAL && qq0 < k0 + km + 15) || qq0 + BQ > S;
      const float* ls = lse_s(st);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1), key = key0 + 8 * (e >> 1);
          float p = exp2f(fmaf(s[j][e], scale_log2, -ls[c] * kLog2e));
          if (edge && (qq0 + c >= S || (CAUSAL && qq0 + c < key))) p = 0.f;
          s[j][e] = p;
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        pex[(pair * NJ + j) * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      pair_arrive(1 + pair);                         // P^T is in shared memory
      mma_nn<DP, NJ>(acc, s, do_s(st), 0);    // dV += P^T dO
    } else {
      mma_nt<DP, NJ>(s, vs, km, do_s(st), 0);  // dP^T = V dO^T
      pair_sync(1 + pair);
      const float* dl = dl_s(st);
      // ds = p * (dp - delta) * scale
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 p = pex[(pair * NJ + j) * 32 + lane];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = pv[e] * (s[j][e] - dl[8 * j + 2 * t4 + (e & 1)]) * scale;
      }
      mma_nn<DP, NJ>(acc, s, q_s(st), 0);      // dK += dS^T Q
    }
  }

  T* out = (first ? dv : dk) + ((size_t)b * S + key0) * kv_stride + (size_t)g * DP;
  store_rows<DP>(key0 < S ? out : nullptr, key0 + 8 < S ? out + 8 * kv_stride : nullptr, acc,
                 1.f, 1.f);
}

// ---------------------------------------------------------------- dQ, fp32

// The forward's shape: 8 warps of 16 query rows, Q and dO resident, K and
// V tiles streamed through the two-stage ring.  Resident dO costs BQ DP
// floats more than the forward's tiles, so the key tiles narrow as DP
// grows: 64 keys up to DP = 64, 32 at 128, and at 256 4 warps (64 rows)
// and 16 keys.  At most 192 KB of shared memory.
template <int DP> struct DqCfg {
  static constexpr int kWarps = DP == 256 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 16 * kWarps;
  static constexpr int BK = DP <= 64 ? 64 : DP == 128 ? 32 : 16;
  static constexpr size_t kSmem = (size_t)(2 * BQ + 4 * BK) * DP * sizeof(float);
  static_assert(kSmem <= kMaxSmem, "tiles must fit a CTA");
};

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(DqCfg<DP>::kThreads, 1)
flash_simple_dq_kernel(const float* __restrict__ q,      // [B, S, H, DP]
                       const float* __restrict__ k,      // [B, S, KV, DP]
                       const float* __restrict__ v,      // [B, S, KV, DP]
                       const float* __restrict__ dout,   // [B, S, H, DP]
                       const float* __restrict__ lse,    // [B, H, S]
                       const float* __restrict__ delta,  // [B, H, S]
                       float* __restrict__ dq,           // [B, S, H, DP]
                       int B, int S, int H, int KV, float scale, float scale_log2) {
  using C = DqCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::kThreads, NJ = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + BQ * DP;
  float* kv_s = dos + BQ * DP;  // stage st: K at kv_s + 2 st BK DP, V after it

  const int bh = head_index();
  if (bh >= B * H) return;
  const int b = bh / H, h = bh % H, g = h / (H / KV);
  const int n_q = (S + BQ - 1) / BQ;
  const int qi = CAUSAL ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qi * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;
  const int m0 = 16 * warp;                 // the warp's rows in the tile
  const int row0 = q0 + m0 + (lane >> 2);   // this lane's rows: row0, row0 + 8
  const size_t qs_stride = (size_t)H * DP, kv_stride = (size_t)KV * DP;
  const size_t q_off = ((size_t)b * S + q0) * qs_stride + (size_t)h * DP;
  const float* k_bg = k + (size_t)b * S * kv_stride + (size_t)g * DP;
  const float* v_bg = v + (size_t)b * S * kv_stride + (size_t)g * DP;
  const int n_k = (S + BK - 1) / BK;
  const int n_kv = CAUSAL ? min(n_k, (q0 + BQ - 1) / BK + 1) : n_k;

  auto load_kv = [&](int it) {
    float* ks = kv_s + (it & 1) * 2 * BK * DP;
    const int k0 = it * BK, rows = min(BK, S - k0);
    async_tile<DP, BK, NT>(ks, k_bg + (size_t)k0 * kv_stride, kv_stride, rows);
    async_tile<DP, BK, NT>(ks + BK * DP, v_bg + (size_t)k0 * kv_stride, kv_stride, rows);
  };
  async_tile<DP, BQ, NT>(qs, q + q_off, qs_stride, min(BQ, S - q0));
  async_tile<DP, BQ, NT>(dos, dout + q_off, qs_stride, min(BQ, S - q0));
  load_kv(0);
  cp_async_commit();

  // lse (base 2) and delta of this lane's rows; 0 past S, where Q and dO
  // are zero rows, so ds is 0 there.
  const float* lse_r = lse + (size_t)bh * S;
  const float* dl_r = delta + (size_t)bh * S;
  const float lse0 = row0 < S ? lse_r[row0] * kLog2e : 0.f;
  const float lse1 = row0 + 8 < S ? lse_r[row0 + 8] * kLog2e : 0.f;
  const float dl0 = row0 < S ? dl_r[row0] : 0.f;
  const float dl1 = row0 + 8 < S ? dl_r[row0 + 8] : 0.f;

  float acc[DP / 8][4];
  zero_frags(acc);
  for (int it = 0; it < n_kv; ++it) {
    cp_async_wait<0>();
    // Tile it has landed for every thread, and every thread is done with
    // tile it - 1: its stage takes tile it + 1, loaded while this one is
    // multiplied.
    __syncthreads();
    if (it + 1 < n_kv) load_kv(it + 1);
    cp_async_commit();
    const int k0 = it * BK;
    const float* ks = kv_s + (it & 1) * 2 * BK * DP;
    // A key tile wholly after the warp's last row adds nothing to it.
    if (!CAUSAL || k0 <= q0 + m0 + 15) {
      const bool edge = (CAUSAL && k0 + BK - 1 > q0 + m0) || k0 + BK > S;
      float s[NJ][4], dp[NJ][4];
      zero_frags(s);
      mma_nt<DP, NJ>(s, qs, m0, ks, 0);  // S = Q K^T
      // dP = dO V^T; on a tile the mask cuts, summed as the plain versions
      // sum it (fma_nt): there are the rows that see few keys.
      zero_frags(dp);
      if (edge)
        fma_nt<DP, NJ>(dp, dos, m0, ks + BK * DP);
      else
        mma_nt<DP, NJ>(dp, dos, m0, ks + BK * DP, 0);
      // p = 2^(s * scale log2 e - lse log2 e), 0 for a key past S or after
      // the row; ds = p * (dp - delta) * scale, in place of s: the A
      // operand of dQ += dS K, as the forward's P is of P V.
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1), row = row0 + 8 * (e >> 1);
          float p = exp2f(fmaf(s[j][e], scale_log2, -(e & 2 ? lse1 : lse0)));
          if (edge && (key >= S || (CAUSAL && key > row))) p = 0.f;
          s[j][e] = p * (dp[j][e] - (e & 2 ? dl1 : dl0)) * scale;
        }
      mma_nn<DP, NJ>(acc, s, ks, 0);  // dQ += dS K
    }
  }

  float* dq_row = dq + ((size_t)b * S + row0) * qs_stride + (size_t)h * DP;
  store_rows<DP>(row0 < S ? dq_row : nullptr, row0 + 8 < S ? dq_row + 8 * qs_stride : nullptr,
                 acc, 1.f, 1.f);
}

// ------------------------------------------------------ dQ, bf16 at DP = 256

// bf16 at DP = 256 on `wgmma`, as flash_bwd.cu's dQ kernel at D <= 128: a
// CTA of two consumer warpgroups of 64 query rows and a producer warpgroup
// whose one thread issues every TMA load (4-D tensor maps, 64-column boxes,
// 128-byte swizzle).  Q and dO stay in shared memory (64 KB each at 128
// rows); 32-key K and V tiles (16 KB each) stream through a ring of three
// stages, 224 KB in all.  A warpgroup's dQ accumulator (64 x 256 fp32) is
// 128 registers a thread, and 32-key tiles keep S and dP at 16 each.  Per
// tile and warpgroup: S = Q K^T and dP = dO V^T (`wgmma.m64n32k16`, both
// operands in shared memory), ds in registers, rounded to bf16 as the A
// operand of dQ += ds K (two `wgmma.m64n128k16`, one a 128-column half of
// K, K as the MN-major B).  Numerics of flash_bwd.cu: fp32 sums, ds
// rounded to bf16 before its product.
namespace wgdq {

constexpr int kD = 256;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int BQ = 64 * kConsumers;                  // query rows a CTA
constexpr int BK = 32;                               // keys a K/V tile
constexpr int kStages = 3;
constexpr int kBoxQ = 128 * BQ;                      // a 64-column box of Q or dO
constexpr int kBoxK = 128 * BK;                      // a 64-column box of K or V
constexpr int kTileQ = (kD / 64) * kBoxQ;            // 64 KB
constexpr int kTileK = (kD / 64) * kBoxK;            // 16 KB
constexpr int kBar = 2 * kTileQ + 2 * kStages * kTileK;  // barriers after the tiles
constexpr size_t kSmem = kBar + 8 * (1 + 2 * kStages) + 1024;
static_assert(kSmem <= kMaxSmem, "tiles must fit a CTA");

// Descriptor of k16 step kk of a K-major operand: rows from `tile` (a
// slice of boxes `box` bytes apart), k columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int box, int kk) {
  return hopper::desc_sw128(tile + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}

// Named as the fp32 dQ kernel is, so a profile's flash_simple_dq time
// counts both.
template <bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_simple_dq_kernel(const __grid_constant__ CUtensorMap tm_q,   // [B, S, H, 256]
                       const __grid_constant__ CUtensorMap tm_k,   // [B, S, KV, 256]
                       const __grid_constant__ CUtensorMap tm_v,   // [B, S, KV, 256]
                       const __grid_constant__ CUtensorMap tm_do,  // [B, S, H, 256]
                       const float* __restrict__ lse,              // [B, H, S]
                       const float* __restrict__ delta,            // [B, H, S]
                       bf16* __restrict__ dq,                      // [B, S, H, 256]
                       int B, int S, int H, int KV, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kBar);
  uint64_t* q_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kStages;
  unsigned char* q_s = smem;
  unsigned char* do_s = smem + kTileQ;
  unsigned char* k_s = smem + 2 * kTileQ;
  unsigned char* v_s = smem + 2 * kTileQ + kStages * kTileK;

  const int n_q = (S + BQ - 1) / BQ;
  const int qi = CAUSAL ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = head_index();
  if (bh >= B * H) return;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int n_k = (S + BK - 1) / BK;
  const int n_kv = CAUSAL ? min(n_k, (qi * BQ + BQ - 1) / BK + 1) : n_k;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kConsumers * 4);  // one arrival a consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread keeps the ring full.
    hopper::reg_dealloc<24>();
    if (threadIdx.x == kConsumers * 128) {
      hopper::mbar_expect_tx(q_full, 2 * kTileQ);
#pragma unroll
      for (int x = 0; x < kD / 64; ++x) {
        hopper::tma_load_4d(q_s + x * kBoxQ, &tm_q, q_full, 64 * x, h, qi * BQ, b);
        hopper::tma_load_4d(do_s + x * kBoxQ, &tm_do, q_full, 64 * x, h, qi * BQ, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        hopper::mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full + st, 2 * kTileK);
#pragma unroll
        for (int x = 0; x < kD / 64; ++x) {
          hopper::tma_load_4d(k_s + st * kTileK + x * kBoxK, &tm_k, full + st, 64 * x, g,
                              it * BK, b);
          hopper::tma_load_4d(v_s + st * kTileK + x * kBoxK, &tm_v, full + st, 64 * x, g,
                              it * BK, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows r0 .. r0 + 63.
    hopper::reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int t4 = lane & 3;
    const int r0 = qi * BQ + wg * 64;
    const int row0 = r0 + warp * 16 + (lane >> 2);  // this thread's rows row0, row0 + 8
    const bool live = r0 < S;

    const float* lse_r = lse + (size_t)bh * S;
    const float* dl_r = delta + (size_t)bh * S;
    const float lse0 = row0 < S ? lse_r[row0] * kLog2e : 0.f;
    const float lse1 = row0 + 8 < S ? lse_r[row0 + 8] * kLog2e : 0.f;
    const float dl0 = row0 < S ? dl_r[row0] : 0.f;
    const float dl1 = row0 + 8 < S ? dl_r[row0 + 8] : 0.f;
    const unsigned char* q_w = q_s + wg * 64 * 128;
    const unsigned char* do_w = do_s + wg * 64 * 128;

    float a0[64], a1[64];  // dQ columns 0-127 and 128-255
#pragma unroll
    for (int i = 0; i < 64; ++i) a0[i] = a1[i] = 0.f;
    hopper::mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kStages;
      const int key0 = it * BK;
      hopper::mbar_wait(full + st, (it / kStages) & 1);
      // A key tile wholly after the warpgroup's last row adds nothing.
      if (live && !(CAUSAL && key0 >= r0 + 64)) {
        const unsigned char* k_t = k_s + st * kTileK;
        const unsigned char* v_t = v_s + st * kTileK;
        float s[BK / 2], dp[BK / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          hopper::wgmma_m64n32k16_ss(s, desc_k(q_w, kBoxQ, kk), desc_k(k_t, kBoxK, kk), kk > 0);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          hopper::wgmma_m64n32k16_ss(dp, desc_k(do_w, kBoxQ, kk), desc_k(v_t, kBoxK, kk),
                                     kk > 0);
        hopper::wgmma_commit();

        // p = 2^(s * scale log2 e - lse log2 e), 0 for a key past S or
        // after the row, while dP is still on the tensor cores.
        hopper::wgmma_wait<1>();
        hopper::reg_fence(s);
        const bool edge = (CAUSAL && key0 + BK - 1 > r0) || key0 + BK > S;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(fmaf(s[4 * j + e], scale_log2, -(e & 2 ? lse1 : lse0)));
            const int key = key0 + 8 * j + 2 * t4 + (e & 1), row = row0 + 8 * (e >> 1);
            if (edge && (key >= S || (CAUSAL && key > row))) p = 0.f;
            s[4 * j + e] = p;
          }
        // ds = p * (dp - delta) * scale, rounded to bf16, then dQ += ds K.
        hopper::wgmma_wait<0>();
        hopper::reg_fence(dp);
        uint32_t ds[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int x = 8 * kk + 2 * i;
            const float dl = i & 1 ? dl1 : dl0;
            ds[kk][i] = pack_bf16(s[x] * (dp[x] - dl) * scale, s[x + 1] * (dp[x + 1] - dl) * scale);
          }
        hopper::reg_fence(a0);
        hopper::reg_fence(a1);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          hopper::wgmma_m64n128k16_rs_tb(
              a0, ds[kk], hopper::desc_sw128(k_t + kk * 16 * 128, kBoxK, 1024), 1);
          hopper::wgmma_m64n128k16_rs_tb(
              a1, ds[kk], hopper::desc_sw128(k_t + 2 * kBoxK + kk * 16 * 128, kBoxK, 1024), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(a0);
        hopper::reg_fence(a1);
      }
      if (lane == 0) hopper::mbar_arrive(empty + st);
    }

    if (live) {
      const size_t q_stride = (size_t)H * kD;
      bf16* dq_row = dq + ((size_t)b * S + row0) * q_stride + (size_t)h * kD;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * t4;
        if (row0 < S) {
          *reinterpret_cast<uint32_t*>(dq_row + col) = pack_bf16(a0[4 * j], a0[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(dq_row + 128 + col) = pack_bf16(a1[4 * j], a1[4 * j + 1]);
        }
        if (row0 + 8 < S) {
          *reinterpret_cast<uint32_t*>(dq_row + 8 * q_stride + col) =
              pack_bf16(a0[4 * j + 2], a0[4 * j + 3]);
          *reinterpret_cast<uint32_t*>(dq_row + 8 * q_stride + 128 + col) =
              pack_bf16(a1[4 * j + 2], a1[4 * j + 3]);
        }
      }
    }
  }
}

template <bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int B, int S, int H, int KV,
                   float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e = hopper::make_map(&mq, q, B, S, H, kD, BQ);
  if (e == cudaSuccess) e = hopper::make_map(&mk, k, B, S, KV, kD, BK);
  if (e == cudaSuccess) e = hopper::make_map(&mv, v, B, S, KV, kD, BK);
  if (e == cudaSuccess) e = hopper::make_map(&mdo, dout, B, S, H, kD, BQ);
  if (e != cudaSuccess) return e;
  auto kernel = flash_simple_dq_kernel<CAUSAL>;
  e = allow_smem(kernel, kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<head_grid((S + BQ - 1) / BQ, B * H), kThreads, kSmem, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dq), B, S, H, KV, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace wgdq

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, S, H, KV;
  float scale;
  cudaStream_t stream;
};

template <int DP, typename T, bool CAUSAL>
cudaError_t launch_fwd(const Args& a, void* o, float* lse) {
  if constexpr (sizeof(T) == 2) {  // bf16 (DP = 256): the wgmma kernel
    return wg256::launch<CAUSAL>(a.q, a.k, a.v, o, lse, a.B, a.S, a.H, a.KV, a.scale, a.stream);
  } else {
    using C = FwdCfg<DP>;
    auto kernel = flash_simple_fwd_kernel<DP, CAUSAL>;
    const dim3 grid = head_grid((a.S + C::BQ - 1) / C::BQ, a.B * a.H);
    cudaError_t e = allow_smem(kernel, C::kSmem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, C::kThreads, C::kSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(o), lse, a.B, a.S, a.H, a.KV,
        a.scale * kLog2e);
    return cudaGetLastError();
  }
}

template <int DP, typename T, bool CAUSAL>
cudaError_t launch_dq(const Args& a, void* dq) {
  if constexpr (sizeof(T) == 2) {  // bf16 (DP = 256): the wgmma kernel
    return wgdq::launch<CAUSAL>(a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.B, a.S, a.H, a.KV,
                                a.scale, a.stream);
  } else {
    using C = DqCfg<DP>;
    auto kernel = flash_simple_dq_kernel<DP, CAUSAL>;
    const dim3 grid = head_grid((a.S + C::BQ - 1) / C::BQ, a.B * a.H);
    cudaError_t e = allow_smem(kernel, C::kSmem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, C::kThreads, C::kSmem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(dq), a.B, a.S, a.H, a.KV, a.scale, a.scale * kLog2e);
    return cudaGetLastError();
  }
}

template <int DP, typename T, bool CAUSAL>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  using C = DkvCfg<DP, T>;
  auto kernel = flash_simple_dkv_kernel<DP, T, CAUSAL>;
  const dim3 grid = head_grid((a.S + C::BKEY - 1) / C::BKEY, a.B * a.KV);
  cudaError_t e = allow_smem(kernel, C::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, C::kThreads, C::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv),
      a.B, a.S, a.H, a.KV, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

// Dispatch over (dtype, DP, causal): fp32 at DP 32, 64, 128 and 256, bf16
// at DP 256 (bf16 at a head dim up to 128 goes to the wgmma kernels).
template <template <int, typename, bool> class F, typename... Xs>
cudaError_t dispatch(int dtype, int DP, int causal, const Args& a, Xs... xs) {
  if (dtype == 0) {
    switch (DP) {
      case 32: return causal ? F<32, float, true>::run(a, xs...) : F<32, float, false>::run(a, xs...);
      case 64: return causal ? F<64, float, true>::run(a, xs...) : F<64, float, false>::run(a, xs...);
      case 128: return causal ? F<128, float, true>::run(a, xs...) : F<128, float, false>::run(a, xs...);
      case 256: return causal ? F<256, float, true>::run(a, xs...) : F<256, float, false>::run(a, xs...);
    }
  } else if (dtype == 1 && DP == 256) {
    return causal ? F<256, bf16, true>::run(a, xs...) : F<256, bf16, false>::run(a, xs...);
  }
  return cudaErrorInvalidValue;
}

template <int DP, typename T, bool C> struct Fwd {
  static cudaError_t run(const Args& a, void* o, float* lse) { return launch_fwd<DP, T, C>(a, o, lse); }
};
template <int DP, typename T, bool C> struct Dq {
  static cudaError_t run(const Args& a, void* dq) { return launch_dq<DP, T, C>(a, dq); }
};
template <int DP, typename T, bool C> struct Dkv {
  static cudaError_t run(const Args& a, void* dk, void* dv) {
    return launch_dkv<DP, T, C>(a, dk, dv);
  }
};

bool valid(int B, int S, int H, int KV) {
  return B > 0 && S > 0 && KV > 0 && H % KV == 0 && (long long)B * H < (1ll << 31);
}

}  // namespace

extern "C" {

// q [B, S, H, DP], k/v [B, S, KV, DP] and o [B, S, H, DP], contiguous and
// 16-byte aligned, of dtype 0 (fp32) or 1 (bf16); lse fp32 [B, H, S].  DP
// (the padded head dim) is 32, 64, 128 or 256 in fp32 and 256 in bf16; KV
// divides H, and B * H is below 2^31.  Returns a cudaError_t.
int flash_simple_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                     int S, int H, int KV, int DP, float scale, int causal, int dtype,
                     void* stream) {
  if (!valid(B, S, H, KV)) return cudaErrorInvalidValue;
  const Args a{q, k, v, nullptr, nullptr, nullptr, B, S, H, KV, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(dtype, DP, causal, a, o, static_cast<float*>(lse));
}

// dq [B, S, H, DP] from q, k, v, dout and the fp32 [B, H, S] lse and delta.
int flash_simple_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int B, int S, int H, int KV,
                    int DP, float scale, int causal, int dtype, void* stream) {
  if (!valid(B, S, H, KV)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, S, H, KV, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Dq>(dtype, DP, causal, a, dq);
}

// dk and dv [B, S, KV, DP] (each GQA group's q heads summed), as
// flash_simple_dq.
int flash_simple_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
                     int KV, int DP, float scale, int causal, int dtype, void* stream) {
  if (!valid(B, S, H, KV)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, S, H, KV, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Dkv>(dtype, DP, causal, a, dk, dv);
}

const char* flash_simple_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
