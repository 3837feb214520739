// Flash-attention forward for Hopper (sm_90a): wgmma on TMA-fed tiles,
// warp-specialised.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (horovod_tpu/ops/flash_attention.py:85, launched by `_flash_forward`
// at :157): exact causal or full attention with an online softmax over K/V
// blocks, writing O and a per-row fp32 log-sum-exp for the backward.
//
// What bounds it on the card: tensor-core operations.  At the Llama-2-7B
// training shape (B=1, S=4096, H=32, D=128, causal) a launch does two
// causal S x S x D products over 32 heads, 137 GFLOP, 0.139 ms at the bf16
// dense peak (989 TFLOP/s), while q, k, v and O are 134 MB, 0.040 ms at
// 3.35 TB/s.  On Hopper only `wgmma` reaches that rate, so the design is
// the one the card is built for:
// - a CTA of three warpgroups covers 128 query rows of one (b, h): two
//   consumer warpgroups of 64 rows each, and a producer warpgroup of which
//   one thread issues every load.  The producer hands its registers to the
//   consumers (`setmaxnreg`: 24 against 240 a thread);
// - TMA loads Q once and 128-key K and V tiles into a ring of three
//   stages (32 KB for Q and 3 x 64 KB for K/V at D = 128: one CTA an SM),
//   guarded by `mbarrier`s: full (the tile's bytes landed) and empty (every
//   consumer warp is done with the stage).  The maps are 4-D over (D,
//   heads, S, B), built on the host per launch, so a tile never crosses a
//   batch and GQA is a coordinate: q head h reads kv head h / (H / KV).
//   Rows past S arrive as zeros, so S may be any length: a ragged last key
//   tile is masked and rows past S are not stored;
// - S = Q K^T is `wgmma.m64n128k16` with both operands in shared memory
//   (K-major descriptors); O += P V is `wgmma.m64n{D}k16` with P from
//   registers, rounded to bf16 straight from the S accumulator, and V in
//   shared memory as the transposed (MN-major) operand: neither P nor a
//   transposed V ever touches shared memory.  Each K/V tile is read from
//   shared memory once per 64-row warpgroup, against once per 16-row warp
//   with mma.sync, and loads never occupy the consumers' issue slots;
// - the softmax is kept off the tensor cores' critical path twice over
//   (as FlashAttention-3 does): within a warpgroup, S(it + 1) and
//   P(it) V(it) are issued together and the softmax of S(it + 1) runs while
//   they execute; between the two warpgroups, named barriers make them take
//   turns to issue (ping-pong), so one's softmax overlaps the other's
//   products.  The softmax takes the row max of the unscaled scores and
//   computes p = 2^(s * scale - m) with one multiply-add and one
//   `ex2.approx` each;
// - causal: the key loop stops at the diagonal tile and masks only it;
//   CTAs of the last query tiles, which walk the most K/V tiles, are
//   launched first so the short ones fill the tail.  The grid's y
//   dimension holds b * H + h up to 65535 and z continues it, so any B * H
//   is one launch;
// - numerics follow the Pallas kernel: scores in fp32, base-2
//   exponentials with log2(e) folded into the scale, the mask value -1e30,
//   p rounded to bf16 before P.V while the row sum l takes the fp32 p, and
//   lse = m ln 2 + log(max(l, 1e-30)).
//
// What was tried on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the
// same products with both warpgroups in lockstep and a two-stage ring took
// 0.37 ms at the 7B shape; issuing S(it + 1) early with only two stages
// was slower (it waited on a load that had just begun); three stages and
// ping-pong 0.33 ms; the fused multiply-add and `ex2.approx` softmax 0.26.

// Plain C entry point, bound from Python with ctypes: the launch goes on
// the stream it is handed, allocates nothing and returns the cudaError_t.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

constexpr int kConsumers = 2;                   // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int BQ = 64 * kConsumers;             // query rows a CTA
constexpr int BK = 128;                         // keys a K/V tile
constexpr int kStages = 3;
constexpr int kBoxBytes = 128 * 128;            // a 64-column box of 128 rows
static_assert(BQ == 128 && BK == 128, "Q, K and V tiles share one box shape");

// Shared memory: Q, then K stage 0..kStages-1, then V stages, each a tile
// of D / 64 boxes; then the barriers.  1024 bytes of slack align the base.
template <int D> struct Layout {
  static constexpr int kTile = (D / 64) * kBoxBytes;
  static constexpr int kBar = kTile * (1 + 2 * kStages);
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,  // [B, S, H, D]
                 const __grid_constant__ CUtensorMap tm_k,  // [B, S, KV, D]
                 const __grid_constant__ CUtensorMap tm_v,  // [B, S, KV, D]
                 bf16* __restrict__ o,                      // [B, S, H, D]
                 float* __restrict__ lse,                   // [B, H, S]
                 int B, int S, int H, int KV, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + kStages;
  uint64_t* empty = bar + 1 + 2 * kStages;
  unsigned char* q_s = smem;
  unsigned char* k_s = smem + L::kTile;
  unsigned char* v_s = smem + L::kTile * (1 + kStages);

  const int n_q = (S + BQ - 1) / BQ;
  const int qi = CAUSAL ? n_q - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh >= B * H) return;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int n_k = (S + BK - 1) / BK;
  const int n_kv = CAUSAL ? min(qi + 1, n_k) : n_k;
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
      hopper::mbar_expect_tx(q_full, L::kTile);
#pragma unroll
      for (int x = 0; x < D / 64; ++x)
        hopper::tma_load_4d(q_s + x * kBoxBytes, &tm_q, q_full, 64 * x, h, qi * BQ, b);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        hopper::mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(k_full + st, L::kTile);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          hopper::tma_load_4d(k_s + st * L::kTile + x * kBoxBytes, &tm_k, k_full + st, 64 * x,
                              g, it * BK, b);
        hopper::mbar_expect_tx(v_full + st, L::kTile);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          hopper::tma_load_4d(v_s + st * L::kTile + x * kBoxBytes, &tm_v, v_full + st, 64 * x,
                              g, it * BK, b);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows qi * BQ + 64 wg .. + 63.
    hopper::reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, t4 = lane & 3;
    const int row0 = qi * BQ + wg * 64 + warp * 16 + gr;  // and row0 + 8

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // running max (base 2) of rows row0, row0 + 8
    float l0 = 0.f, l1 = 0.f;          // this lane's part of the running sums

    // Software pipeline over the key tiles: while the tensor cores run
    // S(it + 1) = Q K(it + 1)^T and O += P(it) V(it), this warpgroup's
    // threads take the softmax of S(it + 1).  O is rescaled by tile
    // it + 1's alpha once P(it) V(it) has landed, just before P(it + 1)
    // V(it + 1) is issued.
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    auto issue_s = [&](int it) {
      const unsigned char* k_t = k_s + (it % kStages) * L::kTile;
      hopper::mbar_wait(k_full + it % kStages, (it / kStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        hopper::wgmma_m64n128k16_ss(s, hopper::desc_sw128(q_s + wg * 64 * 128 + off, 16, 1024),
                                    hopper::desc_sw128(k_t + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
    };
    auto issue_pv = [&](int it) {
      const unsigned char* v_t = v_s + (it % kStages) * L::kTile;
      hopper::mbar_wait(v_full + it % kStages, (it / kStages) & 1);
      hopper::reg_fence(oacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = hopper::desc_sw128(v_t + kk * 16 * 128, kBoxBytes, 1024);
        if constexpr (D == 128)
          hopper::wgmma_m64n128k16_rs_tb(oacc, pa[kk], dv, 1);
        else
          hopper::wgmma_m64n64k16_rs_tb(oacc, pa[kk], dv, 1);
      }
      hopper::wgmma_commit();
    };
    // Softmax of S(it) in place: mask the diagonal tile and keys past S,
    // update the running max (base 2) and sums, leave the fp32 p in s.
    // Returns the factors that rescale O for rows row0 and row0 + 8.
    auto softmax = [&](int it, float& alpha0, float& alpha1) {
      hopper::reg_fence(s);
      const int key0 = it * BK;
      if ((CAUSAL && it == qi) || key0 + BK > S) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = key0 + 8 * j + 2 * t4 + (e & 1);
            const int row = row0 + ((e >> 1) << 3);
            if (col >= S || (CAUSAL && col > row)) s[4 * j + e] = kNegInf;
          }
      }
      // The max of the unscaled scores (the scale is positive), then
      // p = 2^(s * scale_log2 - m) in one multiply-add each.
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
    // p rounded to bf16: the A fragments of keys 16 kk .. 16 kk + 15.
    auto to_pa = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    // Each warp releases the stage of tile it once its reads are done.
    auto release = [&](int it) {
      if (lane == 0) hopper::mbar_arrive(empty + it % kStages);
    };

    // Ping-pong: the two consumer warpgroups take turns to issue their
    // products (named barriers 1 and 2), so one's softmax runs while the
    // other's products keep the tensor cores busy.
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
      hopper::wgmma_wait<0>();  // P(it) V(it) has landed in oacc
      hopper::reg_fence(oacc);
      release(it);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= alpha0;
        oacc[4 * j + 1] *= alpha0;
        oacc[4 * j + 2] *= alpha1;
        oacc[4 * j + 3] *= alpha1;
      }
      to_pa();
    }
    turn_wait();
    issue_pv(n_kv - 1);
    if (wg == 0) turn_pass();  // warpgroup 1 took the first turn's pass
    hopper::wgmma_wait<0>();
    hopper::reg_fence(oacc);
    release(n_kv - 1);

    l0 = fmaxf(quad_sum(l0), 1e-30f);
    l1 = fmaxf(quad_sum(l1), 1e-30f);
    const float s0 = 1.f / l0, s1 = 1.f / l1;
    const size_t q_stride = (size_t)H * D;
    bf16* o_row = o + ((size_t)b * S + row0) * q_stride + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(o_row + col) =
            pack_bf16(oacc[4 * j] * s0, oacc[4 * j + 1] * s0);
      if (row0 + 8 < S)
        *reinterpret_cast<uint32_t*>(o_row + 8 * q_stride + col) =
            pack_bf16(oacc[4 * j + 2] * s1, oacc[4 * j + 3] * s1);
    }
    if (t4 == 0) {
      float* lse_row = lse + (size_t)bh * S;
      if (row0 < S) lse_row[row0] = m0 * kLn2 + logf(l0);
      if (row0 + 8 < S) lse_row[row0 + 8] = m1 * kLn2 + logf(l1);
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int H, int KV, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t e = hopper::make_map(&mq, q, B, S, H, D, BQ);
  if (e == cudaSuccess) e = hopper::make_map(&mk, k, B, S, KV, D, BK);
  if (e == cudaSuccess) e = hopper::make_map(&mv, v, B, S, KV, D, BK);
  if (e != cudaSuccess) return e;
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  const size_t smem = Layout<D>::kBytes;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<flash::head_grid((S + BQ - 1) / BQ, B * H), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, B, S, H, KV, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q [B, S, H, D], k/v [B, S, KV, D] and o [B, S, H, D], contiguous and
// 16-byte aligned; lse fp32 [B, H, S].  D is 64 or 128, KV divides H, and
// B * H is below 2^31.  Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
              int H, int KV, int D, float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || (long long)B * H >= (1ll << 31))
    return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return causal ? launch<128, true>(q, k, v, o, l, B, S, H, KV, scale, s)
                  : launch<128, false>(q, k, v, o, l, B, S, H, KV, scale, s);
  if (D == 64)
    return causal ? launch<64, true>(q, k, v, o, l, B, S, H, KV, scale, s)
                  : launch<64, false>(q, k, v, o, l, B, S, H, KV, scale, s);
  return cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
