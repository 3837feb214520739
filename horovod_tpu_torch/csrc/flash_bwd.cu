// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, each a
// warp-specialised kernel of wgmma products on TMA-fed tiles.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel`
// (horovod_tpu/ops/flash_attention.py:185, launched by `_flash_backward`
// at :300) and `_bwd_dkv_kernel` (:224, launched at :328).  Both recompute
// p = exp(s * scale - lse) from q, k and the forward's log-sum-exp, with
// delta = rowsum(dO * O) computed outside the kernels as in the JAX package:
//   dp = dO V^T,  ds = p * (dp - delta) * scale,
//   dQ = ds K,    dV = p^T dO,    dK = ds^T Q.
//
// What bounds them on the card: tensor-core operations.  At the Llama-2-7B
// training shape (B=1, S=4096, H=32, D=128, causal) `flash_bwd_dq` does
// three causal S x S x D products over 32 heads (206 GFLOP, 0.208 ms at
// 989 TFLOP/s) and `flash_bwd_dkv` four (275 GFLOP, 0.278 ms), against
// some 0.05 ms to read their inputs once at 3.35 TB/s.  On Hopper only
// `wgmma` reaches that rate, so both kernels take flash_fwd.cu's shape:
// - a CTA of three warpgroups: two consumer warpgroups of 64 rows each,
//   and a producer warpgroup of which one thread issues every load.  The
//   producer hands its registers to the consumers (`setmaxnreg`: 24
//   against 240 a thread);
// - TMA loads the CTA's resident tiles once and streams the others through
//   a ring of `mbarrier`-guarded stages: full (the bytes landed) and empty
//   (every consumer warp is done with the stage).  The maps are 4-D over
//   (D, heads, S, B), built on the host per launch, so a tile never
//   crosses a batch and GQA is a coordinate: q head h reads kv head
//   h / (H / KV).  Rows past S arrive as zeros.  The grid's y dimension
//   holds the (b, head) index up to 65535 and z continues it;
// - every tile in shared memory is a [rows, D] box with D contiguous, as
//   TMA lays it down.  The same tile is the K-major operand where a
//   product contracts over D (S, dP) and the MN-major one where it
//   contracts over rows (dQ, dK, dV), so no tensor is ever transposed, and
//   p and ds go from the score accumulators to the next product's A
//   fragments in registers, rounded to bf16, never through shared memory.
//
// flash_bwd_dq: one CTA per (128 query rows, b * H + h).  Q and dO stay in
// shared memory, each row's lse and delta in registers; 64-key K/V tiles
// stream through the ring up to the causal diagonal.  Per tile and
// warpgroup: S = Q K^T and dP = dO V^T (`wgmma.m64n64k16`, both operands
// in shared memory), ds in registers, dQ += ds K (`wgmma.m64n{D}k16`, K as
// the MN-major B).  dQ stays in fp32 registers and is written once.  The
// CTAs of the last query rows, which walk the most tiles, launch first.
//
// flash_bwd_dkv: one CTA per (128 keys, b * KV + g).  K and V stay in
// shared memory; 64-row Q and dO tiles, with their 64 lse and delta values
// (1-D bulk copies), stream through the ring while the CTA walks the
// group's H / KV q heads and, for each, the query tiles from the causal
// diagonal to S.  Per tile and warpgroup (64 keys), computed transposed:
// S^T = K Q^T and dP^T = V dO^T, both operands in shared memory; p^T and
// ds^T as register A fragments; dV += p^T dO and dK += ds^T Q with dO and
// Q as the MN-major B.  dK and dV (64 x D fp32 each a warpgroup) stay in
// registers across the whole group and are written once: deterministic,
// no atomics, as the Pallas kernel's per-group scratch accumulators.
//
// Numerics follow the Pallas kernels: fp32 scores; p = 2^(s * scale log2(e)
// - lse log2(e)) in one multiply-add and one `ex2.approx`; masked entries
// (the mask value -1e30) give p = 0; p is rounded to bf16 before dV and ds
// before dQ and dK.  Only the tile on the causal diagonal is masked; a
// tile wholly above it is skipped.
//
// S may be any length.  A warpgroup whose rows all lie past S computes
// and stores nothing; in a ragged one, rows past S are computed and never
// stored.  Their Q, dO, K and V rows arrive as zeros, and lse and delta
// come in rows of ld = S rounded up to 64 (the wrapper pads them with
// zeros when S % 64 != 0, so each 64-row tile is one aligned 16-byte bulk
// copy), so every such value stays finite and touches only its own row of
// an accumulator.  In flash_bwd_dq a ragged last key tile of a full
// (non-causal) launch gets p = 0 for its keys past S, which would otherwise
// add to every row's dQ; under the causal mask those keys lie after every
// row that is stored.  In flash_bwd_dkv keys are the accumulators' rows, so
// a key past S changes nothing that is stored, and a query past S (zero Q
// and dO rows, lse and delta 0) adds exactly 0 to dK and dV.
//
// What was tried on the card (NVIDIA H100 80GB HBM3, 700 W, 7B shape, dq /
// dkv ms; PERF.md): three-stage rings for both 0.414-0.418 / 0.567-0.574;
// two stages 0.412 / 0.529-0.530, four 0.408-0.410 / 0.576-0.578, so dq
// keeps four and dkv two; issuing the next tile's S and dP right behind
// this tile's dQ (or dK and dV) products was slower, 0.479-0.485 /
// 0.722-0.735; ping-pong turns between the two warpgroups, as flash_fwd
// takes them, gained nothing here (0.408-0.410 / 0.526-0.529) and are left
// out.  Neither the loads nor the exponential is the limit: leaving out
// every load after the ring fills gave 0.404 / 0.557, leaving out the
// `ex2` 0.388 / 0.513.
//
// Plain C entry points, bound from Python with ctypes: each launch goes on
// the stream it is handed, allocates nothing and returns the cudaError_t.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kWgRows = 64;                     // rows a consumer warpgroup
constexpr int BC = kWgRows * kConsumers;        // resident rows a CTA (128)
constexpr int BT = 64;                          // rows a streamed tile
constexpr int kDqStages = 4;                   // ring depths, tuned on the card
constexpr int kDkvStages = 2;
constexpr int kBoxC = 128 * BC;                 // a 64-column box of BC rows
constexpr int kBoxT = 128 * BT;                 // a 64-column box of BT rows

// flash_bwd_dq's shared memory: Q, dO (D / 64 boxes of 128 rows each),
// then K stages, then V stages (D / 64 boxes of 64 rows each), then the
// barriers.  1024 bytes of slack align the base.
template <int D> struct DqLayout {
  static constexpr int kRes = (D / 64) * kBoxC;
  static constexpr int kTile = (D / 64) * kBoxT;
  static constexpr int kK = 2 * kRes;
  static constexpr int kV = kK + kDqStages * kTile;
  static constexpr int kBar = kV + kDqStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kDqStages) + 1024;
};

// flash_bwd_dkv's: K, V (boxes of 128 rows), then Q stages and dO stages
// (boxes of 64 rows), then lse and delta stages (64 fp32 each), then the
// barriers.
template <int D> struct DkvLayout {
  static constexpr int kRes = (D / 64) * kBoxC;
  static constexpr int kTile = (D / 64) * kBoxT;
  static constexpr int kQ = 2 * kRes;
  static constexpr int kDO = kQ + kDkvStages * kTile;
  static constexpr int kLse = kDO + kDkvStages * kTile;
  static constexpr int kDelta = kLse + kDkvStages * BT * 4;
  static constexpr int kBar = kDelta + kDkvStages * BT * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kDkvStages) + 1024;
};

// Descriptor of k16 step kk of a K-major operand: rows from `tile` (a
// 64-row slice of boxes `box` bytes apart), k columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int box, int kk) {
  return hopper::desc_sw128(tile + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}
// Descriptor of k16 step kk of an MN-major operand: k rows 16 kk .. 16 kk
// + 15 of a tile of BT-row boxes, n the head dim.
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk) {
  return hopper::desc_sw128(tile + kk * 16 * 128, kBoxT, 1024);
}

// acc (+)= A . B over BT = 64 k rows, A the register fragments of a 64 x
// 64 score tile, B an MN-major tile of D columns.
template <int D>
__device__ __forceinline__ void wgmma_rs_d(float (&acc)[D / 2], const uint32_t (&a)[BT / 16][4],
                                           const unsigned char* tile) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    if constexpr (D == 128)
      hopper::wgmma_m64n128k16_rs_tb(acc, a[kk], desc_mn(tile, kk), 1);
    else
      hopper::wgmma_m64n64k16_rs_tb(acc, a[kk], desc_mn(tile, kk), 1);
  }
}

// The A fragments of a 64 x 64 tile's 4 k16 blocks, rounded to bf16.
__device__ __forceinline__ void to_frag(uint32_t (&a)[BT / 16][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Store a warpgroup's 64 x D fp32 accumulator as bf16 rows `stride`
// elements apart: this thread's rows r and r + 8, those below `rows`.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, const float (&acc)[D / 2],
                                           int r, int rows) {
  const int t4 = (threadIdx.x % 32) & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (r < rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * stride + col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < rows)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r + 8) * stride + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// lse and delta rows are ld = S rounded up to a streamed tile apart.
__device__ __forceinline__ int lse_ld(int S) { return (S + BT - 1) / BT * BT; }

template <int N> __device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,   // [B, S, H, D]
                    const __grid_constant__ CUtensorMap tm_k,   // [B, S, KV, D]
                    const __grid_constant__ CUtensorMap tm_v,   // [B, S, KV, D]
                    const __grid_constant__ CUtensorMap tm_do,  // [B, S, H, D]
                    const float* __restrict__ lse,              // [B, H, S]
                    const float* __restrict__ delta,            // [B, H, S]
                    bf16* __restrict__ dq,                      // [B, S, H, D]
                    int B, int S, int H, int KV, float scale, float scale_log2) {
  using L = DqLayout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kDqStages;
  unsigned char* q_s = smem;
  unsigned char* do_s = smem + L::kRes;
  unsigned char* k_s = smem + L::kK;
  unsigned char* v_s = smem + L::kV;

  const int n_q = (S + BC - 1) / BC;
  const int qi = CAUSAL ? n_q - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y + gridDim.y * blockIdx.z;
  if (bh >= B * H) return;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int n_t = (S + BT - 1) / BT;
  const int n_kv = CAUSAL ? min((qi * BC + BC - 1) / BT + 1, n_t) : n_t;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
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
      hopper::mbar_expect_tx(q_full, 2 * L::kRes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        hopper::tma_load_4d(q_s + x * kBoxC, &tm_q, q_full, 64 * x, h, qi * BC, b);
        hopper::tma_load_4d(do_s + x * kBoxC, &tm_do, q_full, 64 * x, h, qi * BC, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kDqStages;
        hopper::mbar_wait(empty + st, ((it / kDqStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full + st, 2 * L::kTile);
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          hopper::tma_load_4d(k_s + st * L::kTile + x * kBoxT, &tm_k, full + st, 64 * x, g,
                              it * BT, b);
          hopper::tma_load_4d(v_s + st * L::kTile + x * kBoxT, &tm_v, full + st, 64 * x, g,
                              it * BT, b);
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows r0 .. r0 + 63.
    hopper::reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, t4 = lane & 3;
    const int r0 = qi * BC + wg * kWgRows;
    const int rw = warp * 16 + gr;  // this thread's rows r0 + rw and r0 + rw + 8
    const bool live = r0 < S;

    float lse0 = 0.f, lse1 = 0.f, dl0 = 0.f, dl1 = 0.f;
    if (live) {
      const float* lse_row = lse + (size_t)bh * lse_ld(S) + r0 + rw;
      const float* dl_row = delta + (size_t)bh * lse_ld(S) + r0 + rw;
      lse0 = lse_row[0] * kLog2e;
      lse1 = lse_row[8] * kLog2e;
      dl0 = dl_row[0];
      dl1 = dl_row[8];
    }
    const unsigned char* q_w = q_s + wg * kWgRows * 128;
    const unsigned char* do_w = do_s + wg * kWgRows * 128;

    float acc[D / 2];
    zero(acc);
    hopper::mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kDqStages;
      const int key0 = it * BT;
      hopper::mbar_wait(full + st, (it / kDqStages) & 1);
      if (live && !(CAUSAL && key0 >= r0 + kWgRows)) {
        const unsigned char* k_t = k_s + st * L::kTile;
        const unsigned char* v_t = v_s + st * L::kTile;
        float s[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_m64n64k16_ss(s, desc_k(q_w, kBoxC, kk), desc_k(k_t, kBoxT, kk), kk > 0);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_m64n64k16_ss(dp, desc_k(do_w, kBoxC, kk), desc_k(v_t, kBoxT, kk),
                                     kk > 0);
        hopper::wgmma_commit();

        // p = 2^(s * scale log2 e - lse log2 e), 0 above the diagonal,
        // while dP is still on the tensor cores.
        hopper::wgmma_wait<1>();
        hopper::reg_fence(s);
        const bool diag = CAUSAL && key0 == r0;
        const bool ragged = !CAUSAL && key0 + BT > S;  // keys past S in this tile
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(fmaf(s[4 * j + e], scale_log2, -(e & 2 ? lse1 : lse0)));
            if (diag && 8 * j + 2 * t4 + (e & 1) > rw + 4 * (e & 2)) p = 0.f;
            if (ragged && key0 + 8 * j + 2 * t4 + (e & 1) >= S) p = 0.f;
            s[4 * j + e] = p;
          }
        // ds = p * (dp - delta) * scale, then dQ += ds K.
        hopper::wgmma_wait<0>();
        hopper::reg_fence(dp);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e & 2 ? dl1 : dl0)) * scale;
        uint32_t ds[BT / 16][4];
        to_frag(ds, dp);
        hopper::reg_fence(acc);
        hopper::wgmma_fence();
        wgmma_rs_d<D>(acc, ds, k_t);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(acc);
      }
      if (lane == 0) hopper::mbar_arrive(empty + st);
    }
    if (live)
      store_rows<D>(dq + ((size_t)b * S + r0) * H * D + (size_t)h * D, (size_t)H * D, acc, rw,
                    S - r0);
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,   // [B, S, H, D]
                     const __grid_constant__ CUtensorMap tm_k,   // [B, S, KV, D]
                     const __grid_constant__ CUtensorMap tm_v,   // [B, S, KV, D]
                     const __grid_constant__ CUtensorMap tm_do,  // [B, S, H, D]
                     const float* __restrict__ lse,              // [B, H, S]
                     const float* __restrict__ delta,            // [B, H, S]
                     bf16* __restrict__ dk,                      // [B, S, KV, D]
                     bf16* __restrict__ dv,                      // [B, S, KV, D]
                     int B, int S, int H, int KV, float scale, float scale_log2) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kDkvStages;
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + L::kRes;
  unsigned char* q_s = smem + L::kQ;
  unsigned char* do_s = smem + L::kDO;
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* dl_s = reinterpret_cast<float*>(smem + L::kDelta);

  const int ki = blockIdx.x;  // key blocks near 0 walk the most query tiles
  const int bg = blockIdx.y + gridDim.y * blockIdx.z;
  if (bg >= B * KV) return;
  const int b = bg / KV, g = bg - b * KV;
  const int rep = H / KV;
  const int lower = CAUSAL ? ki * BC / BT : 0;  // first query tile at or past the diagonal
  const int per_head = (S + BT - 1) / BT - lower;
  const int total = rep * per_head;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
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
      hopper::mbar_expect_tx(kv_full, 2 * L::kRes);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        hopper::tma_load_4d(k_s + x * kBoxC, &tm_k, kv_full, 64 * x, g, ki * BC, b);
        hopper::tma_load_4d(v_s + x * kBoxC, &tm_v, kv_full, 64 * x, g, ki * BC, b);
      }
      for (int it = 0; it < total; ++it) {
        const int st = it % kDkvStages;
        const int h = g * rep + it / per_head;
        const int q0 = (lower + it % per_head) * BT;
        hopper::mbar_wait(empty + st, ((it / kDkvStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full + st, 2 * L::kTile + 2 * BT * 4);
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          hopper::tma_load_4d(q_s + st * L::kTile + x * kBoxT, &tm_q, full + st, 64 * x, h, q0,
                              b);
          hopper::tma_load_4d(do_s + st * L::kTile + x * kBoxT, &tm_do, full + st, 64 * x, h,
                              q0, b);
        }
        const size_t row = ((size_t)b * H + h) * lse_ld(S) + q0;
        hopper::bulk_load(lse_s + st * BT, lse + row, BT * 4, full + st);
        hopper::bulk_load(dl_s + st * BT, delta + row, BT * 4, full + st);
      }
    }
  } else {
    // Consumer warpgroup wg: keys k0 .. k0 + 63.
    hopper::reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int gr = lane >> 2, t4 = lane & 3;
    const int k0 = ki * BC + wg * kWgRows;
    const int rw = warp * 16 + gr;  // this thread's keys k0 + rw and k0 + rw + 8
    const bool live = k0 < S;
    const unsigned char* k_w = k_s + wg * kWgRows * 128;
    const unsigned char* v_w = v_s + wg * kWgRows * 128;

    float dk_acc[D / 2], dv_acc[D / 2];
    zero(dk_acc);
    zero(dv_acc);
    hopper::mbar_wait(kv_full, 0);
    for (int it = 0; it < total; ++it) {
      const int st = it % kDkvStages;
      const int q0 = (lower + it % per_head) * BT;
      hopper::mbar_wait(full + st, (it / kDkvStages) & 1);
      if (live && !(CAUSAL && q0 + BT <= k0)) {
        const unsigned char* q_t = q_s + st * L::kTile;
        const unsigned char* do_t = do_s + st * L::kTile;
        const float* lse_t = lse_s + st * BT;
        const float* dl_t = dl_s + st * BT;
        float s[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_m64n64k16_ss(s, desc_k(k_w, kBoxC, kk), desc_k(q_t, kBoxT, kk), kk > 0);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_m64n64k16_ss(dp, desc_k(v_w, kBoxC, kk), desc_k(do_t, kBoxT, kk),
                                     kk > 0);
        hopper::wgmma_commit();

        // p^T = 2^(s^T * scale log2 e - lse[query] log2 e), 0 where the
        // query precedes the key, while dP^T is on the tensor cores.
        hopper::wgmma_wait<1>();
        hopper::reg_fence(s);
        const bool diag = CAUSAL && q0 == k0;
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(fmaf(s[4 * j + e], scale_log2, -(e & 1 ? l.y : l.x) * kLog2e));
            if (diag && 8 * j + 2 * t4 + (e & 1) < rw + 4 * (e & 2)) p = 0.f;
            s[4 * j + e] = p;
          }
        }
        // ds^T = p^T * (dp^T - delta[query]) * scale; then dV += p^T dO
        // and dK += ds^T Q.
        hopper::wgmma_wait<0>();
        hopper::reg_fence(dp);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
          const float2 d = *reinterpret_cast<const float2*>(dl_t + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e & 1 ? d.y : d.x)) * scale;
        }
        uint32_t pa[BT / 16][4], ds[BT / 16][4];
        to_frag(pa, s);
        to_frag(ds, dp);
        hopper::reg_fence(dv_acc);
        hopper::reg_fence(dk_acc);
        hopper::wgmma_fence();
        wgmma_rs_d<D>(dv_acc, pa, do_t);
        wgmma_rs_d<D>(dk_acc, ds, q_t);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(dv_acc);
        hopper::reg_fence(dk_acc);
      }
      if (lane == 0) hopper::mbar_arrive(empty + st);
    }
    if (live) {
      const size_t stride = (size_t)KV * D;
      const size_t off = ((size_t)b * S + k0) * stride + (size_t)g * D;
      store_rows<D>(dk + off, stride, dk_acc, rw, S - k0);
      store_rows<D>(dv + off, stride, dv_acc, rw, S - k0);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, S, H, KV;
  float scale;
  cudaStream_t stream;
};

// The four maps of a launch: q and dO with boxes of `q_rows`, k and v with
// boxes of `kv_rows`.
cudaError_t make_maps(const Args& a, int D, int q_rows, int kv_rows, CUtensorMap* mq,
                      CUtensorMap* mk, CUtensorMap* mv, CUtensorMap* mdo) {
  cudaError_t e = hopper::make_map(mq, a.q, a.B, a.S, a.H, D, q_rows);
  if (e == cudaSuccess) e = hopper::make_map(mk, a.k, a.B, a.S, a.KV, D, kv_rows);
  if (e == cudaSuccess) e = hopper::make_map(mv, a.v, a.B, a.S, a.KV, D, kv_rows);
  if (e == cudaSuccess) e = hopper::make_map(mdo, a.dout, a.B, a.S, a.H, D, q_rows);
  return e;
}

template <int D, bool CAUSAL>
cudaError_t launch_dq(const Args& a, bf16* dq) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e = make_maps(a, D, BC, BT, &mq, &mk, &mv, &mdo);
  if (e != cudaSuccess) return e;
  auto kernel = flash_bwd_dq_kernel<D, CAUSAL>;
  const size_t smem = DqLayout<D>::kBytes;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<head_grid((a.S + BC - 1) / BC, a.B * a.H), kThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, dq, a.B, a.S, a.H, a.KV, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkv(const Args& a, bf16* dk, bf16* dv) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e = make_maps(a, D, BT, BC, &mq, &mk, &mv, &mdo);
  if (e != cudaSuccess) return e;
  auto kernel = flash_bwd_dkv_kernel<D, CAUSAL>;
  const size_t smem = DkvLayout<D>::kBytes;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<head_grid((a.S + BC - 1) / BC, a.B * a.KV), kThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, dk, dv, a.B, a.S, a.H, a.KV, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

bool valid(int B, int S, int H, int KV, int D) {
  return B > 0 && S > 0 && KV > 0 && H % KV == 0 && (long long)B * H < (1ll << 31) &&
         (D == 64 || D == 128);
}

}  // namespace

extern "C" {

// bf16 q, dout, dq [B, S, H, D] and k, v [B, S, KV, D], contiguous and
// 16-byte aligned; lse and delta fp32 [B, H, ld] with ld = S rounded up to
// 64 (zeros past S), 16-byte aligned.  D is 64 or 128, KV divides H, and
// B * H is below 2^31.  Returns a cudaError_t.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int B, int S, int H, int KV, int D, float scale,
                 int causal, void* stream) {
  if (!valid(B, S, H, KV, D)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, S, H, KV, scale, static_cast<cudaStream_t>(stream)};
  bf16* o = static_cast<bf16*>(dq);
  if (D == 128) return causal ? launch_dq<128, true>(a, o) : launch_dq<128, false>(a, o);
  return causal ? launch_dq<64, true>(a, o) : launch_dq<64, false>(a, o);
}

// As flash_bwd_dq, writing dk and dv [B, S, KV, D] (each GQA group's q
// heads summed).
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
                  int KV, int D, float scale, int causal, void* stream) {
  if (!valid(B, S, H, KV, D)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, S, H, KV, scale, static_cast<cudaStream_t>(stream)};
  bf16* ok = static_cast<bf16*>(dk);
  bf16* ov = static_cast<bf16*>(dv);
  if (D == 128)
    return causal ? launch_dkv<128, true>(a, ok, ov) : launch_dkv<128, false>(a, ok, ov);
  return causal ? launch_dkv<64, true>(a, ok, ov) : launch_dkv<64, false>(a, ok, ov);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
