// Flash-attention forward for Hopper (sm_90a).
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
// 3.35 TB/s.  So the products run on the tensor cores from this first
// version (mma.sync m16n8k16, bf16 operands, fp32 accumulators) and every
// K/V block is read from device memory once per CTA, through shared memory.
//
// Design, redesigned for the card rather than carried over block by block:
// - one CTA of 4 warps per (query block of 64 rows, b * H + h); each warp
//   owns 16 query rows and keeps their Q fragments, the O accumulator and
//   the running max and sum in registers.  The TPU kernel's K/V loop
//   (`fori_loop` over blocks of a VMEM-resident sequence) becomes a loop
//   over 64-row K/V tiles staged in shared memory, two stages deep: the
//   next tile's 16-byte `cp.async` copies are in flight while this one is
//   computed;
// - causal: the loop stops at the diagonal block, ((qi+1)*BQ-1)//BK + 1,
//   and only that block is masked (-1e30, as the Pallas kernel); CTAs of
//   the last query blocks, which walk the most K/V tiles, are launched
//   first so the short ones fill the tail;
// - GQA-native: q head h reads kv head h / (H / KV); q, k, v and O are read
//   in their [B, S, heads, D] layout by strides, with no transposed copy;
// - numerics follow the Pallas kernel: the fp32 score is scaled, p is
//   rounded to bf16 before P.V, the row sum l takes the fp32 p, and
//   lse = m + log(max(l, 1e-30)).  Exponentials run base 2 with log2(e)
//   folded into the scale.
//
// Plain C entry point, bound from Python with ctypes: the launch goes on
// the stream it is handed, allocates nothing and returns the cudaError_t.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;  // 4 warps
constexpr int BQ = 64;         // query rows per CTA, 16 per warp
constexpr int BK = 64;         // key rows per tile

template <int D> constexpr size_t fwd_smem() { return (size_t)(BQ + 4 * BK) * D * sizeof(bf16); }

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q,  // [B, S, H, D]
                 const bf16* __restrict__ k,  // [B, S, KV, D]
                 const bf16* __restrict__ v,  // [B, S, KV, D]
                 bf16* __restrict__ o,        // [B, S, H, D]
                 float* __restrict__ lse,     // [B, H, S]
                 int S, int H, int KV, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + BQ * D;  // stage s: K at 2s, V at 2s + 1
  constexpr int kTile = BK * D;

  const int n_q = S / BQ;
  const int qi = CAUSAL ? n_q - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KV * D;
  const bf16* q_blk = q + ((size_t)b * S + (size_t)qi * BQ) * q_stride + (size_t)h * D;
  const bf16* k_base = k + (size_t)b * S * kv_stride + (size_t)g * D;
  const bf16* v_base = v + (size_t)b * S * kv_stride + (size_t)g * D;

  const int n_kv = CAUSAL ? min(((qi + 1) * BQ - 1) / BK + 1, S / BK) : S / BK;

  load_tile<BQ, D, kThreads>(q_s, q_blk, q_stride);
  load_tile<BK, D, kThreads>(kv_s, k_base, kv_stride);
  load_tile<BK, D, kThreads>(kv_s + kTile, v_base, kv_stride);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (base 2) of rows gr, gr + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's part of the running sums
  const int row0 = qi * BQ + warp * 16 + gr;

  for (int kb = 0; kb < n_kv; ++kb) {
    if (kb + 1 < n_kv) {
      bf16* nxt = kv_s + 2 * ((kb + 1) & 1) * kTile;
      load_tile<BK, D, kThreads>(nxt, k_base + (size_t)(kb + 1) * BK * kv_stride, kv_stride);
      load_tile<BK, D, kThreads>(nxt + kTile, v_base + (size_t)(kb + 1) * BK * kv_stride,
                                 kv_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a<D>(qf[kk], q_s, warp * 16, kk);
    }
    const bf16* k_s = kv_s + 2 * (kb & 1) * kTile;
    const bf16* v_s = k_s + kTile;

    // s = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jn = 0; jn < BK / 16; ++jn) {
        uint32_t bfr[4];
        load_b_rows_n<D>(bfr, k_s, 16 * jn, kk);
        mma(s[2 * jn], qf[kk], bfr[0], bfr[1]);
        mma(s[2 * jn + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // Scale (base 2), mask the diagonal block, update the running max.
    const bool masked = CAUSAL && (kb + 1) * BK - 1 > qi * BQ;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int col = kb * BK + 8 * j + 2 * t4 + (e & 1);
          const int row = row0 + ((e >> 1) << 3);
          if (col > row) x = kNegInf;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // acc += P V, p rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bfr[4];
        load_b_rows_k<D>(bfr, v_s, kk, 16 * dn);
        mma(acc[2 * dn], pa, bfr[0], bfr[1]);
        mma(acc[2 * dn + 1], pa, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  bf16* o_rows = o + ((size_t)b * S + row0 - gr) * q_stride + (size_t)h * D;
  store_rows<D>(o_rows, q_stride, acc, 1.f / l0, 1.f / l1);
  if (t4 == 0) {
    float* lse_row = lse + (size_t)bh * S;
    lse_row[row0] = m0 * kLn2 + logf(l0);
    lse_row[row0 + 8] = m1 * kLn2 + logf(l1);
  }
}

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int H, int KV, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, CAUSAL>;
  const size_t smem = fwd_smem<D>();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(S / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, S, H, KV, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q [B, S, H, D], k/v [B, S, KV, D] and o [B, S, H, D], contiguous and
// 16-byte aligned; lse fp32 [B, H, S].  D is 64 or 128, S a multiple of 64,
// KV divides H.  Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
              int H, int KV, int D, float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || S % BQ != 0 || S % BK != 0 || KV <= 0 || H % KV != 0 ||
      B * H > 65535)
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
