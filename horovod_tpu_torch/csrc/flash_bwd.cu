// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV.
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
// some 0.05 ms to read their inputs once at 3.35 TB/s.  So every product
// runs on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulators), fed from tiles staged in shared memory two stages deep
// with 16-byte `cp.async` copies.
//
// Design:
// - flash_bwd_dq: one CTA of 4 warps per (query block of 64 rows, b*H + h),
//   as the forward: Q and dO tiles stay in shared memory, the loop walks
//   64-row K/V tiles up to the causal diagonal, ((qi+1)*BQ-1)//BK + 1, and
//   each warp keeps its 16 rows of dQ in fp32 registers.  The longest CTAs
//   (last query blocks) are launched first.
// - flash_bwd_dkv: one CTA of 4 warps per (key block of 64 rows, b*KV + g).
//   K and V stay in shared memory; each warp keeps dK and dV of its 16 keys
//   in fp32 registers while the CTA walks the group's H / KV q heads and,
//   for each, the 32-row query blocks from the causal diagonal,
//   (ki*BK)//32, to the end.  The whole GQA group is summed in one CTA and
//   written once: deterministic, no atomics, as the Pallas kernel's
//   per-group scratch accumulators.  The products are computed transposed
//   (s^T = K Q^T), so p^T and ds^T come straight out of the C fragments as
//   the A operands of dV += p^T dO and dK += ds^T Q.
// - q head h reads kv head h / (H / KV); all tensors are read in their
//   [B, S, heads, D] layout by strides; lse and delta are fp32 [B, H, S].
// - numerics follow the Pallas kernels: the fp32 score is scaled, masked
//   entries are -1e30 (p = 0), p is rounded to bf16 before dV, ds to bf16
//   before dQ and dK.  Exponentials run base 2 with log2(e) folded in.
//
// Plain C entry points, bound from Python with ctypes: each launch goes on
// the stream it is handed, allocates nothing and returns the cudaError_t.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int BQ = 64;         // dq: query rows per CTA
constexpr int BK = 64;         // dq: key rows per tile; dkv: key rows per CTA
constexpr int BQ2 = 32;        // dkv: query rows per tile

template <int D> constexpr size_t dq_smem() { return (size_t)(2 * BQ + 4 * BK) * D * sizeof(bf16); }
template <int D> constexpr size_t dkv_smem() {
  return (size_t)(2 * BK + 4 * BQ2) * D * sizeof(bf16) + 4 * BQ2 * sizeof(float);
}

template <int N> __device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q,      // [B, S, H, D]
                    const bf16* __restrict__ k,      // [B, S, KV, D]
                    const bf16* __restrict__ v,      // [B, S, KV, D]
                    const bf16* __restrict__ dout,   // [B, S, H, D]
                    const float* __restrict__ lse,   // [B, H, S]
                    const float* __restrict__ delta, // [B, H, S]
                    bf16* __restrict__ dq,           // [B, S, H, D]
                    int S, int H, int KV, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + BQ * D;
  bf16* kv_s = do_s + BQ * D;  // stage s: K at 2s, V at 2s + 1
  constexpr int kTile = BK * D;

  const int n_q = S / BQ;
  const int qi = CAUSAL ? n_q - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KV * D;
  const size_t q_off = ((size_t)b * S + (size_t)qi * BQ) * q_stride + (size_t)h * D;
  const bf16* k_base = k + (size_t)b * S * kv_stride + (size_t)g * D;
  const bf16* v_base = v + (size_t)b * S * kv_stride + (size_t)g * D;
  const int n_kv = CAUSAL ? min(((qi + 1) * BQ - 1) / BK + 1, S / BK) : S / BK;

  load_tile<BQ, D, kThreads>(q_s, q + q_off, q_stride);
  load_tile<BQ, D, kThreads>(do_s, dout + q_off, q_stride);
  load_tile<BK, D, kThreads>(kv_s, k_base, kv_stride);
  load_tile<BK, D, kThreads>(kv_s + kTile, v_base, kv_stride);
  cp_async_commit();

  const int row0 = qi * BQ + warp * 16 + gr;
  const float* lse_row = lse + (size_t)bh * S;
  const float* dl_row = delta + (size_t)bh * S;
  const float lse0 = lse_row[row0] * kLog2e, lse1 = lse_row[row0 + 8] * kLog2e;
  const float dl0 = dl_row[row0], dl1 = dl_row[row0 + 8];

  float acc[D / 8][4];
  zero(acc);

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
    const bf16* k_s = kv_s + 2 * (kb & 1) * kTile;
    const bf16* v_s = k_s + kTile;

    // s = Q K^T and dp = dO V^T for this warp's 16 rows and 64 keys.
    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<D>(qa, q_s, warp * 16, kk);
      load_a<D>(da, do_s, warp * 16, kk);
#pragma unroll
      for (int jn = 0; jn < BK / 16; ++jn) {
        uint32_t kb4[4], vb4[4];
        load_b_rows_n<D>(kb4, k_s, 16 * jn, kk);
        load_b_rows_n<D>(vb4, v_s, 16 * jn, kk);
        mma(s[2 * jn], qa, kb4[0], kb4[1]);
        mma(s[2 * jn + 1], qa, kb4[2], kb4[3]);
        mma(dp[2 * jn], da, vb4[0], vb4[1]);
        mma(dp[2 * jn + 1], da, vb4[2], vb4[3]);
      }
    }

    // p = exp(s * scale - lse), masked to 0; ds = p * (dp - delta) * scale.
    const bool masked = CAUSAL && (kb + 1) * BK - 1 > qi * BQ;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int col = kb * BK + 8 * j + 2 * t4 + (e & 1);
          if (col > row0 + (hi ? 8 : 0)) x = kNegInf;
        }
        const float p = exp2f(x - (hi ? lse1 : lse0));
        dp[j][e] = p * (dp[j][e] - (hi ? dl1 : dl0)) * scale;
      }
    }

    // dQ += ds K, ds rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bfr[4];
        load_b_rows_k<D>(bfr, k_s, kk, 16 * dn);
        mma(acc[2 * dn], a, bfr[0], bfr[1]);
        mma(acc[2 * dn + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  store_rows<D>(dq + q_off + (size_t)warp * 16 * q_stride, q_stride, acc, 1.f, 1.f);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q,      // [B, S, H, D]
                     const bf16* __restrict__ k,      // [B, S, KV, D]
                     const bf16* __restrict__ v,      // [B, S, KV, D]
                     const bf16* __restrict__ dout,   // [B, S, H, D]
                     const float* __restrict__ lse,   // [B, H, S]
                     const float* __restrict__ delta, // [B, H, S]
                     bf16* __restrict__ dk,           // [B, S, KV, D]
                     bf16* __restrict__ dv,           // [B, S, KV, D]
                     int S, int H, int KV, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQTile = BQ2 * D;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + BK * D;
  bf16* qd_s = v_s + BK * D;  // stage s: Q at 2s, dO at 2s + 1
  float* f_s = reinterpret_cast<float*>(qd_s + 4 * kQTile);  // stage s: lse at 2s, delta at 2s + 1

  const int ki = blockIdx.x;  // key blocks near 0 walk the most query blocks
  const int bg = blockIdx.y;
  const int b = bg / KV, g = bg - b * KV;
  const int rep = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KV * D;
  const size_t kv_off = ((size_t)b * S + (size_t)ki * BK) * kv_stride + (size_t)g * D;
  const int lower = CAUSAL ? (ki * BK) / BQ2 : 0;
  const int per_head = S / BQ2 - lower;
  const int total = rep * per_head;

  // Stage the Q, dO, lse and delta of step `it` (q head g*rep + it/per_head,
  // query block lower + it % per_head) into stage `st`.
  auto stage = [&](int it, int st) {
    const int h = g * rep + it / per_head;
    const int qb = lower + it % per_head;
    const size_t off = ((size_t)b * S + (size_t)qb * BQ2) * q_stride + (size_t)h * D;
    load_tile<BQ2, D, kThreads>(qd_s + 2 * st * kQTile, q + off, q_stride);
    load_tile<BQ2, D, kThreads>(qd_s + (2 * st + 1) * kQTile, dout + off, q_stride);
    const size_t row = ((size_t)b * H + h) * S + (size_t)qb * BQ2;
    load_f32<kThreads>(f_s + 2 * st * BQ2, lse + row, BQ2);
    load_f32<kThreads>(f_s + (2 * st + 1) * BQ2, delta + row, BQ2);
  };

  load_tile<BK, D, kThreads>(k_s, k + kv_off, kv_stride);
  load_tile<BK, D, kThreads>(v_s, v + kv_off, kv_stride);
  stage(0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int key0 = ki * BK + warp * 16 + gr;  // keys key0 and key0 + 8

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      stage(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const bf16* q_s = qd_s + 2 * st * kQTile;
    const bf16* do_s = q_s + kQTile;
    const float* lse_s = f_s + 2 * st * BQ2;
    const float* dl_s = lse_s + BQ2;
    const int q0 = (lower + it % per_head) * BQ2;

    // s^T = K Q^T and dp^T = V dO^T for this warp's 16 keys and 32 queries.
    float sT[BQ2 / 8][4], dpT[BQ2 / 8][4];
    zero(sT);
    zero(dpT);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<D>(ka, k_s, warp * 16, kk);
      load_a<D>(va, v_s, warp * 16, kk);
#pragma unroll
      for (int jn = 0; jn < BQ2 / 16; ++jn) {
        uint32_t qb4[4], db4[4];
        load_b_rows_n<D>(qb4, q_s, 16 * jn, kk);
        load_b_rows_n<D>(db4, do_s, 16 * jn, kk);
        mma(sT[2 * jn], ka, qb4[0], qb4[1]);
        mma(sT[2 * jn + 1], ka, qb4[2], qb4[3]);
        mma(dpT[2 * jn], va, db4[0], db4[1]);
        mma(dpT[2 * jn + 1], va, db4[2], db4[3]);
      }
    }

    // p^T = exp(s^T * scale - lse[query]), masked to 0 where query < key;
    // ds^T = p^T * (dp^T - delta[query]) * scale.  sT keeps p^T.
    const bool masked = CAUSAL && q0 < ki * BK + BK - 1;
#pragma unroll
    for (int j = 0; j < BQ2 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        float x = sT[j][e] * scale_log2;
        if (masked && q0 + c < key0 + ((e >> 1) << 3)) x = kNegInf;
        const float p = exp2f(x - lse_s[c] * kLog2e);
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - dl_s[c]) * scale;
      }
    }

    // dV += p^T dO (p^T rounded to bf16); dK += ds^T Q (ds^T rounded).
#pragma unroll
    for (int kk = 0; kk < BQ2 / 16; ++kk) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
      c_to_a(sa, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t db4[4], qb4[4];
        load_b_rows_k<D>(db4, do_s, kk, 16 * dn);
        load_b_rows_k<D>(qb4, q_s, kk, 16 * dn);
        mma(dv_acc[2 * dn], pa, db4[0], db4[1]);
        mma(dv_acc[2 * dn + 1], pa, db4[2], db4[3]);
        mma(dk_acc[2 * dn], sa, qb4[0], qb4[1]);
        mma(dk_acc[2 * dn + 1], sa, qb4[2], qb4[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const size_t out = kv_off + (size_t)warp * 16 * kv_stride;
  store_rows<D>(dk + out, kv_stride, dk_acc, 1.f, 1.f);
  store_rows<D>(dv + out, kv_stride, dv_acc, 1.f, 1.f);
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, S, H, KV;
  float scale;
  cudaStream_t stream;
};

template <int D, bool CAUSAL>
cudaError_t launch_dq(const Args& a, bf16* dq) {
  auto kernel = flash_bwd_dq_kernel<D, CAUSAL>;
  cudaError_t e = allow_smem(kernel, dq_smem<D>());
  if (e != cudaSuccess) return e;
  dim3 grid(a.S / BQ, a.B * a.H);
  kernel<<<grid, kThreads, dq_smem<D>(), a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, dq,
                                                     a.S, a.H, a.KV, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkv(const Args& a, bf16* dk, bf16* dv) {
  auto kernel = flash_bwd_dkv_kernel<D, CAUSAL>;
  cudaError_t e = allow_smem(kernel, dkv_smem<D>());
  if (e != cudaSuccess) return e;
  dim3 grid(a.S / BK, a.B * a.KV);
  kernel<<<grid, kThreads, dkv_smem<D>(), a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, dk,
                                                      dv, a.S, a.H, a.KV, a.scale,
                                                      a.scale * kLog2e);
  return cudaGetLastError();
}

bool valid(int B, int S, int H, int KV, int D) {
  return B > 0 && S > 0 && S % BQ == 0 && S % BK == 0 && KV > 0 && H % KV == 0 &&
         B * H <= 65535 && (D == 64 || D == 128);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, int B, int S, int H, int KV, float scale, void* stream) {
  return Args{static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
              static_cast<const bf16*>(v),     static_cast<const bf16*>(dout),
              static_cast<const float*>(lse),  static_cast<const float*>(delta),
              B, S, H, KV, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// bf16 q, dout, dq [B, S, H, D] and k, v [B, S, KV, D], contiguous and
// 16-byte aligned; lse and delta fp32 [B, H, S].  D is 64 or 128, S a
// multiple of 64, KV divides H.  Returns a cudaError_t.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int B, int S, int H, int KV, int D, float scale,
                 int causal, void* stream) {
  if (!valid(B, S, H, KV, D)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, H, KV, scale, stream);
  bf16* o = static_cast<bf16*>(dq);
  if (D == 128) return causal ? launch_dq<128, true>(a, o) : launch_dq<128, false>(a, o);
  return causal ? launch_dq<64, true>(a, o) : launch_dq<64, false>(a, o);
}

// As flash_bwd_dq, writing dk and dv [B, S, KV, D] (each GQA group's q
// heads summed).
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
                  int KV, int D, float scale, int causal, void* stream) {
  if (!valid(B, S, H, KV, D) || B * KV > 65535) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, H, KV, scale, stream);
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
