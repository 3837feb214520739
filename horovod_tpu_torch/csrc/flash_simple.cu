// Flash attention on CUDA cores for what the wgmma kernels (flash_fwd.cu,
// flash_bwd.cu) do not take: fp32 inputs at any head dim up to 256, and
// bf16 inputs at a head dim above 128.  Three kernels, the forward and the
// two backward ones, each computed in fp32 throughout.
//
// Replaces the same Pallas TPU kernels as the wgmma kernels, at these
// dtypes and widths: `_fwd_kernel` (horovod_tpu/ops/flash_attention.py:85,
// launched at :157), `_bwd_dq_kernel` (:185, launched at :300) and
// `_bwd_dkv_kernel` (:224, launched at :328).  The Pallas kernels take any
// dtype and any head dim up to 256 (`supported`, :512); the JAX package's
// Llama configs train in fp32 (`LlamaConfig.tiny`, head dim 16) and bf16.
//
// fp32 is computed in fp32, with no TF32: PyTorch's own fp32 products on
// the card run in full fp32 by default (`allow_tf32` is False), and so does
// the JAX package's fp32 math on the CPU.  Hopper's tensor cores take fp32
// only as TF32 (10 mantissa bits), so these kernels run on the CUDA cores,
// 67 TFLOP/s of fp32 FMAs on an H100 SXM against 989 TFLOP/s of bf16
// wgmma.  What bounds them is that rate: at the Llama-2-7B training shape
// in fp32 (B=1, S=4096, H=32, D=128, causal) the forward's two causal
// S x S x D products are 137 GFLOP, 2.05 ms at 67 TFLOP/s, against 0.08 ms
// to move q, k, v and o once at 3.35 TB/s.  A 3xTF32 wgmma design (three
// TF32 products that recover fp32's precision) would be the faster route;
// it is later work.
//
// The design is the plain flash algorithm on tiles in shared memory:
// - every tile is 64 rows (queries or keys) by DP columns, fp32 in shared
//   memory, rows DP + 4 floats apart (16-byte aligned rows, and the 8
//   lanes of a 16-byte shared load land in 8 distinct bank quads);
// - a CTA of 256 threads (16 x 16) computes a 64 x 64 score tile, each
//   thread 4 rows (ty * 4 + i) by 4 columns (tx + 16 j), with float4 loads
//   along the head dim: 16 FMAs per 8 shared loads;
// - the score tile goes back to shared memory transposed ([col][row], rows
//   68 floats apart) and feeds the product with the next tile, each thread
//   accumulating 4 rows by DP / 16 columns in registers;
// - the forward keeps its 64 query rows resident and streams 64-key K and
//   V tiles, with the online softmax of flash_fwd.cu (base-2 exponentials,
//   the running max reduced across the 16 lanes of a row, each lane's part
//   of the running sum reduced once at the end, lse = m ln 2 + log(l));
// - flash_simple_dq keeps its 64 query rows (Q and dO) and streams K and V,
//   flash_simple_dkv keeps 64 keys (K and V) and walks the GQA group's q
//   heads and the query tiles from the causal diagonal to S, summing dK and
//   dV in registers: no atomics, a fixed order of sums, so two launches give
//   the same bits;
// - tiles past S read as zero rows; a key past S gets p = 0 and a row past
//   S is never stored.  The causal mask is applied only on the diagonal
//   tile, tiles above it are skipped.
//
// Head dims: DP is 32, 64, 128 or 256; the wrapper zero-pads D up to the
// next of them (zero columns add 0 to every score and give zero columns of
// o, dq, dk and dv).  Shared memory at DP = 256: a tile is 64 x 260 x 4 =
// 66,560 bytes and the transposed score tile 64 x 68 x 4 = 17,408.  The
// forward holds Q, K and V (217,088 bytes with the score tile); the backward
// kernels hold four tiles where they fit (DP <= 128: 152,576 bytes at 128)
// and three at DP = 256 (217,088 bytes), re-reading one resident tile per
// streamed tile instead (Q in flash_simple_dq, K and V in
// flash_simple_dkv).  The limit is 232,448 bytes a CTA (227 KB).
//
// Plain C entry points, bound from Python with ctypes: each launch goes on
// the stream it is handed, allocates nothing and returns the cudaError_t.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kRows = 64;         // rows of every tile, queries or keys
constexpr int kThreads = 256;     // 16 x 16
constexpr int kLdP = kRows + 4;   // row stride of the transposed score tile

// Shared memory of `tiles` [64, dp] tiles and the score tile, in bytes.
constexpr size_t smem_bytes(int dp, int tiles) {
  return ((size_t)tiles * kRows * (dp + 4) + (size_t)kRows * kLdP) * sizeof(float);
}

template <int DP> struct Tile {
  static constexpr int kLd = DP + 4;              // row stride of a [64, DP] tile
  static constexpr int kFloats = kRows * kLd;
  static constexpr int kVec = DP >= 64 ? 4 : 2;   // accumulator columns a load
  static constexpr int kGroups = DP / (16 * kVec);
  // The backward kernels keep four tiles where they fit, else three.
  static constexpr bool kResident = smem_bytes(DP, 4) <= kMaxSmem;
  static_assert(smem_bytes(DP, 3) <= kMaxSmem, "three tiles must fit a CTA");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_val(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// dst [64, DP] (rows kLd apart) = rows 0 .. rows - 1 of src, `stride`
// elements apart, and zeros below them.
template <int DP, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride, int rows) {
  using L = Tile<DP>;
  constexpr int kC4 = DP / 4;
  for (int i = threadIdx.x; i < kRows * kC4; i += kThreads) {
    const int r = i / kC4, c = (i % kC4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = load4(src + (size_t)r * stride + c);
    *reinterpret_cast<float4*>(dst + r * L::kLd + c) = x;
  }
}

// s[i][j] = sum_d a[ty * 4 + i][d] * b[tx + 16 j][d], d in order.
template <int DP>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* a, const float* b) {
  using L = Tile<DP>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * L::kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * L::kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// pt[tx + 16 j][ty * 4 + i] = s[i][j]: the score tile, transposed.
__device__ __forceinline__ void store_scores(float* pt, const float (&s)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(pt + (tx + 16 * j) * kLdP + ty * 4) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
}

// Column c of this thread's accumulator: kVec * tx + 16 kVec g + e for
// c = g kVec + e.
template <int DP> __device__ __forceinline__ int acc_col(int c) {
  using L = Tile<DP>;
  const int tx = threadIdx.x % 16;
  return L::kVec * tx + 16 * L::kVec * (c / L::kVec) + c % L::kVec;
}

// acc[i][c] += sum_k pt[k][ty * 4 + i] * x[k][acc_col(c)], k in order.
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[4][DP / 16], const float* pt,
                                           const float* x) {
  using L = Tile<DP>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < kRows; ++k) {
    const float4 p = *reinterpret_cast<const float4*>(pt + k * kLdP + ty * 4);
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g) {
      const float* xr = x + k * L::kLd + L::kVec * tx + 16 * L::kVec * g;
      float xv[4];
      if constexpr (L::kVec == 4) {
        const float4 t = *reinterpret_cast<const float4*>(xr);
        xv[0] = t.x, xv[1] = t.y, xv[2] = t.z, xv[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(xr);
        xv[0] = t.x, xv[1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < L::kVec; ++e)
          acc[i][g * L::kVec + e] = fmaf(pv[i], xv[e], acc[i][g * L::kVec + e]);
    }
  }
}

// Rows ty * 4 + i of acc (times mul[i]) into dst, rows `stride` elements
// apart, those below `rows` only.
template <int DP, typename T>
__device__ __forceinline__ void store_acc(T* dst, size_t stride, const float (&acc)[4][DP / 16],
                                          const float (&mul)[4], int rows) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c)
      store_val(dst + (size_t)r * stride + acc_col<DP>(c), acc[i][c] * mul[i]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < N; ++c) a[i][c] = 0.f;
}

// Reductions over the 16 lanes that hold one row of a score tile.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The (b * heads + head) index of this CTA (flash::head_grid).
__device__ __forceinline__ int head_index() { return blockIdx.y + gridDim.y * blockIdx.z; }

template <int DP, typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_simple_fwd_kernel(const T* __restrict__ q,   // [B, S, H, DP]
                        const T* __restrict__ k,   // [B, S, KV, DP]
                        const T* __restrict__ v,   // [B, S, KV, DP]
                        T* __restrict__ o,         // [B, S, H, DP]
                        float* __restrict__ lse,   // [B, H, S]
                        int B, int S, int H, int KV, float scale_log2) {
  using L = Tile<DP>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = smem + L::kFloats;
  float* vs = smem + 2 * L::kFloats;
  float* pt = smem + 3 * L::kFloats;

  const int bh = head_index();
  if (bh >= B * H) return;
  const int b = bh / H, h = bh % H, g = h / (H / KV);
  const int n_t = (S + kRows - 1) / kRows;
  const int qi = CAUSAL ? n_t - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qi * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qs_stride = (size_t)H * DP, kv_stride = (size_t)KV * DP;
  const T* k_bg = k + (size_t)b * S * kv_stride + (size_t)g * DP;
  const T* v_bg = v + (size_t)b * S * kv_stride + (size_t)g * DP;

  load_tile<DP>(qs, q + ((size_t)b * S + q0) * qs_stride + (size_t)h * DP, qs_stride,
                min(kRows, S - q0));
  float acc[4][DP / 16];
  zero(acc);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.f;

  const int n_kv = CAUSAL ? qi + 1 : n_t;
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * kRows;
    __syncthreads();  // the last tile's K, V and scores are read
    load_tile<DP>(ks, k_bg + (size_t)k0 * kv_stride, kv_stride, min(kRows, S - k0));
    load_tile<DP>(vs, v_bg + (size_t)k0 * kv_stride, kv_stride, min(kRows, S - k0));
    __syncthreads();
    float s[4][4];
    scores<DP>(s, qs, ks);
    const bool edge = (CAUSAL && it == qi) || k0 + kRows > S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float t = s[i][j] * scale_log2;
        if (edge && (key >= S || (CAUSAL && key > row))) t = kNegInf;
        s[i][j] = t;
        mx = fmaxf(mx, t);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) acc[i][c] *= alpha;
    }
    store_scores(pt, s);
    __syncthreads();
    accumulate<DP>(acc, pt, vs);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sum = fmaxf(row_sum(l[i]), 1e-30f);
    inv[i] = 1.f / sum;
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < S) lse[(size_t)bh * S + row] = m[i] * kLn2 + logf(sum);
  }
  store_acc<DP>(o + ((size_t)b * S + q0) * qs_stride + (size_t)h * DP, qs_stride, acc, inv,
                S - q0);
}

template <int DP, typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_simple_dq_kernel(const T* __restrict__ q,        // [B, S, H, DP]
                       const T* __restrict__ k,        // [B, S, KV, DP]
                       const T* __restrict__ v,        // [B, S, KV, DP]
                       const T* __restrict__ dout,     // [B, S, H, DP]
                       const float* __restrict__ lse,  // [B, H, S]
                       const float* __restrict__ delta,
                       T* __restrict__ dq,             // [B, S, H, DP]
                       int B, int S, int H, int KV, float scale, float scale_log2) {
  using L = Tile<DP>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = smem + L::kFloats;
  float* vs = smem + 2 * L::kFloats;
  float* pt = smem + 3 * L::kFloats;
  float* dos = L::kResident ? smem + 3 * L::kFloats + kRows * kLdP : qs;

  const int bh = head_index();
  if (bh >= B * H) return;
  const int b = bh / H, h = bh % H, g = h / (H / KV);
  const int n_t = (S + kRows - 1) / kRows;
  const int qi = CAUSAL ? n_t - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qi * kRows, rows = min(kRows, S - q0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qs_stride = (size_t)H * DP, kv_stride = (size_t)KV * DP;
  const size_t q_off = ((size_t)b * S + q0) * qs_stride + (size_t)h * DP;
  const T* k_bg = k + (size_t)b * S * kv_stride + (size_t)g * DP;
  const T* v_bg = v + (size_t)b * S * kv_stride + (size_t)g * DP;

  float lse2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    lse2[i] = r < rows ? lse[(size_t)bh * S + q0 + r] * kLog2e : 0.f;
    dl[i] = r < rows ? delta[(size_t)bh * S + q0 + r] : 0.f;
  }
  if (L::kResident) {
    load_tile<DP>(qs, q + q_off, qs_stride, rows);
    load_tile<DP>(dos, dout + q_off, qs_stride, rows);
  }
  float acc[4][DP / 16];
  zero(acc);

  const int n_kv = CAUSAL ? qi + 1 : n_t;
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * kRows;
    __syncthreads();  // the last tile's K and dS are read
    if (!L::kResident) load_tile<DP>(qs, q + q_off, qs_stride, rows);
    load_tile<DP>(ks, k_bg + (size_t)k0 * kv_stride, kv_stride, min(kRows, S - k0));
    load_tile<DP>(vs, v_bg + (size_t)k0 * kv_stride, kv_stride, min(kRows, S - k0));
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<DP>(s, qs, ks);
    if (!L::kResident) {  // dO takes Q's place
      __syncthreads();
      load_tile<DP>(dos, dout + q_off, qs_stride, rows);
      __syncthreads();
    }
    scores<DP>(dp, dos, vs);
    // p = 2^(s * scale log2 e - lse log2 e), 0 for a key past S or after
    // the row; ds = p * (dp - delta) * scale.
    const bool edge = (CAUSAL && it == qi) || k0 + kRows > S;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j, row = q0 + ty * 4 + i;
        float p = exp2f(fmaf(s[i][j], scale_log2, -lse2[i]));
        if (edge && (key >= S || (CAUSAL && key > row))) p = 0.f;
        s[i][j] = p * (dp[i][j] - dl[i]) * scale;
      }
    store_scores(pt, s);
    __syncthreads();
    accumulate<DP>(acc, pt, ks);  // dQ += dS K
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_acc<DP>(dq + q_off, qs_stride, acc, one, rows);
}

template <int DP, typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_simple_dkv_kernel(const T* __restrict__ q,        // [B, S, H, DP]
                        const T* __restrict__ k,        // [B, S, KV, DP]
                        const T* __restrict__ v,        // [B, S, KV, DP]
                        const T* __restrict__ dout,     // [B, S, H, DP]
                        const float* __restrict__ lse,  // [B, H, S]
                        const float* __restrict__ delta,
                        T* __restrict__ dk,             // [B, S, KV, DP]
                        T* __restrict__ dv,             // [B, S, KV, DP]
                        int B, int S, int H, int KV, float scale, float scale_log2) {
  using L = Tile<DP>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = smem + L::kFloats;
  float* ks = smem + 2 * L::kFloats;
  float* pt = smem + 3 * L::kFloats;
  float* vs = L::kResident ? smem + 3 * L::kFloats + kRows * kLdP : ks;

  const int bg = head_index();
  if (bg >= B * KV) return;
  const int b = bg / KV, g = bg % KV, rep = H / KV;
  const int n_t = (S + kRows - 1) / kRows;
  const int ki = blockIdx.x;  // key tiles near 0 walk the most query tiles
  const int k0 = ki * kRows, krows = min(kRows, S - k0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qs_stride = (size_t)H * DP, kv_stride = (size_t)KV * DP;
  const size_t kv_off = ((size_t)b * S + k0) * kv_stride + (size_t)g * DP;

  if (L::kResident) {
    load_tile<DP>(ks, k + kv_off, kv_stride, krows);
    load_tile<DP>(vs, v + kv_off, kv_stride, krows);
  }
  float dk_acc[4][DP / 16], dv_acc[4][DP / 16];
  zero(dk_acc);
  zero(dv_acc);

  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const size_t row_bh = (size_t)b * H + h;
    for (int t = CAUSAL ? ki : 0; t < n_t; ++t) {
      const int q0 = t * kRows, qrows = min(kRows, S - q0);
      const size_t q_off = ((size_t)b * S + q0) * qs_stride + (size_t)h * DP;
      __syncthreads();  // the last tile's Q, dO and scores are read
      load_tile<DP>(qs, q + q_off, qs_stride, qrows);
      load_tile<DP>(dos, dout + q_off, qs_stride, qrows);
      if (!L::kResident) load_tile<DP>(ks, k + kv_off, kv_stride, krows);
      __syncthreads();
      // Transposed: s[i][j] for key k0 + ty * 4 + i, query q0 + tx + 16 j.
      float s[4][4], dp[4][4];
      scores<DP>(s, ks, qs);
      if (!L::kResident) {  // V takes K's place
        __syncthreads();
        load_tile<DP>(vs, v + kv_off, kv_stride, krows);
        __syncthreads();
      }
      scores<DP>(dp, vs, dos);
      const bool edge = (CAUSAL && t == ki) || q0 + kRows > S || k0 + kRows > S;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float lq = c < qrows ? lse[row_bh * S + q0 + c] * kLog2e : 0.f;
        const float dlq = c < qrows ? delta[row_bh * S + q0 + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2f(fmaf(s[i][j], scale_log2, -lq));
          if (edge && (c >= qrows || ty * 4 + i >= krows || (CAUSAL && q0 + c < k0 + ty * 4 + i)))
            p = 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - dlq) * scale;
        }
      }
      store_scores(pt, s);
      __syncthreads();
      accumulate<DP>(dv_acc, pt, dos);  // dV += P^T dO
      __syncthreads();
      store_scores(pt, dp);
      __syncthreads();
      accumulate<DP>(dk_acc, pt, qs);   // dK += dS^T Q
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_acc<DP>(dk + kv_off, kv_stride, dk_acc, one, krows);
  store_acc<DP>(dv + kv_off, kv_stride, dv_acc, one, krows);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, S, H, KV;
  float scale;
  cudaStream_t stream;
};


template <int DP, typename T, bool CAUSAL>
cudaError_t launch_fwd(const Args& a, void* o, float* lse) {
  auto kernel = flash_simple_fwd_kernel<DP, T, CAUSAL>;
  const size_t smem = smem_bytes(DP, 3);
  const dim3 grid = head_grid((a.S + kRows - 1) / kRows, a.B * a.H);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(o), lse, a.B, a.S, a.H, a.KV, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int DP, typename T, bool CAUSAL>
cudaError_t launch_dq(const Args& a, void* dq) {
  auto kernel = flash_simple_dq_kernel<DP, T, CAUSAL>;
  const size_t smem = smem_bytes(DP, Tile<DP>::kResident ? 4 : 3);
  const dim3 grid = head_grid((a.S + kRows - 1) / kRows, a.B * a.H);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dq), a.B, a.S, a.H, a.KV,
      a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int DP, typename T, bool CAUSAL>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  auto kernel = flash_simple_dkv_kernel<DP, T, CAUSAL>;
  const size_t smem = smem_bytes(DP, Tile<DP>::kResident ? 4 : 3);
  const dim3 grid = head_grid((a.S + kRows - 1) / kRows, a.B * a.KV);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, a.stream>>>(
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
