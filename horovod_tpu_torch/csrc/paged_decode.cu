// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (horovod_tpu/ops/flash_attention.py, launched by `paged_attention`):
// one query token per request attends over that request's K/V pages,
// which a block table scatters over a pool [NB, BS, KV, Dh].  Positions
// >= lengths[b] are masked with the same -1e30 the Pallas kernel uses.
//
// Design, redesigned for the card rather than carried over block by block:
// - one CTA per (request b, kv group g).  The TPU kernel's sequential grid
//   axis over table columns becomes a loop inside the CTA, and the CTA
//   reads tables[b, j] itself in place of scalar prefetch;
// - the loop stops at ceil(lengths[b] / BS) columns instead of visiting
//   every padded column: a fully masked column contributes exactly 0 to
//   the online softmax, so the result is the same;
// - the group's `rep` query heads stay together, so each K/V page row is
//   read from device memory once per group (GQA-native);
// - pages are staged `ppt` at a time (a tile of ppt * BS tokens) in shared
//   memory, then scores, the online-softmax update and the P.V product run
//   out of shared memory.  Two stages: while one tile is computed, the next
//   one's pages are in flight as 16-byte `cp.async` copies, so a CTA keeps
//   a whole tile of loads outstanding instead of one load per thread;
// - fp32 accumulation with bf16 or fp32 inputs; p is rounded to the
//   input type before the P.V product, as the Pallas kernel does.
//
// Layout requirement: a K/V row of Dh elements is a whole number of
// 16-byte copies and both pools start 16-byte aligned.  The entry point
// refuses anything else with cudaErrorInvalidValue.
//
// Bound: memory.  A launch must read sum_b ceil(len_b / BS) * BS * KV * Dh
// elements of K and as many of V.  At 8 requests x 1024 tokens x 32 kv
// heads x 128 in bf16 that is 134 MB, about 40 us at 3.35 TB/s.  This
// first version keeps one CTA per (b, g) and no split over columns, so a
// long request is served by one CTA walking its pages in order; splitting
// the columns across CTAs, TMA and wgmma are later work.
//
// Contract: lengths[b] >= 1.  A row with length 0 returns 0 here, while
// the Pallas kernel returns the mean of V (exp(-1e30 - (-1e30)) = 1).
//
// Plain C entry points, bound from Python with ctypes; the launch goes on
// the stream it is handed, allocates nothing and returns the cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Largest dynamic shared memory a CTA may ask for on Hopper.
constexpr size_t kMaxSmem = 232448;
// Tiles are shrunk until the CTA's shared memory fits under this, so a few
// CTAs stay resident on each SM.
constexpr size_t kTileSmemBudget = 96 * 1024;
constexpr int kTargetTileTokens = 64;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory of one CTA, in this order: two stages of a K tile and a V
// tile ([tile, Dh] of T each), q and the accumulator ([rep, Dh] fp32
// each), scores/p ([rep, tile] fp32), then m, l and alpha ([rep] fp32
// each).
size_t smem_bytes(size_t elem, int rep, int Dh, int tile) {
  return 4 * (size_t)tile * Dh * elem + 2 * (size_t)rep * Dh * 4 +
         (size_t)rep * tile * 4 + 3 * (size_t)rep * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the K and V rows of group g for the live tokens of table columns
// j0.. into k_s / v_s as 16-byte asynchronous copies, committed as one
// group.
template <typename T>
__device__ __forceinline__ void stage_tile(T* k_s, T* v_s, const T* k_pool,
                                           const T* v_pool, const int* tbl,
                                           int j0, int t_live, int g, int Dh,
                                           int BS, size_t row_stride) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = Dh / V;
  for (int i = threadIdx.x; i < t_live * vpr; i += kThreads) {
    const int t = i / vpr;
    const int c = i - t * vpr;
    const int blk = tbl[j0 + t / BS];
    const size_t src =
        ((size_t)blk * BS + (t % BS)) * row_stride + (size_t)g * Dh + c * V;
    cp_async16(reinterpret_cast<uint4*>(k_s) + i, k_pool + src);
    cp_async16(reinterpret_cast<uint4*>(v_s) + i, v_pool + src);
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,         // [B, KV * rep, Dh]
                    const T* __restrict__ k_pool,    // [NB, BS, KV, Dh]
                    const T* __restrict__ v_pool,    // [NB, BS, KV, Dh]
                    const int* __restrict__ tables,  // [B, n_cols]
                    const int* __restrict__ lengths, // [B]
                    T* __restrict__ out,             // [B, KV * rep, Dh]
                    int KV, int rep, int Dh, int BS, int n_cols, int ppt,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = ppt * BS;
  const size_t stage_elems = (size_t)tile * Dh;
  T* kv_s = reinterpret_cast<T*>(smem);  // stage s: K at 2s, V at 2s + 1
  float* q_s = reinterpret_cast<float*>(kv_s + 4 * stage_elems);
  float* acc_s = q_s + rep * Dh;
  float* s_s = acc_s + rep * Dh;
  float* m_s = s_s + rep * tile;
  float* l_s = m_s + rep;
  float* a_s = l_s + rep;

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = lengths[b];
  int n_live = (len + BS - 1) / BS;
  if (n_live > n_cols) n_live = n_cols;
  if (n_live < 0) n_live = 0;
  // Positions at or past `limit` are masked: past the request's length,
  // or past the table's last column.
  const int limit = min(len, n_live * BS);

  // Head h = g * rep + r, as q.reshape(B, KV, rep, Dh) groups it.
  const size_t head0 = ((size_t)b * KV + g) * rep;
  const T* q_g = q + head0 * Dh;
  for (int i = tid; i < rep * Dh; i += kThreads) {
    q_s[i] = to_f(q_g[i]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int* tbl = tables + (size_t)b * n_cols;
  const size_t row_stride = (size_t)KV * Dh;  // between tokens of a page
  const int n_tiles = (n_live + ppt - 1) / ppt;
  if (n_tiles > 0)
    stage_tile<T>(kv_s, kv_s + stage_elems, k_pool, v_pool, tbl, 0,
                  min(tile, n_live * BS), g, Dh, BS, row_stride);
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * ppt;
    const int t_live = min(tile, (n_live - j0) * BS);
    const T* k_s = kv_s + (2 * (it & 1)) * stage_elems;
    const T* v_s = k_s + stage_elems;
    // 1. Put the next tile's pages in flight into the other stage (last
    //    read by tile it - 1, which every thread has finished), then wait
    //    for this tile's.
    if (it + 1 < n_tiles) {
      T* k_n = kv_s + (2 * ((it + 1) & 1)) * stage_elems;
      stage_tile<T>(k_n, k_n + stage_elems, k_pool, v_pool, tbl, j0 + ppt,
                    min(tile, (n_live - j0 - ppt) * BS), g, Dh, BS,
                    row_stride);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // 2. Scores: one warp per (r, t), the lanes split Dh.
    for (int p = warp; p < rep * t_live; p += kWarps) {
      const int r = p / t_live;
      const int t = p - r * t_live;
      const float* qr = q_s + r * Dh;
      const T* kt = k_s + (size_t)t * Dh;
      float dot = 0.f;
      for (int d = lane; d < Dh; d += 32) dot += qr[d] * to_f(kt[d]);
      dot = warp_sum(dot);
      if (lane == 0) {
        const int pos = j0 * BS + t;
        s_s[r * tile + t] = pos < limit ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // 3. Online softmax, one warp per head.
    for (int r = warp; r < rep; r += kWarps) {
      float* sr = s_s + r * tile;
      float mx = kNegInf;
      for (int t = lane; t < t_live; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < t_live; t += 32) {
        const float pr = expf(sr[t] - m_new);
        sum += pr;
        sr[t] = to_f(from_f<T>(pr));  // p in the input type, as the TPU kernel
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 4. acc[r, d] = alpha_r * acc[r, d] + sum_t p[r, t] * v[t, d].
    for (int i = tid; i < rep * Dh; i += kThreads) {
      const int r = i / Dh;
      const int d = i - r * Dh;
      const float* pr = s_s + r * tile;
      float a = acc_s[i] * a_s[r];
      for (int t = 0; t < t_live; ++t) a += pr[t] * to_f(v_s[(size_t)t * Dh + d]);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  __syncthreads();  // l_s is written by one lane per head
  T* o = out + head0 * Dh;
  for (int i = tid; i < rep * Dh; i += kThreads) {
    const int r = i / Dh;
    o[i] = from_f<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, void* out, int B,
                   int H, int KV, int Dh, int BS, int n_cols, float scale,
                   cudaStream_t stream) {
  const int rep = H / KV;
  int ppt = kTargetTileTokens / BS;
  if (ppt < 1) ppt = 1;
  if (ppt > n_cols) ppt = n_cols;
  while (ppt > 1 && smem_bytes(sizeof(T), rep, Dh, ppt * BS) > kTileSmemBudget) ppt /= 2;
  const size_t smem = smem_bytes(sizeof(T), rep, Dh, ppt * BS);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;

  if ((Dh * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, KV);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, static_cast<T*>(out), KV,
      rep, Dh, BS, n_cols, ppt, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                 const void* tables, const void* lengths, void* out, int B,
                 int H, int KV, int Dh, int BS, int n_cols, float scale,
                 int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || Dh <= 0 || BS <= 0 || n_cols <= 0 ||
      KV > 65535)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, tb, ln, out, B, H, KV, Dh, BS,
                           n_cols, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, tb, ln, out, B, H, KV,
                                   Dh, BS, n_cols, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
