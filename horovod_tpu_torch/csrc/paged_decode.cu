// Paged decode attention for Hopper (sm_90a), split over table columns.
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (horovod_tpu/ops/flash_attention.py, launched by `paged_attention`):
// one query token per request attends over that request's K/V pages,
// which a block table scatters over a pool [NB, BS, KV, Dh].  Positions
// >= lengths[b] are masked with the same -1e30 the Pallas kernel uses.
//
// Bound: memory.  A launch must read the live K/V pages once,
// sum_b ceil(len_b / BS) * BS * KV * Dh elements of K and as many of V
// (`paged_bytes` in ops/flash_attention.py).  At 8 requests of 1..2048
// tokens x 32 kv heads x 128 in bf16 that is 126 MB, 38 us at 3.35 TB/s.
// What the design does about it:
// - more CTAs in flight, no serial walk of a long row: the grid is
//   (B, KV * head chunks, n_splits).  Split s walks table columns
//   [s * cps, min((s + 1) * cps, n_live)), cps = ceil(n_cols / n_splits),
//   so a long request is read by many CTAs at once while short ones leave
//   their empty splits at once.  The wrapper picks n_splits on the host
//   from B, KV, n_cols and the SM count (never from lengths, which live on
//   the card).  Each split writes its unnormalised fp32 acc, its max m
//   and its sum l to scratch; a second small kernel, `paged_combine`,
//   merges them by log-sum-exp.  A second kernel rather than a
//   last-CTA-per-(b, g) merge: it needs no zeroed counter in scratch (the
//   kernel allocates nothing and scratch comes from torch.empty) and no
//   fence between CTAs, and costs one launch of B * H small blocks.  With
//   one split the main kernel writes the output itself;
// - one block-wide barrier a tile: K/V tiles of 16 KB (K and V, 8 KB each
//   at Dh = 128 in bf16) are staged in a ring of four with 16-byte
//   `cp.async` copies, so three tiles, 48 KB, are in flight while one is
//   computed, and the 64 KB ring leaves room for three CTAs an SM; the
//   barrier that publishes tile i also frees the stage tile i + 3 refills.
//   (Measured on an H100: two or three stages of 32 KB tiles were slower at
//   the 7B decode shape, 0.079-0.094 ms against 0.076; PERF.md);
// - vectorised steps with no shared-memory scratch between them: LPT
//   lanes share a token, each owning 16-byte chunks of its K and V rows
//   (8 bf16 or 4 fp32 values), read as uint4.  A row whose bytes are no
//   multiple of 16 (a bf16 head dim that is no multiple of 8, an fp32 one
//   no multiple of 4) runs a narrow-copy instance instead: 4-byte chunks
//   (fp32, even bf16 head dims; `cp.async` of 4 bytes) or 2-byte ones
//   (odd bf16 head dims; plain loads and stores), 32 lanes a token.  A group of LPT lanes keeps
//   its own online softmax (running max m and sum l of each head, in
//   registers) over the J tokens of each tile it owns, and holds its
//   heads' q chunk and acc chunk in registers; the scores are summed over
//   the group with log2(LPT) shuffles.  The groups of a CTA are merged
//   once, at the end of the split, through shared memory;
// - the `rep` query heads of a kv group stay together (GQA-native), so
//   each K/V row is read from device memory once per split; more than 8
//   heads a group are served in chunks of 8 by separate CTAs.
//
// Numerics: scores in fp32 (exponentials base 2 with log2(e) folded into
// the scale; m is written out in natural units); p is rounded to the input
// type before the P.V product, as the Pallas kernel does, while l sums the
// fp32 p; the mask value is -1e30.  Splits and groups change the order of
// the sums, and p is rounded against a group's running max.
//
// Layout requirement: q and both pools start aligned to the chunk the
// row's width picks (16, 4 or 2 bytes: `chunk_bytes`), and Dh is at most
// 256.  The entry point refuses anything else with cudaErrorInvalidValue.
//
// Contract: lengths[b] >= 1.  A row with length 0 returns 0 here, while
// the Pallas kernel returns the mean of V (exp(-1e30 - (-1e30)) = 1).
//
// Plain C entry points, bound from Python with ctypes; the launches go on
// the stream they are handed, allocate nothing and return the cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;
// Largest dynamic shared memory a CTA may ask for on Hopper.
constexpr size_t kMaxSmem = 232448;

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

// A chunk of CB bytes, the unit a lane copies and reads.
template <int CB> struct ChunkOf;
template <> struct ChunkOf<16> { using type = uint4; };
template <> struct ChunkOf<4> { using type = uint32_t; };
template <> struct ChunkOf<2> { using type = uint16_t; };

// The CB / sizeof(T) values of a chunk, as fp32.
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <typename T> __device__ __forceinline__ void unpack(const uint32_t& u, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint32_t& u, float* f) {
  f[0] = __uint_as_float(u);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint32_t& u, float* f) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}
template <typename T> __device__ __forceinline__ void unpack(const uint16_t& u, float* f) {
  f[0] = __uint_as_float((uint32_t)u << 16);  // a bf16 value
}

// Stage one chunk: 16- and 4-byte chunks by cp.async, 2-byte ones (which
// cp.async does not copy) by a load and a store, visible after the
// barrier that publishes the tile.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_chunk(uint4* dst, const void* src) { cp_async16(dst, src); }
__device__ __forceinline__ void copy_chunk(uint32_t* dst, const void* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy_chunk(uint16_t* dst, const void* src) {
  *dst = *static_cast<const uint16_t*>(src);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Compile-time shape of one instantiation: RMAX query heads a CTA, CPL
// chunks of CB bytes a lane, LPT lanes a token.  NG groups of LPT lanes
// each own J tokens of a tile of TT tokens; a stage (K and V of a tile) is
// at most 16 KB, 8 KB at 8 heads a CTA, which frees registers for them.
template <typename T, int RMAX, int CPL, int LPT, int CB>
struct Cfg {
  using Chunk = typename ChunkOf<CB>::type;
  static constexpr int V = CB / sizeof(T);  // values in a chunk
  static constexpr int NG = kThreads / LPT;
  static constexpr int J0 = (RMAX >= 8 ? 32 : 64) / (CPL * CB);
  static constexpr int J = J0 < 1 ? 1 : (J0 > 4 ? 4 : J0);
  static constexpr int TT = NG * J;
};
constexpr int kStages = 4;       // K/V tiles in the ring, three in flight
constexpr int kTableSmem = 4096; // most table columns of a split kept in smem

// Stage the K and V rows of a tile's live tokens (tile-local t < t_live,
// at position rel0 + t counted from the split's first column) as chunk
// copies, committed as one group.  Group grp copies rows grp + NG * k; its
// J page ids are read first, so their latencies overlap.
template <typename T, int CPL, int LPT, int NG, int J, typename Chunk>
__device__ __forceinline__ void stage_tile(Chunk* k_s, Chunk* v_s, const T* k_pool,
                                           const T* v_pool, const int* tbl, int rel0,
                                           int t_live, int C, int g, int Dh, int BS,
                                           size_t row_stride, int sub, int grp) {
  constexpr int V = sizeof(Chunk) / sizeof(T);
  int blk[J], slot[J];
#pragma unroll
  for (int k = 0; k < J; ++k) {
    const int t = grp + NG * k;
    if (t < t_live) {
      const int p = rel0 + t;
      const int col = p / BS;
      blk[k] = tbl[col];
      slot[k] = p - col * BS;
    }
  }
#pragma unroll
  for (int k = 0; k < J; ++k) {
    const int t = grp + NG * k;
    if (t < t_live) {
      const size_t row = ((size_t)blk[k] * BS + slot[k]) * row_stride + (size_t)g * Dh;
#pragma unroll
      for (int kc = 0; kc < CPL; ++kc) {
        const int c = sub + kc * LPT;
        if (c < C) {
          copy_chunk(k_s + (size_t)t * C + c, k_pool + row + c * V);
          copy_chunk(v_s + (size_t)t * C + c, v_pool + row + c * V);
        }
      }
    }
  }
  cp_async_commit();
}

template <typename T, int RMAX, int CPL, int LPT, int CB>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,         // [B, KV * rep, Dh]
                    const T* __restrict__ k_pool,    // [NB, BS, KV, Dh]
                    const T* __restrict__ v_pool,    // [NB, BS, KV, Dh]
                    const int* __restrict__ tables,  // [B, n_cols]
                    const int* __restrict__ lengths, // [B]
                    T* __restrict__ out,             // [B, KV * rep, Dh], one split
                    float* __restrict__ part_acc,    // [B, H, n_splits, Dh]
                    float* __restrict__ part_m,      // [B, H, n_splits]
                    float* __restrict__ part_l,      // [B, H, n_splits]
                    int KV, int rep, int Dh, int BS, int n_cols, int n_splits,
                    float scale_log2) {
  using K = Cfg<T, RMAX, CPL, LPT, CB>;
  using Chunk = typename K::Chunk;
  constexpr int V = K::V, NG = K::NG, J = K::J, TT = K::TT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int C = Dh / V;  // chunks a row
  const int n_hc = (rep + RMAX - 1) / RMAX;
  const int b = blockIdx.x;
  const int g = blockIdx.y / n_hc;
  const int r0 = (blockIdx.y - g * n_hc) * RMAX;
  const int nr = min(RMAX, rep - r0);
  const int split = blockIdx.z;
  const int H = KV * rep;
  const int tid = threadIdx.x;
  const int sub = tid % LPT;  // lane within the token group
  const int grp = tid / LPT;

  const int len = lengths[b];
  int n_live = (len + BS - 1) / BS;
  if (n_live > n_cols) n_live = n_cols;
  if (n_live < 0) n_live = 0;
  const int cps = (n_cols + n_splits - 1) / n_splits;
  const int c0 = split * cps;
  const int c1 = min(c0 + cps, n_live);
  // Head h = g * rep + r, as q.reshape(B, KV, rep, Dh) groups it.
  const size_t head0 = (size_t)b * H + (size_t)g * rep + r0;

  if (c0 >= c1) {  // no live column in this split
    if (part_acc != nullptr) {
      for (int i = tid; i < nr * Dh; i += kThreads) {
        const int r = i / Dh;
        part_acc[((head0 + r) * n_splits + split) * Dh + (i - r * Dh)] = 0.f;
      }
      for (int r = tid; r < nr; r += kThreads) {
        part_m[(head0 + r) * n_splits + split] = kNegInf;
        part_l[(head0 + r) * n_splits + split] = 0.f;
      }
    } else {
      for (int i = tid; i < nr * Dh; i += kThreads) out[head0 * Dh + i] = from_f<T>(0.f);
    }
    return;
  }
  const int tok0 = c0 * BS;
  const int n_tok = min(c1 * BS, len) - tok0;  // the split's live tokens
  const int n_tiles = (n_tok + TT - 1) / TT;

  Chunk* stage = reinterpret_cast<Chunk*>(smem);
  const size_t stage_chunks = (size_t)TT * C;  // of K, and as many of V
  // The split's table columns, in shared memory when a split's share fits:
  // the host's own test (launch_cfg reserves the room only then), never
  // this request's live columns.
  const int* tbl = tables + (size_t)b * n_cols + c0;
  if (cps <= kTableSmem) {
    int* tbl_s = reinterpret_cast<int*>(stage + 2 * kStages * stage_chunks);
    for (int j = tid; j < c1 - c0; j += kThreads) tbl_s[j] = tbl[j];
    tbl = tbl_s;
    __syncthreads();
  }
  const size_t row_stride = (size_t)KV * Dh;  // between tokens of a page
  auto stage_it = [&](int it) {
    if (it < n_tiles) {
      Chunk* k_n = stage + 2 * (it % kStages) * stage_chunks;
      stage_tile<T, CPL, LPT, NG, J>(k_n, k_n + stage_chunks, k_pool, v_pool, tbl, it * TT,
                                      min(TT, n_tok - it * TT), C, g, Dh, BS, row_stride,
                                      sub, grp);
    } else {
      cp_async_commit();  // an empty group keeps the wait counts uniform
    }
  };
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) stage_it(it);

  // This lane's q chunks (fp32) for the CTA's heads; zero past the row.
  float qr[RMAX][CPL][V];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = sub + k * LPT;
      if (r < nr && c < C) {
        const Chunk u = *reinterpret_cast<const Chunk*>(q + (head0 + r) * Dh + c * V);
        unpack<T>(u, qr[r][k]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) qr[r][k][e] = 0.f;
      }
    }
  float acc[RMAX][CPL][V];
  float m[RMAX], l[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][k][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    // Tile it has landed for every thread, and every thread is done with
    // tile it - 1, whose stage tile it + kStages - 1 now refills.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    stage_it(it + kStages - 1);
    const Chunk* k_s = stage + 2 * (it % kStages) * stage_chunks;
    const Chunk* v_s = k_s + stage_chunks;
    const int t_live = min(TT, n_tok - it * TT);

    // Scores of the group's J tokens for every head, base 2, masked.
    float s[J][RMAX];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = grp * J + j;
      float dot[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) dot[r] = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = sub + k * LPT;
        if (c < C && t < t_live) {
          float kv[V];
          unpack<T>(k_s[(size_t)t * C + c], kv);
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
#pragma unroll
            for (int e = 0; e < V; ++e) dot[r] = fmaf(qr[r][k][e], kv[e], dot[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
#pragma unroll
        for (int o = LPT / 2; o > 0; o >>= 1)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
        s[j][r] = t < t_live ? dot[r] * scale_log2 : kNegInf;
      }
    }

    // Online softmax of the group, one rescale a tile; p rounded to T.
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < J; ++j) mx = fmaxf(mx, s[j][r]);
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float p = grp * J + j < t_live ? exp2f(s[j][r] - mx) : 0.f;
        sum += p;
        s[j][r] = to_f(from_f<T>(p));
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int k = 0; k < CPL; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][k][e] *= alpha;
    }

    // acc += p . V over the group's live tokens.
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = grp * J + j;
      if (t >= t_live) break;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = sub + k * LPT;
        if (c < C) {
          float vv[V];
          unpack<T>(v_s[(size_t)t * C + c], vv);
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[r][k][e] = fmaf(s[j][r], vv[e], acc[r][k][e]);
        }
      }
    }
  }

  // Merge the NG groups through shared memory (the stages are free once
  // every thread has passed this barrier): the CTA's max of each head, then
  // each group's acc and l scaled to it and summed.
  __syncthreads();
  float* m_s = reinterpret_cast<float*>(smem);   // [NG][RMAX]
  float* l_s = m_s + NG * RMAX;                  // [NG][RMAX]
  float* a_s = l_s + NG * RMAX;                  // [NG][RMAX][Dh]
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      m_s[grp * RMAX + r] = m[r];
      l_s[grp * RMAX + r] = l[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    float M = kNegInf;
    for (int i = 0; i < NG; ++i) M = fmaxf(M, m_s[i * RMAX + r]);
    const float w = exp2f(m[r] - M);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = sub + k * LPT;
      if (c < C) {
        float* dst = a_s + ((size_t)grp * RMAX + r) * Dh + c * V;
#pragma unroll
        for (int e = 0; e < V; ++e) dst[e] = acc[r][k][e] * w;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * Dh; i += kThreads) {
    const int r = i / Dh;
    const int d = i - r * Dh;
    float M = kNegInf;
    for (int x = 0; x < NG; ++x) M = fmaxf(M, m_s[x * RMAX + r]);
    float L = 0.f, a = 0.f;
    for (int x = 0; x < NG; ++x) {
      L += l_s[x * RMAX + r] * exp2f(m_s[x * RMAX + r] - M);
      a += a_s[((size_t)x * RMAX + r) * Dh + d];
    }
    if (part_acc == nullptr) {
      out[(head0 + r) * Dh + d] = from_f<T>(a / fmaxf(L, 1e-30f));
    } else {
      const size_t pr = (head0 + r) * n_splits + split;
      part_acc[pr * Dh + d] = a;
      if (d == 0) {
        part_m[pr] = M == kNegInf ? kNegInf : M * kLn2;
        part_l[pr] = L;
      }
    }
  }
}

// Log-sum-exp merge of the splits of one (request, head): M = max_s m_s,
// L = sum_s l_s e^(m_s - M), O = sum_s acc_s e^(m_s - M) / max(L, 1e-30).
// The weights e^(m_s - M) go to shared memory; then, where Dh is a
// multiple of 4 (VEC), SL slices of the threads each sum every SL-th
// split's acc row as float4 loads, and the slices are added; else each
// thread sums whole columns.  Dynamic shared memory: n_splits + 4 *
// kThreads + 32 floats.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                     const float* __restrict__ part_l, T* __restrict__ out, int Dh,
                     int n_splits) {
  extern __shared__ __align__(16) float cs[];
  float4* red = reinterpret_cast<float4*>(cs);  // [kThreads]
  float* w = cs + 4 * kThreads;                 // [n_splits]
  float* wred = w + n_splits;                   // [32]
  const size_t row = blockIdx.x;  // b * H + h
  const float* pm = part_m + row * n_splits;
  const float* pl = part_l + row * n_splits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float M = kNegInf;
  for (int s = tid; s < n_splits; s += kThreads) M = fmaxf(M, pm[s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  if (lane == 0) wred[warp] = M;
  __syncthreads();
  M = fmaxf(fmaxf(wred[0], wred[1]), fmaxf(wred[2], wred[3]));
  float L = 0.f;
  for (int s = tid; s < n_splits; s += kThreads) {
    const float ws = __expf(pm[s] - M);
    w[s] = ws;
    L += pl[s] * ws;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
  if (lane == 0) wred[4 + warp] = L;
  __syncthreads();
  L = wred[4] + wred[5] + wred[6] + wred[7];
  if constexpr (!VEC) {
    const float inv = 1.f / fmaxf(L, 1e-30f);
    const float* pa = part_acc + row * n_splits * Dh;
    for (int d = tid; d < Dh; d += kThreads) {
      float a = 0.f;
      for (int s = 0; s < n_splits; ++s) a += w[s] * pa[(size_t)s * Dh + d];
      out[row * Dh + d] = from_f<T>(a * inv);
    }
    return;
  }

  const int DV = Dh / 4;  // float4 columns of a row
  const int SL = kThreads / DV;
  const float4* pa = reinterpret_cast<const float4*>(part_acc + row * n_splits * Dh);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < SL * DV) {
    const int sl = tid / DV, d4 = tid - sl * DV;
#pragma unroll 4
    for (int s = sl; s < n_splits; s += SL) {
      const float4 x = pa[(size_t)s * DV + d4];
      const float ws = w[s];
      a.x += ws * x.x;
      a.y += ws * x.y;
      a.z += ws * x.z;
      a.w += ws * x.w;
    }
  }
  red[tid] = a;
  __syncthreads();
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d4 = tid; d4 < DV; d4 += kThreads) {
    float4 t = red[d4];
    for (int sl = 1; sl < SL; ++sl) {
      const float4 x = red[sl * DV + d4];
      t.x += x.x;
      t.y += x.y;
      t.z += x.z;
      t.w += x.w;
    }
    T* o = out + row * Dh + 4 * d4;
    o[0] = from_f<T>(t.x * inv);
    o[1] = from_f<T>(t.y * inv);
    o[2] = from_f<T>(t.z * inv);
    o[3] = from_f<T>(t.w * inv);
  }
}

template <typename T, int RMAX, int CPL, int LPT, int CB>
cudaError_t launch_cfg(const void* q, const void* k_pool, const void* v_pool,
                       const int* tables, const int* lengths, void* out, float* part_acc,
                       float* part_m, float* part_l, int B, int H, int KV, int Dh, int BS,
                       int n_cols, int n_splits, float scale, cudaStream_t stream) {
  using K = Cfg<T, RMAX, CPL, LPT, CB>;
  const int rep = H / KV;
  const int C = Dh / K::V;
  const int cps = (n_cols + n_splits - 1) / n_splits;
  const size_t stages = 2 * (size_t)kStages * K::TT * C * CB +
                        (cps <= kTableSmem ? ((size_t)cps * 4 + 15) / 16 * 16 : 0);
  const size_t merge = (2 * (size_t)K::NG * RMAX + (size_t)K::NG * RMAX * Dh) * 4;
  const size_t smem = stages > merge ? stages : merge;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<T, RMAX, CPL, LPT, CB>;
  // Raise the kernel's shared-memory limit once per device (a decode tick
  // launches it once per layer; the attribute call costs host time).
  static size_t smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= 64 || smem_set[dev] < smem)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) smem_set[dev] = smem;
  }
  const int n_hc = (rep + RMAX - 1) / RMAX;
  if ((long long)KV * n_hc > 65535) return cudaErrorInvalidValue;
  const bool split = n_splits > 1;
  dim3 grid(B, KV * n_hc, n_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, static_cast<T*>(out), split ? part_acc : nullptr,
      split ? part_m : nullptr, split ? part_l : nullptr, KV, rep, Dh, BS, n_cols, n_splits,
      scale * kLog2e);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  auto combine = Dh % 4 == 0 ? paged_combine_kernel<T, true> : paged_combine_kernel<T, false>;
  const size_t csmem = (4 * (size_t)kThreads + n_splits + 32) * 4;
  if (csmem > kMaxSmem) return cudaErrorInvalidValue;
  if (csmem > 48 * 1024) {
    e = cudaFuncSetAttribute(combine, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem);
    if (e != cudaSuccess) return e;
  }
  combine<<<B * H, kThreads, csmem, stream>>>(part_acc, part_m, part_l, static_cast<T*>(out),
                                             Dh, n_splits);
  return cudaGetLastError();
}

// Pick the instantiation's lanes a token and chunks a lane.  16-byte
// chunks: 8, 16 or 32 lanes (the power of two at or above the row's
// chunks, at least 8) of one chunk, or, for fp32 rows of 33-64 chunks, 32
// lanes of two.  Narrow chunks: 32 lanes of 1, 2, 4 or 8.
template <typename T, int RMAX, int CB>
cudaError_t launch_rep(const void* q, const void* k, const void* v, const int* tb,
                       const int* ln, void* out, float* pa, float* pm, float* pl, int B,
                       int H, int KV, int Dh, int BS, int n_cols, int n_splits, float scale,
                       cudaStream_t s) {
  const int C = Dh * (int)sizeof(T) / CB;
#define PD_LAUNCH(CPL, LPT)                                                                     \
  return launch_cfg<T, RMAX, CPL, LPT, CB>(q, k, v, tb, ln, out, pa, pm, pl, B, H, KV, Dh, BS, \
                                           n_cols, n_splits, scale, s)
  if constexpr (CB == 16) {
    if (C <= 8) PD_LAUNCH(1, 8);
    if (C <= 16) PD_LAUNCH(1, 16);
    if (C <= 32) PD_LAUNCH(1, 32);
    if constexpr (sizeof(T) == 4) {
      if (C <= 64) PD_LAUNCH(2, 32);
    }
  } else {
    if (C <= 32) PD_LAUNCH(1, 32);
    if (C <= 64) PD_LAUNCH(2, 32);
    if (C <= 128) PD_LAUNCH(4, 32);
    if constexpr (2 * sizeof(T) > CB) {  // rows past 128 chunks
      if (C <= 256) PD_LAUNCH(8, 32);
    }
  }
#undef PD_LAUNCH
  return cudaErrorInvalidValue;
}

// Heads a CTA: 1, 2, 4 or 8 with 16-byte chunks; 1 or 8 with narrow ones.
template <typename T, int CB>
cudaError_t launch_cb(const void* q, const void* k, const void* v, const int* tb,
                      const int* ln, void* out, float* pa, float* pm, float* pl, int B, int H,
                      int KV, int Dh, int BS, int n_cols, int n_splits, float scale,
                      cudaStream_t s) {
  const int rep = H / KV;
  if (rep <= 1) return launch_rep<T, 1, CB>(q, k, v, tb, ln, out, pa, pm, pl, B, H, KV, Dh, BS, n_cols, n_splits, scale, s);
  if constexpr (CB == 16) {
    if (rep <= 2) return launch_rep<T, 2, CB>(q, k, v, tb, ln, out, pa, pm, pl, B, H, KV, Dh, BS, n_cols, n_splits, scale, s);
    if (rep <= 4) return launch_rep<T, 4, CB>(q, k, v, tb, ln, out, pa, pm, pl, B, H, KV, Dh, BS, n_cols, n_splits, scale, s);
  }
  return launch_rep<T, 8, CB>(q, k, v, tb, ln, out, pa, pm, pl, B, H, KV, Dh, BS, n_cols, n_splits, scale, s);
}

// The chunk a row of `row_bytes` is copied in: 16 bytes where they divide
// it, else 4, else 2.
inline int chunk_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16 : row_bytes % 4 == 0 ? 4 : 2;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tb, const int* ln,
                   void* out, float* pa, float* pm, float* pl, int B, int H, int KV, int Dh,
                   int BS, int n_cols, int n_splits, float scale, cudaStream_t s) {
  const int cb = chunk_bytes(Dh * (int)sizeof(T));
  if (Dh > 256 || reinterpret_cast<uintptr_t>(k) % cb != 0 ||
      reinterpret_cast<uintptr_t>(v) % cb != 0 || reinterpret_cast<uintptr_t>(q) % cb != 0)
    return cudaErrorInvalidValue;
  if (n_splits > 1 && (pa == nullptr || pm == nullptr || pl == nullptr))
    return cudaErrorInvalidValue;
  if (cb == 16) return launch_cb<T, 16>(q, k, v, tb, ln, out, pa, pm, pl, B, H, KV, Dh, BS, n_cols, n_splits, scale, s);
  if (cb == 4) return launch_cb<T, 4>(q, k, v, tb, ln, out, pa, pm, pl, B, H, KV, Dh, BS, n_cols, n_splits, scale, s);
  if constexpr (sizeof(T) == 2)
    return launch_cb<T, 2>(q, k, v, tb, ln, out, pa, pm, pl, B, H, KV, Dh, BS, n_cols, n_splits, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  part_acc [B, H, n_splits, Dh],
// part_m and part_l [B, H, n_splits], fp32 scratch the caller allocates;
// they may be null when n_splits is 1.  Returns a cudaError_t.
int paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                 const void* lengths, void* out, void* part_acc, void* part_m, void* part_l,
                 int B, int H, int KV, int Dh, int BS, int n_cols, int n_splits, float scale,
                 int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || Dh <= 0 || BS <= 0 ||
      n_cols <= 0 || n_splits <= 0 || n_splits > n_cols || n_splits > 65535)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, tb, ln, out, pa, pm, pl, B, H, KV, Dh, BS,
                           n_cols, n_splits, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, tb, ln, out, pa, pm, pl, B, H, KV, Dh,
                                   BS, n_cols, n_splits, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
