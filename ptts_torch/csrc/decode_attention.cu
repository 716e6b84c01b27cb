// FlowLM's per-frame decode attention over the KV cache, for Hopper
// (sm_90a): one query per stream against the cache columns its mask lets
// through. Plain C interface, loaded from Python with ctypes
// (ptts_torch/ops/cuda/decode_attention.py).
//
// Replaces no Pallas kernel. The JAX package computes this attention in
// plain jnp (ptts_tpu/ops/attention.py, decode_attention_masked) and leaves
// it to XLA, which fuses the cast of the cache into the products. The
// port's plain version (ops/attention.decode_attention_masked) casts the
// whole cache to f32 and copies it again into the einsum's layout, per
// layer and frame: at 256 streams and a 544-column bf16 cache that is, per
// frame, ~3.4 GB read, ~7 GB written in f32 and more than 7 GB read back and
// copied again by elementwise kernels, where the attention needs the valid
// columns' bf16 bytes alone (~1.5 GB at the serving pool's ~45% valid share).
//
// What bounds it on this card (H100 SXM, 3.35 TB/s): ~2 FLOPs per byte of
// K and V, so bytes. Its bound is the valid columns' K and V rows plus q
// and the output, read and written once. The design moves no other byte:
//   * Grid (split, stream), 256 threads. A block takes one stream, all its
//     heads, and an even share of its valid columns (all of them when the
//     wrapper asks for one split). A column's K row over all heads is H*D
//     contiguous elements (2 KB in bf16 at 16 x 64); thread (r, c) reads
//     chunk c of it as 16 bytes, neighbouring threads on neighbouring
//     addresses, and 256 / (H*D*size / 16) row slots r take that many
//     columns at once (2 in bf16, 1 in f32 at 16 heads).
//   * The block counts its stream's valid columns (__syncthreads_count),
//     then lists its share of them in shared memory (warp ballots). Masked
//     columns are never read, so nothing they hold -- a stale ring row, a
//     row no stream wrote, NaN -- reaches the output. A row with no valid
//     column takes every column at an equal score, as the plain version's
//     softmax over all -1e30 scores does.
//   * Each thread copies its own chunks of K and V through a STAGES-deep
//     cp.async ring in shared memory and reads back only what it copied
//     itself, so the loop needs no block barrier and keeps STAGES x 32
//     bytes per thread in flight (32 KB per block, several blocks per SM).
//   * Scores: the D/N threads of a head each take a dot over their N lanes
//     and sum it with shuffles. Each (head, row slot) keeps an online
//     softmax (running max m, sum l, accumulator of its N output lanes);
//     the row slots are merged through shared memory at the end.
//   * Splits: the wrapper chooses their number from B, Tmax and the SM
//     count, so that small batches still fill the card (at least
//     ceil(Tmax / MAX_COLS), so a share always fits the list). With more
//     than one, each block writes (m, l, acc) per head to a scratch buffer
//     and a second kernel combines them.
//   * Grouped-query attention: with G query heads per KV head (KV head j
//     serves query heads j*G .. j*G + G-1), the block walks the KV rows of
//     the Hkv heads as above and each thread scores its K chunk against
//     the G query heads of its KV head, so K and V are read once for all
//     G of them; the thread keeps G online-softmax states. G = 1 is
//     FlowLM's multi-head attention, in the same arithmetic as before
//     grouping was added. The softmax scale is the caller's.
// Numerics, against the plain version: scores taken in f32 from the
// inputs' own type (a bf16 x bf16 product is exact in f32), summed over D
// in f32 and scaled (1/sqrt(D) for FlowLM) after the sum; f32 softmax statistics; p
// rounded to V's type before p.V (as probs.to(v.dtype) does, here on the
// unnormalised p of the online form); p.V accumulated in f32; the sum
// clamped at 1e-30; the output rounded to q's type. f32 caches stay in
// f32 FFMA throughout: no TF32, no bf16. The kernel allocates nothing and
// does not synchronise; each launch is checked with cudaGetLastError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;              // head dim
constexpr int NT = 256;            // threads per block
constexpr int STAGES = 4;          // depth of each thread's cp.async ring
constexpr int MAX_COLS = 1024;     // valid columns one block lists (a split's share)
constexpr int COMBINE_THREADS = 256;
constexpr float NEG_INF = -1e30f;

// 16 bytes of K, V, q or out as f32 lanes, and back.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};
template <> struct Chunk<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(p[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
  // p rounded to bf16 (the plain version's probs.to(v.dtype)), back in f32
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ bf16 from(float x) { return __float2bfloat16_rn(x); }
};

// 16-byte async copy global -> shared, cached in L2 only.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Fold another online-softmax state (mo, lo, ao) into (m, l, a).
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float mo, float lo,
                                      const float* ao) {
  const float mx = fmaxf(m, mo), ca = expf(m - mx), cb = expf(mo - mx);
  l = l * ca + lo * cb;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * ca + ao[e] * cb;
  m = mx;
}

// grid (splits, batch), NT threads. q and out [B, G*H, D]; k and v [B,
// Tmax, H, D] (H = heads, the KV heads); mask [B, Tmax] bytes (0 = masked);
// part [B, splits, G*H, 2 + D] f32 (m, l, acc) when splits > 1. Thread (r,
// c) = (tid / tpr, tid % tpr) owns lanes c*N .. c*N + N-1 of the H*D row
// (KV head c*N / D, query heads G times that onwards) and the columns of
// row slot r.
template <typename T, int G>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const unsigned char* __restrict__ mask, T* __restrict__ out,
                   float* __restrict__ part, int tmax, int heads, int splits, float scale) {
  using C = Chunk<T>;
  constexpr int N = C::N;           // lanes per 16-byte chunk
  constexpr int LPH = D / N;        // threads per head
  __shared__ __align__(16) uint4 ring[STAGES][2][NT];   // [stage][K, V][thread]
  __shared__ int cols[MAX_COLS];
  __shared__ int warp_n[NT / 32];

  const int split = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tpr = heads * LPH, rp = NT / tpr;
  const int r = tid / tpr, c = tid % tpr;
  const size_t row = (size_t)heads * D;                    // a K/V row
  const int qheads = G * heads;
  // this thread's lanes of query head g of its group, in q and out
  const size_t qat = (size_t)b * qheads * D + (size_t)(c / LPH) * G * D + (size_t)(c % LPH) * N;
  const unsigned char* mrow = mask + (size_t)b * tmax;

  // 1. How many columns are valid; none -> every column, at equal scores.
  int n = 0;
  for (int t0 = 0; t0 < tmax; t0 += NT) {
    const int t = t0 + tid;
    n += __syncthreads_count(t < tmax && mrow[t] != 0);
  }
  const bool uniform = n == 0;
  if (uniform) n = tmax;
  const int v0 = (int)((long long)split * n / splits);
  const int v1 = (int)((long long)(split + 1) * n / splits);
  const int mine = v1 - v0;   // <= MAX_COLS: the wrapper's split count sees to it

  // 2. List the valid columns v0 .. v1 - 1 (in column order) in shared memory.
  if (uniform) {
    for (int i = tid; i < mine; i += NT) cols[i] = v0 + i;
  } else {
    int seen = 0;   // valid columns before t0; the same in every thread
    for (int t0 = 0; t0 < tmax && seen < v1; t0 += NT) {
      const int t = t0 + tid;
      const bool ok = t < tmax && mrow[t] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) warp_n[warp] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) {
        before += w < warp ? warp_n[w] : 0;
        total += warp_n[w];
      }
      const int i = seen + before + __popc(bal & ((1u << lane) - 1u));
      if (ok && i >= v0 && i < v1) cols[i - v0] = t;
      seen += total;
      __syncthreads();
    }
  }
  __syncthreads();

  // 3. Walk the list rp columns a step: at step j, row slot r takes entry
  //    j * rp + r. Copies run STAGES - 1 steps ahead of the math.
  float qf[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g)
    C::unpack(*reinterpret_cast<const uint4*>(q + qat + (size_t)g * D), qf[g]);
  const T* kb = k + (size_t)b * tmax * row + (size_t)c * N;
  const T* vb = v + (size_t)b * tmax * row + (size_t)c * N;
  const int steps = (mine + rp - 1) / rp;
  auto fetch = [&](int j) {
    const int i = j * rp + r;
    if (j < steps && i < mine) {
      const size_t at = (size_t)cols[i] * row;
      cp_async16(&ring[j % STAGES][0][tid], kb + at);
      cp_async16(&ring[j % STAGES][1][tid], vb + at);
    }
    cp_commit();   // an empty group where nothing was copied keeps the count
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) fetch(j);

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[g][e] = 0.f;
  }
  for (int j = 0; j < steps; ++j) {
    fetch(j + STAGES - 1);
    cp_wait<STAGES - 1>();   // this thread's copies of step j have landed
    float kf[N], vf[N];
    C::unpack(ring[j % STAGES][0][tid], kf);
    C::unpack(ring[j % STAGES][1][tid], vf);
    const bool live = j * rp + r < mine;   // the same in all LPH threads of the head
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
      for (int o = LPH / 2; o > 0; o /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (live) {
        const float s = uniform ? NEG_INF : dot * scale;
        const float mx = fmaxf(m[g], s), corr = expf(m[g] - mx), p = expf(s - mx);
        l[g] = l[g] * corr + p;
        const float pv = C::round(p);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e] * corr);
        m[g] = mx;
      }
    }
  }
  cp_wait<0>();

  // 4. Merge the row slots into slot 0 through the (now idle) ring, one
  //    query head of the group at a time.
  if (rp > 1) {
    float* st = reinterpret_cast<float*>(&ring[0][0][0]);   // [NT - tpr][2 + N]
#pragma unroll
    for (int g = 0; g < G; ++g) {
      __syncthreads();
      if (r > 0) {
        float* x = st + (tid - tpr) * (2 + N);
        x[0] = m[g];
        x[1] = l[g];
#pragma unroll
        for (int e = 0; e < N; ++e) x[2 + e] = acc[g][e];
      }
      __syncthreads();
      if (r == 0)
        for (int o = 1; o < rp; ++o) {
          const float* x = st + ((o - 1) * tpr + c) * (2 + N);
          merge<N>(m[g], l[g], acc[g], x[0], x[1], x + 2);
        }
    }
  }
  if (r != 0) return;

  // 5. One split: the output. Several: this split's state, for the combine.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (splits == 1) {
      const float den = fmaxf(l[g], 1e-30f);
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = acc[g][e] / den;
      *reinterpret_cast<uint4*>(out + qat + (size_t)g * D) = C::pack(o);
    } else {
      const int h = (c / LPH) * G + g, d0 = (c % LPH) * N;
      float* p = part + (((size_t)b * splits + split) * qheads + h) * (2 + D);
      if (d0 == 0) {
        p[0] = m[g];
        p[1] = l[g];
      }
#pragma unroll
      for (int e = 0; e < N; ++e) p[2 + d0 + e] = acc[g][e];
    }
  }
}

// grid ceil(B*H*D / COMBINE_THREADS): one thread per output element folds
// the splits' (m, l, acc) of its (stream, head) and writes the output.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_attn_combine(const float* __restrict__ part, T* __restrict__ out, int batch, int heads,
                    int splits) {
  const int i = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= batch * heads * D) return;
  const int d = i % D, h = (i / D) % heads, b = i / (D * heads);
  const size_t stride = (size_t)heads * (2 + D);   // from one split to the next
  const float* p = part + ((size_t)b * splits * heads + h) * (2 + D);
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, p[s * stride]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* x = p + s * stride;
    const float w = expf(x[0] - mx);
    l = fmaf(x[1], w, l);
    a = fmaf(x[2 + d], w, a);
  }
  out[i] = Chunk<T>::from(a / fmaxf(l, 1e-30f));
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* part,
           int batch, int tmax, int heads, int splits, float scale, cudaStream_t stream) {
  decode_attn_kernel<T, G><<<dim3(splits, batch), NT, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const unsigned char*)mask, (T*)out, (float*)part,
      tmax, heads, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int total = batch * G * heads * D;
  decode_attn_combine<T><<<(total + COMBINE_THREADS - 1) / COMBINE_THREADS, COMBINE_THREADS, 0,
                           stream>>>((const float*)part, (T*)out, batch, G * heads, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_group(const void* q, const void* k, const void* v, const void* mask, void* out,
                 void* part, int batch, int tmax, int heads, int group, int splits, float scale,
                 cudaStream_t s) {
  switch (group) {
    case 1: return launch<T, 1>(q, k, v, mask, out, part, batch, tmax, heads, splits, scale, s);
    case 2: return launch<T, 2>(q, k, v, mask, out, part, batch, tmax, heads, splits, scale, s);
    case 4: return launch<T, 4>(q, k, v, mask, out, part, batch, tmax, heads, splits, scale, s);
    case 8: return launch<T, 8>(q, k, v, mask, out, part, batch, tmax, heads, splits, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out [B, group * H, 64]; k, v [B, Tmax, H, 64] (H KV heads, each serving
// ``group`` query heads: 1, 2, 4 or 8), contiguous, 16-byte aligned, all
// float32 (is_bf16 == 0) or all bfloat16; mask [B, Tmax] bool; part: f32
// scratch of B * splits * group * H * 66 when splits > 1 (else unused).
// H * 64 * the element size must divide 4096 bytes, and ceil(Tmax / splits)
// <= 1024. Returns a cudaError_t (0 on success).
int ptts_decode_attn(const void* q, const void* k, const void* v, const void* mask, void* out,
                     void* part, int batch, int tmax, int heads, int group, int splits,
                     float scale, int is_bf16, void* stream) {
  const int chunks = heads * D * (is_bf16 ? 2 : 4) / 16;   // 16-byte chunks per row
  if (batch < 1 || batch > 65535 || tmax < 1 || heads < 1 || NT % chunks != 0 || splits < 1 ||
      (tmax + splits - 1) / splits > MAX_COLS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_group<bf16>(q, k, v, mask, out, part, batch, tmax, heads, group,
                                      splits, scale, s)
                 : launch_group<float>(q, k, v, mask, out, part, batch, tmax, heads, group,
                                       splits, scale, s);
}

}  // extern "C"
