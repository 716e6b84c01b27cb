// Fused RoPE + attention straight off the fused QKV projection, for Hopper
// (sm_90a). Plain C interface, loaded from Python with ctypes
// (ptts_torch/ops/cuda/fused_attention.py).
//
// Replaces the two Pallas TPU kernels of ptts_tpu/ops/pallas/fused_attention.py:
//   * ptts_causal_attn_qkv  <- causal_attention_qkv (:361, body
//     _causal_attn_qkv_kernel :259): FlowLM prefill. Halves-layout RoPE on q
//     and k at positions 0..T-1, full-causal softmax attention with keys
//     masked to k < lengths[b]; also returns the rotated K for the KV cache.
//   * ptts_window_attn_qkv  <- window_attention_qkv (:186, body
//     _window_attn_qkv_kernel :66): Mimi transformer. The same RoPE, then a
//     sliding window: key k is valid for query q iff 0 <= q - k < context.
//
// What bounds them on this card: B1 runs at T <= 128, where every byte of
// the [B, T, 3HD] projection is read once and the math is ~T/2 FMAs per
// byte -- it is bound by bytes and by launch latency, not by arithmetic.
// B2 is ~250 keys per query (context = 250, D = 64): ~32 K FMAs per query
// row, arithmetic that a register-blocked or tensor-core kernel would do
// far faster than this one.
//
// Design (simple and right first): one block per (64-row query tile, head,
// stream); q, k and v are read straight from the fused projection (no split,
// no transpose), q and k are rotated while they are loaded, from host-built
// f32 cos/sin tables, and rounded to the input dtype; an online softmax in
// f32 walks only the key tiles the mask can reach (B1: tiles up to the query
// tile and below lengths[b]; B2: from q0 - context + 1 to the query tile).
// Masked keys get p = 0 by select, never by multiplying, and K/V rows that
// no query of the stream may see (past lengths[b] or past T) are zeroed at
// load, so stale or poisoned cache rows never reach the sums. Products are
// f32 FMAs on values of the input dtype (bf16 x bf16 is exact in f32), p is
// rounded to the input dtype before p.V, the denominator is clamped at
// 1e-30. Scores and p.V run on the CUDA cores; wgmma and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;              // head dim (both models)
constexpr int HALF = D / 2;
constexpr int TILE = 64;           // query rows and key rows per tile
constexpr int THREADS = 256;       // 4 threads per query row
constexpr int LD = D + 1;          // padded shared-memory row (floats)
constexpr int KEYS_PER_THREAD = TILE / 4;
constexpr int DIMS_PER_THREAD = D / 4;
constexpr float NEG_INF = -1e30f;
constexpr size_t SMEM_BYTES = 4 * TILE * LD * sizeof(float);  // q, k, v, p

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Halves-layout RoPE of one (lo, hi) lane pair, rounded to T. Written with
// the _rn intrinsics so no FMA contraction changes the rounding against
// the plain version (lo*cos - hi*sin, lo*sin + hi*cos, each product rounded).
template <typename T>
__device__ __forceinline__ void rotate(float xl, float xh, float c, float s,
                                       float* lo, float* hi) {
  *lo = round_to<T>(__fsub_rn(__fmul_rn(xl, c), __fmul_rn(xh, s)));
  *hi = round_to<T>(__fadd_rn(__fmul_rn(xl, s), __fmul_rn(xh, c)));
}

// Rows [row0, row0 + TILE) of one head's q or k lanes (starting at column
// col0 of each projection row), rotated at their positions, into dst as f32.
// Rows >= nrows are zero.
template <typename T>
__device__ void load_rotated(float* dst, const T* rows, int row0, int nrows,
                             size_t row_stride, int col0, const float* cos_t,
                             const float* sin_t) {
  for (int i = threadIdx.x; i < TILE * HALF; i += THREADS) {
    const int r = i / HALF, d = i % HALF, t = row0 + r;
    float lo = 0.f, hi = 0.f;
    if (t < nrows) {
      const T* src = rows + (size_t)t * row_stride + col0;
      rotate<T>(to_f32(src[d]), to_f32(src[d + HALF]), cos_t[t * HALF + d],
                sin_t[t * HALF + d], &lo, &hi);
    }
    dst[r * LD + d] = lo;
    dst[r * LD + d + HALF] = hi;
  }
}

template <typename T>
__device__ void load_plain(float* dst, const T* rows, int row0, int nrows,
                           size_t row_stride, int col0) {
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int r = i / D, d = i % D, t = row0 + r;
    dst[r * LD + d] = t < nrows ? to_f32(rows[(size_t)t * row_stride + col0 + d]) : 0.f;
  }
}

// grid (ceil(T / TILE), heads, batch), THREADS threads, SMEM_BYTES dynamic.
// qkv [B, T, 3*H*D]; out and k_rot [B, T, H*D]; cos_t/sin_t [T, D/2] f32.
// WINDOW selects B2 (context) over B1 (lengths, k_rot).
template <typename T, bool WINDOW>
__global__ void __launch_bounds__(THREADS)
attn_qkv_kernel(const T* __restrict__ qkv, const int* __restrict__ lengths,
                const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                T* __restrict__ out, T* __restrict__ k_rot, int seq, int heads,
                int context) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + TILE * LD;
  float* vs = ks + TILE * LD;
  float* ps = vs + TILE * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int HD = heads * D;
  const size_t row_stride = 3 * (size_t)HD;
  const T* rows = qkv + (size_t)b * seq * row_stride;
  const int q0 = qt * TILE;
  // keys any query of this stream may see: k < kend
  const int kend = WINDOW ? seq : min(max(lengths[b], 0), seq);

  if (!WINDOW) {
    // rotated K of this tile index, for the cache: every row < T, including
    // rows past lengths[b] -- each position is written by exactly one block
    T* kr = k_rot + (size_t)b * seq * HD + h * D;
    for (int i = threadIdx.x; i < TILE * HALF; i += THREADS) {
      const int r = i / HALF, d = i % HALF, t = q0 + r;
      if (t < seq) {
        const T* src = rows + (size_t)t * row_stride + HD + h * D;
        float lo, hi;
        rotate<T>(to_f32(src[d]), to_f32(src[d + HALF]), cos_t[t * HALF + d],
                  sin_t[t * HALF + d], &lo, &hi);
        kr[(size_t)t * HD + d] = from_f32<T>(lo);
        kr[(size_t)t * HD + d + HALF] = from_f32<T>(hi);
      }
    }
  }

  load_rotated<T>(qs, rows, q0, seq, row_stride, h * D, cos_t, sin_t);

  const int r = threadIdx.x >> 2;  // query row in the tile
  const int c = threadIdx.x & 3;   // quarter: keys c + 4j, dims c + 4i
  const int qpos = q0 + r;
  const float scale = 1.0f / sqrtf((float)D);
  float m = NEG_INF, l = 0.f;
  float acc[DIMS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < DIMS_PER_THREAD; ++i) acc[i] = 0.f;

  const int kt_lo = WINDOW ? max(0, q0 - context + 1) / TILE : 0;
  const int kt_hi = kend > 0 ? min(qt, (kend - 1) / TILE) : -1;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // q loaded / previous tile's k, v consumed
    load_rotated<T>(ks, rows, k0, kend, row_stride, HD + h * D, cos_t, sin_t);
    load_plain<T>(vs, rows, k0, kend, row_stride, 2 * HD + h * D);
    __syncthreads();

    float s[KEYS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < KEYS_PER_THREAD; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < KEYS_PER_THREAD; ++j) s[j] = fmaf(qd, ks[(c + 4 * j) * LD + d], s[j]);
    }

    unsigned valid = 0;
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < KEYS_PER_THREAD; ++j) {
      const int kpos = k0 + c + 4 * j;
      bool ok = kpos <= qpos && kpos < kend;
      if (WINDOW) ok = ok && (qpos - kpos) < context;
      s[j] = ok ? s[j] * scale : NEG_INF;
      valid |= (unsigned)ok << j;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS_PER_THREAD; ++j) {
      const float p = (valid >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      lsum += p;
      ps[r * LD + c + 4 * j] = round_to<T>(p);
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l = l * corr + lsum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DIMS_PER_THREAD; ++i) acc[i] *= corr;
    __syncwarp();  // a row's p is written and read by the same warp

    for (int j = 0; j < TILE; ++j) {
      const float pj = ps[r * LD + j];
#pragma unroll
      for (int i = 0; i < DIMS_PER_THREAD; ++i) acc[i] = fmaf(pj, vs[j * LD + c + 4 * i], acc[i]);
    }
  }

  if (qpos < seq) {
    const float denom = fmaxf(l, 1e-30f);
    T* o = out + ((size_t)b * seq + qpos) * HD + h * D;
#pragma unroll
    for (int i = 0; i < DIMS_PER_THREAD; ++i) o[c + 4 * i] = from_f32<T>(acc[i] / denom);
  }
}

template <typename T, bool WINDOW>
int launch(const void* qkv, const void* lengths, const void* cos_t, const void* sin_t,
           void* out, void* k_rot, int batch, int seq, int heads, int context,
           void* stream) {
  auto kernel = attn_qkv_kernel<T, WINDOW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + TILE - 1) / TILE, heads, batch);
  kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const T*)qkv, (const int*)lengths, (const float*)cos_t, (const float*)sin_t,
      (T*)out, (T*)k_rot, seq, heads, context);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B1. lengths: [B] int32 on the device. bf16 != 0 selects bfloat16 tensors,
// else float32. Returns a cudaError_t (0 on success).
int ptts_causal_attn_qkv(const void* qkv, const void* lengths, const void* cos_t,
                         const void* sin_t, void* out, void* k_rot, int batch,
                         int seq, int heads, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16, false>(qkv, lengths, cos_t, sin_t, out, k_rot,
                                             batch, seq, heads, 0, stream)
              : launch<float, false>(qkv, lengths, cos_t, sin_t, out, k_rot, batch,
                                     seq, heads, 0, stream);
}

// B2. Returns a cudaError_t (0 on success).
int ptts_window_attn_qkv(const void* qkv, const void* cos_t, const void* sin_t,
                         void* out, int batch, int seq, int heads, int context,
                         int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16, true>(qkv, nullptr, cos_t, sin_t, out, nullptr,
                                            batch, seq, heads, context, stream)
              : launch<float, true>(qkv, nullptr, cos_t, sin_t, out, nullptr, batch,
                                    seq, heads, context, stream);
}

const char* ptts_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
