// The hybrid backbone's Mamba-2 frame step, for Hopper (sm_90a): one
// position of one Mamba layer for every row of the pool, the SSM state and
// the conv window advanced in place. Plain C interface, loaded from Python
// with ctypes (ptts_torch/ops/cuda/ssm_step.py).
//
// Replaces no Pallas kernel: the JAX package has no hybrid backbone. The
// port's plain version (ops/cuda/ssm_step.ssm_step_plain) makes several
// passes over the state per layer and frame: the decay, the outer-product
// update, the read-out with C. At the serving pool (257 rows, 64 heads of
// a 64 x 128 state, bf16) the state is 269.5 MB a layer, so each pass costs
// ~0.1-0.2 ms however the elementwise kernels run.
//
// What bounds it on this card (H100 SXM, 3.35 TB/s): ~1 FLOP per byte of
// state, so bytes. Its bound is the state read once and written once, plus
// the conv window and the per-row inputs and output (~2% of the state).
// Two kernels, launched back to back on the caller's stream:
//   * ssm_prologue_kernel, grid (ceil((C + H) / NT), B): thread i of row b
//     takes conv channel i < C (C = H*P + 2N: x, B and C of the layer), or
//     head i - C. A channel reads its K - 1 window entries and the new
//     input, writes the shifted window back (only when live), and writes
//     silu(conv + bias), rounded to the inputs' dtype, as f32 into the
//     scratch row. A head writes dt = softplus(dt + dt_bias) and dA =
//     exp(dt * -exp(A_log)). A separate kernel because the B and C
//     channels are shared by every head of a row: fused into the state
//     pass, the blocks of one row would race on their window.
//   * ssm_update_kernel, grid (H, B), NT threads: one block per (row,
//     head) takes its P x N tile of the state. A state row of N elements is
//     N / V 16-byte vectors (V = 8 bf16, 4 f32); thread t owns vector t % TPR
//     of rows t / TPR + k * RPS. Each thread issues all of its tile's loads
//     (streaming, evict-first: the state is ~5x L2) before any arithmetic,
//     so 16 KB (bf16) a block is in flight, up to 8 blocks an SM. Its B and
//     C lanes, x, dt, dA and D come from the scratch row (L2) into
//     registers. Per element, in f32:
//         s' = (s * dA) + ((x * dt) * B)          rounded once to the state's dtype
//     and the row's read-out from s' as stored:
//         y[p] = sum_n C[n] * s'[p, n] + D * x[p]
//     summed over the TPR threads of a row with warp shuffles. When live
//     is false the tile is not written and y reads the state as it was.
// Numerics, against the plain version: the same f32 products and sums,
// each rounded as PyTorch's separate elementwise kernels round them (no
// FMA contraction in the update), the state rounded once as it is stored;
// the conv's four products summed in tap order; only the order of the
// read-out's f32 sum over N differs. The kernels allocate nothing and do
// not synchronise; the launches are checked with cudaGetLastError. `live`
// is read on the device, so a captured graph replays it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int P = 64;      // head dim
constexpr int N = 128;     // state size
constexpr int K = 4;       // conv taps
constexpr int NT = 256;    // threads per block, both kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// 16 bytes of the state as f32 lanes, and back (rounded to nearest even).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ float round(float x) { return x; }
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
};
template <> struct Vec<bf16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
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
};

// xbc [B, C] and dt [B, H]: rows `stride` elements apart. conv [B, K-1, C];
// conv_w [C, K]; conv_b [C]; dt_bias, a_log [H]. work [B, C + 2H] f32: the
// conv's output (x, B, C), then dt, then dA.
template <typename T>
__global__ void __launch_bounds__(NT)
ssm_prologue_kernel(const T* __restrict__ xbc, const T* __restrict__ dtr, long long stride,
                    T* __restrict__ conv, const T* __restrict__ conv_w,
                    const T* __restrict__ conv_b, const T* __restrict__ dt_bias,
                    const T* __restrict__ a_log, const bool* __restrict__ live,
                    float* __restrict__ work, int heads) {
  const int C = heads * P + 2 * N;
  const int i = blockIdx.x * NT + threadIdx.x, b = blockIdx.y;
  const bool on = live == nullptr || *live;
  float* row = work + (size_t)b * (C + 2 * heads);
  if (i < C) {
    T* win = conv + (size_t)b * (K - 1) * C + i;
    T v[K];
#pragma unroll
    for (int k = 0; k < K - 1; ++k) v[k] = win[(size_t)k * C];
    v[K - 1] = xbc[(size_t)b * stride + i];
    const T* w = conv_w + (size_t)i * K;
    float acc = __fmul_rn(to_f(v[0]), to_f(w[0]));
#pragma unroll
    for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(to_f(v[k]), to_f(w[k])));
    acc = __fadd_rn(acc, to_f(conv_b[i]));
    row[i] = Vec<T>::round(__fmul_rn(acc, 1.f / (1.f + expf(-acc))));   // silu
    if (on) {
#pragma unroll
      for (int k = 0; k < K - 1; ++k) win[(size_t)k * C] = v[k + 1];
    }
  } else if (i < C + heads) {
    const int h = i - C;
    const float x = __fadd_rn(to_f(dtr[(size_t)b * stride + h]), to_f(dt_bias[h]));
    const float dt = x > 20.f ? x : log1pf(expf(x));   // softplus
    row[C + h] = dt;
    row[C + heads + h] = expf(__fmul_rn(dt, -expf(to_f(a_log[h]))));
  }
}

// ssm [B, H, P, N]; work as above; d_skip [H]; y [B, H * P] f32.
template <typename T>
__global__ void __launch_bounds__(NT)
ssm_update_kernel(T* __restrict__ ssm, const float* __restrict__ work,
                  const T* __restrict__ d_skip, const bool* __restrict__ live,
                  float* __restrict__ y, int heads) {
  using W = Vec<T>;
  constexpr int V = W::V;             // lanes per 16-byte vector
  constexpr int TPR = N / V;          // threads per state row: 16 bf16, 32 f32
  constexpr int RPS = NT / TPR;       // rows per sweep of the block
  constexpr int SWEEPS = P / RPS;     // 4 bf16, 8 f32
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = threadIdx.x % TPR, r0 = threadIdx.x / TPR;
  uint4* tile = reinterpret_cast<uint4*>(ssm + ((size_t)b * heads + h) * P * N) + c;

  uint4 s[SWEEPS];
#pragma unroll
  for (int k = 0; k < SWEEPS; ++k) s[k] = __ldcs(tile + (r0 + k * RPS) * TPR);

  const int C = heads * P + 2 * N;
  const float* row = work + (size_t)b * (C + 2 * heads);
  const bool on = live == nullptr || *live;
  const float dt = row[C + h], da = row[C + heads + h], dh = to_f(d_skip[h]);
  const float* xh = row + h * P;
  float bn[V], cn[V], xp[SWEEPS];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    bn[e] = row[heads * P + c * V + e];
    cn[e] = row[heads * P + N + c * V + e];
  }
#pragma unroll
  for (int k = 0; k < SWEEPS; ++k) xp[k] = xh[r0 + k * RPS];

#pragma unroll
  for (int k = 0; k < SWEEPS; ++k) {
    float f[V];
    W::unpack(s[k], f);
    if (on) {
      const float xdt = __fmul_rn(xp[k], dt);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = W::round(__fadd_rn(__fmul_rn(f[e], da),
                                                            __fmul_rn(xdt, bn[e])));
      __stcs(tile + (r0 + k * RPS) * TPR, W::pack(f));
    }
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc = fmaf(cn[e], f[e], acc);
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (c == 0)
      y[((size_t)b * heads + h) * P + r0 + k * RPS] = __fadd_rn(acc, __fmul_rn(dh, xp[k]));
  }
}

template <typename T>
int launch(const void* xbc, const void* dt, long long stride, void* ssm, void* conv,
           const void* conv_w, const void* conv_b, const void* dt_bias, const void* a_log,
           const void* d_skip, const void* live, void* work, void* y, int batch, int heads,
           cudaStream_t s) {
  const int C = heads * P + 2 * N;
  const bool* on = static_cast<const bool*>(live);
  ssm_prologue_kernel<T><<<dim3((C + heads + NT - 1) / NT, batch), NT, 0, s>>>(
      static_cast<const T*>(xbc), static_cast<const T*>(dt), stride, static_cast<T*>(conv),
      static_cast<const T*>(conv_w), static_cast<const T*>(conv_b),
      static_cast<const T*>(dt_bias), static_cast<const T*>(a_log), on,
      static_cast<float*>(work), heads);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssm_update_kernel<T><<<dim3(heads, batch), NT, 0, s>>>(
      static_cast<T*>(ssm), static_cast<const float*>(work), static_cast<const T*>(d_skip), on,
      static_cast<float*>(y), heads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xbc [B, H*64 + 256] and dt [B, H]: rows `stride` elements apart (views of
// one in_proj output); ssm [B, H, 64, 128], 16-byte aligned; conv [B, 3,
// H*64 + 256]; conv_w [H*64 + 256, 4]; conv_b [H*64 + 256]; dt_bias, a_log,
// d [H]; all contiguous but xbc and dt, all float32 (is_bf16 == 0) or all
// bfloat16. live: one bool on the device, or null for always. work: f32
// scratch of B * (H*64 + 256 + 2H); y: f32 [B, H*64]. Returns a cudaError_t
// (0 on success).
int ptts_ssm_step(const void* xbc, const void* dt, long long stride, void* ssm, void* conv,
                  const void* conv_w, const void* conv_b, const void* dt_bias,
                  const void* a_log, const void* d_skip, const void* live, void* work, void* y,
                  int batch, int heads, int is_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || stride < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<bf16>(xbc, dt, stride, ssm, conv, conv_w, conv_b, dt_bias, a_log,
                                d_skip, live, work, y, batch, heads, s)
                 : launch<float>(xbc, dt, stride, ssm, conv, conv_w, conv_b, dt_bias, a_log,
                                 d_skip, live, work, y, batch, heads, s);
}

}  // extern "C"
