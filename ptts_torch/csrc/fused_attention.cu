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
// What bounds them on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32 on the
// CUDA cores, 989 TFLOP/s bf16 on the tensor cores). B1 runs at T <= 128:
// q and k of every row and v below lengths[b] are read once and the math is
// a few FLOPs per byte, so it is bound by bytes (5.4 us at B = 8, T = 128,
// f32, at serving admission's ragged lengths) and, below that, by launch and
// per-block latency. B2 at T = 1024 does
// ~250 keys per query: in f32 it is bound by the CUDA cores (13.7 us), in
// bf16 by bytes (2.5 us) -- its FLOPs take under 1 us even at mma.sync
// rates, so the bf16 kernel uses mma.sync, not wgmma.
//
// Design. One block per (query tile, head, stream); q, k and v are read
// straight from the projection (no split, no transpose). Query tiles are 64
// rows, or 32 where 64-row tiles would leave SMs idle (fewer blocks than
// SMs), so small admission shapes still fill the card. K/V tiles of 64 keys
// stream through a 2-stage ring in shared memory by 16-byte cp.async: the
// next tile's copy is in flight while the current one is used. Rows that
// no query of the stream may see (past lengths[b] or past T) are
// zero-filled by the copy and never read from memory -- stale or poisoned
// cache rows never reach the sums. Each K
// tile is rotated once, in shared memory, when it lands; its cos/sin are
// loaded during the previous tile's math, and the block's q, k_rot and
// table loads are all issued before any of them is used. Only the key tiles
// the mask can reach are walked (B1: up to the query tile and below
// lengths[b]; B2: from q0 - context + 1).
//   * f32 (the main path's type): CUDA cores, no TF32 (1xTF32 would break
//     the 1e-4 gate). 128 threads; each owns a 4-row (2 at 32-row tiles) by
//     8-key micro-tile of S and a 4 (2) by 8-dim micro-tile of O in
//     registers, and reads its operands from shared memory as float4: 2.67
//     FMAs per shared word (1.6 at 32-row tiles) where a one-row-per-thread
//     kernel does 1. That is still under the 4 per word at which the CUDA cores, not
//     shared memory, would set the pace: B2 in f32 is bound by shared-memory
//     bandwidth (an 8 x 8 micro-tile would reach 4, at 2 warps a block).
//   * bf16: tensor cores, FlashAttention-2 style mma.sync m16n8k16 (bf16 in,
//     f32 accumulate). Each warp owns 16 query rows; Q and K go through
//     ldmatrix, V through ldmatrix.trans; S stays in registers, the online
//     softmax reduces over 4 lanes with shuffles, and P is packed to bf16 in
//     registers as the A operand of P.V (the plain version's
//     probs.to(v.dtype)). Key blocks no query of the tile can see are
//     skipped. The math takes well under a microsecond; the per-tile chain
//     of copy, barrier and RoPE sets its time.
// Numerics shared with the plain versions (ops/cuda/fused_attention.py):
// RoPE products and sums rounded one by one (__fmul_rn/__fadd_rn) and the
// result rounded to the input type; masked scores SELECTED to -1e30, never
// multiplied; f32 softmax statistics; p rounded to the input type before
// P.V; the denominator clamped at 1e-30. B1 writes the rotated K of every
// position < T exactly once (the block of that query tile, 16-byte stores).
// The dynamic shared-memory limit is raised once per (kernel, device).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;            // head dim (both models)
constexpr int HALF = D / 2;
constexpr int BK = 64;           // keys per K/V tile
constexpr int STAGES = 2;        // depth of the K/V ring (3 measured no faster in bf16)
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

std::atomic<int> g_attr_calls{0};  // cudaFuncSetAttribute calls made, ever

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// ---------------------------------------------------------------------------
// Copies and RoPE, shared by both kernels
// ---------------------------------------------------------------------------

// 16-byte async copy global -> shared; valid == false zero-fills the 16
// bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue the copy of a BK-row tile of one head's D lanes (starting at column
// col0 of each projection row) into dst (row stride LDS elements). Rows at
// or past nvalid are zero-filled.
template <typename T, int LDS, int NT>
__device__ __forceinline__ void load_tile_async(T* dst, const T* rows, int row0, int nvalid,
                                                size_t row_stride, int col0) {
  constexpr int N = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / N;         // chunks per row
  for (int i = threadIdx.x; i < BK * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR, t = row0 + r;
    const bool ok = t < nvalid;
    cp_async16(dst + r * LDS + c * N, rows + (size_t)(ok ? t : 0) * row_stride + col0 + c * N,
               ok);
  }
}

template <typename T> union Chunk {
  uint4 u;
  T e[16 / sizeof(T)];
};

// Halves-layout RoPE of NROWS rows at positions pos0.., for one or two row
// sets that share their positions (a query tile's q and k, or one K tile),
// in phases so that every load a thread makes is in flight at once:
// load_cs() reads the f32 cos/sin of the thread's chunks, load_x() its
// 16-byte chunks of lane pairs (d, d + D/2); store() rotates them -- each product and sum rounded,
// no FMA contraction, as the plain version computes them -- rounds to T and
// writes them to dst (which may be the source). Rows at positions >= nvalid
// are zeroed in dst when zero_invalid, else left alone.
template <typename T, int NROWS, int NT, int NSETS>
struct Rope {
  static constexpr int N = 16 / sizeof(T);             // elements per chunk
  static constexpr int CH = HALF / N;                  // chunks per half row
  static constexpr int ITERS = (NROWS * CH + NT - 1) / NT;
  Chunk<T> lo[NSETS][ITERS], hi[NSETS][ITERS];
  float co[ITERS][N], si[ITERS][N];
  int pos0, nvalid;

  __device__ __forceinline__ void load_cs(int p0, int nv, const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t) {
    pos0 = p0;
    nvalid = nv;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = threadIdx.x + it * NT, r = i / CH, c = i % CH, t = pos0 + r;
      if (i < NROWS * CH && t < nvalid) {
#pragma unroll
        for (int e = 0; e < N; e += 4) {
          const size_t at = (size_t)t * HALF + c * N + e;
          const float4 c4 = __ldg(reinterpret_cast<const float4*>(cos_t + at));
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(sin_t + at));
          co[it][e] = c4.x; co[it][e + 1] = c4.y; co[it][e + 2] = c4.z; co[it][e + 3] = c4.w;
          si[it][e] = s4.x; si[it][e + 1] = s4.y; si[it][e + 2] = s4.z; si[it][e + 3] = s4.w;
        }
      }
    }
  }

  __device__ __forceinline__ void load_x(const T* src0, const T* src1, size_t stride) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = threadIdx.x + it * NT, r = i / CH, c = i % CH, t = pos0 + r;
      if (i < NROWS * CH && t < nvalid) {
#pragma unroll
        for (int set = 0; set < NSETS; ++set) {
          const T* sl = (set ? src1 : src0) + (size_t)r * stride + c * N;
          lo[set][it].u = *reinterpret_cast<const uint4*>(sl);
          hi[set][it].u = *reinterpret_cast<const uint4*>(sl + HALF);
        }
      }
    }
  }

  template <int SET>
  __device__ __forceinline__ void store(T* dst, size_t stride, bool zero_invalid) const {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = threadIdx.x + it * NT, r = i / CH, c = i % CH, t = pos0 + r;
      if (i >= NROWS * CH) continue;
      Chunk<T> a, b;
      if (t < nvalid) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float xl = to_f32(lo[SET][it].e[e]), xh = to_f32(hi[SET][it].e[e]);
          a.e[e] = from_f32<T>(__fsub_rn(__fmul_rn(xl, co[it][e]), __fmul_rn(xh, si[it][e])));
          b.e[e] = from_f32<T>(__fadd_rn(__fmul_rn(xl, si[it][e]), __fmul_rn(xh, co[it][e])));
        }
      } else if (zero_invalid) {
        a.u = make_uint4(0, 0, 0, 0);
        b.u = a.u;
      } else {
        continue;
      }
      T* dl = dst + (size_t)r * stride + c * N;
      *reinterpret_cast<uint4*>(dl) = a.u;
      *reinterpret_cast<uint4*>(dl + HALF) = b.u;
    }
  }
};

// The key range of one query tile: tiles [*kt_lo, *kt_hi] (empty when
// kt_lo > kt_hi), keys valid below *kend.
template <bool WINDOW>
__device__ __forceinline__ void key_tiles(int q0, int bq, int seq, const int* lengths, int b,
                                          int context, int* kend, int* kt_lo, int* kt_hi) {
  *kend = WINDOW ? seq : min(max(lengths[b], 0), seq);
  *kt_lo = WINDOW ? max(0, q0 - context + 1) / BK : 0;
  *kt_hi = *kend > 0 ? min((q0 + bq - 1) / BK, (*kend - 1) / BK) : -1;
}

// The keys [*klo, *khi) of the tile at k0 that some query of the tile at q0
// may see; the rest are skipped (their scores are masked all the same).
template <bool WINDOW>
__device__ __forceinline__ void tile_keys(int q0, int bq, int k0, int kend, int context,
                                          int* klo, int* khi) {
  *klo = WINDOW ? max(q0 - context + 1 - k0, 0) : 0;
  *khi = min(BK, min(kend, q0 + bq) - k0);
}

template <bool WINDOW>
__device__ __forceinline__ bool key_ok(int qpos, int kpos, int kend, int context) {
  bool ok = kpos <= qpos && kpos < kend;
  if (WINDOW) ok = ok && (qpos - kpos) < context;
  return ok;
}

// ---------------------------------------------------------------------------
// f32: register-blocked CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 128;  // 16 row groups x 8 key (and dim) groups
constexpr int F32_LD = D + 4;     // padded row (floats): float4 reads of 8 rows hit 32 banks

template <int BQ> constexpr size_t f32_smem_bytes() {
  // q [BQ][LD], k and v rings [STAGES][BK][LD] each, p [BK][BQ + 4]
  return (size_t)(BQ * F32_LD + 2 * STAGES * BK * F32_LD + BK * (BQ + 4)) * sizeof(float);
}

// Scores of the thread's R rows against keys tk + 8j (j < 8) of one K tile:
// s[i][j] += q[row i] . k[key j] over D, operands read from shared memory as
// float4 (R + 8 loads for 32 R FMAs per 4 lanes of D).
template <int R>
__device__ __forceinline__ void f32_scores(float (&s)[R][8], const float* qs, const float* kb,
                                           int tr, int tk) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 qv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qs + (tr * R + i) * F32_LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(kb + (tk + 8 * j) * F32_LD + d);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
      }
    }
  }
}

// grid (ceil(T / BQ), heads, batch), F32_THREADS threads.
// qkv [B, T, 3*H*D]; out and k_rot [B, T, H*D]; cos_t/sin_t [T, D/2] f32.
// Thread (tr, tk) = (tid / 8, tid % 8) owns query rows tr*R .. tr*R + R-1,
// keys tk + 8j of each key tile (j < 8) and output dims tk*4..+3, 32+tk*4..+3.
template <int BQ, bool WINDOW>
__global__ void __launch_bounds__(F32_THREADS)
attn_f32_kernel(const float* __restrict__ qkv, const int* __restrict__ lengths,
                const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                float* __restrict__ out, float* __restrict__ k_rot, int seq, int heads,
                int context) {
  constexpr int NT = F32_THREADS, R = BQ / 16, LD = F32_LD, LDP = BQ + 4, ST = STAGES;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [BQ][LD], rotated
  float* ks = qs + BQ * LD;         // [ST][BK][LD], rotated on arrival
  float* vs = ks + ST * BK * LD;    // [ST][BK][LD]
  float* ps = vs + ST * BK * LD;    // [BK][LDP]: p of key j for row r at j * LDP + r

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int HD = heads * D;
  const size_t rs = 3 * (size_t)HD;
  const float* rows = qkv + (size_t)b * seq * rs;
  // q of this tile and (B1) k of its positions, for the cache: loads first
  Rope<float, BQ, NT, WINDOW ? 1 : 2> qk;
  qk.load_cs(q0, seq, cos_t, sin_t);
  qk.load_x(rows + (size_t)q0 * rs + h * D, rows + (size_t)q0 * rs + HD + h * D, rs);
  int kend, kt_lo, kt_hi;
  key_tiles<WINDOW>(q0, BQ, seq, lengths, b, context, &kend, &kt_lo, &kt_hi);

  // K/V tile kt into ring stage (kt - kt_lo) % ST, one commit group per tile
  // (empty past kt_hi, so the group count stays uniform)
  auto issue = [&](int kt) {
    if (kt <= kt_hi) {
      const int at = (kt - kt_lo) % ST * BK * LD;
      load_tile_async<float, LD, NT>(ks + at, rows, kt * BK, kend, rs, HD + h * D);
      load_tile_async<float, LD, NT>(vs + at, rows, kt * BK, kend, rs, 2 * HD + h * D);
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) issue(kt_lo + i);
  Rope<float, BK, NT, 1> kr;  // each K tile's RoPE; its cos/sin load ahead of the tile
  if (kt_lo <= kt_hi) kr.load_cs(kt_lo * BK, kend, cos_t, sin_t);
  qk.template store<0>(qs, LD, true);
  if constexpr (!WINDOW)
    qk.template store<1>(k_rot + ((size_t)b * seq + q0) * HD + h * D, HD, false);

  const int tr = threadIdx.x >> 3, tk = threadIdx.x & 7;
  const float scale = 1.0f / sqrtf((float)D);
  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    float* kb = ks + (kt - kt_lo) % ST * BK * LD;
    float* vb = vs + (kt - kt_lo) % ST * BK * LD;
    issue(kt + ST - 1);  // in flight during this tile and the next ST - 2
    cp_wait<ST - 1>();   // tile kt has landed
    __syncthreads();  // tile kt (and q) visible to every thread
    const int k0 = kt * BK;
    kr.load_x(kb, nullptr, LD);
    kr.template store<0>(kb, LD, false);
    if (kt < kt_hi) kr.load_cs(k0 + BK, kend, cos_t, sin_t);  // in flight during the math
    __syncthreads();
    int klo, khi;
    tile_keys<WINDOW>(q0, BQ, k0, kend, context, &klo, &khi);

    float s[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    f32_scores<R>(s, qs, kb, tr, tk);

    // online softmax over this tile; a row's 64 keys sit in 8 adjacent lanes
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + tr * R + i;
      unsigned valid = 0;
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = key_ok<WINDOW>(qpos, k0 + tk + 8 * j, kend, context);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        valid |= (unsigned)ok << j;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float m_new = fmaxf(m[i], tmax);
      const float corr = expf(m[i] - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (valid >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        lsum += p;
        ps[(tk + 8 * j) * LDP + tr * R + i] = p;
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 4);
      l[i] = l[i] * corr + lsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row's p is written and read by its own warp only

#pragma unroll 4
    for (int j = klo; j < khi; ++j) {
      float pr[R];
      if constexpr (R == 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + j * LDP + tr * R);
        pr[0] = p4.x; pr[1] = p4.y; pr[2] = p4.z; pr[3] = p4.w;
      } else {
        const float2 p2 = *reinterpret_cast<const float2*>(ps + j * LDP + tr * R);
        pr[0] = p2.x; pr[1] = p2.y;
      }
      const float4 v0 = *reinterpret_cast<const float4*>(vb + j * LD + tk * 4);
      const float4 v1 = *reinterpret_cast<const float4*>(vb + j * LD + HALF + tk * 4);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i][0] = fmaf(pr[i], v0.x, acc[i][0]);
        acc[i][1] = fmaf(pr[i], v0.y, acc[i][1]);
        acc[i][2] = fmaf(pr[i], v0.z, acc[i][2]);
        acc[i][3] = fmaf(pr[i], v0.w, acc[i][3]);
        acc[i][4] = fmaf(pr[i], v1.x, acc[i][4]);
        acc[i][5] = fmaf(pr[i], v1.y, acc[i][5]);
        acc[i][6] = fmaf(pr[i], v1.z, acc[i][6]);
        acc[i][7] = fmaf(pr[i], v1.w, acc[i][7]);
      }
    }
    __syncthreads();  // this stage and p consumed before they are refilled
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qpos = q0 + tr * R + i;
    if (qpos < seq) {
      const float denom = fmaxf(l[i], 1e-30f);
      float* o = out + ((size_t)b * seq + qpos) * HD + h * D;
      *reinterpret_cast<float4*>(o + tk * 4) =
          make_float4(acc[i][0] / denom, acc[i][1] / denom, acc[i][2] / denom, acc[i][3] / denom);
      *reinterpret_cast<float4*>(o + HALF + tk * 4) =
          make_float4(acc[i][4] / denom, acc[i][5] / denom, acc[i][6] / denom, acc[i][7] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16, bf16 -> f32)
// ---------------------------------------------------------------------------

constexpr int BF16_LD = D + 8;  // padded row (bf16): 144 B, ldmatrix rows hit distinct banks

template <int NW> constexpr size_t bf16_smem_bytes() {
  // q [16 NW][LD], k and v rings [STAGES][BK][LD] each
  return (size_t)(16 * NW * BF16_LD + 2 * STAGES * BK * BF16_LD) * sizeof(bf16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (ceil(T / (16 NW)), heads, batch), 32 NW threads. Warp w owns query
// rows q0 + 16w .. +15; lane (g, t4) = (lane / 4, lane % 4) holds, in each
// 8-column block of S and O, rows g and g + 8 at columns 2 t4 and 2 t4 + 1
// (the mma accumulator layout).
template <int NW, bool WINDOW>
__global__ void __launch_bounds__(NW * 32)
attn_bf16_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lengths,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                 bf16* __restrict__ out, bf16* __restrict__ k_rot, int seq, int heads,
                 int context) {
  constexpr int NT = NW * 32, BQ = NW * 16, LD = BF16_LD, ST = STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD], rotated
  bf16* ks = qs + BQ * LD;                        // [ST][BK][LD], rotated on arrival
  bf16* vs = ks + ST * BK * LD;                   // [ST][BK][LD]

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int HD = heads * D;
  const size_t rs = 3 * (size_t)HD;
  const bf16* rows = qkv + (size_t)b * seq * rs;
  Rope<bf16, BQ, NT, WINDOW ? 1 : 2> qk;
  qk.load_cs(q0, seq, cos_t, sin_t);
  qk.load_x(rows + (size_t)q0 * rs + h * D, rows + (size_t)q0 * rs + HD + h * D, rs);
  int kend, kt_lo, kt_hi;
  key_tiles<WINDOW>(q0, BQ, seq, lengths, b, context, &kend, &kt_lo, &kt_hi);

  // K/V tile kt into ring stage (kt - kt_lo) % ST, one commit group per tile
  // (empty past kt_hi, so the group count stays uniform)
  auto issue = [&](int kt) {
    if (kt <= kt_hi) {
      const int at = (kt - kt_lo) % ST * BK * LD;
      load_tile_async<bf16, LD, NT>(ks + at, rows, kt * BK, kend, rs, HD + h * D);
      load_tile_async<bf16, LD, NT>(vs + at, rows, kt * BK, kend, rs, 2 * HD + h * D);
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) issue(kt_lo + i);
  Rope<bf16, BK, NT, 1> kr;  // each K tile's RoPE; its cos/sin load ahead of the tile
  if (kt_lo <= kt_hi) kr.load_cs(kt_lo * BK, kend, cos_t, sin_t);
  qk.template store<0>(qs, LD, true);
  if constexpr (!WINDOW)
    qk.template store<1>(k_rot + ((size_t)b * seq + q0) * HD + h * D, HD, false);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  uint32_t qf[4][4];  // A fragments of the warp's 16 rows, one per 16-lane chunk of D
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    ldsm_x4(qf[kc], qs + (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);

  const float scale = 1.0f / sqrtf((float)D);
  float o[8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    bf16* kb = ks + (kt - kt_lo) % ST * BK * LD;
    bf16* vb = vs + (kt - kt_lo) % ST * BK * LD;
    issue(kt + ST - 1);  // in flight during this tile and the next ST - 2
    cp_wait<ST - 1>();   // tile kt has landed
    __syncthreads();
    const int k0 = kt * BK;
    kr.load_x(kb, nullptr, LD);
    kr.template store<0>(kb, LD, false);
    if (kt < kt_hi) kr.load_cs(k0 + BK, kend, cos_t, sin_t);  // in flight during the math
    __syncthreads();
    int klo, khi;
    tile_keys<WINDOW>(q0, BQ, k0, kend, context, &klo, &khi);

    // S = Q K^T: 8 blocks of 8 keys, each 4 floats per lane
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        if (16 * nb2 + 16 <= klo || 16 * nb2 >= khi) continue;  // uniform over the block
        uint32_t kf[4];  // B fragments of key blocks 2 nb2 and 2 nb2 + 1
        ldsm_x4(kf, kb + (nb2 * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kc * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nb2], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * nb2 + 1], qf[kc], kf[2], kf[3]);
      }
    }

    // online softmax; a row's 64 keys sit in the 4 lanes of one g
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qpos = q0 + warp * 16 + g + 8 * hr;
      unsigned valid = 0;
      float tmax = NEG_INF;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = key_ok<WINDOW>(qpos, k0 + nb * 8 + 2 * t4 + e, kend, context);
          float& x = s[nb][2 * hr + e];
          x = ok ? x * scale : NEG_INF;
          valid |= (unsigned)ok << (2 * nb + e);
          tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[hr], tmax);
      const float corr = expf(m[hr] - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nb][2 * hr + e];
          x = (valid >> (2 * nb + e)) & 1u ? expf(x - m_new) : 0.f;
          lsum += x;
        }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      l[hr] = l[hr] * corr + lsum;
      m[hr] = m_new;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        o[nb][2 * hr] *= corr;
        o[nb][2 * hr + 1] *= corr;
      }
    }

    // O += P V: P from the S accumulators, packed to bf16 as A fragments
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      if (16 * kc + 16 <= klo || 16 * kc >= khi) continue;
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int db2 = 0; db2 < 4; ++db2) {
        uint32_t vf[4];  // B fragments of dim blocks 2 db2 and 2 db2 + 1
        ldsm_x4_trans(vf, vb + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + db2 * 16 +
                              (lane >> 4) * 8);
        mma_bf16(o[2 * db2], pa, vf[0], vf[1]);
        mma_bf16(o[2 * db2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage consumed before it is refilled
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qpos = q0 + warp * 16 + g + 8 * hr;
    if (qpos < seq) {
      const float denom = fmaxf(l[hr], 1e-30f);
      bf16* orow = out + ((size_t)b * seq + qpos) * HD + h * D;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[nb][2 * hr] / denom, o[nb][2 * hr + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Raise the kernel's dynamic shared-memory limit on the current device, once.
int ensure_smem(const void* kernel, size_t bytes, std::atomic<int>* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    g_attr_calls.fetch_add(1);
    ready[dev].store(1, std::memory_order_release);
  }
  return 0;
}

// 32-row query tiles where 64-row tiles would give fewer blocks than the
// device has SMs (read once per device).
bool small_tiles(int batch, int seq, int heads) {
  static std::atomic<int> sms[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return false;
  int n = sms[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 132;
    sms[dev].store(n, std::memory_order_relaxed);
  }
  return (long long)((seq + 63) / 64) * heads * batch < n;
}

template <int BQ, bool WINDOW>
int launch_f32(const void* qkv, const void* lengths, const void* cos_t, const void* sin_t,
               void* out, void* k_rot, int batch, int seq, int heads, int context,
               cudaStream_t stream) {
  static std::atomic<int> ready[MAX_DEVICES];
  auto kernel = attn_f32_kernel<BQ, WINDOW>;
  constexpr size_t smem = f32_smem_bytes<BQ>();
  const int err = ensure_smem((const void*)kernel, smem, ready);
  if (err) return err;
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  kernel<<<grid, F32_THREADS, smem, stream>>>(
      (const float*)qkv, (const int*)lengths, (const float*)cos_t, (const float*)sin_t,
      (float*)out, (float*)k_rot, seq, heads, context);
  return (int)cudaGetLastError();
}

template <int NW, bool WINDOW>
int launch_bf16(const void* qkv, const void* lengths, const void* cos_t, const void* sin_t,
                void* out, void* k_rot, int batch, int seq, int heads, int context,
                cudaStream_t stream) {
  static std::atomic<int> ready[MAX_DEVICES];
  auto kernel = attn_bf16_kernel<NW, WINDOW>;
  constexpr size_t smem = bf16_smem_bytes<NW>();
  const int err = ensure_smem((const void*)kernel, smem, ready);
  if (err) return err;
  const dim3 grid((seq + 16 * NW - 1) / (16 * NW), heads, batch);
  kernel<<<grid, NW * 32, smem, stream>>>(
      (const bf16*)qkv, (const int*)lengths, (const float*)cos_t, (const float*)sin_t,
      (bf16*)out, (bf16*)k_rot, seq, heads, context);
  return (int)cudaGetLastError();
}

template <bool WINDOW>
int launch(const void* qkv, const void* lengths, const void* cos_t, const void* sin_t, void* out,
           void* k_rot, int batch, int seq, int heads, int context, int bf16_in, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool small = small_tiles(batch, seq, heads);
  if (bf16_in)
    return small ? launch_bf16<2, WINDOW>(qkv, lengths, cos_t, sin_t, out, k_rot, batch, seq,
                                          heads, context, s)
                 : launch_bf16<4, WINDOW>(qkv, lengths, cos_t, sin_t, out, k_rot, batch, seq,
                                          heads, context, s);
  return small ? launch_f32<32, WINDOW>(qkv, lengths, cos_t, sin_t, out, k_rot, batch, seq,
                                        heads, context, s)
               : launch_f32<64, WINDOW>(qkv, lengths, cos_t, sin_t, out, k_rot, batch, seq,
                                        heads, context, s);
}

}  // namespace

extern "C" {

// B1. lengths: [B] int32 on the device. is_bf16 != 0 selects bfloat16 tensors,
// else float32. Returns a cudaError_t (0 on success).
int ptts_causal_attn_qkv(const void* qkv, const void* lengths, const void* cos_t,
                         const void* sin_t, void* out, void* k_rot, int batch, int seq,
                         int heads, int is_bf16, void* stream) {
  return launch<false>(qkv, lengths, cos_t, sin_t, out, k_rot, batch, seq, heads, 0, is_bf16,
                       stream);
}

// B2. Returns a cudaError_t (0 on success).
int ptts_window_attn_qkv(const void* qkv, const void* cos_t, const void* sin_t, void* out,
                         int batch, int seq, int heads, int context, int is_bf16, void* stream) {
  return launch<true>(qkv, nullptr, cos_t, sin_t, out, nullptr, batch, seq, heads, context,
                      is_bf16, stream);
}

// How many times the library has raised a kernel's shared-memory limit
// (once per kernel and device; a second launch at any shape adds nothing).
int ptts_attr_calls(void) { return g_attr_calls.load(); }

const char* ptts_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
