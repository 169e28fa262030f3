// GQA flash-decode attention: one query token per sequence against its
// KV cache, with an f32 online softmax.
//
// Replaces the Pallas kernel ``decode_attn_blocked`` of
// src/repro/kernels/decode_attn/kernel.py, and the S padding of its wrapper
// (ops.decode_attn pads the cache to a multiple of 512, a copy of every
// layer's cache at every step): this kernel masks the ragged end itself,
// so the cache is read where it lies and never copied.
//
//   L = min(lengths[b], S)
//   out[b, h*G + g, :] = sum_{j<L} softmax_j(q[b, h*G + g, :] . k[b, j, h, :] / sqrt(d))
//                        * v[b, j, h, :]
//
// Heads are grouped contiguously: query head h*G + g reads kv head h.  A
// length above S attends over all S entries (the reference's ref.py; its
// Pallas path would count the zero padding as valid there).
//
// Bound on the H100: bytes.  The work is 4*G*d operations per valid cache
// row against 2*d*sizeof(T) bytes of K and V, far below the ~295
// operations a byte where the tensor cores would be the limit.  The
// compulsory traffic is the valid K/V rows, q and the output, each once.
//
// Design: one block of 128 threads per (kv head, sequence).  The block
// walks its valid rows in tiles of up to 128; K and V tiles are copied
// into shared memory with 16-byte cp.async, two stages deep, so the next
// tile's loads are in flight while the current one is computed.  Each K
// and V row is read from device memory once for all G query heads of its
// group (the point of GQA).  Per tile:
//   1. scores: a thread per cache row, all G heads at once, 16-byte
//      shared-memory reads (K rows padded by 16 bytes, so the threads of
//      a quarter-warp hit distinct banks);
//   2. online softmax: block max and sum per head through warp shuffles
//      and a 4-warp combine; every thread keeps the running max and
//      denominator (f32) of every head in registers, so no thread waits
//      on another to publish them;
//   3. PV: each thread owns columns of the (G, d) accumulator, in
//      registers, rescaled by exp(m_old - m_new) and summed over the tile.
// The grid is B * Hkv blocks (64 at the served shapes on 132 SMs) and the
// longest sequence sets the time: splitting S across blocks with a
// combine pass is the lead for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr int MAX_TILE = THREADS;            // a thread per row in phase 1
constexpr int CPT = MAX_D / THREADS;         // accumulator columns a thread owns
constexpr int STAGES = 2;
constexpr size_t SMEM_BUDGET = 136 * 1024;   // dynamic shared memory for the tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive elements from a 16-byte aligned shared-memory address
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T>
__host__ __device__ constexpr int k_stride(int d) {  // padded K row, in elements
  return d + 16 / (int)sizeof(T);
}

// G is a template parameter: every loop over the group's heads unrolls
// exactly, with no per-head guard inside the hot loops.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, int S, int Hkv, int d, int tile, float scale) {
  __shared__ __align__(16) float q_sh[G][MAX_D];
  __shared__ float p_sh[G][MAX_TILE];
  __shared__ float red_sh[WARPS][G];
  extern __shared__ __align__(16) unsigned char kv_sh[];  // [STAGES][K|V][tile][row]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = min(lengths[b], S);
  const long long qo = ((long long)b * Hkv + h) * G * d;  // q/out as (B, Hkv, G, d)
  const long long row = (long long)Hkv * d;               // cache row stride
  const T* kb = k + (long long)b * S * row + (long long)h * d;
  const T* vb = v + (long long)b * S * row + (long long)h * d;
  const int ks = k_stride<T>(d);
  const int cpr = d * (int)sizeof(T) / 16;  // 16-byte chunks a row
  const size_t stage_elems = (size_t)tile * (ks + d);

  auto k_stage = [&](int s) { return reinterpret_cast<T*>(kv_sh) + s * stage_elems; };
  auto v_stage = [&](int s) { return k_stage(s) + (size_t)tile * ks; };
  auto load_tile = [&](int s, int t0) {
    const int n = min(tile, L - t0);
    T* kd = k_stage(s);
    T* vd = v_stage(s);
    for (int idx = tid; idx < n * cpr; idx += THREADS) {
      const int r = idx / cpr, c = (idx % cpr) * (16 / (int)sizeof(T));
      const long long g_off = (long long)(t0 + r) * row + c;
      cp_async16(kd + (size_t)r * ks + c, kb + g_off);
      cp_async16(vd + (size_t)r * d + c, vb + g_off);
    }
  };

  for (int i = tid; i < G * d; i += THREADS) q_sh[i / d][i % d] = to_f(q[qo + i]) * scale;
  float acc[G][CPT], m_run[G], l_run[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[g][j] = 0.f;
  }

  if (L > 0) load_tile(0, 0);
  cp_async_commit();
  for (int t0 = 0, it = 0; t0 < L; t0 += tile, ++it) {
    const int s = it & 1;
    if (t0 + tile < L) load_tile(s ^ 1, t0 + tile);
    cp_async_commit();
    cp_async_wait_one();  // every group but the one just issued: this tile
    __syncthreads();
    const int n = min(tile, L - t0);
    const T* kt = k_stage(s);
    const T* vt = v_stage(s);

    // 1. scores: thread tid takes cache row tid, all G heads
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = tid < n ? 0.f : -INFINITY;
    if (tid < n) {
      const T* kr = kt + (size_t)tid * ks;
      for (int i = 0; i < d; i += 8) {
        float kx[8];
        load8(kr + i, kx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float qx[8];
          load8(&q_sh[g][i], qx);
#pragma unroll
          for (int e = 0; e < 8; ++e) sc[g] = fmaf(qx[e], kx[e], sc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mx = warp_max(sc[g]);
      if (lane == 0) red_sh[warp][g] = mx;
    }
    __syncthreads();

    // 2. online softmax: every thread updates its own copy of m and l
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = red_sh[0][g];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) mt = fmaxf(mt, red_sh[w][g]);
      const float m_new = fmaxf(m_run[g], mt);
      alpha[g] = expf(m_run[g] - m_new);  // 0 on the first tile
      m_run[g] = m_new;
      const float p = tid < n ? expf(sc[g] - m_new) : 0.f;
      if (tid < tile) p_sh[g][tid] = p;
      sc[g] = p;
    }
    __syncthreads();  // every warp has read red_sh's maxima
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sum = warp_sum(sc[g]);
      if (lane == 0) red_sh[warp][g] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sum = red_sh[0][g];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum += red_sh[w][g];
      l_run[g] = l_run[g] * alpha[g] + sum;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[g][j] *= alpha[g];
    }

    // 3. PV: thread tid owns columns tid + THREADS*j of all G heads
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      float vr[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tid + THREADS * j;
        vr[j] = c < d ? to_f(vt[(size_t)t * d + c]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = p_sh[g][t];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[g][j] = fmaf(p, vr[j], acc[g][j]);
      }
    }
    __syncthreads();  // the next iteration refills this stage, p_sh and red_sh
  }

  // 4. normalise; output in q's dtype
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float inv = 1.f / l_run[g];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + THREADS * j;
      if (c < d) out[qo + (long long)g * d + c] = from_f<T>(acc[g][j] * inv);
    }
  }
}

template <typename T, int G>
int launch_g(const T* q, const T* k, const T* v, const int* lengths, T* out, int B,
             int S, int Hkv, int d, void* stream) {
  int tile = MAX_TILE;
  auto smem_for = [&](int t) {
    return (size_t)STAGES * t * (k_stride<T>(d) + d) * sizeof(T);
  };
  while (tile > 8 && smem_for(tile) > SMEM_BUDGET) tile /= 2;
  const size_t smem = smem_for(tile);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  decode_attn_kernel<T, G><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, lengths, out, S, Hkv, d, tile, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* lengths, T* out, int B,
           int S, int Hkv, int G, int d, void* stream) {
  // the wrapper checks these; a bad call never reaches the kernel
  if (d < 8 || d > MAX_D || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hkv <= 0) return (int)cudaGetLastError();
#define DECODE_ATTN_G(n) \
  case n:                \
    return launch_g<T, n>(q, k, v, lengths, out, B, S, Hkv, d, stream);
  switch (G) {
    DECODE_ATTN_G(1) DECODE_ATTN_G(2) DECODE_ATTN_G(3) DECODE_ATTN_G(4)
    DECODE_ATTN_G(5) DECODE_ATTN_G(6) DECODE_ATTN_G(7) DECODE_ATTN_G(8)
    DECODE_ATTN_G(9) DECODE_ATTN_G(10) DECODE_ATTN_G(11) DECODE_ATTN_G(12)
    DECODE_ATTN_G(13) DECODE_ATTN_G(14) DECODE_ATTN_G(15) DECODE_ATTN_G(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DECODE_ATTN_G
}

}  // namespace

extern "C" int decode_attn_f32(const float* q, const float* k, const float* v,
                               const int* lengths, float* out, int B, int S,
                               int Hkv, int G, int d, void* stream) {
  return launch<float>(q, k, v, lengths, out, B, S, Hkv, G, d, stream);
}

extern "C" int decode_attn_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const int* lengths,
                                __nv_bfloat16* out, int B, int S, int Hkv, int G,
                                int d, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, Hkv, G, d, stream);
}
