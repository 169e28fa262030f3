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
// Design: split-S flash decoding in two kernels.
//   1. The chunk kernel: one block of 128 threads per (kv head, sequence,
//      chunk of `chunk` cache rows).  The grid is sized from S alone,
//      (Hkv, B, ceil(S / chunk)): the lengths live on the device, and
//      reading them on the host would put a sync in every layer of every
//      decode step.  A block whose chunk starts at or past L exits at once.
//      The others walk their rows in 64-row tiles, copied into shared
//      memory by 16-byte cp.async two stages deep, K and V in separate
//      groups, so the next tile lands while this one is computed and V
//      lands while the scores are; each K and V row is read from device
//      memory once for all G query heads of its group.  Rows are padded by
//      16 bytes so a warp's reads of eight rows hit distinct banks.  The
//      block keeps an f32 online softmax (running max m and denominator l
//      per head) and writes its unnormalised partial (m[G], l[G],
//      acc[G][d]) to a workspace the wrapper allocates.  A chunk that holds
//      a row always holds a valid one, so m is finite and no
//      exp(-inf - (-inf)) arises.
//      bf16 runs on the tensor cores (decode_attn_chunk_mma: mma.sync
//      m16n8k16, f32 accumulation): a warp scores 16 rows against the
//      group's heads padded to 8, the unnormalised weights go through
//      shared memory as bf16 (the plain version rounds its normalised
//      weights to v's dtype too), and PV runs as O^T = V^T P^T.  Without
//      the tensor cores the SIMT loops held each block on its own
//      shared-memory reads and shuffles, as long as on its loads.  f32 runs
//      on the SIMT kernel (decode_attn_chunk), which keeps f32 products.
//   2. decode_attn_combine: a thread per output element folds the
//      ceil(L / chunk) partials of its (sequence, head) in one pass,
//      rescaling by exp(m_c - max m), and divides by the rescaled sum of l.
// At the served shapes (B 8, S 2048, chunk 256) the chunk kernel has up to
// 512 blocks, three to an SM (~74 KB of shared memory each), where one
// block per (kv head, sequence) gave 64 blocks on 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr int MAX_TILE = THREADS / 2;        // two threads a row in phase 1
constexpr int CPT = MAX_D / THREADS;         // accumulator columns a thread owns
constexpr int STAGES = 2;
constexpr size_t SMEM_BUDGET = 136 * 1024;   // dynamic shared memory for the tiles

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive floats from a 16-byte aligned shared-memory address
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // every cp.async group but the N newest has landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes, or zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// The f32 chunk kernel (SIMT): scores with two threads a row, all G heads
// at once; PV with a thread per column of the (G, d) accumulator.
template <int G>
__global__ void __launch_bounds__(THREADS)
decode_attn_chunk(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ lengths,
                  float* __restrict__ part, int S, int Hkv, int d, int chunk,
                  int tile, float scale) {
  using T = float;
  __shared__ __align__(16) float q_sh[G][MAX_D];
  __shared__ __align__(16) float p_sh[G][MAX_TILE];
  __shared__ float red_sh[WARPS][G];
  extern __shared__ __align__(16) unsigned char kv_sh[];  // [stages][K|V][tile][row]

  const int h = blockIdx.x, b = blockIdx.y, ch = blockIdx.z;
  const int L = min(lengths[b], S);
  const int r0 = ch * chunk;
  if (r0 >= L) return;  // the combine reads only the chunks that hold rows
  const int r1 = min(r0 + chunk, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qo = ((long long)b * Hkv + h) * G * d;  // q as (B, Hkv, G, d)
  const long long row = (long long)Hkv * d;               // cache row stride
  const T* kb = k + (long long)b * S * row + (long long)h * d;
  const T* vb = v + (long long)b * S * row + (long long)h * d;
  const int ks = k_stride<T>(d);
  const int cpr = d * (int)sizeof(T) / 16;  // 16-byte chunks a row
  const size_t stage_elems = (size_t)tile * (ks + d);

  auto k_stage = [&](int s) { return reinterpret_cast<T*>(kv_sh) + s * stage_elems; };
  auto v_stage = [&](int s) { return k_stage(s) + (size_t)tile * ks; };
  // K and V of a tile go in two cp.async groups: the scores and the
  // softmax run while V is still landing
  auto load_rows = [&](T* dst, int stride, const T* src, int t0) {
    const int n = min(tile, r1 - t0);
    for (int idx = tid; idx < n * cpr; idx += THREADS) {
      const int r = idx / cpr, c = (idx % cpr) * (16 / (int)sizeof(T));
      cp_async16(dst + (size_t)r * stride + c, src + (long long)(t0 + r) * row + c);
    }
    cp_async_commit();
  };

  load_rows(k_stage(0), ks, kb, r0);
  load_rows(v_stage(0), d, vb, r0);
  for (int i = tid; i < G * d; i += THREADS) q_sh[i / d][i % d] = q[qo + i] * scale;
  float acc[G][CPT], m_run[G], l_run[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[g][j] = 0.f;
  }

  for (int t0 = r0, it = 0; t0 < r1; t0 += tile, ++it) {
    const int s = it & 1;
    if (t0 + tile < r1) {
      load_rows(k_stage(s ^ 1), ks, kb, t0 + tile);
      load_rows(v_stage(s ^ 1), d, vb, t0 + tile);
    } else {  // two empty groups keep the count the waits rely on
      cp_async_commit();
      cp_async_commit();
    }
    cp_async_wait<3>();  // this tile's K
    __syncthreads();
    const int n = min(tile, r1 - t0);
    const T* kt = k_stage(s);
    const T* vt = v_stage(s);

    // 1. scores: threads 2r and 2r + 1 take cache row r, all G heads, each
    // the alternate 8-element groups of d, summed by one shuffle
    const int r = tid >> 1, half = tid & 1;
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    if (r < n) {
      const T* kr = kt + (size_t)r * ks;
      for (int i = 8 * half; i < d; i += 16) {
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
      sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 1);
      if (r >= n) sc[g] = -INFINITY;
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
      const float m_new = fmaxf(m_run[g], mt);  // finite: the tile holds a row
      alpha[g] = expf(m_run[g] - m_new);  // 0 on the first tile
      m_run[g] = m_new;
      const float p = r < n ? expf(sc[g] - m_new) : 0.f;
      if (!half && r < tile) p_sh[g][r] = p;
      sc[g] = half ? 0.f : p;  // each row counted once in the sum
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

    cp_async_wait<2>();  // this tile's V
    __syncthreads();

    // 3. PV: thread tid owns columns tid + THREADS*j of all G heads; the
    // weights of four rows come in one 16-byte read
    const int n4 = n & ~3;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + THREADS * j;
      if (c >= d) continue;
      const T* vc = vt + c;
      int t = 0;
      for (; t < n4; t += 4) {
        float vr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vr[u] = vc[(size_t)(t + u) * d];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 pg = *reinterpret_cast<const float4*>(&p_sh[g][t]);
          float a = acc[g][j];
          a = fmaf(pg.x, vr[0], a);
          a = fmaf(pg.y, vr[1], a);
          a = fmaf(pg.z, vr[2], a);
          acc[g][j] = fmaf(pg.w, vr[3], a);
        }
      }
      for (; t < n; ++t) {
        const float vr = vc[(size_t)t * d];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][j] = fmaf(p_sh[g][t], vr, acc[g][j]);
      }
    }
    __syncthreads();  // the next iteration refills this stage, p_sh and red_sh
  }

  // 4. the partial, unnormalised: m[G], l[G], acc[G][d]
  float* pp = part + (((long long)b * Hkv + h) * gridDim.z + ch) * (G * (d + 2));
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (tid == g) {  // a constant index: m_run and l_run stay in registers
      pp[g] = m_run[g];
      pp[G + g] = l_run[g];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + THREADS * j;
      if (c < d) pp[2 * G + g * d + c] = acc[g][j];
    }
  }
}

// The bf16 chunk kernel on the tensor cores (mma.sync m16n8k16, f32
// accumulation).  Four warps; warp w scores rows 16w .. 16w+15 of a 64-row
// tile against the NB*8 (padded) heads of the group, and in PV owns the
// 16-column blocks w, w+4, ... of O^T = V^T P^T.  The unnormalised weights
// go through shared memory as bf16 (rows of a head contiguous) to become
// the B operand of PV.  Rows past the end of the sequence are zero-filled
// by cp.async up to the next multiple of 16, so no garbage meets a zero
// weight; the pad columns of K (d % 16 == 8) are zeroed once.
template <int G>
__global__ void __launch_bounds__(THREADS)
decode_attn_chunk_mma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ lengths, float* __restrict__ part, int S,
                      int Hkv, int d, int chunk, int tile, float scale) {
  using T = __nv_bfloat16;
  constexpr int NB = (G + 7) / 8;     // 8-head blocks
  constexpr int MBW = MAX_D / 16 / WARPS;  // 16-column blocks a warp owns at most
  __shared__ __align__(16) T qb_sh[NB * 8][MAX_D + 8];
  __shared__ __align__(16) T pb_sh[NB * 8][MAX_TILE + 8];
  __shared__ float red_max[WARPS][NB * 8];
  __shared__ float red_sum[WARPS][NB * 8];
  extern __shared__ __align__(16) unsigned char kv_sh[];  // [stages][K|V][tile][row]

  const int h = blockIdx.x, b = blockIdx.y, ch = blockIdx.z;
  const int L = min(lengths[b], S);
  const int r0 = ch * chunk;
  if (r0 >= L) return;  // the combine reads only the chunks that hold rows
  const int r1 = min(r0 + chunk, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qo = ((long long)b * Hkv + h) * G * d;  // q as (B, Hkv, G, d)
  const long long row = (long long)Hkv * d;               // cache row stride
  const T* kb = k + (long long)b * S * row + (long long)h * d;
  const T* vb = v + (long long)b * S * row + (long long)h * d;
  const int ks = k_stride<T>(d);  // K and V rows padded by 8 elements
  const int dk = (d + 15) & ~15;  // d in whole 16-element k-steps
  const int cpr = d / 8;          // 16-byte chunks a row
  const size_t stage_elems = (size_t)tile * 2 * ks;

  auto k_stage = [&](int s) { return reinterpret_cast<T*>(kv_sh) + s * stage_elems; };
  auto v_stage = [&](int s) { return k_stage(s) + (size_t)tile * ks; };
  // rows t0 .. t0+n-1 of K or V, zeros up to the next multiple of 16
  auto load_rows = [&](T* dst, int stride, const T* src, int t0) {
    const int n = min(tile, r1 - t0), n16 = min((n + 15) & ~15, tile);
    for (int idx = tid; idx < n16 * cpr; idx += THREADS) {
      const int rr = idx / cpr, c = (idx % cpr) * 8;
      const bool in = rr < n;
      cp_async16_zfill(dst + (size_t)rr * stride + c,
                       src + (long long)(t0 + (in ? rr : 0)) * row + c, in ? 16 : 0);
    }
    cp_async_commit();
  };

  load_rows(k_stage(0), ks, kb, r0);
  load_rows(v_stage(0), ks, vb, r0);
  for (int i = tid; i < NB * 8 * dk; i += THREADS) {
    const int g = i / dk, c = i % dk;
    qb_sh[g][c] = g < G && c < d ? q[qo + (long long)g * d + c] : __float2bfloat16(0.f);
  }
  const int stages = chunk > tile ? 2 : 1;
  for (int i = tid; i < stages * tile; i += THREADS)  // K's pad columns
    *reinterpret_cast<uint4*>(k_stage(i / tile) + (size_t)(i % tile) * ks + d) =
        make_uint4(0, 0, 0, 0);

  const int ra = lane >> 2, cg = 2 * (lane & 3);  // fragment row and head pair
  float acc[MBW][NB][4], m_run[NB][2], l_run[NB][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_run[nb][j] = -INFINITY;
      l_run[nb][j] = 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < MBW; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nb][e] = 0.f;
  }

  for (int t0 = r0, it = 0; t0 < r1; t0 += tile, ++it) {
    const int s = it & 1;
    if (t0 + tile < r1) {
      load_rows(k_stage(s ^ 1), ks, kb, t0 + tile);
      load_rows(v_stage(s ^ 1), ks, vb, t0 + tile);
    } else {  // two empty groups keep the count the waits rely on
      cp_async_commit();
      cp_async_commit();
    }
    cp_async_wait<3>();  // this tile's K
    __syncthreads();
    const int n = min(tile, r1 - t0), n16 = min((n + 15) & ~15, tile);
    const T* kt = k_stage(s);
    const T* vt = v_stage(s);

    // 1. scores of rows 16w + ra (+8) against heads nb*8 + cg (+1)
    const int rw = 16 * warp;
    float sc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
    if (rw < n) {
      for (int kk = 0; kk < dk; kk += 16) {
        unsigned a[4];
        ldmatrix_x4(a, kt + (size_t)(rw + ((lane >> 3) & 1) * 8 + (lane & 7)) * ks + kk +
                           (lane >> 4) * 8);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          unsigned bq[2];
          ldmatrix_x2(bq, &qb_sh[nb * 8 + (lane & 7)][kk + ((lane >> 3) & 1) * 8]);
          mma_bf16(sc[nb], a, bq);
        }
      }
    }
    const bool va = rw + ra < n, vb8 = rw + ra + 8 < n;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[nb][j] = va ? sc[nb][j] * scale : -INFINITY;
        sc[nb][2 + j] = vb8 ? sc[nb][2 + j] * scale : -INFINITY;
        float mx = fmaxf(sc[nb][j], sc[nb][2 + j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        if (lane < 4) red_max[warp][nb * 8 + cg + j] = mx;
      }
    __syncthreads();

    // 2. online softmax per head: every lane keeps m and l of its heads
    float alpha[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int g = nb * 8 + cg + j;
        float mt = red_max[0][g];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) mt = fmaxf(mt, red_max[w][g]);
        const float m_new = fmaxf(m_run[nb][j], mt);  // finite: the tile holds a row
        alpha[nb][j] = expf(m_run[nb][j] - m_new);   // 0 on the first tile
        m_run[nb][j] = m_new;
        const float p0 = va ? expf(sc[nb][j] - m_new) : 0.f;
        const float p1 = vb8 ? expf(sc[nb][2 + j] - m_new) : 0.f;
        pb_sh[g][rw + ra] = __float2bfloat16(p0);
        pb_sh[g][rw + ra + 8] = __float2bfloat16(p1);
        float sum = p0 + p1;
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        if (lane < 4) red_sum[warp][g] = sum;
      }
    cp_async_wait<2>();  // this tile's V
    __syncthreads();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int g = nb * 8 + cg + j;
        float sum = red_sum[0][g];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum += red_sum[w][g];
        l_run[nb][j] = l_run[nb][j] * alpha[nb][j] + sum;
#pragma unroll
        for (int mi = 0; mi < MBW; ++mi) {
          acc[mi][nb][j] *= alpha[nb][j];
          acc[mi][nb][2 + j] *= alpha[nb][j];
        }
      }

    // 3. PV: O^T[col][g] += V^T[col][row] P^T[row][g], 16 rows a step
    for (int kk = 0; kk < n16; kk += 16) {
      unsigned bp[NB][2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        ldmatrix_x2(bp[nb], &pb_sh[nb * 8 + (lane & 7)][kk + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int mi = 0; mi < MBW; ++mi) {
        const int c0 = 16 * (warp + WARPS * mi);
        if (c0 >= dk) break;
        unsigned av[4];
        ldmatrix_x4_trans(av, vt + (size_t)(kk + (lane >> 4) * 8 + (lane & 7)) * ks + c0 +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_bf16(acc[mi][nb], av, bp[nb]);
      }
    }
    __syncthreads();  // the next iteration refills this stage, pb_sh and the sums
  }

  // 4. the partial, unnormalised: m[G], l[G], acc[G][d]
  float* pp = part + (((long long)b * Hkv + h) * gridDim.z + ch) * (G * (d + 2));
  if (warp == 0 && lane < 4) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int g = nb * 8 + cg + j;
        if (g < G) {
          pp[g] = m_run[nb][j];
          pp[G + g] = l_run[nb][j];
        }
      }
  }
#pragma unroll
  for (int mi = 0; mi < MBW; ++mi) {
    const int c0 = 16 * (warp + WARPS * mi);
    if (c0 >= dk) break;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = nb * 8 + cg + (e & 1), col = c0 + ra + 8 * (e >> 1);
        if (g < G && col < d) pp[2 * G + g * d + col] = acc[mi][nb][e];
      }
  }
}

// out[b, h*G + g, c] = sum_ch e_ch * acc_ch[g][c] / sum_ch e_ch * l_ch[g],
// e_ch = exp(m_ch[g] - max_ch m_ch[g]), over the chunks that hold rows; a
// thread per output element folds the chunks in one pass, rescaling its
// running sums whenever the running max rises
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_combine(const float* __restrict__ part, const int* __restrict__ lengths,
                    T* __restrict__ out, int S, int Hkv, int G, int d, int chunk,
                    int nc) {
  const int i = blockIdx.x * THREADS + threadIdx.x;  // g * d + column
  const int h = blockIdx.y, b = blockIdx.z;
  if (i >= G * d) return;
  const int g = i / d;
  const int L = min(lengths[b], S);
  const int n = (L + chunk - 1) / chunk;
  const int w = G * (d + 2);
  const float* pc = part + ((long long)b * Hkv + h) * nc * w;
  float m = -INFINITY, l = 0.f, a = 0.f;
#pragma unroll 8
  for (int c = 0; c < n; ++c, pc += w) {
    const float mc = pc[g], lc = pc[G + g], ac = pc[2 * G + i];
    const float mn = fmaxf(m, mc);
    const float r = expf(m - mn), e = expf(mc - mn);  // r = 0 on the first chunk
    l = fmaf(l, r, lc * e);
    a = fmaf(a, r, ac * e);
    m = mn;
  }
  out[((long long)b * Hkv + h) * G * d + i] = from_f<T>(a / l);
}

template <typename T, int G>
int launch_g(const T* q, const T* k, const T* v, const int* lengths, float* part,
             T* out, int B, int S, int Hkv, int d, int chunk, void* stream) {
  constexpr bool mma = std::is_same<T, __nv_bfloat16>::value;
  const int nc = (S + chunk - 1) / chunk;
  const int vs = mma ? k_stride<T>(d) : d;  // V row stride in shared memory
  int tile = MAX_TILE;
  auto smem_for = [&](int t) {
    return (size_t)(chunk > t ? STAGES : 1) * t * (k_stride<T>(d) + vs) * sizeof(T);
  };
  while (tile > 8 && smem_for(tile) > SMEM_BUDGET) tile /= 2;
  const size_t smem = smem_for(tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hkv, B, nc);
  const float scale = 1.0f / sqrtf((float)d);
  cudaError_t err;
  if constexpr (mma) {
    err = cudaFuncSetAttribute(decode_attn_chunk_mma<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_attn_chunk_mma<G><<<grid, THREADS, smem, st>>>(q, k, v, lengths, part, S, Hkv,
                                                          d, chunk, tile, scale);
  } else {
    err = cudaFuncSetAttribute(decode_attn_chunk<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_attn_chunk<G><<<grid, THREADS, smem, st>>>(q, k, v, lengths, part, S, Hkv, d,
                                                      chunk, tile, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attn_combine<T><<<dim3((G * d + THREADS - 1) / THREADS, Hkv, B), THREADS, 0, st>>>(
      part, lengths, out, S, Hkv, G, d, chunk, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* lengths, float* part, T* out,
           int B, int S, int Hkv, int G, int d, int chunk, void* stream) {
  // the wrapper checks these; a bad call never reaches the kernel
  if (d < 8 || d > MAX_D || d % 8 != 0 || chunk < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hkv <= 0 || S <= 0) return (int)cudaGetLastError();
#define DECODE_ATTN_G(n) \
  case n:                \
    return launch_g<T, n>(q, k, v, lengths, part, out, B, S, Hkv, d, chunk, stream);
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
                               const int* lengths, float* part, float* out, int B,
                               int S, int Hkv, int G, int d, int chunk, void* stream) {
  return launch<float>(q, k, v, lengths, part, out, B, S, Hkv, G, d, chunk, stream);
}

extern "C" int decode_attn_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const int* lengths, float* part,
                                __nv_bfloat16* out, int B, int S, int Hkv, int G, int d,
                                int chunk, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, part, out, B, S, Hkv, G, d, chunk,
                               stream);
}
