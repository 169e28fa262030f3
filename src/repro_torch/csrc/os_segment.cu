// Fused overlap-save segment pipeline, from cached segment spectra or from
// raw input.
//
// Replaces the Pallas kernels ``os_segment_planes`` (entry
// ``os_segment_f32``; full and tail form, the tail form's lead crop stays
// in the Python wrapper) and ``os_segment_conv_planes`` (entry
// ``os_segment_conv_f32``) of src/repro/kernels/os_segment/kernel.py.
// Per (sample, segment):
//
//   [conv form] F = fx . fy . fz (x segment)    (forward DFT, three passes)
//   Z  = sum_i F[i] * W[:, i]  + b * A*B*C on bin (0,0,0)      (MAD + bias)
//   Y1 = Z  x_a ea   (A -> s   : only the segment's seg_core output rows)
//   Y2 = Y1 x_b eb   (B -> oy  : only the valid output rows)
//   out = Re(Y2) x_c mr + Im(Y2) x_c mi   (C'' -> oz, real)
//
// ea/eb/mr/mi are the inverse DFT matrices with the valid crop folded in
// (built by ops._inverse_mats); mr/mi carry the hermitian weights 1 at DC
// and at the even-C Nyquist bin, 2 elsewhere, where sin vanishes so the
// imaginary part is ignored exactly as a c2r transform ignores it.
//
// The conv form's forward transform is the TPU kernel's in-kernel matmul
// DFT, in the same pass order: a real-input pass along z that takes the nz
// live samples of each row to the C'' rfft bins (fz), then the complex
// product along y (ny -> B, fy), then along x (seg_extent -> A, fx).  The
// segment windows are read straight from x: segment q's row e is x-row
// q*seg_core + e, and rows past the input extent read as zeros (the
// reference's ``input_pad``).  The forward matrices come from
// ops._forward_mats.
//
// What bounds it on the H100: operations.  At n337's layer 2 (16 samples
// of 80 x 73^3, fft (6, 75, 75)) the matmul DFT passes do ~0.6 TFLOP and
// the MAD ~0.25 in fp32, outside the tensor cores, against ~6 GB moved per
// pass.  The TPU kernel kept two whole-segment (fp_block, A, B, C'')
// accumulators in VMEM; at full width one output channel's segment
// spectrum is megabytes, far beyond the 227 KB of shared memory a block
// may use.  So each pass writes a scratch buffer the wrapper allocates and
// is its own kernel, of one of three shapes:
// * rows_gemm, the last (contiguous) axis as a real product with a small
//   matrix: the forward z pass (real x rows -> C'' bins: fz read as the
//   float matrix (nz, 2C'')) and the inverse c pass (the spectra read as
//   floats (P, 2C'') against mr and mi interleaved row by row, each row of
//   output written straight into its valid output column: no reassembly
//   copy).  A block owns 128 rows x 16*RN columns; each thread an 8 x RN
//   register tile, reading its rows' four k at a time as 16-byte shared
//   loads.
// * axis_product, a long middle axis (y forward, b inverse): a complex
//   product over K of L (K, N) with the columns (p, r) of the input; a
//   block owns 64 columns x 16*RN outputs, each thread an RN x 4 tile.
// * short_axis, a middle axis with K, N <= 8 (x forward: seg_extent -> A;
//   a inverse: A -> seg_core): one thread per (p, r) column holds its K
//   inputs in registers and writes its N outputs; bytes-bound.
// The long passes walk K in chunks of 16 through a two-stage cp.async ring
// (next chunk's copies in flight while this one is multiplied); the MAD is
// cmul_mad.cuh's.  Channels are not padded to the TPU's F_CHUNK (n337's
// layer 0 has f = 1), and no extent needs to be a multiple of a tile: the
// copies zero-fill outside the operands and the stores are masked.
#include "cmul_mad.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 16;           // K a pipeline stage
constexpr int kAxTC = 64;         // axis_product: columns a block
constexpr int kRowTP = 128;       // rows_gemm: rows a block
constexpr int kRowLD = kKC + 4;   // its staged row: 16-byte aligned, and
                                  // neighbouring rows on distinct banks

// out[p, n, r] = sum_k L[k, n] * in[p, k, r]   (complex), over the C = P*R
// columns (p, r).  grid (ceil(C/64), ceil(N/(16*RN))); block 256 =
// 16 column lanes x 16 output lanes.
template <int RN, int VEC>
__global__ void __launch_bounds__(kThreads)
    axis_product(const float2* __restrict__ in, const float2* __restrict__ L,
                 float2* __restrict__ out, int K, int N, long long R, long long C) {
  constexpr int TN = 16 * RN;
  constexpr int VPR = kAxTC / VEC;      // copies a staged k-row
  constexpr int KSTEP = kThreads / VPR;  // k-rows a pass of the block
  __shared__ __align__(16) float2 Is[2][kKC][kAxTC];
  __shared__ __align__(16) float2 Ls[2][kKC][TN];
  const int tid = threadIdx.x, tc = tid % 16, tn = tid / 16;
  const long long c0 = (long long)blockIdx.x * kAxTC;
  const int n0 = blockIdx.y * TN;
  // each thread copies the same VEC columns of every k-row; with VEC = 2,
  // R is even, so a pair never straddles two p
  const int cv = tid % VPR;
  long long src = -1;
  {
    const long long c = c0 + cv * VEC;
    if (c < C) {
      const long long p = c / R;
      src = p * K * R + (c - p * R);
    }
  }
  auto load = [&](int stage, int k0) {
    for (int kk = tid / VPR; kk < kKC; kk += KSTEP) {
      const int k = k0 + kk;
      const bool ok = src >= 0 && k < K;
      float2* dst = &Is[stage][kk][cv * VEC];
      const float2* g = ok ? in + src + (long long)k * R : in;
      if (VEC == 2) cp_async16z(dst, g, ok); else cp_async8z(dst, g, ok);
    }
    for (int e = tid; e < kKC * TN; e += kThreads) {
      const int kk = e / TN, nn = e % TN;
      const bool ok = k0 + kk < K && n0 + nn < N;
      cp_async8z(&Ls[stage][kk][nn], ok ? L + (long long)(k0 + kk) * N + n0 + nn : L, ok);
    }
  };
  float2 acc[RN][4];
#pragma unroll
  for (int u = 0; u < RN; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = make_float2(0.f, 0.f);
  const int nk = (K + kKC - 1) / kKC;
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) load((kc + 1) & 1, (kc + 1) * kKC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = kc & 1;
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      float2 a[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) a[v] = Is[st][kk][tc + 16 * v];
#pragma unroll
      for (int u = 0; u < RN; ++u) {
        const float2 l = Ls[st][kk][tn + 16 * u];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[u][v].x = fmaf(l.x, a[v].x, fmaf(-l.y, a[v].y, acc[u][v].x));
          acc[u][v].y = fmaf(l.x, a[v].y, fmaf(l.y, a[v].x, acc[u][v].y));
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's copies
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const long long c = c0 + tc + 16 * v;
    if (c >= C) continue;
    const long long p = c / R;
    float2* o = out + p * N * R + (c - p * R);
#pragma unroll
    for (int u = 0; u < RN; ++u) {
      const int n = n0 + tn + 16 * u;
      if (n < N) o[(long long)n * R] = acc[u][v];
    }
  }
}

// The same product for K, N <= 8: a thread per column (p, r), its K
// inputs in registers, L (zero-padded to 8 x 8) in shared memory.  The
// loop over outputs is not unrolled, so L stays in shared memory (unrolled,
// all of L was hoisted into registers, 164 a thread: one block an SM for a
// bytes-bound pass).
__global__ void __launch_bounds__(kThreads)
    short_axis(const float2* __restrict__ in, const float2* __restrict__ L,
               float2* __restrict__ out, int K, int N, long long R, long long C) {
  __shared__ float2 Ls[8][8];
  if (threadIdx.x < 64) {
    const int k = threadIdx.x / 8, n = threadIdx.x % 8;
    Ls[k][n] = (k < K && n < N) ? L[k * N + n] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x; c < C;
       c += (long long)gridDim.x * kThreads) {
    const long long p = c / R, r = c - p * R;
    const float2* src = in + p * K * R + r;
    float2 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = k < K ? src[(long long)k * R] : make_float2(0.f, 0.f);
    float2* dst = out + p * N * R + r;
#pragma unroll 1
    for (int n = 0; n < N; ++n) {
      float2 o = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float2 l = Ls[k][n];
        o.x = fmaf(l.x, v[k].x, fmaf(-l.y, v[k].y, o.x));
        o.y = fmaf(l.x, v[k].y, fmaf(l.y, v[k].x, o.y));
      }
      dst[(long long)n * R] = o;
    }
  }
}

// Where rows_gemm's input row p starts: row p of a (P, K) matrix, or
// (gather) the forward pass's row p = (((n*Q + q)*f + i)*E + e)*ny + y,
// which is x-row q*seg + e of (n, i) — zeros past nx, the reference's
// input_pad.
struct RowMap {
  int gather, Q, f, E, seg, nx, ny;
};
// Where its output row p goes: row p of a (P, N) matrix, or (scatter) the
// inverse pass's row p = (((n*Q + q)*fp + j)*s + x)*oy + y, segment j0 + q's
// output row x, which is output column c = (j0 + q)*s + x, kept when
// out0 - L <= c < out0 and written to (n, j, c - (out0 - L), y) of the
// (N, fp, L, oy, oz) output: the valid crop, the tail segment's crop and
// the trailing-column crop of the unfused path in one index map.
struct OutMap {
  int scatter, Q, fp, s, oy, j0, out0, L;
};

template <class I>
__device__ __forceinline__ long long in_row(I p, const RowMap& m, int K) {
  if (!m.gather) return (long long)p * K;
  const I y = p % m.ny; p /= m.ny;
  const I e = p % m.E; p /= m.E;
  const I i = p % m.f; p /= m.f;
  const I q = p % m.Q;
  const I n = p / m.Q;
  const I gx = q * m.seg + e;
  if (gx >= (I)m.nx) return -1;
  return ((((long long)n * m.f + i) * m.nx + gx) * m.ny + y) * K;
}

template <class I>
__device__ __forceinline__ long long out_row(I p, const OutMap& m, int N) {
  if (!m.scatter) return (long long)p * N;
  const I y = p % m.oy; p /= m.oy;
  const I x = p % m.s; p /= m.s;
  const I j = p % m.fp; p /= m.fp;
  const I q = p % m.Q;
  const I n = p / m.Q;
  const I c = (q + m.j0) * m.s + x, lo = m.out0 - m.L;
  if (c < lo || c >= (I)m.out0) return -1;
  return ((((long long)n * m.fp + j) * m.L + (c - lo)) * m.oy + y) * N;
}

// out[p', n] = sum_k A[p, k] * Bm[k, n]   (real), A's rows of K floats
// (input row p where ``map`` puts it), output row p' = ``omap``(p) of N
// floats.  Bm is B0 (K, N), or with B1 set the rows of B0 and B1 (K/2, N)
// interleaved: Bm[2c] = B0[c], Bm[2c+1] = B1[c].
// grid (ceil(P/128), ceil(N/(16*RN))); block 256 = 16 column lanes x
// 16 row lanes.
template <int RN, int VEC>
__global__ void __launch_bounds__(kThreads)
    rows_gemm(const float* __restrict__ A, RowMap map, const float* __restrict__ B0,
              const float* __restrict__ B1, float* __restrict__ out, OutMap omap,
              long long P, int K, int N) {
  constexpr int TN = 16 * RN;
  constexpr int VPR = kKC / VEC;  // copies a staged row
  __shared__ __align__(16) float As[2][kRowTP][kRowLD];
  __shared__ __align__(16) float Bs[2][kKC][TN];
  __shared__ long long rowoff[kRowTP], outoff[kRowTP];
  const int tid = threadIdx.x, tn = tid % 16, tp = tid / 16;
  const long long p0 = (long long)blockIdx.x * kRowTP;
  const int n0 = blockIdx.y * TN;
  if (tid < kRowTP) {
    // row indices in 32 bits where they fit: 64-bit division is slow
    const long long p = p0 + tid;
    long long in = -1, o = -1;
    if (p < P) {
      if (P <= 0xffffffffLL) {
        in = in_row((unsigned)p, map, K);
        o = out_row((unsigned)p, omap, N);
      } else {
        in = in_row(p, map, K);
        o = out_row(p, omap, N);
      }
    }
    rowoff[tid] = in;
    outoff[tid] = o;
  }
  __syncthreads();
  auto load = [&](int stage, int k0) {
    for (int e = tid; e < kRowTP * VPR; e += kThreads) {
      const int row = e / VPR, kv = (e % VPR) * VEC;
      const long long off = rowoff[row];
      const bool ok = off >= 0 && k0 + kv < K;
      float* dst = &As[stage][row][kv];
      const float* g = ok ? A + off + k0 + kv : A;
      if (VEC == 4) cp_async16z(dst, g, ok);
      else if (VEC == 2) cp_async8z(dst, g, ok);
      else cp_async4z(dst, g, ok);
    }
    for (int e = tid; e < kKC * TN; e += kThreads) {
      const int kk = e / TN, nn = e % TN;
      const int k = k0 + kk, n = n0 + nn;
      const bool ok = k < K && n < N;
      const float* g = !ok ? B0
                       : B1 == nullptr ? B0 + (long long)k * N + n
                                       : ((k & 1) ? B1 : B0) + (long long)(k >> 1) * N + n;
      cp_async4z(&Bs[stage][kk][nn], g, ok);
    }
  };
  float acc[8][RN];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < RN; ++v) acc[u][v] = 0.f;
  const int nk = (K + kKC - 1) / kKC;
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) load((kc + 1) & 1, (kc + 1) * kKC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = kc & 1;
#pragma unroll
    for (int kq = 0; kq < kKC; kq += 4) {
      float4 a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        a[u] = *reinterpret_cast<const float4*>(&As[st][tp + 16 * u][kq]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int v = 0; v < RN; ++v) {
          const float b = Bs[st][kq + q][tn + 16 * v];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float av = q == 0 ? a[u].x : q == 1 ? a[u].y : q == 2 ? a[u].z : a[u].w;
            acc[u][v] = fmaf(av, b, acc[u][v]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const long long o = outoff[tp + 16 * u];  // -1: past P, or cropped
    if (o < 0) continue;
#pragma unroll
    for (int v = 0; v < RN; ++v) {
      const int n = n0 + tn + 16 * v;
      if (n < N) out[o + n] = acc[u][v];
    }
  }
}

template <int RN>
cudaError_t launch_axis_rn(const float2* in, const float2* L, float2* out,
                           long long P, int K, int N, long long R, cudaStream_t st) {
  const long long C = P * R;
  dim3 grid((unsigned)((C + kAxTC - 1) / kAxTC), (unsigned)((N + 16 * RN - 1) / (16 * RN)));
  // 16-byte copies of column pairs: R even and ``in`` 16-byte aligned
  if (R % 2 == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0)
    axis_product<RN, 2><<<grid, kThreads, 0, st>>>(in, L, out, K, N, R, C);
  else
    axis_product<RN, 1><<<grid, kThreads, 0, st>>>(in, L, out, K, N, R, C);
  return cudaGetLastError();
}

// out (P, N, R) = L (K, N) applied along the middle axis of in (P, K, R)
cudaError_t launch_axis(const float2* in, const float2* L, float2* out,
                        long long P, int K, int N, long long R, cudaStream_t st) {
  const long long C = P * R;
  if (C <= 0 || N <= 0) return cudaGetLastError();
  if (K <= 8 && N <= 8) {
    long long blocks = (C + kThreads - 1) / kThreads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    short_axis<<<(unsigned)blocks, kThreads, 0, st>>>(in, L, out, K, N, R, C);
    return cudaGetLastError();
  }
  switch ((N + 15) / 16) {
    case 1: return launch_axis_rn<1>(in, L, out, P, K, N, R, st);
    case 2: return launch_axis_rn<2>(in, L, out, P, K, N, R, st);
    case 3: return launch_axis_rn<3>(in, L, out, P, K, N, R, st);
    case 4: return launch_axis_rn<4>(in, L, out, P, K, N, R, st);
    default: return launch_axis_rn<5>(in, L, out, P, K, N, R, st);
  }
}

template <int RN>
cudaError_t launch_rows_rn(const float* A, RowMap map, const float* B0, const float* B1,
                           float* out, OutMap omap, long long P, int K, int N,
                           cudaStream_t st) {
  dim3 grid((unsigned)((P + kRowTP - 1) / kRowTP), (unsigned)((N + 16 * RN - 1) / (16 * RN)));
  // a row's copies may be as wide as its start's alignment: every row
  // starts at a multiple of K floats
  const bool a16 = (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  if (K % 4 == 0 && a16)
    rows_gemm<RN, 4><<<grid, kThreads, 0, st>>>(A, map, B0, B1, out, omap, P, K, N);
  else if (K % 2 == 0 && (reinterpret_cast<uintptr_t>(A) & 7) == 0)
    rows_gemm<RN, 2><<<grid, kThreads, 0, st>>>(A, map, B0, B1, out, omap, P, K, N);
  else
    rows_gemm<RN, 1><<<grid, kThreads, 0, st>>>(A, map, B0, B1, out, omap, P, K, N);
  return cudaGetLastError();
}

// out (P, N) = A (P, K) . Bm (K, N), real; see rows_gemm
cudaError_t launch_rows(const float* A, RowMap map, const float* B0, const float* B1,
                        float* out, OutMap omap, long long P, int K, int N,
                        cudaStream_t st) {
  if (P <= 0 || N <= 0) return cudaGetLastError();
  switch ((N + 15) / 16) {
    case 1: return launch_rows_rn<1>(A, map, B0, B1, out, omap, P, K, N, st);
    case 2: return launch_rows_rn<2>(A, map, B0, B1, out, omap, P, K, N, st);
    case 3: return launch_rows_rn<3>(A, map, B0, B1, out, omap, P, K, N, st);
    case 4: return launch_rows_rn<4>(A, map, B0, B1, out, omap, P, K, N, st);
    default: return launch_rows_rn<5>(A, map, B0, B1, out, omap, P, K, N, st);
  }
}

// MAD + DC bias into Z, then the three crop-folded inverse passes; the
// last writes each kept output row straight into out (N, fp, L, oy, oz),
// the trailing L of the out0 valid columns (segments j0 .. j0+Q-1 of N
// samples).
cudaError_t mad_inverse(const float2* F, const float2* W, const float* nb,
                        const float2* ea, const float2* eb, const float* mr,
                        const float* mi, float2* Z, float2* Y1, float2* Y2,
                        float* out, int N, int Q, int f, int fp, int A, int B,
                        int Cb, int s, int oy, int oz, int j0, int out0, int L,
                        cudaStream_t st) {
  const long long bins = (long long)A * B * Cb;
  cudaError_t err = launch_cmul_mad(F, W, nb, Z, N * Q, f, fp, bins, st);
  if (err != cudaSuccess) return err;
  const long long M = (long long)N * Q * fp;
  // inverse along a: (M, A, B*Cb) -> (M, s, B*Cb)
  err = launch_axis(Z, ea, Y1, M, A, s, (long long)B * Cb, st);
  if (err != cudaSuccess) return err;
  // inverse along b: (M*s, B, Cb) -> (M*s, oy, Cb)
  err = launch_axis(Y1, eb, Y2, M * s, B, oy, Cb, st);
  if (err != cudaSuccess) return err;
  // inverse along c, real: the spectra as floats (M*s*oy, 2*Cb) against
  // mr/mi interleaved, each row of oz outputs scattered into out
  return launch_rows(reinterpret_cast<const float*>(Y2), RowMap{}, mr, mi, out,
                     OutMap{1, Q, fp, s, oy, j0, out0, L}, M * s * oy, 2 * Cb, oz, st);
}

}  // namespace

// From cached spectra: F (N, Q, f, A, B, Cb) of segments j0 .. j0+Q-1 ->
// out (N, fp, L, oy, oz), the trailing L of the out0 valid columns.
extern "C" int os_segment_f32(const void* F, const void* W, const float* nb,
                              const void* ea, const void* eb, const float* mr,
                              const float* mi, void* Z, void* Y1, void* Y2,
                              float* out, int N, int Q, int f, int fp, int A, int B,
                              int Cb, int s, int oy, int oz, int j0, int out0, int L,
                              void* stream) {
  return (int)mad_inverse(
      static_cast<const float2*>(F), static_cast<const float2*>(W), nb,
      static_cast<const float2*>(ea), static_cast<const float2*>(eb), mr, mi,
      static_cast<float2*>(Z), static_cast<float2*>(Y1),
      static_cast<float2*>(Y2), out, N, Q, f, fp, A, B, Cb, s, oy, oz, j0, out0, L,
      static_cast<cudaStream_t>(stream));
}

// The conv form: x (N, f, nx, ny, nz) real -> out (N, fp, out0, oy, oz).
// Three scratch buffers serve all six intermediates, each reused once its
// contents are dead (every pass runs in order on one stream):
//   bufA: X1 (N*Q*f*E*ny, Cb), then Z  (N*Q, fp, A, B, Cb)
//   bufB: X2 (N*Q*f*E, B, Cb), then Y1 (N*Q*fp, s, B, Cb)
//   bufC: F  (N*Q, f, A, B, Cb), then Y2 (N*Q*fp*s, oy, Cb)
extern "C" int os_segment_conv_f32(
    const float* x, const void* fz, const void* fy, const void* fx,
    const void* W, const float* nb, const void* ea, const void* eb,
    const float* mr, const float* mi, void* bufA, void* bufB, void* bufC,
    float* out, int N, int Q, int f, int fp, int E, int seg, int nx, int ny,
    int nz, int A, int B, int Cb, int s, int oy, int oz, int out0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* a = static_cast<float2*>(bufA);
  float2* b = static_cast<float2*>(bufB);
  float2* c = static_cast<float2*>(bufC);
  const long long rows = (long long)N * Q * f * E;  // (segment, channel, x-row)
  // forward along z, real input: x rows (rows*ny, nz) against fz read as
  // floats (nz, 2*Cb) -> X1 (rows*ny, Cb)
  cudaError_t err = launch_rows(x, RowMap{1, Q, f, E, seg, nx, ny},
                                static_cast<const float*>(fz), nullptr,
                                reinterpret_cast<float*>(a), OutMap{}, rows * ny, nz,
                                2 * Cb, st);
  if (err != cudaSuccess) return (int)err;
  // forward along y: (rows, ny, Cb) -> X2 (rows, B, Cb)
  err = launch_axis(a, static_cast<const float2*>(fy), b, rows, ny, B, Cb, st);
  if (err != cudaSuccess) return (int)err;
  // forward along x: (N*Q*f, E, B*Cb) -> F (N*Q*f, A, B*Cb)
  err = launch_axis(b, static_cast<const float2*>(fx), c, (long long)N * Q * f, E, A,
                    (long long)B * Cb, st);
  if (err != cudaSuccess) return (int)err;
  return (int)mad_inverse(
      c, static_cast<const float2*>(W), nb, static_cast<const float2*>(ea),
      static_cast<const float2*>(eb), mr, mi, a, b, c, out, N, Q, f, fp, A, B, Cb,
      s, oy, oz, 0, out0, out0, st);
}
