// Fused overlap-save segment pipeline, from cached segment spectra or from
// raw input.
//
// Replaces the Pallas kernels ``os_segment_planes`` (entry
// ``os_segment_f32``: the full segment grid, and the strip path's trailing
// segments with their lead crop) and ``os_segment_conv_planes`` (entry
// ``os_segment_conv_f32``) of src/repro/kernels/os_segment/kernel.py.
// Per (sample, segment j0 + q, output channel j) of the A x B x C segment
// transform (C'' = C/2 + 1 rfft bins):
//
//   [conv form] F = the segment's forward DFT, three passes (below)
//   Z[a, b, c] = sum_i F[i, a, b, c] * W[j, i, a, b, c]  + b[j]*A*B*C on bin 0
//   out = the 3D C2R inverse of Z over A*B*C, cropped to the segment's valid
//         seg_core x oy x oz outputs and to the output columns the call keeps
//
// The TPU kernel did the inverse as three matrix DFTs on the MXU, its
// whole-segment accumulators in VMEM.  On the H100 that form costs ~10x an
// FFT's operations in fp32 SIMT, and each pass round-trips a full-size
// complex64 scratch tensor through device memory.  What the call must move
// is W (read once), F and the output, so it is bound by bytes: here the
// inverse is mixed-radix FFTs in shared memory, and one complex64
// intermediate Y1 (N, f', L, B, C'') is the only scratch of the served
// calls.  Two passes:
//
// 1. inverse_x: MAD + bias + the A-point inverse along x.  A block owns T
//    contiguous (b, c) columns, RS (sample, segment) pairs and one output
//    channel, and builds their (RS, A, T) tile in shared memory.  With
//    f < MAD_F = 4 input channels (the served layer 0 has f = 1) a thread
//    multiplies element (a, column) for its RS pairs straight from device
//    memory, two elements' loads in flight (mad_direct; RS = 4, 2 or 1,
//    whichever leaves fewest of the call's pairs empty); the block walks W
//    once.  With f >= 4 the sum over f wants register tiles that reuse
//    each operand across pairs and channels, which the FFT's tile leaves
//    no room for: cmul_mad.cuh's kernel forms the product and its bias
//    into a scratch Z (N*Q, f', A, B, C'') first, and pass 1 copies its
//    tile from there (load_z).  The FFT then runs in place along a, and
//    only the x-rows the call keeps are written to Y1: row x of segment
//    j0 + q is output column (j0 + q)*seg_core + x, kept when out0 - L <=
//    it < out0.  That one rule is the tail segment's crop and the strip
//    path's lead crop: a strip call (out_cols = core, half of its two
//    segments' rows dropped) carries no dropped row further.
// 2. inverse_yz: one (n, j, x) plane a block.  The (B, C'') plane is loaded
//    into shared memory (cp.async), the B-point inverse runs along y, then
//    the z-axis C2R of the oy kept rows, in chunks through a scratch: for
//    even C one C/2-point complex FFT of the pre-twiddled pairs (X_k,
//    X*_{C/2-k}), for odd C the hermitian extensions of two rows to C
//    points as one transform, X_a + i X_b (its outputs x_a + i x_b); the
//    imaginary parts of the DC and Nyquist bins are ignored, as a C2R
//    ignores them.  The oy x oz valid outputs, over A*B*C, go straight
//    into out (N, f', L, oy, oz).  Where a plane does not fit in shared
//    memory (B*C''*8 bytes near the 227 KB a block may use), the same two
//    transforms run as two launches through device memory (inverse_y into
//    Y2 (N, f', L, oy, C''), then inverse_z); the wrapper decides from the
//    spec's shape (ops._inverse_config), as it sizes every tile.  A block
//    has 512 threads, one block an SM (their registers and, at the served
//    specs, the plane fill it); a plane small enough for three blocks an
//    SM runs in blocks of 256 threads with their registers capped to fit,
//    three planes in flight, so one block's syncs are covered by another's
//    work (the dense path's and the shard's conv forms).
//
// The FFTs are in-place decimation in frequency: stage t of radix r over
// sub-length m takes the r points pos0 + q*m, applies the r-point inverse
// DFT (radix 2 and 4 by sums; 3, 5, 7 and 9 in the symmetric form over
// x_t +- x_{r-t}) and multiplies output q by e^{+2 pi i q k / (r m)}.
// fft_optimal_size gives lengths of radices 2, 3, 5 and 7; pairs of 2s and
// of 3s run as one radix-4 or radix-9 stage, one pass through shared memory
// fewer.  Outputs land in digit-reversed order, read back through a
// permutation.  The butterfly, twiddle and permutation tables are built
// once per spec on the host in float64 and rounded to float32
// (kernels/os_segment/fft_plan.py).  A warp's lanes take 32 lines (columns,
// or rows of the z chunk) and its warps the butterflies, two at a time:
// lanes touch neighbouring words, and each twiddle is one broadcast load.
// In pass 1, whose x length may be short (A = 6 at the dense path's layer
// 2: 2 or 3 butterflies a line), a stage with fewer butterflies than warps
// splits the warps into groups over separate lines.  Everything is fp32
// outside the tensor cores.
//
// The conv form's forward transform is the TPU kernel's in-kernel matmul
// DFT, in the same pass order: a real-input pass along z that takes the nz
// live samples of each row to the C'' rfft bins (fz, rows_gemm), then the
// complex product along y (ny -> B, fy, axis_product), then along x
// (seg_extent -> A, fx, short_axis or axis_product).  The segment windows
// are read straight from x: segment q's row e is x-row q*seg_core + e, and
// rows past the input extent read as zeros (the reference's
// ``input_pad``).  The forward matrices come from ops._forward_mats.
// * rows_gemm: the z pass as a real product, a block owns 128 rows x
//   16*RN columns, each thread an 8 x RN register tile, its rows' four k
//   at a time as 16-byte shared loads.
// * axis_product, a long middle axis: a complex product over K of L (K, N)
//   with the columns (p, r) of the input; a block owns 64 columns x 16*RN
//   outputs, each thread an RN x 4 tile.
// * short_axis, K, N <= 8: one thread per (p, r) column holds its K inputs
//   in registers and writes its N outputs; bytes-bound.
// The long passes walk K in chunks of 16 through a two-stage cp.async ring.
#include "cmul_mad.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlaneThreads = 512;   // inverse_yz, inverse_z
constexpr int kSmallThreads = 256;   // inverse_yz on planes that leave room
constexpr int kSmallMinB = 3;        // for this many blocks an SM
constexpr int kSmemSM = 233472;      // shared memory an SM (228 KB)
constexpr int kSlab = 32;           // inverse_y (fallback): columns a block
constexpr int kKC = 16;             // K a pipeline stage
constexpr int kAxTC = 64;           // axis_product: columns a block
constexpr int kRowTP = 128;         // rows_gemm: rows a block
constexpr int kRowLD = kKC + 4;     // its staged row: 16-byte aligned, and
                                    // neighbouring rows on distinct banks

// ---------------------------------------------------------------------------
// The forward passes of the conv form
// ---------------------------------------------------------------------------

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

// Where rows_gemm's input row p = (((n*Q + q)*f + i)*E + e)*ny + y
// starts: x-row q*seg + e of (n, i), or -1 past nx (the reference's
// input_pad: zeros).
struct RowMap {
  int Q, f, E, seg, nx, ny;
};

template <class I>
__device__ __forceinline__ long long in_row(I p, const RowMap& m, int K) {
  const I y = p % m.ny; p /= m.ny;
  const I e = p % m.E; p /= m.E;
  const I i = p % m.f; p /= m.f;
  const I q = p % m.Q;
  const I n = p / m.Q;
  const I gx = q * m.seg + e;
  if (gx >= (I)m.nx) return -1;
  return ((((long long)n * m.f + i) * m.nx + gx) * m.ny + y) * K;
}

// out[p, n] = sum_k A[p', k] * Bm[k, n]   (real), input row p' = ``map``(p)
// of K floats, output rows of N floats.
// grid (ceil(P/128), ceil(N/(16*RN))); block 256 = 16 column lanes x
// 16 row lanes.
template <int RN, int VEC>
__global__ void __launch_bounds__(kThreads)
    rows_gemm(const float* __restrict__ A, RowMap map, const float* __restrict__ Bm,
              float* __restrict__ out, long long P, int K, int N) {
  constexpr int TN = 16 * RN;
  constexpr int VPR = kKC / VEC;  // copies a staged row
  __shared__ __align__(16) float As[2][kRowTP][kRowLD];
  __shared__ __align__(16) float Bs[2][kKC][TN];
  __shared__ long long rowoff[kRowTP];
  const int tid = threadIdx.x, tn = tid % 16, tp = tid / 16;
  const long long p0 = (long long)blockIdx.x * kRowTP;
  const int n0 = blockIdx.y * TN;
  if (tid < kRowTP) {
    // row indices in 32 bits where they fit: 64-bit division is slow
    const long long p = p0 + tid;
    long long in = -1;
    if (p < P) in = P <= 0xffffffffLL ? in_row((unsigned)p, map, K) : in_row(p, map, K);
    rowoff[tid] = in;
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
      cp_async4z(&Bs[stage][kk][nn], ok ? Bm + (long long)k * N + n : Bm, ok);
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
    const long long p = p0 + tp + 16 * u;
    if (p >= P) continue;
#pragma unroll
    for (int v = 0; v < RN; ++v) {
      const int n = n0 + tn + 16 * v;
      if (n < N) out[p * N + n] = acc[u][v];
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
cudaError_t launch_rows_rn(const float* A, RowMap map, const float* Bm, float* out,
                           long long P, int K, int N, cudaStream_t st) {
  dim3 grid((unsigned)((P + kRowTP - 1) / kRowTP), (unsigned)((N + 16 * RN - 1) / (16 * RN)));
  // a row's copies may be as wide as its start's alignment: every row
  // starts at a multiple of K floats
  const bool a16 = (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  if (K % 4 == 0 && a16)
    rows_gemm<RN, 4><<<grid, kThreads, 0, st>>>(A, map, Bm, out, P, K, N);
  else if (K % 2 == 0 && (reinterpret_cast<uintptr_t>(A) & 7) == 0)
    rows_gemm<RN, 2><<<grid, kThreads, 0, st>>>(A, map, Bm, out, P, K, N);
  else
    rows_gemm<RN, 1><<<grid, kThreads, 0, st>>>(A, map, Bm, out, P, K, N);
  return cudaGetLastError();
}

// out (P, N) = A (rows gathered by map, K) . Bm (K, N), real; see rows_gemm
cudaError_t launch_rows(const float* A, RowMap map, const float* Bm, float* out,
                        long long P, int K, int N, cudaStream_t st) {
  if (P <= 0 || N <= 0) return cudaGetLastError();
  switch ((N + 15) / 16) {
    case 1: return launch_rows_rn<1>(A, map, Bm, out, P, K, N, st);
    case 2: return launch_rows_rn<2>(A, map, Bm, out, P, K, N, st);
    case 3: return launch_rows_rn<3>(A, map, Bm, out, P, K, N, st);
    case 4: return launch_rows_rn<4>(A, map, Bm, out, P, K, N, st);
    default: return launch_rows_rn<5>(A, map, Bm, out, P, K, N, st);
  }
}

// ---------------------------------------------------------------------------
// The inverse: mixed-radix FFTs in shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// (cos, sin) of 2 pi j / R for the odd radices, 0 <= j < R
template <int R>
__device__ __forceinline__ float2 unit_root(int j) {
  if (j == 0) return make_float2(1.f, 0.f);
  if (R == 9) {
    switch (j) {
      case 1: return make_float2(0.76604444311897804f, 0.64278760968653933f);
      case 2: return make_float2(0.17364817766693041f, 0.98480775301220806f);
      case 3: return make_float2(-0.5f, 0.86602540378443865f);
      case 4: return make_float2(-0.93969262078590838f, 0.34202014332566873f);
      case 5: return make_float2(-0.93969262078590838f, -0.34202014332566873f);
      case 6: return make_float2(-0.5f, -0.86602540378443865f);
      case 7: return make_float2(0.17364817766693041f, -0.98480775301220806f);
      default: return make_float2(0.76604444311897804f, -0.64278760968653933f);
    }
  }
  if (R == 3) {
    return j == 1 ? make_float2(-0.5f, 0.86602540378443865f)
                  : make_float2(-0.5f, -0.86602540378443865f);
  }
  if (R == 5) {
    switch (j) {
      case 1: return make_float2(0.30901699437494742f, 0.95105651629515357f);
      case 2: return make_float2(-0.80901699437494742f, 0.58778525229247313f);
      case 3: return make_float2(-0.80901699437494742f, -0.58778525229247313f);
      default: return make_float2(0.30901699437494742f, -0.95105651629515357f);
    }
  }
  switch (j) {  // R == 7
    case 1: return make_float2(0.62348980185873353f, 0.78183148246802981f);
    case 2: return make_float2(-0.22252093395631440f, 0.97492791218182361f);
    case 3: return make_float2(-0.90096886790241913f, 0.43388373911755812f);
    case 4: return make_float2(-0.90096886790241913f, -0.43388373911755812f);
    case 5: return make_float2(-0.22252093395631440f, -0.97492791218182361f);
    default: return make_float2(0.62348980185873353f, -0.78183148246802981f);
  }
}

// In place: x[p] = sum_t x[t] e^{+2 pi i p t / R}
template <int R>
__device__ __forceinline__ void idft(float2 (&x)[R]) {
  if constexpr (R == 2) {
    const float2 a = x[0];
    x[0] = cadd(a, x[1]);
    x[1] = csub(a, x[1]);
  } else if constexpr (R == 4) {
    const float2 a = cadd(x[0], x[2]), b = csub(x[0], x[2]);
    const float2 c = cadd(x[1], x[3]), d = csub(x[1], x[3]);
    x[0] = cadd(a, c);
    x[2] = csub(a, c);
    x[1] = make_float2(b.x - d.y, b.y + d.x);  // b + i d
    x[3] = make_float2(b.x + d.y, b.y - d.x);  // b - i d
  } else {
    constexpr int H = (R - 1) / 2;
    float2 sm[H], df[H];
    float2 y[R];
    y[0] = x[0];
#pragma unroll
    for (int t = 1; t <= H; ++t) {
      sm[t - 1] = cadd(x[t], x[R - t]);
      df[t - 1] = csub(x[t], x[R - t]);
      y[0] = cadd(y[0], sm[t - 1]);
    }
#pragma unroll
    for (int p = 1; p <= H; ++p) {
      float2 a = x[0], b = make_float2(0.f, 0.f);
#pragma unroll
      for (int t = 1; t <= H; ++t) {
        const float2 w = unit_root<R>((p * t) % R);
        a.x = fmaf(w.x, sm[t - 1].x, a.x);
        a.y = fmaf(w.x, sm[t - 1].y, a.y);
        b.x = fmaf(w.y, df[t - 1].x, b.x);
        b.y = fmaf(w.y, df[t - 1].y, b.y);
      }
      y[p] = make_float2(a.x - b.y, a.y + b.x);      // a + i b
      y[R - p] = make_float2(a.x + b.y, a.y - b.x);  // a - i b
    }
#pragma unroll
    for (int t = 0; t < R; ++t) x[t] = y[t];
  }
}

// One length's tables (fft_plan.axis_tables): ``p`` its int header
// [S, n, perm_off, (r, m, tw_off, bf_off) per stage] with the butterfly
// and permutation tables after it, ``t`` its twiddles.
struct Axis {
  const int* p;
  const float2* t;
};

// axis 0 (x), 1 (y) or 2 (z) of a spec's packed tables (fft_plan.spec_tables)
__device__ __forceinline__ Axis spec_axis(const int* P, const float2* T, int which) {
  return Axis{P + __ldg(P + which), T + __ldg(P + 3 + which)};
}
__device__ __forceinline__ const int* axis_perm(Axis ax) { return ax.p + __ldg(ax.p + 2); }

// n lines in shared memory: line l starts at (l / div) * hi + l % div, its
// points es apart
struct Lines {
  int n, div, hi, es;
};

template <int R>
__device__ __forceinline__ void butterfly(float2* base, int e, int m, int es,
                                          const float2* __restrict__ tw, float2 (&x)[R]) {
  const int pos = e & 0xffff, k = e >> 16;
  idft<R>(x);
  base[pos * es] = x[0];
#pragma unroll
  for (int t = 1; t < R; ++t) base[(pos + t * m) * es] = cmul(x[t], __ldg(tw + (t - 1) * m + k));
}

// One stage over every line: a warp's lanes take 32 lines, its warps the
// butterflies, two at a time (both loaded before either is computed).
// With GROUPS (pass 1: the segment's x extent is short), where the stage
// has fewer butterflies than the block has warps, the warps split into
// groups that take 32 lines each.
template <int R, bool GROUPS>
__device__ __forceinline__ void fft_stage(float2* buf, Lines ln, int nb, int m,
                                          const int* __restrict__ bf,
                                          const float2* __restrict__ tw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int ng = 1, wpg = nw, grp = 0, wb = warp;
  if (GROUPS) {
    ng = max(1, min(nw / nb, (ln.n + 31) >> 5));
    wpg = nw / ng;
    grp = warp / wpg;
    wb = warp - grp * wpg;
    if (grp >= ng) return;
  }
  for (int l = grp * 32 + lane; l < ln.n; l += ng * 32) {
    float2* base = buf + (l / ln.div) * ln.hi + l % ln.div;
    int b = wb;
    for (; b + wpg < nb; b += 2 * wpg) {
      const int e0 = __ldg(bf + b), e1 = __ldg(bf + b + wpg);
      float2 x[R], y[R];
#pragma unroll
      for (int t = 0; t < R; ++t) x[t] = base[((e0 & 0xffff) + t * m) * ln.es];
#pragma unroll
      for (int t = 0; t < R; ++t) y[t] = base[((e1 & 0xffff) + t * m) * ln.es];
      butterfly<R>(base, e0, m, ln.es, tw, x);
      butterfly<R>(base, e1, m, ln.es, tw, y);
    }
    if (b < nb) {
      const int e0 = __ldg(bf + b);
      float2 x[R];
#pragma unroll
      for (int t = 0; t < R; ++t) x[t] = base[((e0 & 0xffff) + t * m) * ln.es];
      butterfly<R>(base, e0, m, ln.es, tw, x);
    }
  }
}

// The unnormalized inverse FFT of every line, in place; outputs in
// digit-reversed positions (axis_perm).  Every thread of the block calls it.
template <bool GROUPS = false>
__device__ void fft_lines(float2* buf, Lines ln, Axis ax) {
  const int S = __ldg(ax.p), n = __ldg(ax.p + 1);
  for (int st = 0; st < S; ++st) {
    const int* h = ax.p + 3 + 4 * st;
    const int r = __ldg(h), m = __ldg(h + 1);
    const float2* tw = ax.t + __ldg(h + 2);
    const int* bf = ax.p + __ldg(h + 3);
    switch (r) {
      case 2: fft_stage<2, GROUPS>(buf, ln, n / 2, m, bf, tw); break;
      case 3: fft_stage<3, GROUPS>(buf, ln, n / 3, m, bf, tw); break;
      case 4: fft_stage<4, GROUPS>(buf, ln, n / 4, m, bf, tw); break;
      case 5: fft_stage<5, GROUPS>(buf, ln, n / 5, m, bf, tw); break;
      case 7: fft_stage<7, GROUPS>(buf, ln, n / 7, m, bf, tw); break;
      default: fft_stage<9, GROUPS>(buf, ln, n / 9, m, bf, tw); break;
    }
    __syncthreads();
  }
}

// One call's segment grid: N samples x Q trailing segments (j0 .. j0+Q-1)
// of f input channels, f' output channels; the trailing L of the out0
// valid output columns are kept.
struct Grid {
  int N, Q, f, fp, A, s, j0, out0, L;
  long long BC;  // B * C'': the (b, c) columns
};

// The MAD + DC-bin bias of pass 1 into the tile zs (RS, A, T), f < MAD_F
// input channels: a thread takes element (a, column c), U of them at a
// time, every load of the U issued before the products, from device
// memory through L1 (each W value serves RS pairs).  NT threads a block.
template <int RS, int U, int NT>
__device__ __forceinline__ void mad_direct(const float2* __restrict__ F,
                                           const float2* __restrict__ W,
                                           const float* __restrict__ nb, float2* zs,
                                           const Grid& g, int logT, int s0, int j,
                                           long long c0) {
  const int Tn = 1 << logT, A = g.A, NQ = g.N * g.Q;
  const long long aBC = (long long)A * g.BC;
  const int nel = A << logT;
  for (int e0 = threadIdx.x; e0 < nel; e0 += NT * U) {
    long long off[U];
    bool in[U], live[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int e = e0 + q * NT;
      in[q] = e < nel;
      live[q] = in[q] && c0 + (e & (Tn - 1)) < g.BC;
      off[q] = (long long)(e >> logT) * g.BC + c0 + (e & (Tn - 1));
    }
    float2 acc[U][RS];
#pragma unroll
    for (int q = 0; q < U; ++q)
#pragma unroll
      for (int u = 0; u < RS; ++u) acc[q][u] = make_float2(0.f, 0.f);
    for (int i = 0; i < g.f; ++i) {
      float2 x[U][RS], w[U];
#pragma unroll
      for (int q = 0; q < U; ++q) {
#pragma unroll
        for (int u = 0; u < RS; ++u)
          x[q][u] = live[q] && s0 + u < NQ
                        ? __ldg(F + ((long long)(s0 + u) * g.f + i) * aBC + off[q])
                        : make_float2(0.f, 0.f);
        w[q] = live[q] ? __ldg(W + ((long long)j * g.f + i) * aBC + off[q])
                       : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int q = 0; q < U; ++q)
#pragma unroll
        for (int u = 0; u < RS; ++u) {
          float2& o = acc[q][u];
          o.x = fmaf(x[q][u].x, w[q].x, fmaf(-x[q][u].y, w[q].y, o.x));
          o.y = fmaf(x[q][u].x, w[q].y, fmaf(x[q][u].y, w[q].x, o.y));
        }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (!in[q]) continue;
      // b[j] * A*B*C on the real part of bin (0, 0, 0)
      if (nb != nullptr && live[q] && off[q] == 0) {
        const float bias = __ldg(nb + j);
#pragma unroll
        for (int u = 0; u < RS; ++u) acc[q][u].x += bias;
      }
#pragma unroll
      for (int u = 0; u < RS; ++u) zs[u * nel + e0 + q * NT] = acc[q][u];
    }
  }
}

// The tile zs (RS, A, T) copied from Z (NQ, f', A, B, C''), where
// cmul_mad has formed the product and its bias (f >= MAD_F): every copy in
// flight at once.
template <int RS, int NT>
__device__ __forceinline__ void load_z(const float2* __restrict__ Z, float2* zs,
                                       const Grid& g, int logT, int s0, int j,
                                       long long c0) {
  const int Tn = 1 << logT, nel = g.A << logT, NQ = g.N * g.Q;
  const long long aBC = (long long)g.A * g.BC;
  for (int e = threadIdx.x; e < RS * nel; e += NT) {
    const int u = e / nel, a = (e - u * nel) >> logT;
    const long long col = c0 + (e & (Tn - 1));
    const bool ok = s0 + u < NQ && col < g.BC;
    cp_async8z(zs + e,
               ok ? Z + ((long long)(s0 + u) * g.fp + j) * aBC + (long long)a * g.BC + col : Z,
               ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// Pass 1.  Block: RS (sample, segment) pairs from s0, output channel j,
// 2^logT columns from c0; its tile zs (RS, A, T) in shared memory, the
// product formed in place (mad_direct) or copied from Z.
template <int RS, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    inverse_x(const float2* __restrict__ F, const float2* __restrict__ W,
              const float* __restrict__ nb, const float2* __restrict__ Z,
              const int* __restrict__ P, const float2* __restrict__ T,
              float2* __restrict__ Y1, Grid g, int logT, int ns) {
  extern __shared__ float4 smem4[];
  float2* zs = reinterpret_cast<float2*>(smem4);
  const int tid = threadIdx.x, Tn = 1 << logT, A = g.A, NQ = g.N * g.Q;
  // s-tiles fastest, then channels: blocks sharing a W tile run side by
  // side, and those sharing an F tile within f' of each other
  long long blk = blockIdx.x;
  const int s0 = (int)(blk % ns) * RS;
  blk /= ns;
  const int j = (int)(blk % g.fp);
  const long long c0 = (blk / g.fp) << logT;
  if (Z != nullptr)
    load_z<RS, NT>(Z, zs, g, logT, s0, j, c0);
  else
    mad_direct<RS, 2, NT>(F, W, nb, zs, g, logT, s0, j, c0);
  __syncthreads();

  const Axis ax = spec_axis(P, T, 0);
  fft_lines<true>(zs, Lines{RS << logT, Tn, A << logT, Tn}, ax);

  // the kept rows: per pair the x-rows [x0, x1) of its segment, each T
  // columns; NT/T rows at a time
  const int* perm = axis_perm(ax);
  const int lo = g.out0 - g.L, c = tid & (Tn - 1);
  const long long col = c0 + c;
  for (int sl = 0; sl < RS && s0 + sl < NQ; ++sl) {
    const int n = (s0 + sl) / g.Q, q = (s0 + sl) - n * g.Q;
    const int oc0 = (g.j0 + q) * g.s - lo;  // output column of row 0
    const int x0 = max(0, -oc0), x1 = min(g.s, g.out0 - (g.j0 + q) * g.s);
    if (x1 <= x0 || col >= g.BC) continue;
    const long long row0 = ((long long)n * g.fp + j) * g.L + oc0;
    for (int x = x0 + (tid >> logT); x < x1; x += NT >> logT)
      Y1[(row0 + x) * g.BC + col] = zs[((sl * A + __ldg(perm + x)) << logT) + c];
  }
}

// Pass 2's plane: B x C'' bins (C the z transform length), oy x oz kept
// outputs; the z C2R runs in chunks of RR rows, RC transforms through a
// scratch of RC x Mp (Mp = M rounded up to odd: rows on distinct banks).
// Odd C takes two rows a transform (RR = 2*RC), even C one (RR = RC).
struct Plane {
  int B, Cb, C, oy, oz, M, Mp, RC, RR;
  float scale;  // 1 / (A*B*C)
};

// The hermitian extension of odd C's row at k < C, the DC bin's imaginary
// part ignored, as a C2R ignores it
__device__ __forceinline__ float2 hermitian(const float2* row, int k, const Plane& pl) {
  if (k < pl.Cb) {
    float2 v = row[k];
    if (k == 0) v.y = 0.f;
    return v;
  }
  const float2 v = row[pl.C - k];
  return make_float2(v.x, -v.y);
}

// The z-axis C2R of rows y0 .. y0+nr-1 of a plane: row y's bins at
// tile + row(y)*Cb (row(y) = rowpos[y], or y - ybase without rowpos),
// written to out (rows of oz floats, from row y0).  Every thread calls it.
__device__ void c2r_rows(const float2* tile, const int* __restrict__ rowpos, int ybase,
                         int y0, int nr, float2* scr, const Plane& pl, Axis az,
                         const float2* __restrict__ pre, float* __restrict__ out) {
  auto row = [&](int y) {
    return tile + (long long)(rowpos != nullptr ? __ldg(rowpos + y) : y - ybase) * pl.Cb;
  };
  // a warp a transform, its lanes along the row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int nl = pre != nullptr ? nr : (nr + 1) / 2;
  for (int r = warp; r < nl; r += nw) {
    float2* dst = scr + r * pl.Mp;
    if (pre != nullptr) {
      // even C: Z'_k = (X_k + X*_{M-k}) + i e^{2 pi i k/C} (X_k - X*_{M-k})
      const float2* src = row(y0 + r);
      for (int k = lane; k < pl.M; k += 32) {
        float2 xk = src[k], xm = src[pl.M - k];
        if (k == 0) xk.y = xm.y = 0.f;  // DC and Nyquist: real parts only
        const float2 sm = make_float2(xk.x + xm.x, xk.y - xm.y);
        const float2 wd = cmul(__ldg(pre + k), make_float2(xk.x - xm.x, xk.y + xm.y));
        dst[k] = make_float2(sm.x - wd.y, sm.y + wd.x);
      }
    } else {
      // odd C: rows 2r and 2r+1 as one transform, X_a + i X_b of their
      // hermitian extensions (real outputs: x_a + i x_b)
      const float2* sa = row(y0 + 2 * r);
      const float2* sb = 2 * r + 1 < nr ? row(y0 + 2 * r + 1) : nullptr;
      for (int k = lane; k < pl.C; k += 32) {
        const float2 a = hermitian(sa, k, pl);
        const float2 b = sb != nullptr ? hermitian(sb, k, pl) : make_float2(0.f, 0.f);
        dst[k] = make_float2(a.x - b.y, a.y + b.x);
      }
    }
  }
  __syncthreads();
  fft_lines(scr, Lines{nl, 1, pl.Mp, 1}, az);
  const int* perm = axis_perm(az);
  for (int r = warp; r < nl; r += nw) {
    const float2* src = scr + r * pl.Mp;
    if (pre != nullptr) {
      float* o = out + (long long)(y0 + r) * pl.oz;
      for (int z = lane; z < pl.oz; z += 32) {
        const float2 t = src[__ldg(perm + (z >> 1))];
        o[z] = ((z & 1) ? t.y : t.x) * pl.scale;
      }
    } else {
      float* o = out + (long long)(y0 + 2 * r) * pl.oz;
      const bool two = 2 * r + 1 < nr;
      for (int z = lane; z < pl.oz; z += 32) {
        const float2 t = src[__ldg(perm + z)];
        o[z] = t.x * pl.scale;
        if (two) o[pl.oz + z] = t.y * pl.scale;
      }
    }
  }
  __syncthreads();  // scr is refilled by the next chunk
}

__device__ __forceinline__ const float2* pre_twiddle(const int* P, const float2* T) {
  const int off = __ldg(P + 6);
  return off < 0 ? nullptr : T + off;
}

// Pass 2, fused: plane blockIdx.x of Y1 (planes, B, C'') -> out (planes,
// oy, oz).  Shared memory: the plane, then the z scratch.
template <int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    inverse_yz(const float2* __restrict__ Y1, const int* __restrict__ P,
               const float2* __restrict__ T, float* __restrict__ out, Plane pl) {
  extern __shared__ float4 smem4[];
  float2* tile = reinterpret_cast<float2*>(smem4);
  const int BC = pl.B * pl.Cb;
  float2* scr = tile + BC;
  const long long plane = blockIdx.x;
  const float2* src = Y1 + plane * BC;
  // every copy in flight at once; 16-byte copies where BC is even (the
  // plane then starts 16-byte aligned)
  if ((BC & 1) == 0) {
    for (int e = threadIdx.x; e < BC / 2; e += NT) cp_async16z(tile + 2 * e, src + 2 * e, true);
  } else {
    for (int e = threadIdx.x; e < BC; e += NT) cp_async8z(tile + e, src + e, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const Axis ay = spec_axis(P, T, 1);
  fft_lines(tile, Lines{pl.Cb, pl.Cb, 0, pl.Cb}, ay);
  const int* rowpos = axis_perm(ay);
  const Axis az = spec_axis(P, T, 2);
  const float2* pre = pre_twiddle(P, T);
  float* o = out + plane * pl.oy * pl.oz;
  for (int y0 = 0; y0 < pl.oy; y0 += pl.RR)
    c2r_rows(tile, rowpos, 0, y0, min(pl.RR, pl.oy - y0), scr, pl, az, pre, o);
}

// Pass 2 through device memory, for a plane past shared memory: the y
// inverse of a slab of kSlab columns, rows y < oy into Y2 (planes, oy, C'')
__global__ void __launch_bounds__(kThreads)
    inverse_y(const float2* __restrict__ Y1, const int* __restrict__ P,
              const float2* __restrict__ T, float2* __restrict__ Y2, Plane pl, int nslab) {
  extern __shared__ float4 smem4[];
  float2* tile = reinterpret_cast<float2*>(smem4);  // (B, kSlab)
  const long long plane = blockIdx.x / nslab;
  const int c0 = (blockIdx.x % nslab) * kSlab;
  const float2* src = Y1 + plane * pl.B * pl.Cb;
  for (int e = threadIdx.x; e < pl.B * kSlab; e += kThreads) {
    const int b = e / kSlab, c = e % kSlab;
    tile[e] = c0 + c < pl.Cb ? __ldg(src + (long long)b * pl.Cb + c0 + c)
                             : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const Axis ay = spec_axis(P, T, 1);
  fft_lines(tile, Lines{kSlab, kSlab, 0, kSlab}, ay);
  const int* perm = axis_perm(ay);
  float2* dst = Y2 + plane * pl.oy * pl.Cb;
  for (int e = threadIdx.x; e < pl.oy * kSlab; e += kThreads) {
    const int y = e / kSlab, c = e % kSlab;
    if (c0 + c < pl.Cb) dst[(long long)y * pl.Cb + c0 + c] = tile[__ldg(perm + y) * kSlab + c];
  }
}

// ... then the z C2R of a chunk of RR rows of Y2 a block
__global__ void __launch_bounds__(kPlaneThreads)
    inverse_z(const float2* __restrict__ Y2, const int* __restrict__ P,
              const float2* __restrict__ T, float* __restrict__ out, Plane pl, int nchunk) {
  extern __shared__ float4 smem4[];
  float2* tile = reinterpret_cast<float2*>(smem4);  // (RR, C'')
  float2* scr = tile + pl.RR * pl.Cb;
  const long long plane = blockIdx.x / nchunk;
  const int y0 = (blockIdx.x % nchunk) * pl.RR, nr = min(pl.RR, pl.oy - y0);
  const float2* src = Y2 + (plane * pl.oy + y0) * pl.Cb;
  for (int e = threadIdx.x; e < nr * pl.Cb; e += kPlaneThreads)
    cp_async8z(tile + e, src + e, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  c2r_rows(tile, nullptr, y0, y0, nr, scr, pl, spec_axis(P, T, 2), pre_twiddle(P, T),
           out + plane * pl.oy * pl.oz);
}

template <int NT, int MINB>
cudaError_t launch_yz(const float2* Y1, const int* P, const float2* T, float* out,
                      const Plane& pl, long long planes, size_t smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      inverse_yz<NT, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  inverse_yz<NT, MINB><<<(unsigned)planes, NT, smem, st>>>(Y1, P, T, out, pl);
  return cudaGetLastError();
}

template <int RS>
cudaError_t launch_x(const float2* F, const float2* W, const float* nb, const float2* Z,
                     const int* P, const float2* T, float2* Y1, const Grid& g, int logT,
                     int ns, long long blocks, size_t smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      inverse_x<RS, kThreads, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  inverse_x<RS, kThreads, 4><<<(unsigned)blocks, kThreads, smem, st>>>(F, W, nb, Z, P, T, Y1,
                                                                      g, logT, ns);
  return cudaGetLastError();
}

// The inverse of one call: pass 1 into Y1 (with Z set, cmul_mad forms the
// product there first), then pass 2 (fused, or with Y2 through device
// memory when RC is negative).  RS, logT and RC come from the wrapper
// (ops._inverse_config), which sizes them from the spec.
cudaError_t inverse(const float2* F, const float2* W, const float* nb, float2* Z,
                    const int* P, const float2* T, float2* Y1, float2* Y2, float* out,
                    Grid g, int B, int Cb, int C, int oy, int oz, int RS, int logT, int RC,
                    cudaStream_t st) {
  const int NQ = g.N * g.Q;
  if (NQ <= 0 || g.fp <= 0 || g.L <= 0) return cudaGetLastError();
  cudaError_t err;
  if (Z != nullptr) {
    err = launch_cmul_mad(F, W, nb, Z, NQ, g.f, g.fp, (long long)g.A * g.BC, st);
    if (err != cudaSuccess) return err;
  }
  // pass 1
  const int ns = (NQ + RS - 1) / RS;
  const long long blocks = ((g.BC + (1 << logT) - 1) >> logT) * ns * g.fp;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t xs = (size_t)RS * g.A * 8 << logT;
  switch (RS) {
    case 4: err = launch_x<4>(F, W, nb, Z, P, T, Y1, g, logT, ns, blocks, xs, st); break;
    case 2: err = launch_x<2>(F, W, nb, Z, P, T, Y1, g, logT, ns, blocks, xs, st); break;
    case 1: err = launch_x<1>(F, W, nb, Z, P, T, Y1, g, logT, ns, blocks, xs, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  // pass 2
  const int M = C % 2 == 0 ? C / 2 : C;
  const int rc = RC > 0 ? RC : -RC;
  Plane pl{B, Cb, C, oy, oz, M, M | 1, rc, C % 2 == 0 ? rc : 2 * rc, 0.f};
  pl.scale = (float)(1.0 / ((double)g.A * B * C));
  const long long planes = (long long)g.N * g.fp * g.L;
  if (planes > 0x7fffffffLL / 64) return cudaErrorInvalidConfiguration;
  if (RC > 0) {
    const size_t smem = ((size_t)B * Cb + (size_t)pl.RC * pl.Mp) * 8;
    // a plane that leaves room for kSmallMinB blocks an SM runs in blocks
    // of kSmallThreads, their registers capped to fit: several planes in
    // flight an SM, one's syncs covered by another's work
    if (smem * kSmallMinB + kSmallMinB * 1024 <= kSmemSM)
      return launch_yz<kSmallThreads, kSmallMinB>(Y1, P, T, out, pl, planes, smem, st);
    return launch_yz<kPlaneThreads, 1>(Y1, P, T, out, pl, planes, smem, st);
  }
  const int nslab = (Cb + kSlab - 1) / kSlab;
  const size_t ysm = (size_t)B * kSlab * 8;
  err = cudaFuncSetAttribute(inverse_y, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ysm);
  if (err != cudaSuccess) return err;
  inverse_y<<<(unsigned)(planes * nslab), kThreads, ysm, st>>>(Y1, P, T, Y2, pl, nslab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nchunk = (oy + pl.RR - 1) / pl.RR;
  const size_t zsm = ((size_t)pl.RR * Cb + (size_t)pl.RC * pl.Mp) * 8;
  err = cudaFuncSetAttribute(inverse_z, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)zsm);
  if (err != cudaSuccess) return err;
  inverse_z<<<(unsigned)(planes * nchunk), kPlaneThreads, zsm, st>>>(Y2, P, T, out, pl, nchunk);
  return cudaGetLastError();
}

}  // namespace

// From cached spectra: F (N, Q, f, A, B, C'') of segments j0 .. j0+Q-1 ->
// out (N, fp, L, oy, oz), the trailing L of the out0 valid columns.
// P/T: fft_plan.spec_tables; Z (N*Q, fp, A, B, C'') when cmul_mad forms
// the product (f >= MAD_F), else null; Y1 (N, fp, L, B, C''); Y2 (N, fp,
// L, oy, C'') only when RC < 0 (pass 2 through device memory).
extern "C" int os_segment_f32(const void* F, const void* W, const float* nb, void* Z,
                              const int* P, const void* T, void* Y1, void* Y2, float* out,
                              int N, int Q, int f, int fp, int A, int B, int Cb, int C, int s,
                              int oy, int oz, int j0, int out0, int L, int RS, int logT,
                              int RC, void* stream) {
  const Grid g{N, Q, f, fp, A, s, j0, out0, L, (long long)B * Cb};
  return (int)inverse(static_cast<const float2*>(F), static_cast<const float2*>(W), nb,
                      static_cast<float2*>(Z), P, static_cast<const float2*>(T),
                      static_cast<float2*>(Y1), static_cast<float2*>(Y2), out, g, B, Cb, C,
                      oy, oz, RS, logT, RC, static_cast<cudaStream_t>(stream));
}

// The conv form: x (N, f, nx, ny, nz) real -> out (N, fp, out0, oy, oz).
// Three scratch buffers serve the six intermediates, each reused once its
// contents are dead (every pass runs in order on one stream):
//   bufA: X1 (N*Q*f*E*ny, Cb), then Z (N*Q, fp, A, B, Cb) if f >= MAD_F
//   bufB: X2 (N*Q*f*E, B, Cb), then Y1 (N, fp, out0, B, Cb)
//   bufC: F  (N*Q, f, A, B, Cb), then Y2 (N, fp, out0, oy, Cb) if RC < 0
// ``mad`` is 1 where cmul_mad forms the product in bufA (f >= MAD_F).
extern "C" int os_segment_conv_f32(
    const float* x, const void* fz, const void* fy, const void* fx, const void* W,
    const float* nb, const int* P, const void* T, void* bufA, void* bufB, void* bufC,
    float* out, int N, int Q, int f, int fp, int E, int seg, int nx, int ny, int nz,
    int A, int B, int Cb, int C, int s, int oy, int oz, int out0, int mad, int RS,
    int logT, int RC, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* a = static_cast<float2*>(bufA);
  float2* b = static_cast<float2*>(bufB);
  float2* c = static_cast<float2*>(bufC);
  const long long rows = (long long)N * Q * f * E;  // (segment, channel, x-row)
  // forward along z, real input: x rows (rows*ny, nz) against fz read as
  // floats (nz, 2*Cb) -> X1 (rows*ny, Cb)
  cudaError_t err = launch_rows(x, RowMap{Q, f, E, seg, nx, ny},
                                static_cast<const float*>(fz), reinterpret_cast<float*>(a),
                                rows * ny, nz, 2 * Cb, st);
  if (err != cudaSuccess) return (int)err;
  // forward along y: (rows, ny, Cb) -> X2 (rows, B, Cb)
  err = launch_axis(a, static_cast<const float2*>(fy), b, rows, ny, B, Cb, st);
  if (err != cudaSuccess) return (int)err;
  // forward along x: (N*Q*f, E, B*Cb) -> F (N*Q*f, A, B*Cb)
  err = launch_axis(b, static_cast<const float2*>(fx), c, (long long)N * Q * f, E, A,
                    (long long)B * Cb, st);
  if (err != cudaSuccess) return (int)err;
  const Grid g{N, Q, f, fp, A, s, 0, out0, out0, (long long)B * Cb};
  return (int)inverse(c, static_cast<const float2*>(W), nb, mad ? a : nullptr, P,
                      static_cast<const float2*>(T), b, c, out, g, B, Cb, C, oy, oz, RS, logT,
                      RC, st);
}
