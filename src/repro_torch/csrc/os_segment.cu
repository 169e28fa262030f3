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
// What bounds it on the H100: the DFT products are operations (hundreds of
// GFLOP per call at full n337 width in fp32, outside the tensor cores);
// the MAD is bytes (cmul_mad.cuh).  The TPU kernel kept two whole-segment
// (fp_block, A, B, C'') accumulators in VMEM; at full width one output
// channel's segment spectrum is megabytes, far beyond the 227 KB of shared
// memory a block may use.  So this design stages it through device memory:
// each pass writes a scratch buffer the wrapper allocates, and each DFT
// pass is a shared-memory tiled product along one axis (32x32 output tile,
// K in steps of 16, four accumulators a thread).  Channels are not padded
// to the TPU's F_CHUNK (n337's layer 0 has f = 1) and bins are not padded
// to lanes.
#include "cmul_mad.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kK = 16;

// out[p, n, r] = sum_k L[k, n] * in[p, k, r]   (complex)
// grid (P, ceil(N/32), <= ceil(R/32), grid-stride over r tiles); block (32, 8)
__global__ void axis_product(const float2* __restrict__ in,
                             const float2* __restrict__ L,
                             float2* __restrict__ out, int K, int N,
                             long long R) {
  __shared__ float2 Ls[kK][kTile];
  __shared__ float2 Is[kK][kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long p = blockIdx.x;
  const int n0 = blockIdx.y * kTile;
  const float2* inp = in + p * (long long)K * R;
  const long long n_rt = (R + kTile - 1) / kTile;
  for (long long rt = blockIdx.z; rt < n_rt; rt += gridDim.z) {
    const long long r = rt * kTile + tx;
    float2 acc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] = make_float2(0.f, 0.f);
    for (int k0 = 0; k0 < K; k0 += kK) {
      for (int kk = ty; kk < kK; kk += 8) {
        const int k = k0 + kk;
        Is[kk][tx] = (k < K && r < R) ? inp[(long long)k * R + r]
                                      : make_float2(0.f, 0.f);
        Ls[kk][tx] = (k < K && n0 + tx < N) ? L[(long long)k * N + n0 + tx]
                                            : make_float2(0.f, 0.f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const float2 a = Is[kk][tx];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 l = Ls[kk][ty + 8 * u];
          acc[u].x = fmaf(l.x, a.x, fmaf(-l.y, a.y, acc[u].x));
          acc[u].y = fmaf(l.x, a.y, fmaf(l.y, a.x, acc[u].y));
        }
      }
      __syncthreads();
    }
    if (r < R) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + ty + 8 * u;
        if (n < N) out[(p * N + n) * R + r] = acc[u];
      }
    }
  }
}

// out[p, z] = sum_c Re(in[p, c]) * mr[c, z] + Im(in[p, c]) * mi[c, z]
// grid (ceil(P/32), ceil(Z/32)); block (32, 8)
__global__ void real_last_axis(const float2* __restrict__ in,
                               const float* __restrict__ mr,
                               const float* __restrict__ mi,
                               float* __restrict__ out, long long P, int K,
                               int Z) {
  __shared__ float2 Is[kTile][kK];
  __shared__ float Mr[kK][kTile];
  __shared__ float Mi[kK][kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const long long p0 = (long long)blockIdx.x * kTile;
  const int z = blockIdx.y * kTile + tx;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += kK) {
    for (int e = tid; e < kTile * kK; e += kTile * 8) {
      const int pp = e / kK, kk = e % kK;
      const long long p = p0 + pp;
      const int k = k0 + kk;
      Is[pp][kk] = (p < P && k < K) ? in[p * K + k] : make_float2(0.f, 0.f);
    }
    for (int kk = ty; kk < kK; kk += 8) {
      const int k = k0 + kk;
      const bool ok = k < K && z < Z;
      Mr[kk][tx] = ok ? mr[(long long)k * Z + z] : 0.f;
      Mi[kk][tx] = ok ? mi[(long long)k * Z + z] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float a = Mr[kk][tx], b = Mi[kk][tx];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 v = Is[ty + 8 * u][kk];
        acc[u] = fmaf(v.x, a, fmaf(v.y, b, acc[u]));
      }
    }
    __syncthreads();
  }
  if (z < Z) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long p = p0 + ty + 8 * u;
      if (p < P) out[p * Z + z] = acc[u];
    }
  }
}

// out[p, c] = sum_t x_row(p)[t] * fz[t, c]   (real rows, complex fz)
// Row p = (((n*Q + q)*f + i)*E + e)*ny + y reads x-row q*seg + e of
// (n, i), or zeros past nx.  grid (ceil(P/32), ceil(Cb/32)); block (32, 8)
__global__ void forward_real_rows(const float* __restrict__ x,
                                  const float2* __restrict__ fz,
                                  float2* __restrict__ out, long long P,
                                  int Q, int f, int E, int seg, int nx,
                                  int ny, int nz, int Cb) {
  __shared__ float Xs[kTile][kK + 1];
  __shared__ float2 Fs[kK][kTile];
  __shared__ long long rowoff[kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const long long p0 = (long long)blockIdx.x * kTile;
  const int c = blockIdx.y * kTile + tx;
  if (tid < kTile) {
    const long long p = p0 + tid;
    long long off = -1;
    if (p < P) {
      long long t = p;
      const int y = (int)(t % ny); t /= ny;
      const int e = (int)(t % E); t /= E;
      const int i = (int)(t % f); t /= f;
      const int q = (int)(t % Q);
      const long long n = t / Q;
      const int gx = q * seg + e;
      if (gx < nx) off = (((n * f + i) * nx + gx) * (long long)ny + y) * nz;
    }
    rowoff[tid] = off;
  }
  __syncthreads();
  float2 acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = make_float2(0.f, 0.f);
  for (int t0 = 0; t0 < nz; t0 += kK) {
    for (int e = tid; e < kTile * kK; e += kTile * 8) {
      const int pp = e / kK, kk = e % kK;
      const long long off = rowoff[pp];
      const int t = t0 + kk;
      Xs[pp][kk] = (off >= 0 && t < nz) ? x[off + t] : 0.f;
    }
    for (int kk = ty; kk < kK; kk += 8) {
      const int t = t0 + kk;
      Fs[kk][tx] = (t < nz && c < Cb) ? fz[(long long)t * Cb + c]
                                      : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float2 m = Fs[kk][tx];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v = Xs[ty + 8 * u][kk];
        acc[u].x = fmaf(v, m.x, acc[u].x);
        acc[u].y = fmaf(v, m.y, acc[u].y);
      }
    }
    __syncthreads();
  }
  if (c < Cb) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long p = p0 + ty + 8 * u;
      if (p < P) out[p * Cb + c] = acc[u];
    }
  }
}

cudaError_t launch_axis_product(const float2* in, const float2* L, float2* out,
                                long long P, int K, int N, long long R,
                                cudaStream_t stream) {
  const long long n_rt = (R + kTile - 1) / kTile;
  dim3 grid((unsigned)P, (unsigned)((N + kTile - 1) / kTile),
            (unsigned)(n_rt < 65535 ? n_rt : 65535));
  axis_product<<<grid, dim3(kTile, 8), 0, stream>>>(in, L, out, K, N, R);
  return cudaGetLastError();
}

// MAD + DC bias into Z, then the three crop-folded inverse passes.
cudaError_t mad_inverse(const float2* F, const float2* W, const float* nb,
                        const float2* ea, const float2* eb, const float* mr,
                        const float* mi, float2* Z, float2* Y1, float2* Y2,
                        float* out, int NQ, int f, int fp, int A, int B,
                        int Cb, int s, int oy, int oz, cudaStream_t st) {
  const long long bins = (long long)A * B * Cb;
  cudaError_t err = launch_cmul_mad(F, W, nb, Z, NQ, f, fp, bins, st);
  if (err != cudaSuccess) return err;
  const long long M = (long long)NQ * fp;
  // inverse along a: (M, A, B*Cb) -> (M, s, B*Cb)
  err = launch_axis_product(Z, ea, Y1, M, A, s, (long long)B * Cb, st);
  if (err != cudaSuccess) return err;
  // inverse along b: (M*s, B, Cb) -> (M*s, oy, Cb)
  err = launch_axis_product(Y1, eb, Y2, M * s, B, oy, Cb, st);
  if (err != cudaSuccess) return err;
  // inverse along c, real: (M*s*oy, Cb) -> (M*s*oy, oz)
  const long long P = M * s * oy;
  dim3 grid((unsigned)((P + kTile - 1) / kTile),
            (unsigned)((oz + kTile - 1) / kTile));
  real_last_axis<<<grid, dim3(kTile, 8), 0, st>>>(Y2, mr, mi, out, P, Cb, oz);
  return cudaGetLastError();
}

}  // namespace

extern "C" int os_segment_f32(const void* F, const void* W, const float* nb,
                              const void* ea, const void* eb, const float* mr,
                              const float* mi, void* Z, void* Y1, void* Y2,
                              float* out, int NQ, int f, int fp, int A, int B,
                              int Cb, int s, int oy, int oz, void* stream) {
  return (int)mad_inverse(
      static_cast<const float2*>(F), static_cast<const float2*>(W), nb,
      static_cast<const float2*>(ea), static_cast<const float2*>(eb), mr, mi,
      static_cast<float2*>(Z), static_cast<float2*>(Y1),
      static_cast<float2*>(Y2), out, NQ, f, fp, A, B, Cb, s, oy, oz,
      static_cast<cudaStream_t>(stream));
}

// The conv form: x (N, f, nx, ny, nz) real -> out (N, Q, fp, s, oy, oz).
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
    int nz, int A, int B, int Cb, int s, int oy, int oz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* a = static_cast<float2*>(bufA);
  float2* b = static_cast<float2*>(bufB);
  float2* c = static_cast<float2*>(bufC);
  const long long rows = (long long)N * Q * f * E;  // (segment, channel, x-row)
  // forward along z, real input: (rows*ny, nz) -> X1 (rows*ny, Cb)
  const long long P = rows * ny;
  dim3 grid((unsigned)((P + kTile - 1) / kTile),
            (unsigned)((Cb + kTile - 1) / kTile));
  forward_real_rows<<<grid, dim3(kTile, 8), 0, st>>>(
      x, static_cast<const float2*>(fz), a, P, Q, f, E, seg, nx, ny, nz, Cb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // forward along y: (rows, ny, Cb) -> X2 (rows, B, Cb)
  err = launch_axis_product(a, static_cast<const float2*>(fy), b, rows, ny, B,
                            Cb, st);
  if (err != cudaSuccess) return (int)err;
  // forward along x: (N*Q*f, E, B*Cb) -> F (N*Q*f, A, B*Cb)
  err = launch_axis_product(b, static_cast<const float2*>(fx), c,
                            (long long)N * Q * f, E, A, (long long)B * Cb, st);
  if (err != cudaSuccess) return (int)err;
  return (int)mad_inverse(
      c, static_cast<const float2*>(W), nb, static_cast<const float2*>(ea),
      static_cast<const float2*>(eb), mr, mi, a, b, c, out, N * Q, f, fp, A,
      B, Cb, s, oy, oz, st);
}
