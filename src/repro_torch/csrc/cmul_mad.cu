// Complex MAD over channels, the FFT conv's pointwise stage.
//
// Replaces the Pallas kernels ``cmul_mad_planes`` and
// ``cmul_mad_bias_planes`` of src/repro/kernels/cmul_mad/kernel.py: both
// are one computation here, ``nb == nullptr`` giving the first and a
// per-output-channel DC-bin bias ``nb[j] = b[j] * prod(fft_shape)`` the
// second.  What bounds it and how the design answers: see cmul_mad.cuh.
#include "cmul_mad.cuh"

extern "C" int cmul_mad_c64(const void* X, const void* W, const float* nb,
                            void* O, int S, int f, int fp, long long B,
                            void* stream) {
  return (int)launch_cmul_mad(static_cast<const float2*>(X),
                              static_cast<const float2*>(W), nb,
                              static_cast<float2*>(O), S, f, fp, B,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
