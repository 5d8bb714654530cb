// K10: the many-stream bandwidth probe,
//     out = 0.999 * in[0] + in[1] + ... + in[n-1]   (f32, summed in that order)
//
// Replaces the Pallas kernel of otmb_tpu/utils/profiling.py:dma_peak_probe.
// Its traffic is known exactly: n reads and one write of the same length.
// Timed over back-to-back launches, bytes / time is the copy bandwidth a
// many-stream kernel can sustain on this card: the denominator for the
// other kernels' bandwidth fractions.
//
// Bound on the H100: device-memory bandwidth, by construction (one add per
// 4 bytes read). Design: one thread per 16-byte float4 of every stream, i
// fastest, so each warp reads 512 consecutive bytes of each stream per
// load instruction; the streams' pointers travel by value in the kernel's
// parameter block.
#include "common.cuh"

namespace otmb {

constexpr int kProbeMaxStreams = 16;

struct ProbeStreams {
  const float4* in[kProbeMaxStreams];
};

__global__ void probe_kernel(ProbeStreams s, int nstreams, float4* __restrict__ out,
                             long long n4) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  const float4 a = s.in[0][e];
  float4 acc = make_float4(a.x * 0.999f, a.y * 0.999f, a.z * 0.999f, a.w * 0.999f);
  // Unrolled, so every s.in[r] is a constant index into the parameter
  // block rather than a copy of it on the stack.
#pragma unroll
  for (int r = 1; r < kProbeMaxStreams; ++r) {
    if (r < nstreams) {
      const float4 b = s.in[r][e];
      acc.x = acc.x + b.x;
      acc.y = acc.y + b.y;
      acc.z = acc.z + b.z;
      acc.w = acc.w + b.w;
    }
  }
  out[e] = acc;
}

}  // namespace otmb

// `ins` is a host array of `nstreams` device pointers, each to `n` floats
// (n a multiple of 4, every pointer 16-byte aligned; the wrapper checks).
OTMB_EXPORT int otmb_probe_f32(const void* const* ins, int nstreams, void* out, long long n,
                               void* stream) {
  if (nstreams < 1 || nstreams > otmb::kProbeMaxStreams || n % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  otmb::ProbeStreams s = {};
  for (int r = 0; r < nstreams; ++r) s.in[r] = static_cast<const float4*>(ins[r]);
  const long long n4 = n / 4;
  otmb::probe_kernel<<<otmb::blocks_for(n4), otmb::kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(s, nstreams,
                                                           static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}
