// SpecAugment 1-D time warp for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel acvae_tpu/ops/pallas/warp_kernel.py
// (time_warp_1d, body _warp_kernel).  Computes, for image and flow [B, T, F]
// in float32,
//
//   q     = t - clip(flow[b,t,f], -max_shift, max_shift)
//   i     = clip(floor(q), 0, T-2)
//   alpha = clip(q - i, 0, 1)
//   out[b,t,f] = (1-alpha) * image[b,i,f] + alpha * image[b,i+1,f]
//
// Bound: memory.  Each element reads one flow value and writes one output
// (the two image reads fall on rows i and i+1 of the same (b), which the
// smooth spline flow keeps within a few rows of t, so they hit L1/L2): 12
// bytes per element, 25.2 MB at [32, 1024, 64], about 7.5 us at 3.35 TB/s.
//
// Design: the TPU kernel staged each image in VMEM and enumerated shifts in
// 8-row windows only because Mosaic has no dynamic gather.  Hopper gathers
// natively, so this is one thread per output element in a grid-stride loop
// with f innermost: neighbouring threads read neighbouring flow and output
// addresses, and the two image rows of one (b, t) are read contiguously
// across f.  Any T >= 2 works; there is no chunking.
//
// The arithmetic uses explicitly rounded operations (no FMA contraction) so
// that it rounds exactly like the unfused PyTorch reference time_warp_1d_ref.
// Index math is 32-bit unsigned (the launcher refuses B*T*F >= 2^31): 64-bit
// division is a long software sequence on the GPU, and the per-element
// (b, t, f) split would otherwise cost more than the memory traffic.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void time_warp_1d_kernel(const float* __restrict__ image,
                                    const float* __restrict__ flow,
                                    float* __restrict__ out,
                                    unsigned total, unsigned T, unsigned F,
                                    float max_shift) {
  const unsigned stride = gridDim.x * blockDim.x;
  const float t_hi = (float)(T - 2);
  // total < 2^31 and stride < 2^31, so idx + stride cannot wrap
  for (unsigned idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const unsigned f = idx % F;
    const unsigned bt = idx / F;
    const unsigned t = bt % T;
    const float fl = fminf(fmaxf(__ldg(flow + idx), -max_shift), max_shift);
    const float q = __fsub_rn((float)t, fl);
    const float lo_f = fminf(fmaxf(floorf(q), 0.0f), t_hi);
    const float alpha = fminf(fmaxf(__fsub_rn(q, lo_f), 0.0f), 1.0f);
    // row lo of this (b): (bt - t) = b*T
    const float* row = image + (bt - t + (unsigned)lo_f) * F + f;
    const float low = __ldg(row);
    const float high = __ldg(row + F);
    out[idx] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, alpha), low),
                         __fmul_rn(alpha, high));
  }
}

// Launches on `stream`; returns cudaGetLastError() so the caller can raise
// on a refused launch, or cudaErrorInvalidValue for B*T*F >= 2^31.
extern "C" int time_warp_1d_launch(const void* image, const void* flow,
                                   void* out, long long B, int T, int F,
                                   float max_shift, void* stream) {
  const long long total = B * (long long)T * F;
  if (total == 0) return 0;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long max_blocks = (long long)sms * 16;  // 16 x 256 threads per SM
  if (blocks > max_blocks) blocks = max_blocks;
  time_warp_1d_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)image, (const float*)flow, (float*)out, (unsigned)total,
      (unsigned)T, (unsigned)F, max_shift);
  return (int)cudaGetLastError();
}
