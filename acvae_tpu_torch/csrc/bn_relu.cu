// The PANN ConvBlock's inference epilogue for Hopper (sm_90a): BatchNorm on
// running statistics, ReLU and, after a block's second conv, the 2x2 average
// pool, as one pass over each conv's output.
//
// Replaces no Pallas kernel.  It stands for the fusion XLA makes on the TPU of
// acvae_tpu/models/encoders.py:38-60 (ConvBlock: conv -> BatchNorm -> relu,
// twice, then the pool).  Unfused, the port read each bf16 conv output back
// five times in float32 (cast, sub, mul, add, cast), then relu and avg_pool2d
// read it again: ~40 bytes of traffic an element.  Here each element is read
// once and written once (a quarter as much written after the pool).
//
// For x [N, C, H, W] NCHW-contiguous in T (bfloat16 or float32) and float32
// per-channel mean, mul (= rsqrt(running_var + eps) * weight, computed by the
// wrapper with PyTorch's own ops) and bias:
//
//   y   = relu(T((x - mean) * mul + bias))
//   out = y, or T(((0 + y00 + y01) + y10 + y11) / 4) over VALID 2x2 windows
//         (floor on odd H or W) with pool
//
// Bit-exact against the unfused PyTorch ops: every step is rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction), the cast rounds to
// nearest even (the same cvt.rn as PyTorch's bfloat16), relu is PyTorch's
// clamp_min(0) (NaN kept, else fmaxf(v, 0)), and the pool sums in float32 in
// avg_pool2d's order, from 0, and divides by 4 (x * 0.25 is the same rounding
// of the same real number).
//
// Bound: bytes.  At Cnn14's 12 BatchNorms of a batch of 512 clips of 1024
// frames, bf16, it moves 27.6 GB: 8.2 ms at 3.35 TB/s.  Design: each (n, c)
// plane is contiguous and shares one channel's three parameters, so threads
// walk 16-byte vectors of the flattened tensor (one vector never straddles two
// planes: the launcher asks H*W, and the output plane, to be whole vectors)
// and fetch the channel's parameters through the read-only cache.  Unpooled,
// a thread keeps UNROLL vector loads in flight.  Pooled, where an output row
// is whole vectors (Wo % V == 0), a thread writes one output vector from four
// input vectors, two from each of its two input rows.  The channel is found
// with multiply-high division (the vector index is below 2^31).  Any other
// shape (in bf16, the 128x8 and 64x4 maps of Cnn10 and Cnn14, which pool to
// rows of 4 and 2 values), or an unaligned pointer, takes a scalar kernel, one
// output element a thread.
// The grid is one wave of resident blocks over the card's SMs, walked with a
// grid stride, so every block shape fills all 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;   // unpooled: vector loads in flight a thread

// n / d for n < 2^31 by a multiply-high and a shift (PyTorch's IntDivider)
struct Divider {
  unsigned d, m, s;
  explicit Divider(unsigned d_) : d(d_), s(0) {
    while (s < 32 && (1ull << s) < d) ++s;
    m = static_cast<unsigned>(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
  __device__ __forceinline__ unsigned mod(unsigned n) const { return n - div(n) * d; }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

struct Affine {
  float mean, mul, bias;
};

__device__ __forceinline__ Affine affine(const float* mean, const float* mul,
                                         const float* bias, unsigned c) {
  return {__ldg(mean + c), __ldg(mul + c), __ldg(bias + c)};
}

// relu(T((x - mean) * mul + bias)) as a float (exact in T)
template <typename T>
__device__ __forceinline__ float bn_relu1(T x, Affine a) {
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(to_f(x), a.mean), a.mul), a.bias);
  const float r = to_f(from_f<T>(y));
  return isnan(r) ? r : fmaxf(r, 0.0f);
}

__device__ __forceinline__ float pool4(float a00, float a01, float a10, float a11) {
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(0.0f, a00), a01), a10), a11);
  return __fmul_rn(s, 0.25f);
}

// unpooled: vector i of the flattened tensor; per_plane = H*W / V vectors
template <typename T>
__global__ void __launch_bounds__(THREADS)
bn_relu_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const float* __restrict__ mean, const float* __restrict__ mul,
                   const float* __restrict__ bias, unsigned nvec,
                   Divider per_plane, Divider chans) {
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
  Vec<T>* ov = reinterpret_cast<Vec<T>*>(out);
  const unsigned stride = gridDim.x * THREADS;
  // nvec < 2^31 and UNROLL * stride < 2^31: the indices cannot wrap
  for (unsigned i0 = blockIdx.x * THREADS + threadIdx.x; i0 < nvec;
       i0 += UNROLL * stride) {
    Vec<T> v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const unsigned i = i0 + k * stride;
      if (i < nvec) v[k] = xv[i];
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const unsigned i = i0 + k * stride;
      if (i >= nvec) break;
      const Affine a = affine(mean, mul, bias, chans.mod(per_plane.div(i)));
#pragma unroll
      for (int j = 0; j < Vec<T>::N; ++j) v[k].v[j] = from_f<T>(bn_relu1(v[k].v[j], a));
      ov[i] = v[k];
    }
  }
}

// pooled: output vector i; per_plane = Ho*Wo / V vectors, an output row whole
// vectors (Wo % V == 0; out_w = Wo divides the plane's values into rows)
template <typename T>
__global__ void __launch_bounds__(THREADS)
bn_relu_pool_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const float* __restrict__ mean, const float* __restrict__ mul,
                    const float* __restrict__ bias, unsigned nvec,
                    Divider per_plane, Divider chans, Divider out_w,
                    unsigned H, unsigned W) {
  constexpr int V = Vec<T>::N;
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
  Vec<T>* ov = reinterpret_cast<Vec<T>*>(out);
  const unsigned stride = gridDim.x * THREADS;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < nvec; i += stride) {
    const unsigned plane = per_plane.div(i);
    const unsigned q = i - plane * per_plane.d;
    // rows 2ho and 2ho + 1 from column 2 wo0: top in[0..1], bottom in[2..3]
    const unsigned o = q * V, ho = out_w.div(o), wo0 = o - ho * out_w.d;
    const unsigned long long at =
        static_cast<unsigned long long>(plane) * H * W + 2ull * ho * W + 2 * wo0;
    Vec<T> in[4];   // value t of a row pair is in[t / V].v[t % V]
#pragma unroll
    for (int k = 0; k < 4; ++k) in[k] = xv[(at + (k & 1) * V + (k >> 1) * W) / V];
    const Affine a = affine(mean, mul, bias, chans.mod(plane));
    Vec<T> r;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int t = 2 * j;   // the top-left input of output j
      r.v[j] = from_f<T>(pool4(
          bn_relu1(in[t / V].v[t % V], a), bn_relu1(in[(t + 1) / V].v[(t + 1) % V], a),
          bn_relu1(in[2 + t / V].v[t % V], a), bn_relu1(in[2 + (t + 1) / V].v[(t + 1) % V], a)));
    }
    ov[i] = r;
  }
}

// any shape: output element i of [N, C, Ho, Wo]
template <typename T, bool POOL>
__global__ void __launch_bounds__(THREADS)
bn_relu_any_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const float* __restrict__ mean, const float* __restrict__ mul,
                   const float* __restrict__ bias, unsigned total,
                   Divider per_plane, Divider chans, Divider out_w,
                   unsigned H, unsigned W) {
  const unsigned stride = gridDim.x * THREADS;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < total; i += stride) {
    const unsigned plane = per_plane.div(i);
    const unsigned q = i - plane * per_plane.d;
    const Affine a = affine(mean, mul, bias, chans.mod(plane));
    if (!POOL) {
      out[i] = from_f<T>(bn_relu1(x[i], a));
      continue;
    }
    const unsigned ho = out_w.div(q), wo = q - ho * out_w.d;
    const T* p = x + static_cast<unsigned long long>(plane) * H * W + 2ull * ho * W + 2 * wo;
    out[i] = from_f<T>(pool4(bn_relu1(p[0], a), bn_relu1(p[1], a),
                             bn_relu1(p[W], a), bn_relu1(p[W + 1], a)));
  }
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// one wave of resident blocks (fewer if the work is smaller)
template <typename K>
int grid_for(K kernel, unsigned long long threads_needed) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const unsigned long long wave = static_cast<unsigned long long>(sm_count()) *
                                  (per_sm > 0 ? per_sm : 1);
  const unsigned long long blocks = (threads_needed + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < wave ? blocks : wave);
}

template <typename T>
int launch(const void* xp, void* op, const float* mean, const float* mul,
           const float* bias, long long N, int C, int H, int W, bool pool,
           cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const T* x = static_cast<const T*>(xp);
  T* out = static_cast<T*>(op);
  const int Ho = pool ? H / 2 : H, Wo = pool ? W / 2 : W;
  const unsigned long long planes = static_cast<unsigned long long>(N) * C;
  const unsigned long long total = planes * Ho * Wo;
  if (total == 0) return 0;
  if (total >= (1ull << 31) * V || planes >= (1ull << 31) ||
      static_cast<unsigned long long>(H) * W >= (1ull << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(xp) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(op) % 16 == 0;
  const unsigned in_plane = static_cast<unsigned>(H) * W, out_plane = Ho * Wo;
  const Divider chans(C);
  if (aligned && in_plane % V == 0 && out_plane % V == 0) {
    const unsigned nvec = static_cast<unsigned>(total / V);
    const Divider per_plane(out_plane / V), out_w(Wo);
    if (!pool) {
      auto k = bn_relu_vec_kernel<T>;
      k<<<grid_for(k, (nvec + UNROLL - 1) / UNROLL), THREADS, 0, stream>>>(
          x, out, mean, mul, bias, nvec, per_plane, chans);
      return static_cast<int>(cudaGetLastError());
    }
    if (W == 2 * Wo && Wo % V == 0) {
      auto k = bn_relu_pool_kernel<T>;
      k<<<grid_for(k, nvec), THREADS, 0, stream>>>(x, out, mean, mul, bias, nvec,
                                                   per_plane, chans, out_w, H, W);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (total >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Divider per_plane(out_plane), out_w(Wo);
  auto k = pool ? bn_relu_any_kernel<T, true> : bn_relu_any_kernel<T, false>;
  k<<<grid_for(k, total), THREADS, 0, stream>>>(
      x, out, mean, mul, bias, static_cast<unsigned>(total), per_plane, chans,
      out_w, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out [N, C, H, W] (out [N, C, H/2, W/2] with pool) contiguous, dtype
// 0 float32, 1 bfloat16; mean, mul, bias [C] float32.  Launches on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// 32-bit indices cannot hold.
extern "C" int bn_relu_launch(const void* x, void* out, const void* mean,
                              const void* mul, const void* bias, int dtype,
                              long long N, int C, int H, int W, int pool,
                              void* stream) {
  const float *m = static_cast<const float*>(mean), *s = static_cast<const float*>(mul),
              *b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, m, s, b, N, C, H, W, pool != 0, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, m, s, b, N, C, H, W, pool != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
