// The int8 serving encoder's conv and pool for Hopper (sm_90a).
//
// Replaces acvae_tpu/models/quant.py QuantPannEncoder._conv (:424) with the
// f32 affine and _requantize (:439) after it, and _avgpool_i8 (:86).  These
// have no Pallas counterpart: on the TPU, XLA builds them from
// lax.conv_general_dilated(..., preferred_element_type=int32) plus an
// elementwise epilogue fused into one s8-producing fusion.
//
// conv3x3_i8: x [N,H,W,Ci] int8 (NHWC), w [Co,3,3,Ci] int8 (OHWI, repacked
// once at bake time), A/B [Co] float32;
//   acc = sum_{dy,dx,ci} xpad[n,h+dy-1,w+dx-1,ci] * w[co,dy,dx,ci]   (int32)
//   y   = fma(float(acc), A[co], B[co])         (one rounding, as XLA does)
//   mode 0 "sym":     clip(rint(y), 0, 127)              -> int8
//   mode 1 "offset":  clip(rint(y) - 128, -128, 127)     -> int8
//   mode 2 "f32relu": max(y, 0)                          -> float32
//   mode 3 "f32":     y                                  -> float32
// where xpad reads pad_code (0, or -128 for the offset coding) outside the
// image.  No int32 or f32 intermediate reaches device memory.
//
// Bound, batch 512 of T 1024 x F 64 (Cnn10 64->512, 8 convs a batch): the
// larger of 2*N*H*W*9*Ci*Co operations at 1,979 TOP/s (int8 tensor cores)
// and the bytes of x, w and out at 3.35 TB/s, per conv: 0.65 ms for the
// Ci=1 stem (bytes), 1.28 ms for block 1's 64->64 (2.47 TOP, 4.3 GB: bytes),
// 0.63 / 1.25 ms for each later block's two convs (operations); 7.6 ms for
// the 8.  This first kernel is far from that: it multiplies on the integer
// pipes with __dp4a (4 int8 products a lane and instruction), which peak
// near a sixteenth of the int8 tensor cores, so it is bound by its own dp4a
// issue rate: 78-88 TOP/s, 164-172 ms for the 8 convs of a batch of 512
// (H100 80GB HBM3 at 700 W, chip_smoke.py, three runs).  Design, for that: an implicit
// GEMM, one block of 256 threads per tile of 8x8 output pixels x 64 output
// channels; the 10x10 input halo and the 64 channels' 3x3 weights are
// staged in shared memory 64 input channels at a time (44 KB), each thread
// keeps 4 pixels x 4 channels of int32 sums in registers and reads its
// operands as 16-byte vectors, so each pair of vector loads feeds 16 dp4a.
// The Ci=1 stem is a scalar kernel (9 products an output).  Tensor cores
// (mma.sync s8 m16n8k32, then wgmma fed by TMA) are the next step.
//
// avgpool2x2_i8: x [N,H,W,C] int8 -> [N,H/2,W/2,C]: the int32 sum of the
// 2x2 window, then (s+2)>>2 (arithmetic shift); odd trailing rows and
// columns dropped.  Bound: bytes (input read once, output written once),
// 0.80 + 0.40 + 0.20 = 1.4 ms for blocks 1-3 of a batch.  One thread per 16
// channels of an output pixel: four 16-byte loads, one 16-byte store.
//
// Offsets into the activations are 64-bit: block 1's tensors at batch 512
// hold exactly 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 8;              // output pixel tile
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;
constexpr int TCO = 64;                    // output channels per block
constexpr int KC = 64;                     // input channels per stage
constexpr int KQ = KC / 16;                // 16-byte vectors per pixel
constexpr int THREADS = 256;

template <int MODE>
__device__ __forceinline__ void store_one(void* out, long long o, int acc,
                                          float a, float b) {
  const float y = __fmaf_rn(__int2float_rn(acc), a, b);
  if (MODE == 2) {
    static_cast<float*>(out)[o] = fmaxf(y, 0.0f);
  } else if (MODE == 3) {
    static_cast<float*>(out)[o] = y;
  } else {
    float v = rintf(y);
    if (MODE == 0) {
      v = fminf(fmaxf(v, 0.0f), 127.0f);
    } else {
      v = fminf(fmaxf(__fsub_rn(v, 128.0f), -128.0f), 127.0f);
    }
    static_cast<int8_t*>(out)[o] = static_cast<int8_t>(static_cast<int>(v));
  }
}

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// Ci a multiple of 64, Co a multiple of 64.  grid.x: N * tiles_h * tiles_w
// pixel tiles, grid.y: Co / 64.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
conv3x3_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ A, const float* __restrict__ B,
                  void* __restrict__ out, int H, int W, int Ci, int Co,
                  int tiles_h, int tiles_w, int pad_word) {
  __shared__ int4 s_in[HALO_H * HALO_W * KQ];   // [halo pixel][16 B of ci]
  __shared__ int4 s_w[9 * KQ * TCO];            // [tap][16 B of ci][co]
  const int tid = threadIdx.x;
  const int cg = tid & 15;                      // channels cg + 16j
  const int pg = tid >> 4;                      // pixels pg + 16i
  const int r0 = pg >> 3, col = pg & 7;         // rows r0 + 2i, column col
  long long tile = blockIdx.x;
  const int tw_i = static_cast<int>(tile % tiles_w);
  tile /= tiles_w;
  const int th_i = static_cast<int>(tile % tiles_h);
  const long long n = tile / tiles_h;
  const int h0 = th_i * TH, w0 = tw_i * TW, co0 = blockIdx.y * TCO;
  const long long img = n * H * W;              // first pixel of image n

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kc0 = 0; kc0 < Ci; kc0 += KC) {
    __syncthreads();
    for (int e = tid; e < HALO_H * HALO_W * KQ; e += THREADS) {
      const int hp = e / KQ, q = e % KQ;
      const int hh = h0 - 1 + hp / HALO_W, ww = w0 - 1 + hp % HALO_W;
      int4 v = make_int4(pad_word, pad_word, pad_word, pad_word);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const int8_t* p = x + (img + static_cast<long long>(hh) * W + ww) * Ci
                          + kc0 + q * 16;
        v = __ldg(reinterpret_cast<const int4*>(p));
      }
      s_in[e] = v;
    }
    // weights: consecutive threads read consecutive 16 B of one channel's
    // 3x3 x 64-ci slab (9 runs of 64 contiguous bytes)
    for (int e = tid; e < 9 * KQ * TCO; e += THREADS) {
      const int c = e / (9 * KQ), tq = e % (9 * KQ);
      const int tap = tq / KQ, q = tq % KQ;
      const int8_t* p = w + (static_cast<long long>(co0 + c) * 9 + tap) * Ci
                        + kc0 + q * 16;
      s_w[tq * TCO + c] = __ldg(reinterpret_cast<const int4*>(p));
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        int4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = s_in[((r0 + 2 * i + dy) * HALO_W + col + dx) * KQ + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = s_w[(tap * KQ + q) * TCO + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot16(a[i], b[j], acc[i][j]);
      }
    }
  }

  float av[4], bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    av[j] = __ldg(A + co0 + cg + 16 * j);
    bv[j] = __ldg(B + co0 + cg + 16 * j);
  }
  const int ww = w0 + col;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int hh = h0 + r0 + 2 * i;
    if (hh >= H || ww >= W) continue;
    const long long base = (img + static_cast<long long>(hh) * W + ww) * Co
                           + co0 + cg;
#pragma unroll
    for (int j = 0; j < 4; ++j) store_one<MODE>(out, base + 16 * j, acc[i][j], av[j], bv[j]);
  }
}

// Ci == 1 (the stem).  One thread per (pixel, 16 output channels); the
// weights [Co][9] sit in shared memory as int.  total = N*H*W*(Co/16) < 2^31.
constexpr int STEM_MAX_CO = 512;

template <int MODE>
__global__ void __launch_bounds__(THREADS)
conv3x3_c1_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ A, const float* __restrict__ B,
                  void* __restrict__ out, unsigned total, int H, int W, int Co,
                  int pad) {
  __shared__ int s_w[STEM_MAX_CO * 9];
  for (int e = threadIdx.x; e < Co * 9; e += THREADS) s_w[e] = w[e];
  __syncthreads();
  const unsigned groups = static_cast<unsigned>(Co) / 16;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const unsigned g = idx % groups;
    const unsigned pix = idx / groups;          // n*H*W + h*W + w
    const int ww = static_cast<int>(pix % static_cast<unsigned>(W));
    const unsigned t = pix / static_cast<unsigned>(W);
    const int hh = static_cast<int>(t % static_cast<unsigned>(H));
    const long long row0 = static_cast<long long>(pix) - ww - static_cast<long long>(hh) * W;
    int v[9];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int h = hh + dy - 1, c = ww + dx - 1;
        v[dy * 3 + dx] = (h >= 0 && h < H && c >= 0 && c < W)
                             ? static_cast<int>(x[row0 + static_cast<long long>(h) * W + c])
                             : pad;
      }
    const long long base = static_cast<long long>(pix) * Co + g * 16;
    const int* wg = s_w + g * 16 * 9;
    if (MODE >= 2) {
      float r[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        int acc = 0;
#pragma unroll
        for (int t9 = 0; t9 < 9; ++t9) acc += v[t9] * wg[k * 9 + t9];
        const float y = __fmaf_rn(__int2float_rn(acc), __ldg(A + g * 16 + k),
                                  __ldg(B + g * 16 + k));
        r[k] = MODE == 2 ? fmaxf(y, 0.0f) : y;
      }
      float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + base);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
    } else {
      uint32_t packed[4];
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = 4 * k4 + b;
          int acc = 0;
#pragma unroll
          for (int t9 = 0; t9 < 9; ++t9) acc += v[t9] * wg[k * 9 + t9];
          const float y = __fmaf_rn(__int2float_rn(acc), __ldg(A + g * 16 + k),
                                    __ldg(B + g * 16 + k));
          float q = rintf(y);
          q = MODE == 0 ? fminf(fmaxf(q, 0.0f), 127.0f)
                        : fminf(fmaxf(__fsub_rn(q, 128.0f), -128.0f), 127.0f);
          word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * b);
        }
        packed[k4] = word;
      }
      *reinterpret_cast<int4*>(static_cast<int8_t*>(out) + base) =
          make_int4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

// total = N*Ho*Wo*(C/16) < 2^31
__global__ void __launch_bounds__(THREADS)
avgpool2x2_i8_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                     unsigned total, int H, int W, int C, int Ho, int Wo) {
  const unsigned groups = static_cast<unsigned>(C) / 16;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const unsigned g = idx % groups;
    const unsigned p = idx / groups;            // n*Ho*Wo + ho*Wo + wo
    const unsigned wo = p % static_cast<unsigned>(Wo);
    const unsigned t = p / static_cast<unsigned>(Wo);
    const unsigned ho = t % static_cast<unsigned>(Ho);
    const unsigned n = t / static_cast<unsigned>(Ho);
    const long long row = static_cast<long long>(W) * C;
    const long long base = ((static_cast<long long>(n) * H + 2 * ho) * W + 2 * wo) * C + g * 16;
    const int4 q00 = __ldg(reinterpret_cast<const int4*>(x + base));
    const int4 q01 = __ldg(reinterpret_cast<const int4*>(x + base + C));
    const int4 q10 = __ldg(reinterpret_cast<const int4*>(x + base + row));
    const int4 q11 = __ldg(reinterpret_cast<const int4*>(x + base + row + C));
    const uint32_t* a = reinterpret_cast<const uint32_t*>(&q00);
    const uint32_t* b = reinterpret_cast<const uint32_t*>(&q01);
    const uint32_t* c = reinterpret_cast<const uint32_t*>(&q10);
    const uint32_t* d = reinterpret_cast<const uint32_t*>(&q11);
    int r[4];
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      uint32_t word = 0;
#pragma unroll
      for (int bt = 0; bt < 4; ++bt) {
        const int sh = 24 - 8 * bt;             // byte bt, sign-extended
        const int s = (static_cast<int>(a[k4] << sh) >> 24)
                      + (static_cast<int>(b[k4] << sh) >> 24)
                      + (static_cast<int>(c[k4] << sh) >> 24)
                      + (static_cast<int>(d[k4] << sh) >> 24);
        word |= (static_cast<uint32_t>((s + 2) >> 2) & 0xFFu) << (8 * bt);
      }
      r[k4] = static_cast<int>(word);
    }
    *reinterpret_cast<int4*>(out + p * static_cast<long long>(C) + g * 16) =
        make_int4(r[0], r[1], r[2], r[3]);
  }
}

int grid_for(long long total) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (total + THREADS - 1) / THREADS;
  const long long max_blocks = static_cast<long long>(sms) * 8;
  return static_cast<int>(blocks < max_blocks ? blocks : max_blocks);
}

template <int MODE>
void launch_conv(const int8_t* x, const int8_t* w, const float* A, const float* B,
                 void* out, long long N, int H, int W, int Ci, int Co, int pad,
                 cudaStream_t stream) {
  if (Ci == 1) {
    const long long total = N * H * W * (Co / 16);
    conv3x3_c1_kernel<MODE><<<grid_for(total), THREADS, 0, stream>>>(
        x, w, A, B, out, static_cast<unsigned>(total), H, W, Co, pad);
    return;
  }
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  const uint32_t pb = static_cast<uint32_t>(pad) & 0xFFu;
  const int pad_word = static_cast<int>(pb * 0x01010101u);
  const dim3 grid(static_cast<unsigned>(N * tiles_h * tiles_w), Co / TCO);
  conv3x3_i8_kernel<MODE><<<grid, THREADS, 0, stream>>>(
      x, w, A, B, out, H, W, Ci, Co, tiles_h, tiles_w, pad_word);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape or mode the kernels do not take (the wrapper checks first).
extern "C" int conv3x3_i8_launch(const void* x, const void* w, const void* A,
                                 const void* B, void* out, long long N, int H,
                                 int W, int Ci, int Co, int mode, int pad_code,
                                 void* stream) {
  if (N * H * W == 0) return 0;
  const bool ci_ok = Ci == 1 ? Co <= STEM_MAX_CO : Ci % KC == 0;
  if (!ci_ok || Co % TCO != 0 || Co <= 0 || mode < 0 || mode > 3 ||
      pad_code < -128 || pad_code > 127)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = N * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if ((Ci == 1 ? N * H * W * (Co / 16) : tiles) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch_conv<0>(xi, wi, Af, Bf, out, N, H, W, Ci, Co, pad_code, s); break;
    case 1: launch_conv<1>(xi, wi, Af, Bf, out, N, H, W, Ci, Co, pad_code, s); break;
    case 2: launch_conv<2>(xi, wi, Af, Bf, out, N, H, W, Ci, Co, pad_code, s); break;
    default: launch_conv<3>(xi, wi, Af, Bf, out, N, H, W, Ci, Co, pad_code, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int avgpool2x2_i8_launch(const void* x, void* out, long long N, int H,
                                    int W, int C, void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  const long long total = N * Ho * Wo * (C / 16);
  if (total == 0) return 0;
  if (C % 16 != 0 || total >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  avgpool2x2_i8_kernel<<<grid_for(total), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out),
      static_cast<unsigned>(total), H, W, C, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}
