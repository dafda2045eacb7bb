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
// image.  No int32 or f32 intermediate reaches device memory.  Every sum is
// exact in int32 (|acc| <= 9*512*128*127 < 2^31), so the order of the sums
// does not change the result.
//
// Bound, batch 512 of T 1024 x F 64 (Cnn10 64->512, 8 convs a batch): the
// larger of 2*N*H*W*9*Ci*Co operations at 1,979 TOP/s (int8 tensor cores)
// and the bytes of x, w and out at 3.35 TB/s: 0.65 ms for the Ci=1 stem
// (bytes), 1.28 ms for block 1's 64->64 (bytes), 0.63 / 1.25 ms for each
// later block's two convs (operations); 7.6 ms for the 8.
//
// Body (Ci a multiple of 64): an implicit GEMM on the int8 tensor cores,
// M = N*H*W output pixels, N = Co, K = 9*Ci ordered (tap, ci), so that an
// OHWI weight row is one output channel's K bytes, the K-major operand of
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (SASS IMMA).  A block owns 128
// output pixels (whole image rows where W <= 128: 2, 4, 8 and 16 rows in
// Cnn10's four blocks) and 128 output channels (64 where Co is not a
// multiple of 128, and for Co = 64).  Eight warps (four for 64 channels)
// each compute 64 pixels x 32 channels.  The K loop walks 32 input channels
// at a time through a 2-stage cp.async pipeline (16-byte copies): each
// stage holds the tile's (rows+2) x (W+2) input halo and the 9 taps'
// weights, so that chunk c+1 loads while chunk c multiplies.  At two stages
// (99 KB) two blocks of 128 channels share an SM (three of 64), and one
// block's barriers and epilogue overlap another's multiplies; a third
// stage, at one block an SM, was slower.  A tap (dy,dx) reads the halo
// shifted by dy*(W+2)+dx pixels: ldmatrix takes one row address a lane, so
// the shift costs nothing, and it yields the m16n8k32 A fragment directly.
// Halo pixels and weight rows are 32 B; the two 16-byte halves are swapped
// on every other group of 4 rows, so the 8 rows that one ldmatrix phase
// reads fall on distinct banks.  The epilogue is the affine and requantize
// above, staged through shared memory so that each thread stores 16
// contiguous bytes.  What bounds it: the tensor cores' issue rate through
// mma.sync, then the weight tile's L2 traffic (~45 KB per 9.4 MOP a block
// and chunk).  ptxas (chip_smoke.py's build line): 128 registers for 128
// channels (68 B of spill stores), 166 for 64, up to 98,816 B of dynamic
// shared memory at the largest halo.
// wgmma (m64nNk32, A from registers, B from shared memory through a
// no-swizzle K-major descriptor: LBO = 16*BN between the K halves, SBO =
// 128 between 8-channel groups) was bit-exact but no faster: ptxas
// serialises wgmmas whose A registers ldmatrix writes inside the pipeline
// (C7513), and A from shared memory needs a halo without the row gaps
// that the taps' shifts read across.  It is the next step (ROADMAP B2).
//
// Stem (Ci = 1): bound by the bytes it writes (64 per pixel).  A block
// walks tiles of as many whole rows (of up to 128 columns) as a 2 KB input
// halo holds (26 rows of 64 in Cnn10) and stages each tile's halo in shared
// memory once, so every input byte is read from device memory once; the
// next tile's halo is loaded into registers while this one computes, into
// the other of two buffers after it.  The 9 products of an output run on
// the int8 tensor cores (mma.sync m16n8k16, K = the 9 taps padded to 16:
// one MMA gives 16 pixels x 8 channels): a __dp4a version (3 integer-pipe
// instructions an output) stayed at twice the bound (PERF.md), and f32
// FMAs would take 9.  What is left an output is the epilogue,
// the body's (see code_bits; exact_float stands in for the conversion) in
// five FP32-pipe instructions, and the stores: each warp stages 16 pixels x 64
// channels in shared memory, so that each lane stores 16 contiguous bytes.
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

constexpr int THREADS = 256;               // pool and stem blocks

// ---------------------------------------------------------------- epilogue
__device__ __forceinline__ float affine(int acc, float a, float b) {
  return __fmaf_rn(__int2float_rn(acc), a, b);
}

// Modes 0 and 1: the int8 code of y in the low byte of the result, without
// the conversion unit.  clip(rint(y), lo, hi) == rint(clip(y, lo, hi)) for
// integer bounds, and for 0 <= v < 2^22 the sum v + 1.5*2^23 rounds v to
// the nearest integer, ties to even (as rintf), leaving it in the low
// mantissa bits; clip(rint(y) - 128, -128, 127) is that code for the bounds
// 0 and 255 with its top bit flipped.  A NaN clips to 0 (fmaxf), as in
// rintf-then-clip.
template <int MODE>
__device__ __forceinline__ uint32_t code_bits(float y) {
  const float v = fminf(fmaxf(y, 0.0f), MODE == 0 ? 127.0f : 255.0f);
  const uint32_t r = __float_as_uint(__fadd_rn(v, 12582912.0f));
  return MODE == 0 ? r : r ^ 0x80u;
}

// float(acc) from acc + 0x4B400000 (the bits of 1.5*2^23, where the stem's
// accumulators start), exact for |acc| < 2^22, without the conversion unit
constexpr int MAGIC = 0x4B400000;
__device__ __forceinline__ float exact_float(int acc_magic) {
  return __fsub_rn(__int_as_float(acc_magic), 12582912.0f);
}

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8_k16(int (&d)[4], const uint32_t (&a)[2],
                                           uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of the 16-byte half k of 32-byte row `row`, swizzled
__device__ __forceinline__ int swz(int row, int k) {
  return row * 32 + ((k ^ ((row >> 2) & 1)) << 4);
}

// ---------------------------------------------------------------- body
constexpr int BM = 128;                    // output pixels a block
constexpr int KC = 32;                     // input channels a stage
constexpr int STAGES = 2;

struct ConvGeom {
  int H, W, Ci, Co;
  int tw, rows;        // the pixel tile: rows x tw, rows * tw <= BM
  int hw2, hp;         // halo width tw + 2, halo pixels (rows + 2) * hw2
  int tiles_h, tiles_w, nco;
  int halo_bytes, stage_bytes;
};

template <int BN>
__device__ __forceinline__ void load_stage(
    uint8_t* s_halo, uint8_t* s_w, const int8_t* __restrict__ x,
    const int8_t* __restrict__ w, const ConvGeom& g, long long img, int h0,
    int w0, int co0, int kc0, int pad_word) {
  constexpr int NT = 2 * BN;
  for (int e = threadIdx.x; e < g.hp * 2; e += NT) {
    const int hp = e >> 1, k = e & 1;
    const int hr = hp / g.hw2, hc = hp - hr * g.hw2;
    const int hh = h0 - 1 + hr, ww = w0 - 1 + hc;
    uint8_t* dst = s_halo + swz(hp, k);
    if (hh >= 0 && hh < g.H && ww >= 0 && ww < g.W) {
      cp_async16(smem_u32(dst), x + (img + static_cast<long long>(hh) * g.W + ww) * g.Ci
                                    + kc0 + k * 16);
    } else {
      *reinterpret_cast<int4*>(dst) = make_int4(pad_word, pad_word, pad_word, pad_word);
    }
  }
  // row tap*BN + n holds channel co0+n's 32 bytes of tap `tap`; consecutive
  // threads read the two halves, then the next tap, of one channel
  for (int e = threadIdx.x; e < 9 * BN * 2; e += NT) {
    const int k = e & 1, tn = e >> 1;
    const int n = tn / 9, tap = tn - n * 9;
    cp_async16(smem_u32(s_w + swz(tap * BN + n, k)),
               w + (static_cast<long long>(co0 + n) * 9 + tap) * g.Ci + kc0 + k * 16);
  }
}

// grid: N * tiles_h * tiles_w * (Co / BN) blocks, the channel block fastest
// (neighbouring blocks share their halo in L2); 2*BN threads; two blocks an
// SM for 128 channels (128 registers), three for 64.
template <int MODE, int BN>
__global__ void __launch_bounds__(2 * BN, BN == 128 ? 2 : 3)
conv3x3_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ A, const float* __restrict__ B,
                  void* __restrict__ out, const ConvGeom g, int pad_word) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int NT = 2 * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;     // warp tile: 64 pixels x 32 channels
  long long t = blockIdx.x;
  const int co0 = static_cast<int>(t % g.nco) * BN;
  t /= g.nco;
  const int tw_i = static_cast<int>(t % g.tiles_w);
  t /= g.tiles_w;
  const int th_i = static_cast<int>(t % g.tiles_h);
  const long long n = t / g.tiles_h;
  const int h0 = th_i * g.rows, w0 = tw_i * g.tw;
  const long long img = n * g.H * g.W;

  // this lane's ldmatrix rows: A, the halo pixel of output pixel m at tap
  // (0,0) for each of the warp's four 16-pixel blocks; B, the channel
  int a_hp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = wm * 64 + i * 16 + (lane & 15);
    int r = m / g.tw, c = m - r * g.tw;
    if (r >= g.rows) r = c = 0;                // past the tile: not stored
    a_hp[i] = r * g.hw2 + c;
  }
  const int ka = lane >> 4, kb = (lane >> 3) & 1;
  int b_off[2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
    b_off[jj] = swz(wn * 32 + jj * 16 + (lane & 7) + ((lane >> 4) << 3), kb);

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int nchunks = g.Ci / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks)
      load_stage<BN>(smem + s * g.stage_bytes, smem + s * g.stage_bytes + g.halo_bytes,
                     x, w, g, img, h0, w0, co0, s * KC, pad_word);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk c is in; every warp is done with chunk c-1
    {
      const int cn = c + STAGES - 1;
      if (cn < nchunks) {
        uint8_t* st = smem + (cn % STAGES) * g.stage_bytes;
        load_stage<BN>(st, st + g.halo_bytes, x, w, g, img, h0, w0, co0, cn * KC,
                       pad_word);
      }
      cp_async_commit();
    }
    const uint8_t* st = smem + (c % STAGES) * g.stage_bytes;
    const uint32_t halo = smem_u32(st), wts = smem_u32(st + g.halo_bytes);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * g.hw2 + tap % 3;
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(halo + swz(a_hp[i] + shift, ka), a[i]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldsm_x4(wts + tap * BN * 32 + b_off[jj], r);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the stages are free: stage the outputs there

  constexpr int ES = MODE >= 2 ? 4 : 1;        // output element bytes
  constexpr int OS = BN * ES + 16;             // staged row stride
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + j * 8 + 2 * tq;
    const float a0 = __ldg(A + co0 + col), a1 = __ldg(A + co0 + col + 1);
    const float b0 = __ldg(B + co0 + col), b1 = __ldg(B + co0 + col + 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wm * 64 + i * 16 + gq + 8 * half;
        const float y0 = affine(acc[i][j][2 * half], a0, b0);
        const float y1 = affine(acc[i][j][2 * half + 1], a1, b1);
        uint8_t* dst = smem + m * OS + col * ES;
        if (MODE >= 2) {
          *reinterpret_cast<float2*>(dst) = MODE == 2
              ? make_float2(fmaxf(y0, 0.0f), fmaxf(y1, 0.0f)) : make_float2(y0, y1);
        } else {
          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(
              __byte_perm(code_bits<MODE>(y0), code_bits<MODE>(y1), 0x0040));
        }
      }
  }
  __syncthreads();
  constexpr int VEC = BN * ES / 16;            // 16-byte vectors a pixel
  const int npx = g.rows * g.tw;
  for (int e = tid; e < npx * VEC; e += NT) {
    const int p = e / VEC, q = e - p * VEC;
    const int r = p / g.tw, c = p - r * g.tw;
    const int hh = h0 + r, ww = w0 + c;
    if (hh >= g.H || ww >= g.W) continue;
    const int4 v = *reinterpret_cast<const int4*>(smem + p * OS + q * 16);
    uint8_t* dst = static_cast<uint8_t*>(out)
        + ((img + static_cast<long long>(hh) * g.W + ww) * g.Co + co0) * ES + q * 16;
    *reinterpret_cast<int4*>(dst) = v;
  }
}

// ---------------------------------------------------------------- stem
constexpr int STEM_MAX_CO = 512;
constexpr int STEM_HALO = 2048;            // halo bytes a tile, at most
constexpr int STEM_LOADS = STEM_HALO / THREADS;
constexpr int STEM_MAX_PX = 1792;          // pixels a tile, at most

struct StemGeom {
  int H, W, Co, tw, rows, hs, tiles_h, tiles_w;
  long long tiles;
};

// Ci == 1, on the int8 tensor cores: mma.sync m16n8k16 with K = 4*dy + dx
// (the 9 taps, each row of 3 padded to 4, and K 12..15 zero), so that one
// MMA gives 16 pixels x 8 channels.  A pixel's A row for dy is the word of
// its 3-byte window in halo row r+dy (the fourth byte meets a zero weight);
// the accumulators start at MAGIC, so that exact_float reads them.  A
// persistent grid walks the tiles; each warp takes 16 pixels of a tile at a
// time, and each 64 channels of them it stages through shared memory so
// that each lane stores 16 contiguous bytes.  The next tile's halo bytes
// are loaded into registers while this tile computes, and stored into the
// other of two halo buffers after it.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
conv3x3_c1_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ A, const float* __restrict__ B,
                  void* __restrict__ out, const StemGeom g, int pad) {
  constexpr int ES = MODE >= 2 ? 4 : 1;        // output element bytes
  constexpr int RS = 64 * ES + 16;             // staged row: 64 channels
  constexpr int VEC = 64 * ES / 16;            // 16-byte vectors a staged row
  __shared__ __align__(16) uint8_t s_in[2][STEM_HALO];
  __shared__ uint32_t s_w[STEM_MAX_CO * 3];    // [co][dy]: 3 taps, a zero byte
  __shared__ __align__(16) uint8_t s_out[THREADS / 32][16 * RS];
  __shared__ uint16_t s_rc[STEM_MAX_PX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  for (int e = threadIdx.x; e < g.Co * 3; e += THREADS) {
    const int8_t* p = w + 3 * e;               // channel e / 3, row e % 3
    s_w[e] = static_cast<uint32_t>(static_cast<uint8_t>(p[0]))
             | static_cast<uint32_t>(static_cast<uint8_t>(p[1])) << 8
             | static_cast<uint32_t>(static_cast<uint8_t>(p[2])) << 16;
  }
  const int halo = (g.rows + 2) * g.hs, npx = g.rows * g.tw, n16 = (npx + 15) >> 4;
  // tile pixel m -> (row << 7 | column), the same in every tile
  for (int m = threadIdx.x; m < npx; m += THREADS)
    s_rc[m] = static_cast<uint16_t>((m / g.tw) << 7 | (m % g.tw));
  // this thread's halo bytes e = tid + 256*k of `tile`, into v
  auto fetch = [&](long long tile, uint8_t (&v)[STEM_LOADS]) {
    const int tw_i = static_cast<int>(tile % g.tiles_w);
    tile /= g.tiles_w;
    const int h0 = static_cast<int>(tile % g.tiles_h) * g.rows, w0 = tw_i * g.tw;
    const long long img = (tile / g.tiles_h) * g.H * g.W;
#pragma unroll
    for (int k = 0; k < STEM_LOADS; ++k) {
      const int e = threadIdx.x + k * THREADS;
      const int hr = e / g.hs, hc = e - hr * g.hs;
      const int hh = h0 - 1 + hr, ww = w0 - 1 + hc;
      v[k] = (e < halo && hh >= 0 && hh < g.H && ww >= 0 && ww < g.W && hc < g.tw + 2)
                 ? static_cast<uint8_t>(x[img + static_cast<long long>(hh) * g.W + ww])
                 : static_cast<uint8_t>(pad);
    }
  };
  auto stash = [&](uint8_t* buf, const uint8_t (&v)[STEM_LOADS]) {
#pragma unroll
    for (int k = 0; k < STEM_LOADS; ++k) {
      const int e = threadIdx.x + k * THREADS;
      if (e < halo) buf[e] = v[k];
    }
  };
  uint8_t nxt[STEM_LOADS];
  if (blockIdx.x < g.tiles) {
    fetch(blockIdx.x, nxt);
    stash(s_in[0], nxt);
  }
  __syncthreads();
  uint8_t* so = s_out[warp];
  const int dy = tq < 3 ? tq : 2;              // lanes tq = 3 meet zero weights
  int cur = 0;
  for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, cur ^= 1) {
    const bool more = tile + gridDim.x < g.tiles;
    if (more) fetch(tile + gridDim.x, nxt);
    long long t = tile;
    const int tw_i = static_cast<int>(t % g.tiles_w);
    t /= g.tiles_w;
    const int th_i = static_cast<int>(t % g.tiles_h);
    const long long img = (t / g.tiles_h) * g.H * g.W;
    const int h0 = th_i * g.rows, w0 = tw_i * g.tw;
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s_in[cur]);
    for (int n0 = 0; n0 < g.Co; n0 += 64) {
      // this lane's channels n0 + 8j + 2tq, +1: weights and affine
      uint32_t wb[8];
      float av[8][2], bv[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wb[j] = tq < 3 ? s_w[(n0 + 8 * j + gq) * 3 + tq] : 0u;
        const int ch = n0 + 8 * j + 2 * tq;
        av[j][0] = __ldg(A + ch);
        av[j][1] = __ldg(A + ch + 1);
        bv[j][0] = __ldg(B + ch);
        bv[j][1] = __ldg(B + ch + 1);
      }
      for (int mt = warp; mt < n16; mt += THREADS / 32) {
        uint32_t a[2];                         // pixels mt*16 + gq, + 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + gq + 8 * h;
          const int rc = s_rc[m < npx ? m : 0];  // past the tile: not stored
          const int base = ((rc >> 7) + dy) * g.hs + (rc & 127), s = base & 3;
          a[h] = __byte_perm(s32[base >> 2], s32[(base >> 2) + 1],
                             s | (s + 1) << 4 | (s + 2) << 8);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          int d[4] = {MAGIC, MAGIC, MAGIC, MAGIC};
          mma_s8_k16(d, a, wb[j]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float y0 = __fmaf_rn(exact_float(d[2 * h]), av[j][0], bv[j][0]);
            const float y1 = __fmaf_rn(exact_float(d[2 * h + 1]), av[j][1], bv[j][1]);
            uint8_t* dst = so + (gq + 8 * h) * RS + (8 * j + 2 * tq) * ES;
            if (MODE >= 2) {
              *reinterpret_cast<float2*>(dst) = MODE == 2
                  ? make_float2(fmaxf(y0, 0.0f), fmaxf(y1, 0.0f)) : make_float2(y0, y1);
            } else {
              *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(
                  __byte_perm(code_bits<MODE>(y0), code_bits<MODE>(y1), 0x0040));
            }
          }
        }
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 16 * VEC; e += 32) {
          const int row = e / VEC, q = e - row * VEC;
          const int m = mt * 16 + row;
          const int rc = s_rc[m < npx ? m : 0];
          const int hh = h0 + (rc >> 7), ww = w0 + (rc & 127);
          if (m >= npx || hh >= g.H || ww >= g.W) continue;
          *reinterpret_cast<int4*>(static_cast<uint8_t*>(out)
              + ((img + static_cast<long long>(hh) * g.W + ww) * g.Co + n0) * ES + q * 16) =
              *reinterpret_cast<const int4*>(so + row * RS + q * 16);
        }
        __syncwarp();
      }
    }
    if (more) stash(s_in[cur ^ 1], nxt);
    __syncthreads();   // the next halo is in; every thread is done with this one
  }
}

// ---------------------------------------------------------------- pool
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

// ---------------------------------------------------------------- host
int sm_count() {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

int grid_for(long long total) {
  const long long blocks = (total + THREADS - 1) / THREADS;
  const long long max_blocks = static_cast<long long>(sm_count()) * 8;
  return static_cast<int>(blocks < max_blocks ? blocks : max_blocks);
}

ConvGeom body_geom(long long N, int H, int W, int Ci, int Co, int bn) {
  ConvGeom g;
  g.H = H; g.W = W; g.Ci = Ci; g.Co = Co;
  g.tw = W < BM ? W : BM;
  g.rows = BM / g.tw < H ? BM / g.tw : H;
  g.hw2 = g.tw + 2;
  g.hp = (g.rows + 2) * g.hw2;
  g.tiles_h = (H + g.rows - 1) / g.rows;
  g.tiles_w = (W + g.tw - 1) / g.tw;
  g.nco = Co / bn;
  g.halo_bytes = (g.hp * 32 + 127) / 128 * 128;
  g.stage_bytes = g.halo_bytes + 9 * bn * 32;
  return g;
}

template <int MODE, int BN>
cudaError_t launch_body(const int8_t* x, const int8_t* w, const float* A, const float* B,
                        void* out, long long N, int H, int W, int Ci, int Co, int pad,
                        cudaStream_t stream) {
  const ConvGeom g = body_geom(N, H, W, Ci, Co, BN);
  const int staged = BM * (BN * (MODE >= 2 ? 4 : 1) + 16);
  const int smem = STAGES * g.stage_bytes > staged ? STAGES * g.stage_bytes : staged;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_i8_kernel<MODE, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const uint32_t pb = static_cast<uint32_t>(pad) & 0xFFu;
  const long long blocks = N * g.tiles_h * g.tiles_w * g.nco;
  conv3x3_i8_kernel<MODE, BN><<<static_cast<unsigned>(blocks), 2 * BN, smem, stream>>>(
      x, w, A, B, out, g, static_cast<int>(pb * 0x01010101u));
  return cudaGetLastError();
}

StemGeom stem_geom(long long N, int H, int W, int Co) {
  StemGeom g;
  g.H = H; g.W = W; g.Co = Co;
  g.tw = W < 128 ? W : 128;
  // a row's bytes, rounded up to words, and one word more: the window at
  // the last column reads the word after it; as many rows as fit
  g.hs = ((g.tw + 2 + 3) & ~3) + 4;
  int rows = STEM_HALO / g.hs - 2;
  rows = rows < STEM_MAX_PX / g.tw ? rows : STEM_MAX_PX / g.tw;
  g.rows = rows < H ? rows : H;
  g.tiles_h = (H + g.rows - 1) / g.rows;
  g.tiles_w = (W + g.tw - 1) / g.tw;
  g.tiles = N * g.tiles_h * g.tiles_w;
  return g;
}

template <int MODE>
cudaError_t launch_stem(const int8_t* x, const int8_t* w, const float* A, const float* B,
                        void* out, long long N, int H, int W, int Co, int pad,
                        cudaStream_t stream) {
  const StemGeom g = stem_geom(N, H, W, Co);
  const long long max_blocks = static_cast<long long>(sm_count()) * 8;
  const int blocks = static_cast<int>(g.tiles < max_blocks ? g.tiles : max_blocks);
  conv3x3_c1_kernel<MODE><<<blocks, THREADS, 0, stream>>>(x, w, A, B, out, g, pad);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_conv(const int8_t* x, const int8_t* w, const float* A, const float* B,
                        void* out, long long N, int H, int W, int Ci, int Co, int pad,
                        cudaStream_t stream) {
  if (Ci == 1) return launch_stem<MODE>(x, w, A, B, out, N, H, W, Co, pad, stream);
  if (Co % 128 == 0)
    return launch_body<MODE, 128>(x, w, A, B, out, N, H, W, Ci, Co, pad, stream);
  return launch_body<MODE, 64>(x, w, A, B, out, N, H, W, Ci, Co, pad, stream);
}

}  // namespace

// Launch on `stream`; returns the CUDA error of the launch, or
// cudaErrorInvalidValue for a shape or mode the kernels do not take (the
// wrapper checks first).
extern "C" int conv3x3_i8_launch(const void* x, const void* w, const void* A,
                                 const void* B, void* out, long long N, int H,
                                 int W, int Ci, int Co, int mode, int pad_code,
                                 void* stream) {
  if (N * H * W == 0) return 0;
  const bool ci_ok = Ci == 1 ? Co <= STEM_MAX_CO : Ci % 64 == 0;
  if (!ci_ok || Co % 64 != 0 || Co <= 0 || mode < 0 || mode > 3 ||
      pad_code < -128 || pad_code > 127)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Ci != 1) {
    const ConvGeom g = body_geom(N, H, W, Ci, Co, Co % 128 == 0 ? 128 : 64);
    if (N * g.tiles_h * g.tiles_w * g.nco >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case 0: err = launch_conv<0>(xi, wi, Af, Bf, out, N, H, W, Ci, Co, pad_code, s); break;
    case 1: err = launch_conv<1>(xi, wi, Af, Bf, out, N, H, W, Ci, Co, pad_code, s); break;
    case 2: err = launch_conv<2>(xi, wi, Af, Bf, out, N, H, W, Ci, Co, pad_code, s); break;
    default: err = launch_conv<3>(xi, wi, Af, Bf, out, N, H, W, Ci, Co, pad_code, s); break;
  }
  return static_cast<int>(err);
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
