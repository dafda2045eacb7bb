// The int8 serving encoder's stem, conv and pool for Hopper (sm_90a).
//
// Replaces acvae_tpu/models/quant.py QuantPannEncoder._quant_stem (:246)
// with the stem's _conv after it, _conv (:424) with the f32 affine and
// _requantize (:439) after it, and _avgpool_i8 (:86).  These have no Pallas
// counterpart: on the TPU, XLA builds them from lax.conv_general_dilated(...,
// preferred_element_type=int32) plus an elementwise epilogue fused into one
// s8-producing fusion.
//
// stem_conv3x3_i8: the same conv at Ci = 1 of the codes
// clip(rint(fma(feats, c1[f], c2[f])), -127, 127) of the f32 log-mel feats
// [N,T,F] (c1, c2 [F]: bn0's affine over the stem's scale), which it
// computes as it reads the mel; the border reads code 0.
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
// and the bytes of x, w and out at 3.35 TB/s: 0.68 ms for the fused stem
// (bytes: the f32 mel read, 64 channels written), 1.28 ms for block 1's
// 64->64 (bytes), 0.63 / 1.25 ms for each later block's two convs
// (operations); 7.6 ms for the 8.
//
// Body (Ci a multiple of 64): an implicit GEMM on wgmma, Hopper's
// warpgroup MMA (m64nNk32 .s32.s8.s8, SASS IGMMA), with both operands read
// from shared memory through descriptors.  M = N*H*W output pixels
// flattened over the whole batch (a tile may span images, so narrow maps
// fill every row: Cnn14's 32x2 maps run as dense as Cnn10's 1024x64), N =
// Co, K = 9*Ci ordered (tap, ci), so that an OHWI weight row is one output
// channel's K bytes.  A tile is 128 pixels x BN channels (BN = 256 where Co
// allows, else 128 or 64), a warpgroup 64 pixels of it.
//   Loads: TMA under mbarriers, one producer thread (warp 8) keeping a
// ring of 3-24 stages in flight; a stage is one tap's K chunk of 128 (64
// where Ci is not a multiple of 128) channels: the tile's pixels as an
// im2col box (the traversal runs across W, H and N; outside an image it
// reads 0) and their weight tile, both with the TMA swizzle that the
// descriptors name (128 or 64 bytes).  The grid is persistent, one block an
// SM; a block keeps one channel block and walks pixel tiles, so the next
// tile's loads run during a tile's epilogue.
//   HALO (K chunks of 64, BN <= 128, where a 256-pixel tile is whole rows
// of one image and W % 8 == 0: Cnn10's 64-channel convs): the block's
// weights are loaded once and stay in shared memory, and a stage is a tiled
// box of the tile's rows plus one above and below, shifted by dx - 1, so
// that tap (dy, dx) is the same box from row dy*W on.  A tile then takes 3
// boxes of 256 + 2W rows instead of 18 of 128.
//   The offset coding's pad (-128) where TMA reads 0: a border pixel adds
// pad * the sum of its outside taps' weights, from a table of the 16 border
// classes x BN channels built in the prologue (no launch, exact in int32).
//   Epilogue: the affine and requantize above, staged through shared memory
// (f32 rows of 256 channels in two halves) so that each thread stores 16
// contiguous bytes.
//   What bounds it: the TMA's rate of box rows, ~1 row of 64 or 128 bytes
// per ~3.6 cycles an SM whatever its length (at the 128-byte rows of the
// K chunks of 128 that is ~8 TB/s of L2 reads), so the tiles and the halo
// are sized to load fewer rows per MAC; then the tensor cores (the convs of
// 512 channels and more run at 80-85% of 1,979 TOP/s).  ptxas
// (chip_smoke.py's build line): 88-168 registers, no spill, up to 232,448
// bytes of dynamic shared memory.  An earlier wgmma with A in registers
// was serialised by ptxas (C7513); A from shared memory is not.  The host
// encodes the two tensor maps at each launch with the driver's
// cuTensorMapEncodeIm2col / cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPointByVersion, so the library links cudart alone.
//
// Stem (Ci = 1; the fused stem and conv3x3_i8's Ci = 1): bound by the
// bytes it writes (64 per pixel), but held back by its instructions an
// output (on an H100 a plain fill_ of its output runs at 3.27 TB/s:
// PERF.md).  A block walks
// tiles of as many whole rows (of up to 128 columns) as a 4 KB halo of
// codes holds (54 rows of 64) and stages each tile's halo in shared memory
// once, so every input element is read from device memory once; the fused
// stem's f32 rows arrive by TMA while the previous tile computes and are
// quantized into codes in the halo.  The 9 products of an output run on
// the int8 tensor cores (mma.sync m16n8k16, K = the 9 taps padded to 16:
// one MMA gives 16 pixels x 8 channels): a __dp4a version (3 integer-pipe
// instructions an output) stayed at twice the bound (PERF.md), and f32
// FMAs would take 9.  What is left an output is the epilogue (exact_float,
// fma.sat, the magic add, an integer min: sat_bits), 3/4 of a byte permute
// to pack 4 codes a word, and no staging: each lane ends with 16 contiguous
// channels of a pixel and stores them as one 16-byte vector.
//
// avgpool2x2_i8: x [N,H,W,C] int8 -> [N,H/2,W/2,C]: the int32 sum of the
// 2x2 window, then (s+2)>>2 (arithmetic shift); odd trailing rows and
// columns dropped.  Bound: bytes (input read once, output written once),
// 0.80 + 0.40 + 0.20 = 1.4 ms for blocks 1-3 of a batch.  One thread per 16
// channels of an output pixel: four 16-byte loads, one 16-byte store.
//
// Offsets into the activations are 64-bit (the tensor maps' strides, the
// stores' offsets): block 1's tensors at batch 512 hold exactly 2^31
// elements.

#include <cuda.h>            // CUtensorMap and its enums (no libcuda link)
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

// The stem's modes 0 and 1 with fewer instructions (it is bound by them):
// z = fma.sat(float(acc), A/256, B/256) is clip(y/256, 0, 1) for y =
// fma(float(acc), A, B) (scaling by a power of 2 commutes with the one
// rounding; below 2^-118 the code is 0 either way), z*256 + 1.5*2^23 is
// 1.5*2^23 + rint(clip(y, 0, 256)) (z*256 is exact), and one integer min
// brings the top to 127 or 255.  The offset coding adds 1.5*2^23 - 128
// instead, so that the low byte is already k - 128 = k ^ 0x80.  A NaN
// saturates to 0, as fmaxf gives.
__device__ __forceinline__ float fma_sat(float a, float b, float c) {
  float d;
  asm("fma.rn.sat.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}
template <int MODE>
__device__ __forceinline__ uint32_t sat_bits(float z) {
  constexpr float M = MODE == 0 ? 12582912.0f : 12582784.0f;
  constexpr int TOP = MODE == 0 ? MAGIC + 127 : MAGIC - 128 + 255;
  return static_cast<uint32_t>(min(__float_as_int(__fmaf_rn(z, 256.0f, M)), TOP));
}

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_s8_k16(int (&d)[4], const uint32_t (&a)[2],
                                           uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// that never ends is a fault of the pipeline's protocol: trap (a launch
// error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// TMA, im2col mode: the tile's BM pixels of one tap, KC channels each,
// from the pixel traversal that starts at (n, h, w) (the tap (0,0) input
// of the tile's first output pixel) with the tap's offsets (dx, dy)
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int c, int w, int h, int n,
                                           uint16_t dx, uint16_t dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(dx), "h"(dy)
      : "memory");
}

// TMA, tiled mode: the box at (c, w, h, n) of a 4-D map
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c, int w, int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n)
      : "memory");
}

// TMA, tiled mode: the box at (x, y, z) of a 3-D map
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// TMA, tiled mode: the box at (x, y) of a 2-D map
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma descriptor of a K-major tile whose rows are KC bytes (64 or 128),
// stored as TMA writes them with the swizzle of that width: 8-row groups
// 8*KC bytes apart (SBO), the layout's swizzle in bits 62-63.  Stepping K
// by 32 bytes adds 2 to the start address field.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, int kc) {
  const uint64_t layout = kc == 128 ? 1 : 2;   // 128B or 64B swizzle
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((8 * kc) >> 4) << 32 | layout << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmmas
template <int R>
__device__ __forceinline__ void acc_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x N] += A[64 x 32] * B[N x 32]^T, s8 x s8 -> s32, both from shared
// memory (SASS IGMMA)
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]),
        "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]),
        "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
        "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_n256(d, da, db);
  else if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n64(d, da, db);
}

// ---------------------------------------------------------------- body
constexpr int BM = 128;                    // output pixels a tile
constexpr int BODY_THREADS = 384;          // 2 consumer warpgroups, 1 producer
constexpr int MAX_STAGES = 24;

struct BodyGeom {
  int M, H, W, Ci, Co;   // M = N*H*W output pixels (< 2^31)
  int m_tiles, nco;      // pixel tiles, channel blocks
  int per_co;            // blocks a channel block: grid = per_co * nco
  int stages, sbytes;    // ring stages, bytes a stage
  int wres;              // bytes of the resident weights (HALO)
  int mode, pad;
  int ostride;           // bytes a staged output row
};

// the sum of the four signed bytes of v (no IDP4A)
__device__ __forceinline__ int byte_sum(uint32_t v) {
  const uint32_t s = (v & 0x00FF00FFu) + ((v >> 8) & 0x00FF00FFu);
  return static_cast<int>((s & 0xFFFFu) + (s >> 16)) - 256 * __popc(v & 0x80808080u);
}

// The affine and requantize of one warpgroup's 64 pixels x the columns
// 8*J0 .. 8*(J0+NJ) of its accumulators into its staging rows (acc[4j + 2h
// + c] is row 16*wq + lane/4 + 8h, column 8j + 2*(lane%4) + c: the wgmma
// accumulator layout), then 16-byte stores of the staged rows.
template <int MODE, int BN, int J0 = 0, int NJ = BN / 8>
__device__ __forceinline__ void epilogue(const int (&acc)[BN / 2], uint8_t* stg,
                                         const float* sA, const float* sB, void* out, int M,
                                         int Co, int ostride, int pbase, int co0, int wg,
                                         int wq, int lane) {
  constexpr int ES = MODE >= 2 ? 4 : 1, VEC = NJ * 8 * ES / 16;
#pragma unroll
  for (int j = J0; j < J0 + NJ; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float a0 = sA[col], a1 = sA[col + 1], b0 = sB[col], b1 = sB[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float y0 = affine(acc[4 * j + 2 * h], a0, b0);
      const float y1 = affine(acc[4 * j + 2 * h + 1], a1, b1);
      uint8_t* dst = stg + (16 * wq + (lane >> 2) + 8 * h) * ostride + (col - 8 * J0) * ES;
      if (MODE >= 2) {
        *reinterpret_cast<float2*>(dst) = MODE == 2
            ? make_float2(fmaxf(y0, 0.0f), fmaxf(y1, 0.0f)) : make_float2(y0, y1);
      } else {
        *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(
            __byte_perm(code_bits<MODE>(y0), code_bits<MODE>(y1), 0x0040));
      }
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  for (int e = lane + 32 * wq; e < 64 * VEC; e += 128) {
    const int row = e / VEC, q = e - row * VEC;
    const int p = pbase + row;
    if (p >= M) continue;
    *reinterpret_cast<int4*>(static_cast<uint8_t*>(out)
        + (static_cast<long long>(p) * Co + co0 + 8 * J0) * ES + q * 16) =
        *reinterpret_cast<const int4*>(stg + row * ostride + q * 16);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");   // staging free again
}

// The border class of pixel p: bit 0 top row, 1 bottom row, 2 left
// column, 3 right column (0 inside the image).
__device__ __forceinline__ int border_class(int p, int H, int W) {
  const int hw = H * W, rem = p % hw, h = rem / W, w = rem - h * W;
  return (h == 0) | (h == H - 1) << 1 | (w == 0) << 2 | (w == W - 1) << 3;
}

// The pad's correction, then the epilogue, of one warpgroup's 64 pixels
// from pbase on.
template <int BN>
__device__ __forceinline__ void finish(int (&acc)[BN / 2], uint8_t* stg, const float* sA,
                                       const float* sB, const int* sC, void* out,
                                       const BodyGeom& g, int pbase, int co0, int wg,
                                       int wq, int lane) {
  if (g.pad != 0) {   // the offset coding's pad, on border pixels
    const int* c2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pbase + 16 * wq + (lane >> 2) + 8 * h;
      c2[h] = sC + (p < g.M ? border_class(p, g.H, g.W) : 0) * BN;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int2 c = *reinterpret_cast<const int2*>(c2[h] + col);
        acc[4 * j + 2 * h] += c.x;
        acc[4 * j + 2 * h + 1] += c.y;
      }
    }
  }
  constexpr int H8 = BN == 256 ? 16 : BN / 8;
  const int M = g.M, Co = g.Co, os = g.ostride;
  switch (g.mode) {
    case 0: epilogue<0, BN>(acc, stg, sA, sB, out, M, Co, os, pbase, co0, wg, wq, lane); break;
    case 1: epilogue<1, BN>(acc, stg, sA, sB, out, M, Co, os, pbase, co0, wg, wq, lane); break;
    // f32 rows of 256 channels go through the staging rows in halves
    case 2:
      epilogue<2, BN, 0, H8>(acc, stg, sA, sB, out, M, Co, os, pbase, co0, wg, wq, lane);
      if constexpr (BN == 256)
        epilogue<2, BN, H8, H8>(acc, stg, sA, sB, out, M, Co, os, pbase, co0, wg, wq, lane);
      break;
    default:
      epilogue<3, BN, 0, H8>(acc, stg, sA, sB, out, M, Co, os, pbase, co0, wg, wq, lane);
      if constexpr (BN == 256)
        epilogue<3, BN, H8, H8>(acc, stg, sA, sB, out, M, Co, os, pbase, co0, wg, wq, lane);
      break;
  }
}


// grid: per_co * nco blocks of 384 threads, one an SM; block b owns output
// channels co0 = (b % nco) * BN and walks the pixel tiles b / nco, + per_co,
// ...  Warps 0-7 (two warpgroups) multiply and store, each half of a tile's
// pixels; warp 8 loads.  A tile is 128 pixels, and a stage of the ring
// holds a tap's K chunk of them (an im2col box) and of the BN channels'
// weights.  HALO: a tile is 256 pixels of whole image rows (two m64 blocks
// a warpgroup), the block's weights (all 9*Ci of its BN channels) are
// loaded once and stay in shared memory, and a stage holds the rows above
// to below the tile, shifted by one dx (a tiled box with zeros outside the
// image): tap (dy, dx) reads it from row dy*W on, so a tile takes 3 loads a
// K chunk instead of 18.
template <int BN, int KC, bool HALO>
__global__ void __launch_bounds__(BODY_THREADS, 1)
conv3x3_i8_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, const int8_t* __restrict__ w,
                  const float* __restrict__ A, const float* __restrict__ B,
                  void* __restrict__ out, const BodyGeom g) {
  constexpr int A_BYTES = BM * KC;
  constexpr int MB = HALO ? 2 : 1, TM = MB * BM;   // m64 blocks a warpgroup, tile pixels
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the tiles must sit on the swizzle's 1024-byte atoms
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t wres = smem_u32(smem);
  uint8_t* staging = smem + g.wres + g.stages * g.sbytes;
  float* sA = reinterpret_cast<float*>(staging + 2 * 64 * g.ostride);
  float* sB = sA + BN;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sB + BN);   // full, empty, weights
  int* sC = reinterpret_cast<int*>(bars + 2 * MAX_STAGES + 1);  // with a pad only
  const uint32_t ring = wres + g.wres, full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8 * MAX_STAGES, wbar = empty0 + 8 * MAX_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int co0 = static_cast<int>(blockIdx.x % g.nco) * BN;
  const int m_first = static_cast<int>(blockIdx.x / g.nco);

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);          // lane 0 of each consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += BODY_THREADS) {
    sA[i] = __ldg(A + co0 + i);
    sB[i] = __ldg(B + co0 + i);
  }
  if (g.pad != 0) {
    // TMA fills the border with 0, so a pixel of border class c adds
    // sC[c][n] = pad * sum over its outside taps of sum_ci w[co0+n, tap, ci]
    for (int n = tid; n < BN; n += BODY_THREADS) {
      const int4* p = reinterpret_cast<const int4*>(
          w + static_cast<long long>(co0 + n) * 9 * g.Ci);
      int ws[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        int s = 0;
        for (int k = 0; k < g.Ci / 16; ++k) {
          const int4 v = __ldg(p + tap * (g.Ci / 16) + k);
          s += byte_sum(v.x) + byte_sum(v.y) + byte_sum(v.z) + byte_sum(v.w);
        }
        ws[tap] = s;
      }
      for (int c = 0; c < 16; ++c) {
        int s = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          if ((dy == 0 && (c & 1)) || (dy == 2 && (c & 2)) || (dx == 0 && (c & 4))
              || (dx == 2 && (c & 8)))
            s += ws[tap];
        }
        sC[c * BN + n] = g.pad * s;
      }
    }
  }
  __syncthreads();

  const int kchunks = g.Ci / KC, kiters = (HALO ? 3 : 9) * kchunks;
  if (warp >= 8) {
    // ------------------------------------------------ producer: one thread
    if (warp == 8 && lane == 0) {
      const int hw = g.H * g.W;
      int stage = 0;
      uint32_t phase = 0;
      if (HALO) {   // the weights, once: chunk (tap, kc) at (tap*kchunks + kc)*BN*KC
        mbar_expect_tx(wbar, 9 * g.Ci * BN);
        for (int i = 0; i < 9 * kchunks; ++i)
          tma_2d(wres + i * BN * KC, &tw, wbar, i * KC, co0);
      }
      for (int m = m_first; m < g.m_tiles; m += g.per_co) {
        const int p0 = m * TM, n = p0 / hw, rem = p0 - n * hw;
        const int h0 = rem / g.W, w0 = rem - h0 * g.W;
        // stage it: HALO (dx, kc), a halo box; else (tap, kc), an im2col
        // box and its weight tile
        for (int it = 0; it < kiters; ++it) {
          const uint32_t full = full0 + 8 * stage, st = ring + stage * g.sbytes;
          const int t = it / kchunks, kc = it - t * kchunks;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, g.sbytes);
          if (HALO) {
            tma_4d(st, &tx, full, kc * KC, t - 1, h0 - 1, n);
          } else {
            tma_im2col(st, &tx, full, kc * KC, w0 - 1, h0 - 1, n,
                       static_cast<uint16_t>(t % 3), static_cast<uint16_t>(t / 3));
            tma_2d(st + A_BYTES, &tw, full, t * g.Ci + kc * KC, co0);
          }
          if (++stage == g.stages) { stage = 0; phase ^= 1; }
        }
      }
      // stay until the consumers have released every stage
      for (int s = 0; s < g.stages; ++s) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (++stage == g.stages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ------------------------------------------------ consumers
    const int wg = warp >> 2, wq = warp & 3;
    uint8_t* stg = staging + wg * 64 * g.ostride;
    int stage = 0;
    uint32_t phase = 0;
    if (HALO) mbar_wait(wbar, 0);
    for (int m = m_first; m < g.m_tiles; m += g.per_co) {
      int acc[MB][BN / 2];
#pragma unroll
      for (int b = 0; b < MB; ++b) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0;
        acc_fence(acc[b]);
      }
      int prev = 0;
      for (int it = 0; it < kiters; ++it) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t st = ring + stage * g.sbytes;
        wgmma_fence();
        if (HALO) {   // stage it = (dx, kc): the taps (0..2, dx)
          const int dx = it / kchunks, kc = it - dx * kchunks;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const uint64_t db = gmma_desc(wres + ((dy * 3 + dx) * kchunks + kc) * BN * KC, KC);
#pragma unroll
            for (int b = 0; b < MB; ++b) {
              const uint64_t da = gmma_desc(st + (dy * g.W + (wg * MB + b) * 64) * KC, KC);
#pragma unroll
              for (int kk = 0; kk < KC / 32; ++kk)
                wgmma_s8<BN>(acc[b], da + 2 * kk, db + 2 * kk);
            }
          }
        } else {
          const uint64_t da = gmma_desc(st + wg * 64 * KC, KC);
          const uint64_t db = gmma_desc(st + A_BYTES, KC);
#pragma unroll
          for (int kk = 0; kk < KC / 32; ++kk) wgmma_s8<BN>(acc[0], da + 2 * kk, db + 2 * kk);
        }
        wgmma_commit();
        wgmma_wait<1>();                     // the previous stage's wgmmas are done
        if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == g.stages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < MB; ++b) acc_fence(acc[b]);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // epilogue: affine and requantize into the staging rows, then
      // 16-byte stores of whole rows
#pragma unroll
      for (int b = 0; b < MB; ++b)
        finish<BN>(acc[b], stg, sA, sB, sC, out, g, m * TM + (wg * MB + b) * 64, co0, wg,
                   wq, lane);
    }
  }
}

// ---------------------------------------------------------------- stem
constexpr int STEM_MAX_CO = 512;
constexpr int STEM_HALO = 4096;            // halo codes a tile (bytes), at most
constexpr int STEM_LOADS = STEM_HALO / THREADS;   // halo elements a thread (no TMA)
constexpr int STEM_MAX_PX = 3584;          // pixels a tile, at most
constexpr int STEM_OFF = 4;                // the byte of a halo row at tile column 0

struct StemGeom {
  int H, W, Co, tw, rows, hs, tiles_h, tiles_w;
  long long tiles;
};

// The stem's input code of one element: an int8 code as it is, or a log-mel
// value through bn0's affine and the stem scale, c1*x + c2 rounded once (as
// XLA fuses it), then clip(rint(.), -127, 127) (half to even, as jnp.round).
__device__ __forceinline__ uint32_t stem_code(int8_t x, const float*, const float*, int) {
  return static_cast<uint8_t>(x);
}
__device__ __forceinline__ uint32_t stem_code(float x, const float* c1, const float* c2,
                                              int f) {
  const int q = __float2int_rn(__fmaf_rn(x, __ldg(c1 + f), __ldg(c2 + f)));
  return static_cast<uint8_t>(max(-127, min(127, q)));
}

// Ci == 1, on the int8 tensor cores: mma.sync m16n8k16 with K = 4*dy + dx
// (the 9 taps, each row of 3 padded to 4, and K 12..15 zero), so that one
// MMA gives 16 pixels x 8 channels.  A pixel's A row for dy is the word of
// its 3-byte window in halo row r+dy (the fourth byte meets a zero weight);
// the accumulators start at MAGIC, so that exact_float reads them.  MMA j's
// column n is channel 16*(n/2) + 2j + n%2 of a block of 64, so that a lane
// ends with 16 contiguous channels of each of its two pixels and stores
// each as one 16-byte vector (a warp: 512 contiguous bytes at Co = 64, the
// stem's), with no staging; the codes' epilogue is sat_bits.  A persistent
// grid walks tiles of whole rows (of up to 128 columns, a 4 KB halo of
// codes: 54 rows of 64); the halo of codes is double-buffered, and the
// next tile's input is on its way while this one computes.
//   TIn float (the fused stem): x is the log-mel [N, H, W] (W the mel
// bins).  TMA (W % 4 == 0, 16-byte aligned): one thread loads the next
// tile's rows as a 3-D box of f32 (columns w0 - 4 .. w0 + tw + 3, zero
// outside) into s_f32 under an mbarrier; after this tile every thread turns
// it into codes, 4 columns at a time.  Otherwise each thread loads its
// elements into registers.  Each element becomes stem_code with its bin's
// c1, c2; outside the image the halo holds code 0 (the SAME padding of the
// codes, not the code of a zero mel).  With `codes`, each tile also writes
// its own pixels' codes (never its halo rows), so each once.  TIn int8: x
// is the codes [N, H, W, 1] and the border reads `pad`.
template <int MODE, typename TIn, bool TMA>
__global__ void __launch_bounds__(THREADS)
conv3x3_c1_kernel(const TIn* __restrict__ x, const float* __restrict__ c1,
                  const float* __restrict__ c2, const int8_t* __restrict__ w,
                  const float* __restrict__ A, const float* __restrict__ B,
                  void* __restrict__ out, int8_t* __restrict__ codes, const StemGeom g,
                  int pad, const __grid_constant__ CUtensorMap tmap) {
  constexpr int ES = MODE >= 2 ? 4 : 1;        // output element bytes
  constexpr bool F32 = sizeof(TIn) == 4;
  static_assert(!TMA || F32, "the TMA path loads f32 rows");
  __shared__ __align__(16) uint8_t s_in[2][STEM_HALO];
  __shared__ __align__(128) float s_f32[TMA ? STEM_HALO : 4];
  __shared__ uint32_t s_w[STEM_MAX_CO * 3];    // [co][dy]: 3 taps, a zero byte
  __shared__ uint16_t s_rc[STEM_MAX_PX];
  __shared__ __align__(8) uint64_t s_bar;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int gq = lane >> 2, tq = lane & 3;
  for (int e = tid; e < g.Co * 3; e += THREADS) {
    const int8_t* p = w + 3 * e;               // channel e / 3, row e % 3
    s_w[e] = static_cast<uint32_t>(static_cast<uint8_t>(p[0]))
             | static_cast<uint32_t>(static_cast<uint8_t>(p[1])) << 8
             | static_cast<uint32_t>(static_cast<uint8_t>(p[2])) << 16;
  }
  const int npx = g.rows * g.tw, n16 = (npx + 15) >> 4;
  // tile pixel m -> (row << 7 | column), the same in every tile
  for (int m = tid; m < npx; m += THREADS)
    s_rc[m] = static_cast<uint16_t>((m / g.tw) << 7 | (m % g.tw));
  struct Tile { long long img; int h0, w0; };
  auto tile_at = [&](long long t) {
    Tile o;
    o.w0 = static_cast<int>(t % g.tiles_w) * g.tw;
    t /= g.tiles_w;
    o.h0 = static_cast<int>(t % g.tiles_h) * g.rows;
    o.img = (t / g.tiles_h) * g.H * g.W;
    return o;
  };
  auto inside = [&](int hh, int ww) { return hh >= 0 && hh < g.H && ww >= 0 && ww < g.W; };
  // Registers: halo element e = row * (tw + 2) + column, at byte row * hs +
  // STEM_OFF - 1 + column of its buffer.
  const int hw2 = g.tw + 2, halo = (g.rows + 2) * hw2;
  auto fetch = [&](const Tile& o, TIn (&v)[STEM_LOADS]) {
#pragma unroll
    for (int k = 0; k < STEM_LOADS; ++k) {
      const int e = tid + k * THREADS, hr = e / hw2, hc = e - hr * hw2;
      const int hh = o.h0 - 1 + hr, ww = o.w0 - 1 + hc;
      v[k] = e < halo && inside(hh, ww) ? x[o.img + static_cast<long long>(hh) * g.W + ww]
                                        : TIn(0);
    }
  };
  auto stash = [&](const Tile& o, uint8_t* buf, const TIn (&v)[STEM_LOADS]) {
#pragma unroll
    for (int k = 0; k < STEM_LOADS; ++k) {
      const int e = tid + k * THREADS, hr = e / hw2, hc = e - hr * hw2;
      if (e >= halo) continue;
      const int hh = o.h0 - 1 + hr, ww = o.w0 - 1 + hc;
      uint32_t q = static_cast<uint8_t>(pad);
      if (inside(hh, ww)) {
        q = stem_code(v[k], c1, c2, ww);
        if (F32 && codes != nullptr && hr >= 1 && hr <= g.rows && hc >= 1 && hc <= g.tw)
          codes[o.img + static_cast<long long>(hh) * g.W + ww] = static_cast<int8_t>(q);
      }
      buf[hr * g.hs + STEM_OFF - 1 + hc] = static_cast<uint8_t>(q);
    }
  };
  // TMA: s_f32 holds the box's rows of BW = tw + 8 floats, tile column c
  // at float 4 + c; its quad e = row * tw/4 + q (columns 4q .. 4q+3) becomes
  // the word (row * hs + STEM_OFF) / 4 + q of the buffer, and the two side
  // columns of each row one a thread.
  const uint32_t bar = smem_u32(&s_bar);
  const int BW = g.tw + 8, qr = g.tw >> 2, nq = (g.rows + 2) * qr, ns = 2 * (g.rows + 2);
  uint32_t phase = 0;
  auto load = [&](const Tile& o) {             // one thread
    mbar_expect_tx(bar, BW * (g.rows + 2) * 4);
    tma_3d(smem_u32(s_f32), &tmap, bar, o.w0 - 4, o.h0 - 1,
           static_cast<int>(o.img / (static_cast<long long>(g.H) * g.W)));
  };
  auto convert = [&](const Tile& o, uint8_t* buf) {
    mbar_wait(bar, phase);
    phase ^= 1;
    for (int e = tid; e < nq; e += THREADS) {
      const int r = e / qr, q = e - r * qr;
      const int hh = o.h0 - 1 + r, ww = o.w0 + 4 * q;
      uint32_t word = 0;
      if (hh >= 0 && hh < g.H && ww < g.W) {
        const float4 v = *reinterpret_cast<const float4*>(s_f32 + r * BW + 4 + 4 * q);
        word = stem_code(v.x, c1, c2, ww) | stem_code(v.y, c1, c2, ww + 1) << 8
               | stem_code(v.z, c1, c2, ww + 2) << 16 | stem_code(v.w, c1, c2, ww + 3) << 24;
        if (codes != nullptr && r >= 1 && r <= g.rows)
          *reinterpret_cast<uint32_t*>(codes + o.img + static_cast<long long>(hh) * g.W + ww) =
              word;
      }
      *reinterpret_cast<uint32_t*>(buf + r * g.hs + STEM_OFF + 4 * q) = word;
    }
    if (tid < ns) {
      const int r = tid >> 1, hh = o.h0 - 1 + r, ww = tid & 1 ? o.w0 + g.tw : o.w0 - 1;
      const float v = s_f32[r * BW + (tid & 1 ? 4 + g.tw : 3)];
      buf[r * g.hs + (tid & 1 ? STEM_OFF + g.tw : STEM_OFF - 1)] =
          static_cast<uint8_t>(inside(hh, ww) ? stem_code(v, c1, c2, ww) : 0u);
    }
  };
  if (TMA && tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  TIn nxt[STEM_LOADS];
  if (blockIdx.x < g.tiles) {
    const Tile o = tile_at(blockIdx.x);
    if constexpr (TMA) {
      if (tid == 0) load(o);
      convert(o, s_in[0]);
    } else {
      fetch(o, nxt);
      stash(o, s_in[0], nxt);
    }
  }
  __syncthreads();
  const int dy = tq < 3 ? tq : 2;              // lanes tq = 3 meet zero weights
  int cur = 0;
  for (long long tile = blockIdx.x; tile < g.tiles; tile += gridDim.x, cur ^= 1) {
    const bool more = tile + gridDim.x < g.tiles;
    const Tile nt = tile_at(more ? tile + gridDim.x : tile);
    if (more) {
      if constexpr (TMA) {
        if (tid == 0) load(nt);                // s_f32 was read before the last barrier
      } else {
        fetch(nt, nxt);
      }
    }
    const Tile o = tile_at(tile);
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s_in[cur]);
    // tiles of whole image rows (W <= 128): pixel m of the tile is pixel
    // tile_px + m of the batch, and it lies in the image below `valid`
    const long long tile_px = o.img + static_cast<long long>(o.h0) * g.W;
    const int valid = (g.H - o.h0 < g.rows ? g.H - o.h0 : g.rows) * g.tw;
    for (int n0 = 0; n0 < g.Co; n0 += 64) {
      // MMA j: this lane's B column gq is channel n0 + 16*(gq/2) + 2j + gq%2,
      // and its outputs are channels n0 + 16tq + 2j, +1
      uint32_t wb[8];
      float av[16], bv[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wb[j] = tq < 3 ? s_w[(n0 + 16 * (gq >> 1) + 2 * j + (gq & 1)) * 3 + tq] : 0u;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        av[i] = __ldg(A + n0 + 16 * tq + i) * (MODE < 2 ? 0.00390625f : 1.0f);  // sat_bits
        bv[i] = __ldg(B + n0 + 16 * tq + i) * (MODE < 2 ? 0.00390625f : 1.0f);
      }
      for (int mt = warp; mt < n16; mt += THREADS / 32) {
        uint32_t a[2];                         // pixels mt*16 + gq, + 8
        uint8_t* dst[2];                       // their 16 channels, or null
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + gq + 8 * h;
          const int rc = s_rc[m < npx ? m : 0];
          const int base = ((rc >> 7) + dy) * g.hs + STEM_OFF - 1 + (rc & 127), s = base & 3;
          a[h] = __byte_perm(s32[base >> 2], s32[(base >> 2) + 1],
                             s | (s + 1) << 4 | (s + 2) << 8);
          if (g.tw == g.W) {
            dst[h] = m < valid ? static_cast<uint8_t*>(out)
                                     + ((tile_px + m) * g.Co + n0 + 16 * tq) * ES
                               : nullptr;
          } else {
            const int hh = o.h0 + (rc >> 7), ww = o.w0 + (rc & 127);
            dst[h] = m < npx && hh < g.H && ww < g.W
                ? static_cast<uint8_t*>(out)
                      + ((o.img + static_cast<long long>(hh) * g.W + ww) * g.Co + n0 + 16 * tq)
                          * ES
                : nullptr;
          }
        }
        uint32_t word[2][4];                   // codes: 4 channels a word
        float f[2][4];                         // f32: 4 channels, stored by pairs of j
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          int d[4] = {MAGIC, MAGIC, MAGIC, MAGIC};
          mma_s8_k16(d, a, wb[j]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (MODE >= 2) {
              const float y0 = __fmaf_rn(exact_float(d[2 * h]), av[2 * j], bv[2 * j]);
              const float y1 = __fmaf_rn(exact_float(d[2 * h + 1]), av[2 * j + 1], bv[2 * j + 1]);
              f[h][2 * (j & 1)] = MODE == 2 ? fmaxf(y0, 0.0f) : y0;
              f[h][2 * (j & 1) + 1] = MODE == 2 ? fmaxf(y1, 0.0f) : y1;
              if ((j & 1) && dst[h] != nullptr)   // channels 16tq + 2j - 2 .. 2j + 1
                *reinterpret_cast<float4*>(dst[h] + 8 * (j - 1)) =
                    make_float4(f[h][0], f[h][1], f[h][2], f[h][3]);
            } else {
              const float z0 = fma_sat(exact_float(d[2 * h]), av[2 * j], bv[2 * j]);
              const float z1 = fma_sat(exact_float(d[2 * h + 1]), av[2 * j + 1], bv[2 * j + 1]);
              const uint32_t pair = __byte_perm(sat_bits<MODE>(z0), sat_bits<MODE>(z1), 0x0040);
              word[h][j >> 1] = j & 1 ? __byte_perm(word[h][j >> 1], pair, 0x5410) : pair;
            }
          }
        }
        if constexpr (MODE < 2) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (dst[h] != nullptr)
              *reinterpret_cast<int4*>(dst[h]) = make_int4(word[h][0], word[h][1], word[h][2],
                                                           word[h][3]);
        }
      }
    }
    if (more) {
      if constexpr (TMA) convert(nt, s_in[cur ^ 1]);
      else stash(nt, s_in[cur ^ 1], nxt);
    }
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

int max_smem() {
  int device = 0, bytes = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return bytes;
}

// The driver's tensor-map encoders, through the runtime's entry-point query
// (the library links only cudart, as nvcc does by default).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*,
                                  const int*, cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

void* driver_fn(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &fn, 12000,
                                                           cudaEnableDefault, &q);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q);
#endif
  return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? fn : nullptr;
}

// x [N,H,W,Ci] as an im2col map (a box of BM pixels x KC channels, the
// traversal's bounding box one pixel inside the border on each side, as a
// SAME 3x3 conv needs) or, with box_rows, a tiled map (boxes of box_rows
// rows x W pixels x KC channels); either reads 0 outside the image.  w
// [Co, 9*Ci] as a tiled map (boxes of BN rows x KC bytes).  All with the
// swizzle of KC-byte rows.
template <int BN, int KC>
cudaError_t body_maps(CUtensorMap* tx, CUtensorMap* tw, const int8_t* x, const int8_t* w,
                      long long N, int H, int W, int Ci, int Co, int box_rows) {
  static const EncodeTiled enc_tiled =
      reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
  static const EncodeIm2col enc_im2col =
      reinterpret_cast<EncodeIm2col>(driver_fn("cuTensorMapEncodeIm2col"));
  if (enc_tiled == nullptr || enc_im2col == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle swz =
      KC == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(Ci), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t xstride[3] = {static_cast<cuuint64_t>(Ci),
                                 static_cast<cuuint64_t>(W) * Ci,
                                 static_cast<cuuint64_t>(H) * W * Ci};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t xbox[4] = {KC, static_cast<cuuint32_t>(W),
                              static_cast<cuuint32_t>(box_rows), 1};
  const CUresult xr = box_rows > 0
      ? enc_tiled(tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x), xdim, xstride,
                  xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
      : enc_im2col(tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x), xdim, xstride,
                   lower, upper, KC, BM, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (xr != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(9) * Ci,
                              static_cast<cuuint64_t>(Co)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(9) * Ci};
  const cuuint32_t wbox[2] = {KC, BN};
  if (enc_tiled(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), wdim,
                wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Bytes a staged output row: BN codes, or f32 values of at most 128
// channels (a 256-channel tile stages in halves), and 16 against bank
// conflicts.
int staged_row(int BN, int mode) {
  return (mode >= 2 ? (BN == 256 ? 128 : BN) * 4 : BN) + 16;
}

// Bytes of shared memory outside the ring: alignment slack, the staging
// rows, A/B, the barriers, the pad's table.
int fixed_smem(int BN, int mode, int pad) {
  return 1024 + 2 * 64 * staged_row(BN, mode) + 2 * BN * 4 + 8 * (2 * MAX_STAGES + 1)
         + (pad != 0 ? 16 * BN * 4 : 0);
}

// The halo box's rows, or 0 where the HALO kernel does not apply: K chunks
// of 64 and BN <= 128 (so that the block's 9*Ci*BN bytes of weights can
// fit), a tile of 2*BM pixels is whole rows of one image (W divides 2*BM,
// and 2*BM / W divides H), a row is whole swizzle atoms (W % 8 == 0), and
// the weights leave room for 3 stages.
int halo_rows(int BN, int KC, int Ci, int H, int W, int mode, int pad) {
  const int tm = 2 * BM, rows = W <= tm && tm % W == 0 ? tm / W : 0;
  if (KC != 64 || BN > 128 || W % 8 != 0 || rows == 0 || H % rows != 0) return 0;
  const int avail = max_smem() - fixed_smem(BN, mode, pad);
  return 9 * Ci * BN + 3 * (tm + 2 * W) * KC <= avail ? rows + 2 : 0;
}

template <int BN, int KC>
cudaError_t launch_body(const int8_t* x, const int8_t* w, const float* A, const float* B,
                        void* out, long long N, int H, int W, int Ci, int Co, int mode,
                        int pad, cudaStream_t stream) {
  BodyGeom g;
  g.M = static_cast<int>(N * H * W);
  g.H = H; g.W = W; g.Ci = Ci; g.Co = Co;
  g.nco = Co / BN;
  g.mode = mode;
  g.pad = pad;
  g.ostride = staged_row(BN, mode);
  const int fixed = fixed_smem(BN, mode, pad), avail = max_smem() - fixed;
  constexpr bool can_halo = KC == 64 && BN <= 128;
  const int rows = halo_rows(BN, KC, Ci, H, W, mode, pad);
  const bool halo = can_halo && rows > 0;
  const int tm = 2 * BM;
  g.wres = halo ? 9 * Ci * BN : 0;
  g.sbytes = halo ? (tm + 2 * W) * KC : (BM + BN) * KC;
  g.m_tiles = (g.M + (halo ? tm : BM) - 1) / (halo ? tm : BM);
  const int sms = sm_count();
  g.per_co = sms / g.nco < g.m_tiles ? sms / g.nco : g.m_tiles;
  if (g.per_co < 1) g.per_co = 1;
  g.stages = (avail - g.wres) / g.sbytes;
  if (g.stages > MAX_STAGES) g.stages = MAX_STAGES;
  if (g.stages < 3) return cudaErrorInvalidConfiguration;
  const int smem = fixed + g.wres + g.stages * g.sbytes;
  CUtensorMap tx, tw;
  cudaError_t err = body_maps<BN, KC>(&tx, &tw, x, w, N, H, W, Ci, Co, halo ? rows : 0);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_i8_kernel<BN, KC, false>;
  if constexpr (can_halo)
    if (halo) kernel = conv3x3_i8_kernel<BN, KC, true>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<g.per_co * g.nco, BODY_THREADS, smem, stream>>>(tx, tw, w, A, B, out, g);
  return cudaGetLastError();
}

StemGeom stem_geom(long long N, int H, int W, int Co) {
  StemGeom g;
  g.H = H; g.W = W; g.Co = Co;
  g.tw = W < 128 ? W : 128;
  // a row's bytes: the tile's columns from byte STEM_OFF, a halo column on
  // each side, and the word after the last window's; as many rows as fit,
  // at most THREADS / 2 with their halo (one side column a thread)
  g.hs = 4 * ((g.tw + 2) / 4 + 2);
  int rows = STEM_HALO / g.hs - 2;
  rows = rows < STEM_MAX_PX / g.tw ? rows : STEM_MAX_PX / g.tw;
  rows = rows < THREADS / 2 - 2 ? rows : THREADS / 2 - 2;
  g.rows = rows < H ? rows : H;
  g.tiles_h = (H + g.rows - 1) / g.rows;
  g.tiles_w = (W + g.tw - 1) / g.tw;
  g.tiles = N * g.tiles_h * g.tiles_w;
  return g;
}

// The TMA path's map of the f32 rows [N, H, W]: boxes of rows + 2 rows of
// tw + 8 columns, zero outside.
cudaError_t stem_map(CUtensorMap* map, const float* x, long long N, const StemGeom& g) {
  static const EncodeTiled enc =
      reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(g.W), static_cast<cuuint64_t>(g.H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(g.W) * 4,
                                 static_cast<cuuint64_t>(g.H) * g.W * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(g.tw + 8),
                             static_cast<cuuint32_t>(g.rows + 2), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
      ? cudaSuccess : cudaErrorInvalidValue;
}

// a persistent grid: as many blocks as fit on the card at once, at most
// one a tile
template <typename Kernel>
int stem_blocks(Kernel kernel, long long tiles) {
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  const long long most = static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(tiles < most ? tiles : most);
}

template <int MODE, typename TIn>
cudaError_t launch_stem(const TIn* x, const float* c1, const float* c2, const int8_t* w,
                        const float* A, const float* B, void* out, int8_t* codes,
                        long long N, int H, int W, int Co, int pad, cudaStream_t stream) {
  const StemGeom g = stem_geom(N, H, W, Co);
  CUtensorMap map{};
  if constexpr (sizeof(TIn) == 4) {
    if (W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(codes)) % 16
                          == 0) {
      const cudaError_t err = stem_map(&map, x, N, g);
      if (err != cudaSuccess) return err;
      auto kernel = conv3x3_c1_kernel<MODE, TIn, true>;
      kernel<<<stem_blocks(kernel, g.tiles), THREADS, 0, stream>>>(x, c1, c2, w, A, B, out,
                                                                    codes, g, pad, map);
      return cudaGetLastError();
    }
  }
  auto kernel = conv3x3_c1_kernel<MODE, TIn, false>;
  kernel<<<stem_blocks(kernel, g.tiles), THREADS, 0, stream>>>(x, c1, c2, w, A, B, out, codes,
                                                                g, pad, map);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_conv(const int8_t* x, const int8_t* w, const float* A, const float* B,
                        void* out, long long N, int H, int W, int Ci, int Co, int pad,
                        cudaStream_t stream) {
  if (Ci == 1)
    return launch_stem<MODE, int8_t>(x, nullptr, nullptr, w, A, B, out, nullptr, N, H, W, Co,
                                     pad, stream);
  // BN = 256 output channels a tile where Co allows (for f32 outputs only
  // without the pad's table: their staging rows leave the ring 3 stages),
  // else 128, else 64; K chunks of 128 input channels where Ci allows, else 64
  if (Co % 256 == 0 && (MODE < 2 || pad == 0))
    return Ci % 128 == 0
        ? launch_body<256, 128>(x, w, A, B, out, N, H, W, Ci, Co, MODE, pad, stream)
        : launch_body<256, 64>(x, w, A, B, out, N, H, W, Ci, Co, MODE, pad, stream);
  if (Co % 128 == 0)
    return Ci % 128 == 0
        ? launch_body<128, 128>(x, w, A, B, out, N, H, W, Ci, Co, MODE, pad, stream)
        : launch_body<128, 64>(x, w, A, B, out, N, H, W, Ci, Co, MODE, pad, stream);
  return Ci % 128 == 0
      ? launch_body<64, 128>(x, w, A, B, out, N, H, W, Ci, Co, MODE, pad, stream)
      : launch_body<64, 64>(x, w, A, B, out, N, H, W, Ci, Co, MODE, pad, stream);
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
  if (Ci != 1 && (N * H * W >= (1LL << 31) || reinterpret_cast<uintptr_t>(w) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
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

// The fused stem: feats [N,H,W] float32 (log-mel frames x bins), c1/c2 [W]
// float32, w [Co,3,3,1] int8, A/B [Co] float32 -> out [N,H,W,Co] of `mode`,
// and with `codes` non-null the stem codes [N,H,W] int8 there too.
extern "C" int stem_conv3x3_i8_launch(const void* feats, const void* c1, const void* c2,
                                      const void* w, const void* A, const void* B, void* out,
                                      void* codes, long long N, int H, int W, int Co,
                                      int mode, void* stream) {
  if (N * H * W == 0) return 0;
  if (Co > STEM_MAX_CO || Co % 64 != 0 || Co <= 0 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(feats);
  const float* a = static_cast<const float*>(c1);
  const float* b = static_cast<const float*>(c2);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  int8_t* q = static_cast<int8_t*>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case 0: err = launch_stem<0, float>(x, a, b, wi, Af, Bf, out, q, N, H, W, Co, 0, s); break;
    case 1: err = launch_stem<1, float>(x, a, b, wi, Af, Bf, out, q, N, H, W, Co, 0, s); break;
    case 2: err = launch_stem<2, float>(x, a, b, wi, Af, Bf, out, q, N, H, W, Co, 0, s); break;
    default: err = launch_stem<3, float>(x, a, b, wi, Af, Bf, out, q, N, H, W, Co, 0, s); break;
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
