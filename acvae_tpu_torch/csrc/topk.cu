// The beam's top-k for Hopper (sm_90a): the k best (score, index) pairs of
// each row of x [R, M] float32, in the order of torch.sort(x, -1,
// descending=True, stable=True) cut to k: descending score, equal scores in
// ascending index.
//
// Replaces no Pallas kernel.  It stands for XLA's lax.top_k in the beam
// search of acvae_tpu/decoding/beam.py:37-75 (beam_topk), which the port ran
// as a full stable radix sort of each row (3 * 4981 scores a clip, 20 steps
// a batch) only to keep the first k.
//
// Order.  Each element becomes one unique 64-bit key: the high word is the
// score's bits mapped so that unsigned order is the sort's order, the low
// word the complement of its index (a lower index is a larger key), and the
// kernel keeps the k largest keys.  The map is the one the card's sort uses
// at every row length (a radix sort of the float's bits: sign set, all bits
// flipped, else the sign flipped), so NaNs with the sign clear are above
// +inf, ordered by their bits, NaNs with the sign set below -inf, and -0.0
// and +0.0 are equal (the radix sort reads -0.0 as +0.0).  The CPU's sort
// puts every NaN first instead; the port's scores hold no NaN.  The values
// written are the input's own bits at the selected indices.
//
// Bound: bytes.  One step of the flagship's beam reads 512 rows of 14,943
// float32 (30.6 MB): 9.1 us at 3.35 TB/s; the output is 512 * 3 pairs.
// Design: one block a row, so a step's 512 rows are one wave on the 132 SMs.
// A row starts wherever R * M puts it (M is odd), so the first up-to-3
// elements before a 16-byte boundary and the last up-to-3 are read as
// scalars and the rest as float4, UNROLL vectors in flight a thread, each
// vector coalesced across the block.  Each thread keeps its CAP best keys
// sorted in registers; one 64-bit compare against the CAP-th rejects almost
// every element.  Then k rounds of a warp max by shuffles give each warp's
// best k, written to shared memory, and warp 0 merges the warps' lists by
// the same rounds.
//
// Any k.  A launch selects at most ROUND_K keys (the registers' list).  A
// larger k takes ceil(k / ROUND_K) launches in turn on the stream: each
// after the first reads the key of the last pair the one before wrote and
// selects the next keys strictly below it, which are the next in order,
// since keys are unique.  Each launch reads the row once more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;   // float4 loads in flight a thread
constexpr int ROUND_K = 16;   // the most keys one launch selects

typedef unsigned long long u64;

// the score word: unsigned order of the result is the sort's order
__device__ __forceinline__ unsigned score_word(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;                      // -0.0 as +0.0
  return b ^ ((b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float v, unsigned i) {
  return (static_cast<u64>(score_word(v)) << 32) | static_cast<u64>(~i);
}

// the CAP largest keys seen, in descending order; 0 is below every key (the
// low word of a key is ~index with index < 2^31, so a key is never 0)
template <int CAP>
struct Best {
  u64 k[CAP];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < CAP; ++j) k[j] = 0;
  }

  __device__ __forceinline__ void push(u64 key) {
    if (key <= k[CAP - 1]) return;
    k[CAP - 1] = key;
#pragma unroll
    for (int j = CAP - 1; j > 0; --j) {
      if (k[j] > k[j - 1]) {
        const u64 t = k[j];
        k[j] = k[j - 1];
        k[j - 1] = t;
      }
    }
  }

  // drop the head if it is `key`
  __device__ __forceinline__ void pop_if(u64 key) {
    if (k[0] != key) return;
#pragma unroll
    for (int j = 0; j < CAP - 1; ++j) k[j] = k[j + 1];
    k[CAP - 1] = 0;
  }
};

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// Selects the k (<= CAP) largest keys of each row, into columns c0..c0+k-1
// of values and indices [R, ld]; AFTER: only keys below that of column
// c0 - 1, which an earlier launch wrote.
template <int CAP, bool AFTER>
__global__ void __launch_bounds__(THREADS)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ values,
                 long long* __restrict__ indices, int M, int ld, int c0, int k) {
  __shared__ u64 lists[WARPS * CAP];
  const long long r = blockIdx.x;
  const float* row = x + r * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* out_v = values + r * ld + c0;
  long long* out_i = indices + r * ld + c0;
  u64 below = ~0ull;
  if (AFTER) below = make_key(out_v[-1], static_cast<unsigned>(out_i[-1]));

  Best<CAP> best;
  best.clear();
  auto see = [&](float v, unsigned i) {
    const u64 key = make_key(v, i);
    if (!AFTER || key < below) best.push(key);
  };

  // scalars up to the first 16-byte boundary, then float4s, then the tail
  const int to_aligned = static_cast<int>(
      ((16u - (static_cast<unsigned>(reinterpret_cast<uintptr_t>(row)) & 15u)) & 15u) >> 2);
  const int head = to_aligned < M ? to_aligned : M;
  const int nvec = (M - head) >> 2;
  const int tail = head + (nvec << 2);
  if (tid < head) see(__ldg(row + tid), tid);
  if (tail + tid < M) see(__ldg(row + tail + tid), tail + tid);
  const float4* vec = reinterpret_cast<const float4*>(row + head);
  for (int i0 = tid; i0 < nvec; i0 += THREADS * UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nvec) v[u] = __ldg(vec + i);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= nvec) break;
      const unsigned at = static_cast<unsigned>(head + (i << 2));
      see(v[u].x, at);
      see(v[u].y, at + 1);
      see(v[u].z, at + 2);
      see(v[u].w, at + 3);
    }
  }

  // each warp's best k, by k rounds of a warp max
  for (int j = 0; j < k; ++j) {
    const u64 top = warp_max(best.k[0]);
    best.pop_if(top);
    if (lane == 0) lists[warp * CAP + j] = top;
  }
  __syncthreads();
  if (warp != 0) return;

  // warp 0 merges the warps' lists: lane w holds warp w's
  best.clear();
  if (lane < WARPS) {
#pragma unroll
    for (int j = 0; j < CAP; ++j)
      if (j < k) best.k[j] = lists[lane * CAP + j];
  }
  for (int j = 0; j < k; ++j) {
    const u64 top = warp_max(best.k[0]);
    best.pop_if(top);
    if (lane == 0) {
      const unsigned i = ~static_cast<unsigned>(top);
      out_v[j] = row[i];
      out_i[j] = i;
    }
  }
}

template <int CAP, bool AFTER>
int launch(const float* x, float* values, long long* indices, long long R, int M,
           int ld, int c0, int k, cudaStream_t stream) {
  topk_rows_kernel<CAP, AFTER><<<static_cast<unsigned>(R), THREADS, 0, stream>>>(
      x, values, indices, M, ld, c0, k);
  return static_cast<int>(cudaGetLastError());
}

// one launch: the k (<= ROUND_K) keys that follow column c0 - 1
template <bool AFTER>
int launch_round(const float* x, float* values, long long* indices, long long R,
                 int M, int ld, int c0, int k, cudaStream_t st) {
  if (k == 1) return launch<1, AFTER>(x, values, indices, R, M, ld, c0, k, st);
  if (k == 2) return launch<2, AFTER>(x, values, indices, R, M, ld, c0, k, st);
  if (k == 3) return launch<3, AFTER>(x, values, indices, R, M, ld, c0, k, st);
  if (k == 4) return launch<4, AFTER>(x, values, indices, R, M, ld, c0, k, st);
  if (k <= 8) return launch<8, AFTER>(x, values, indices, R, M, ld, c0, k, st);
  return launch<16, AFTER>(x, values, indices, R, M, ld, c0, k, st);
}

}  // namespace

// x [R, M] float32 contiguous; values [R, k] float32, indices [R, k] int64
// contiguous, 1 <= k <= M, M < 2^31, R < 2^31.  Launches ceil(k / 16)
// kernels on `stream` and returns the first nonzero cudaGetLastError(), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int topk_rows_launch(const void* x, void* values, void* indices,
                                long long R, long long M, int k, void* stream) {
  if (R <= 0 || M <= 0 || M >= (1ll << 31) || R >= (1ll << 31) || k < 1 || k > M)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(values);
  long long* ip = static_cast<long long*>(indices);
  const int m = static_cast<int>(M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < k; c0 += ROUND_K) {
    const int kc = k - c0 < ROUND_K ? k - c0 : ROUND_K;
    const int err = c0 == 0 ? launch_round<false>(xp, vp, ip, R, m, k, c0, kc, st)
                            : launch_round<true>(xp, vp, ip, R, m, k, c0, kc, st);
    if (err != 0) return err;
  }
  return 0;
}
