// Single-token GQA decode attention over a KV cache for Hopper, split-K.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, _kernel). Same semantics: one query token per row
// against a (B, Hkv, Smax, d) cache; all G query heads of a kv head share
// one cache stream; with window == 0 only positions <= index are live and
// chunks past index are neither read nor computed; with window > 0 the
// rolling-buffer mask (index - pos) % Smax < min(window, index + 1).
// `index` is read from device memory, so a step is data, not a shape.
//
// Design. The TPU walks the cache sequentially on one core; here a grid
// of B*Hkv blocks alone would leave most of the 132 SMs idle at serving
// batch sizes, so the cache is split into chunks: grid (B*Hkv, n_split).
// Each block takes the G query heads of one kv head over one chunk, in
// 64-position sub-tiles with an online softmax, and writes its partial
// (m, l, acc) in fp32 to scratch; a second small kernel combines the
// partials of a row. Scores: one warp per cache position, each lane four
// dims (one coalesced 256-byte row read). Output: one thread per dim.
//
// What bounds it: decode reads the live cache once and does 4*d FLOPs
// per position and query head, far below the card's FLOP/byte balance,
// so it is memory-bound; at serving shapes the cache is small and launch
// latency dominates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G_MAX = 8;      // query heads per kv head
constexpr int DT = 64;        // cache positions per sub-tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

template <int HD>
__global__ void __launch_bounds__(HD)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const int* __restrict__ index_ptr,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc,
                    int G, int Smax, int n_split, int chunk, int window,
                    float scale) {
  constexpr int NW = HD / 32;          // warps per block
  constexpr int PL = HD / 32;          // dims per lane in the score stage
  static_assert(PL == 4, "score stage reads 4 bf16 per lane");
  __shared__ __align__(16) float qs[G_MAX][HD];
  __shared__ float ss[G_MAX][DT];
  __shared__ float m_s[G_MAX], l_s[G_MAX], corr_s[G_MAX];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;           // b * Hkv + kv head
  const int split = blockIdx.y;
  const int index = *index_ptr;

  const __nv_bfloat16* qrow = q + static_cast<long long>(bh) * G * HD;
  const __nv_bfloat16* kbase = kc + static_cast<long long>(bh) * Smax * HD;
  const __nv_bfloat16* vbase = vc + static_cast<long long>(bh) * Smax * HD;

  for (int i = tid; i < G * HD; i += HD)
    qs[i / HD][i % HD] = __bfloat162float(qrow[i]) * scale;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int c0 = split * chunk;
  int c1 = min(c0 + chunk, Smax);
  if (window == 0) c1 = min(c1, index + 1);   // dead chunks: no reads
  const int wlimit = min(window, index + 1);

  float acc[G_MAX];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = c0; t0 < c1; t0 += DT) {
    const int n = min(DT, c1 - t0);
    for (int j = warp; j < n; j += NW) {
      const int pos = t0 + j;
      const uint2 u = *reinterpret_cast<const uint2*>(kbase + pos * HD + lane * PL);
      const float2 k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      bool ok = true;
      if (window > 0) {
        const int age = ((index - pos) % Smax + Smax) % Smax;   // rolling buffer
        ok = age < wlimit;
      }
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < G) {
          const float4 qv = *reinterpret_cast<const float4*>(&qs[g][lane * PL]);
          const float part = warp_sum(qv.x * k01.x + qv.y * k01.y +
                                      qv.z * k23.x + qv.w * k23.y);
          if (lane == 0) ss[g][j] = ok ? part : NEG_INF;
        }
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      const float s0 = lane < n ? ss[g][lane] : NEG_INF;
      const float s1 = lane + 32 < n ? ss[g][lane + 32] : NEG_INF;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      // masked scores are NEG_INF exactly; they get p = 0 even on a row
      // with no live key so far (m_new == NEG_INF)
      const float p0 = s0 > 0.5f * NEG_INF ? __expf(s0 - m_new) : 0.f;
      const float p1 = s1 > 0.5f * NEG_INF ? __expf(s1 - m_new) : 0.f;
      if (lane < n) ss[g][lane] = p0;
      if (lane + 32 < n) ss[g][lane + 32] = p1;
      const float lsum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + lsum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G_MAX; ++g)
      if (g < G) acc[g] *= corr_s[g];
    for (int j = 0; j < n; ++j) {
      const float vv = __bfloat162float(vbase[(t0 + j) * HD + tid]);
#pragma unroll
      for (int g = 0; g < G_MAX; ++g)
        if (g < G) acc[g] += ss[g][j] * vv;
    }
    __syncthreads();
  }

  const long long part = static_cast<long long>(bh) * n_split + split;
  if (tid < G) {
    part_m[part * G + tid] = m_s[tid];
    part_l[part * G + tid] = l_s[tid];
  }
#pragma unroll
  for (int g = 0; g < G_MAX; ++g)
    if (g < G) part_acc[(part * G + g) * HD + tid] = acc[g];
}

template <int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      __nv_bfloat16* __restrict__ out, int G, int n_split) {
  const int row = blockIdx.x;          // (b * Hkv + kv head) * G + g
  const int bh = row / G, g = row % G;
  const int d = threadIdx.x;
  float M = NEG_INF;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, part_m[(static_cast<long long>(bh) * n_split + s) * G + g]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long p = (static_cast<long long>(bh) * n_split + s) * G + g;
    const float w = __expf(part_m[p] - M);
    den += w * part_l[p];
    num += w * part_acc[p * HD + d];
  }
  out[static_cast<long long>(row) * HD + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
}

}  // namespace

// q: (B, Hkv*G, 1, d), caches: (B, Hkv, Smax, d), out: (B, Hkv*G, 1, d),
// all contiguous bf16. Scratch: part_m / part_l (B*Hkv*n_split*G) and
// part_acc (B*Hkv*n_split*G*d), fp32. n_split * chunk must cover Smax.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* index_ptr, void* part_m, void* part_l, void* part_acc,
    void* out, int B, int Hkv, int G, int Smax, int head_dim, int n_split,
    int chunk, int window, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (head_dim != 128 || G < 1 || G > G_MAX || n_split < 1 || chunk < 1 ||
      static_cast<long long>(n_split) * chunk < Smax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(B * Hkv, n_split);
  decode_split_kernel<128><<<grid, 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int*>(index_ptr), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), G, Smax,
      n_split, chunk, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<128><<<B * Hkv * G, 128, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out),
      G, n_split);
  return static_cast<int>(cudaGetLastError());
}
