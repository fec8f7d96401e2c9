// SubnetNorm for Hopper: RMSNorm of each row times the gain row
// gamma_table[subnet_id], with the pending residual add of the block
// before it fused in front.
//
// Replaces the Pallas TPU kernel src/repro/kernels/subnet_rmsnorm.py
// (subnet_rmsnorm at :27, its pallas_call at :42). Per row, in fp32:
//
//     s = x + delta                      (delta null: s = x, not written)
//     h = s * rsqrt(mean(s * s) + eps) * gamma_table[subnet_id]
//
// s is the fp32 sum rounded once to x's type, as torch.add rounds it, so it
// is bit for bit the residual stream that a separate add would give, and h
// normalises that rounded s (the JAX model normalises the rounded bf16
// residual stream). subnet_id is read from device memory: switching subnets
// changes one int32, never the launch.
//
// What bounds it on the H100: bytes. An element costs 2 to 8 bytes of
// device memory for about 4 FLOPs. At the served shapes (8 to 2048 rows of
// 1536) the bytes take 0.01 to 7.5 us at 3.35 TB/s, so a standalone call
// is its launch plus one chain of dependent loads (subnet_id, then the gain
// row). Fusing the residual add removes a launch and a round trip of the
// sum through device memory for each block of the model.
//
// Design: one block of four warps a row. The threads hold the row in
// registers as 16-byte vectors (VPL a thread, a compile-time bucket: 2 for
// d = 1536 in bf16, the second live in half the threads), so the row is
// read once and the outputs are written from registers. The fp32 sum of
// squares is reduced with __shfl_xor_sync within each warp and across the
// four warps through shared memory at one barrier. The subnet_id load is
// issued first and then the row's loads, so the gain-row load that waits
// on it overlaps them. Rows past 16 vectors a thread (fp32 past d = 8192)
// take the streaming variant (VPL = 0), which reads s back for its second
// pass. A warp a row, four rows a block, was built first and measured
// slower at few rows (tools/norm_bench.py on an H100, d = 1536 bf16, 128
// rows: 0.00200 ms standalone and 0.00219 fused, against 0.00142 and
// 0.00153 here): a warp alone takes a whole row's arithmetic in series,
// the length of the chain that bounds a call at few rows.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // a block: one row, four warps

// 16 bytes of T as floats and back; E elements of T a vector
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void to_float(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 from_float(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<__half> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void to_float(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 p =
          __half22float2(*reinterpret_cast<const __half2*>(&w[k]));
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 from_float(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __half2 p = __floats2half2_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void to_float(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 from_float(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// a + b in fp32, rounded once to T (torch.add's arithmetic)
template <typename T>
__device__ __forceinline__ uint4 add(const uint4& a, const uint4& b) {
  constexpr int E = Vec<T>::E;
  float fa[E], fb[E];
  Vec<T>::to_float(a, fa);
  Vec<T>::to_float(b, fb);
#pragma unroll
  for (int k = 0; k < E; ++k) fa[k] += fb[k];
  return Vec<T>::from_float(fa);
}

template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& a) {
  constexpr int E = Vec<T>::E;
  float f[E];
  Vec<T>::to_float(a, f);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < E; ++k) acc = fmaf(f[k], f[k], acc);
  return acc;
}

// s * r * g, rounded to T; g holds the E gains of the vector
template <typename T>
__device__ __forceinline__ uint4 scale(const uint4& s, float r,
                                       const float4* g) {
  constexpr int E = Vec<T>::E;
  float f[E];
  Vec<T>::to_float(s, f);
#pragma unroll
  for (int k = 0; k < E / 4; ++k) {
    f[4 * k] = f[4 * k] * r * g[k].x;
    f[4 * k + 1] = f[4 * k + 1] * r * g[k].y;
    f[4 * k + 2] = f[4 * k + 2] * r * g[k].z;
    f[4 * k + 3] = f[4 * k + 3] * r * g[k].w;
  }
  return Vec<T>::from_float(f);
}

// the sum of v over the block: shuffles within each warp, then the warps'
// sums in warp order through shared memory, so every thread gets the same
// bits
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) v += part[w];
  return v;
}

// One block a row. x, delta: (rows, d) of T as 16-byte vectors, delta read
// only when DELTA; out: with DELTA, s at out and h at out + rows * d, else
// h at out. Each thread holds VPL vectors of the row (0: the streaming
// variant).
template <typename T, int VPL, bool DELTA>
__global__ void __launch_bounds__(kThreads)
    subnet_rmsnorm_kernel(const uint4* __restrict__ x,
                          const uint4* __restrict__ delta,
                          const float* __restrict__ gamma_table,
                          const int* __restrict__ subnet_id,
                          uint4* __restrict__ out, int rows, int d,
                          float eps) {
  constexpr int E = Vec<T>::E;
  constexpr int G4 = E / 4;          // float4 gains a vector
  const int sid = __ldg(subnet_id);  // first: the gain row waits on it
  const int t = threadIdx.x;
  const int nvec = d / E;
  const size_t at = static_cast<size_t>(blockIdx.x) * nvec;
  uint4* s_out = out + at;
  uint4* h_out = out + (DELTA ? static_cast<size_t>(rows) * nvec : 0) + at;
  x += at;
  if constexpr (DELTA) delta += at;
  const float4* g = reinterpret_cast<const float4*>(
      gamma_table + static_cast<size_t>(sid) * d);
  float ss = 0.f;

  if constexpr (VPL > 0) {
    // small rows: the delta vectors and the gains get registers of their
    // own, so every load of the row is issued before the gains' (which
    // wait on subnet_id) and before any add; wide rows load the gains in
    // the output loop and add as delta arrives. Threads past the row's end
    // load its last vector again and store nothing, so the body is one
    // basic block the compiler can schedule whole.
    constexpr bool kEarly = VPL * E <= 48;
    int vc[VPL];
    uint4 s[VPL];
    uint4 dl[kEarly && DELTA ? VPL : 1];
    float4 gv[kEarly ? VPL * G4 : 1];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      vc[i] = min(i * kThreads + t, nvec - 1);
      s[i] = x[vc[i]];
    }
    if constexpr (kEarly) {
      if constexpr (DELTA) {
#pragma unroll
        for (int i = 0; i < VPL; ++i) dl[i] = delta[vc[i]];
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
#pragma unroll
        for (int k = 0; k < G4; ++k)
          gv[i * G4 + k] = __ldg(g + vc[i] * G4 + k);
      }
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const bool live = i * kThreads + t < nvec;
      if constexpr (DELTA) {
        if constexpr (kEarly) {
          s[i] = add<T>(s[i], dl[i]);
        } else {
          s[i] = add<T>(s[i], delta[vc[i]]);
        }
        if (live) s_out[vc[i]] = s[i];
      }
      const float sq = sum_sq<T>(s[i]);
      ss += live ? sq : 0.f;
    }
    const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      uint4 h;
      if constexpr (kEarly) {
        h = scale<T>(s[i], r, gv + i * G4);
      } else {
        float4 gl[G4];
#pragma unroll
        for (int k = 0; k < G4; ++k) gl[k] = __ldg(g + vc[i] * G4 + k);
        h = scale<T>(s[i], r, gl);
      }
      if (i * kThreads + t < nvec) h_out[vc[i]] = h;
    }
  } else {
    // streaming: s goes to memory (or stays x) and is read back by the
    // same thread for the second pass
    for (int v = t; v < nvec; v += kThreads) {
      uint4 s = x[v];
      if constexpr (DELTA) {
        s = add<T>(s, delta[v]);
        s_out[v] = s;
      }
      ss += sum_sq<T>(s);
    }
    const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);
    for (int v = t; v < nvec; v += kThreads) {
      const uint4 s = DELTA ? s_out[v] : x[v];
      float4 gl[G4];
#pragma unroll
      for (int k = 0; k < G4; ++k) gl[k] = __ldg(g + v * G4 + k);
      h_out[v] = scale<T>(s, r, gl);
    }
  }
}

using Kernel = void (*)(const uint4*, const uint4*, const float*, const int*,
                        uint4*, int, int, float);

// the smallest bucket that holds `per_thread` vectors, else streaming
template <typename T, bool DELTA>
Kernel pick(int per_thread) {
#define REPRO_BUCKET(n) \
  if (per_thread <= n) return subnet_rmsnorm_kernel<T, n, DELTA>;
  REPRO_BUCKET(1)
  REPRO_BUCKET(2)
  REPRO_BUCKET(4)
  REPRO_BUCKET(6)
  REPRO_BUCKET(8)
  REPRO_BUCKET(12)
  REPRO_BUCKET(16)
#undef REPRO_BUCKET
  return subnet_rmsnorm_kernel<T, 0, DELTA>;
}

template <typename T>
int launch(const void* x, const void* delta, const void* gamma_table,
           const void* subnet_id, void* out, int rows, int d, float eps,
           void* stream) {
  if (rows <= 0) return 0;
  // 16-byte vectors: d a multiple of 8 and every pointer 16-byte aligned
  if (d <= 0 || d % 8 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(delta) |
        reinterpret_cast<uintptr_t>(gamma_table) |
        reinterpret_cast<uintptr_t>(out)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_thread = (d / Vec<T>::E + kThreads - 1) / kThreads;
  const Kernel kernel = delta ? pick<T, true>(per_thread)
                              : pick<T, false>(per_thread);
  kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(delta),
      static_cast<const float*>(gamma_table),
      static_cast<const int*>(subnet_id), static_cast<uint4*>(out), rows, d,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, delta (null: no residual add), out: contiguous (rows, d) of one type
// (out: (2, rows, d) with delta); gamma_table: fp32 (n, d); subnet_id: one
// int32 on the device. Each returns the CUDA error code of the launch (0 =
// launched).
extern "C" int repro_subnet_rmsnorm_bf16(const void* x, const void* delta,
                                         const void* gamma_table,
                                         const void* subnet_id, void* out,
                                         int rows, int d, float eps,
                                         void* stream) {
  return launch<__nv_bfloat16>(x, delta, gamma_table, subnet_id, out, rows,
                               d, eps, stream);
}

extern "C" int repro_subnet_rmsnorm_f16(const void* x, const void* delta,
                                        const void* gamma_table,
                                        const void* subnet_id, void* out,
                                        int rows, int d, float eps,
                                        void* stream) {
  return launch<__half>(x, delta, gamma_table, subnet_id, out, rows, d, eps,
                        stream);
}

extern "C" int repro_subnet_rmsnorm_f32(const void* x, const void* delta,
                                        const void* gamma_table,
                                        const void* subnet_id, void* out,
                                        int rows, int d, float eps,
                                        void* stream) {
  return launch<float>(x, delta, gamma_table, subnet_id, out, rows, d, eps,
                       stream);
}
