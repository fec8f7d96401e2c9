// WeightSlice matmul for Hopper: y = x[:, :active_in] @ w[:active_in, :active_out],
// zeros past active_out; bf16 in, tensor-core products with fp32
// accumulation, bf16 out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sliced_matmul.py
// (sliced_matmul, _kernel) and its GPU-Pallas twin
// src/repro/kernels/triton_kernels.py (sliced_matmul, _sliced_kernel).
// Same semantics: the active widths are data (the TPU kernel's scalar
// prefetch); here they are int32 values in device memory read by every
// block, so actuating another subnet changes values, never the launch.
// K tiles past active_in are neither loaded nor computed, an N tile that
// starts at or past active_out writes zeros and returns, and the boundary
// tiles are masked: w rows past active_in load as zeros (cp.async
// zero-fill), rows past M are not stored, columns past active_out store 0.
//
// Segments. K may be cut into `nseg` equal segments of `seg` columns of x
// (rows of w), each with its own active prefix of active_in:
//   y[m, n] = sum_s sum_{k < active_in} x[m, s*seg + k] * w[s*seg + k, n].
// With nseg = 1 this is the plain WeightSlice product; with nseg = the
// number of KV heads it is the GQA output projection of a subnet that
// keeps the first active_in / head_dim query heads of every KV group, in
// one launch and with no copy of the per-group operands.
//
// Design. Blocks of 64 x 64 outputs, four warps of 32 x 32, each issuing
// mma.sync.m16n8k16 (bf16 x bf16 -> fp32) on fragments read with
// ldmatrix (x row-major; w row-major through .trans, which gives the B
// fragments without a transposed copy). 32-deep K tiles of x and w are
// staged in shared memory by a four-stage cp.async ring, rows padded by
// 16 bytes so the ldmatrix rows fall on distinct banks. Rows of x, w and
// y take any stride that keeps them 16-byte aligned.
//
// What bounds it: at the serving shapes (M = 8 to 128 rows against
// 1536 x 8960 weights) the weight bytes bound it, 2 bytes per weight for
// under 2 * 128 FLOPs, far below the 295 FLOP/byte of the H100. This
// version stays simple: no TMA, no wgmma, no split-K, so the FFN-down and
// output projections (N = 1536) run on 24 column tiles, under a fifth of
// the 132 SMs, at M <= 64 (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of y per block
constexpr int BN = 64;        // columns of y per block
constexpr int BK = 32;        // depth of one staged K tile
constexpr int STAGES = 4;     // cp.async ring depth
constexpr int THREADS = 128;  // four warps, 2 x 2 over the block tile
constexpr int XLD = BK + 8;   // 80-byte rows
constexpr int WLD = BN + 8;   // 144-byte rows

struct SlicedSmem {
  __nv_bfloat16 x[STAGES][BM][XLD];
  __nv_bfloat16 w[STAGES][BK][WLD];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false the destination is zero-filled and
// nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
sliced_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y,
                     int M, int N, int seg, int nseg,
                     long long xs, long long ws, long long ys,
                     const int* __restrict__ ai_ptr, int ai_static,
                     const int* __restrict__ ao_ptr, int ao_static) {
  __shared__ __align__(16) unsigned char smem_raw[sizeof(SlicedSmem)];
  SlicedSmem& sm = *reinterpret_cast<SlicedSmem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  int ai = ai_ptr != nullptr ? *ai_ptr : ai_static;
  int ao = ao_ptr != nullptr ? *ao_ptr : ao_static;
  ai = max(0, min(ai, seg));
  ao = max(0, min(ao, N));

  if (n0 >= ao) {              // inactive column tile: zeros, no loads
    for (int i = tid; i < BM * (BN / 8); i += THREADS) {
      const int r = m0 + i / (BN / 8);
      const int c = n0 + (i % (BN / 8)) * 8;
      if (r < M && c < N)
        *reinterpret_cast<uint4*>(y + r * ys + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const int kt_seg = (ai + BK - 1) / BK;     // live K tiles per segment
  const int T = kt_seg * nseg;

  // stage the K tile t (segment t / kt_seg) into ring slot `slot`
  auto load = [&](int slot, int t) {
    const int s = t / kt_seg;
    const int kb = (t - s * kt_seg) * BK;    // offset inside the segment
    const long long k0 = static_cast<long long>(s) * seg + kb;
#pragma unroll
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), ch = i % (BK / 8);
      // a chunk straddling active_in meets zero rows of w below
      const bool ok = m0 + r < M && kb + ch * 8 < ai;
      cp_async16(&sm.x[slot][r][ch * 8],
                 ok ? x + (m0 + r) * xs + k0 + ch * 8 : x, ok);
    }
#pragma unroll
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), ch = i % (BN / 8);
      const bool ok = kb + r < ai && n0 + ch * 8 < N;
      cp_async16(&sm.w[slot][r][ch * 8],
                 ok ? w + (k0 + r) * ws + n0 + ch * 8 : w, ok);
    }
  };

  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const bool live = m0 + wm < M;             // warp-uniform
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < T) load(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    cp_async_wait<STAGES - 2>();             // tile t has landed
    __syncthreads();                         // and slot t-1 is consumed
    if (t + STAGES - 1 < T) load((t + STAGES - 1) % STAGES, t + STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    const int slot = t % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], &sm.x[slot][wm + mi * 16 + (lane & 15)]
                                   [kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, &sm.w[slot][kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                                    [wn + nj * 16 + (lane >> 4) * 8]);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * tq;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= M) continue;
        const float v0 = col < ao ? acc[mi][ni][2 * h] : 0.f;
        const float v1 = col + 1 < ao ? acc[mi][ni][2 * h + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(y + row * ys + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// x: (M, K) rows of stride xs; w: (K, N) rows of stride ws; y: (M, N) rows
// of stride ys; strides in elements, rows 16-byte aligned (checked by the
// Python wrapper). K is cut into nseg segments of K / nseg columns. Each
// width pointer may be null, then its static value is used. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int repro_sliced_matmul_bf16(
    const void* x, const void* w, void* y, int M, int N, int K, int nseg,
    long long xs, long long ws, long long ys,
    const void* ai_ptr, int ai_static, const void* ao_ptr, int ao_static,
    void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (nseg <= 0 || K % nseg != 0 || (K / nseg) % 8 != 0 || N % 8 != 0 ||
      xs % 8 != 0 || ws % 8 != 0 || ys % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  sliced_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), M, N, K / nseg, nseg, xs, ws, ys,
      static_cast<const int*>(ai_ptr), ai_static,
      static_cast<const int*>(ao_ptr), ao_static);
  return static_cast<int>(cudaGetLastError());
}
