// Causal GQA flash attention (prefill) for Hopper: bf16 in, tensor-core
// products with fp32 accumulation, fp32 online softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, _kernel, _kv_index). Same semantics: online softmax
// over kv tiles, causal mask, optional sliding window, a valid-kv length
// read from device memory, dead kv tiles skipped, and a fully masked row
// emits 0 (the "mask p again" step).
//
// Design. The TPU kernel carries m, l and the accumulator across a
// sequential kv grid axis; here blocks run in parallel, so the kv loop runs
// inside one block per (64-row q tile, query head, batch row), the kv head
// being hq / G. Four warps take 16 q rows each and keep their Q fragments,
// S = Q K^T, m, l and O in registers; S and O come from
// mma.sync.m16n8k16 (bf16 x bf16 -> fp32). P is rounded to bf16 and fed
// back as the A operand of P @ V straight from the S accumulators. Each
// 64-key tile of K is staged row-major and V transposed in shared memory,
// so every B fragment is one conflict-free 32-bit load; the staging walks
// key rows across the lanes so the transposing stores do not conflict.
//
// What bounds it: at serving shapes (S <= 256) the tile work is small and
// latency dominates; this version issues mma.sync from registers without
// TMA or wgmma (a later change), so it stays well above the bound of the
// bytes it must move.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;        // q rows per block (16 per warp)
constexpr int KT = 64;        // kv rows per tile
constexpr int THREADS = 128;  // four warps
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct FlashSmem {
  __nv_bfloat16 k[KT][HD + 8];      // row-major K tile (+8: spread banks)
  __nv_bfloat16 vt[HD][KT + 8];     // transposed V tile
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int G, int Sq, int Sk,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss,
                 int causal, int window, const int* __restrict__ kv_len_ptr,
                 int kv_len_static, float scale) {
  constexpr int KSTEPS = HD / 16;    // k-steps of Q K^T
  constexpr int NT_S = KT / 8;       // 8-key column tiles of S
  constexpr int NT_O = HD / 8;       // 8-dim column tiles of O
  constexpr int NCH = HD / 8;        // 16-byte chunks per row
  __shared__ __align__(16) unsigned char smem_raw[sizeof(FlashSmem<HD>)];
  FlashSmem<HD>& sm = *reinterpret_cast<FlashSmem<HD>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;           // mma group: row within 8
  const int t = lane & 3;            // thread in group: column pair
  const int q0 = blockIdx.x * QT;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / G;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  const __nv_bfloat16* qb = q + b * qsb + hq * qsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

  // A fragments of this warp's 16 q rows, straight from global memory
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int col = kk * 16 + 2 * t;
    qf[kk][0] = row0 < Sq ? ld32(qb + row0 * qss + col) : 0u;
    qf[kk][1] = row1 < Sq ? ld32(qb + row1 * qss + col) : 0u;
    qf[kk][2] = row0 < Sq ? ld32(qb + row0 * qss + col + 8) : 0u;
    qf[kk][3] = row1 < Sq ? ld32(qb + row1 * qss + col + 8) : 0u;
  }

  int kvl = kv_len_ptr != nullptr ? *kv_len_ptr : kv_len_static;
  kvl = max(0, min(kvl, Sk));
  // live kv tiles: from the window's first live tile to the causal
  // frontier of the tile's last row, clipped to kv_len
  int hi_pos = kvl;
  if (causal) hi_pos = min(hi_pos, q0 + QT);
  const int kt_hi = (hi_pos + KT - 1) / KT;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / KT : 0;
  const bool warp_live = q0 + warp * 16 < Sq;   // warp-uniform

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float oacc[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt)
    oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * KT;
    __syncthreads();                 // previous tile fully consumed
    for (int i = tid; i < KT * NCH; i += THREADS) {
      const int row = i % KT, ch = i / KT;
      uint4 uk = make_uint4(0, 0, 0, 0), uv = make_uint4(0, 0, 0, 0);
      if (k0 + row < Sk) {
        uk = *reinterpret_cast<const uint4*>(kb + (k0 + row) * kss + ch * 8);
        uv = *reinterpret_cast<const uint4*>(vb + (k0 + row) * vss + ch * 8);
      }
      *reinterpret_cast<uint4*>(&sm.k[row][ch * 8]) = uk;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&uv);
#pragma unroll
      for (int e = 0; e < 8; ++e) sm.vt[ch * 8 + e][row] = ve[e];
    }
    __syncthreads();
    if (!warp_live) continue;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const __nv_bfloat16* kr = &sm.k[nt * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, mask, and the online-softmax update of rows row0 / row1
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? row0 : row1;
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        bool ok = key < kvl;
        if (causal) ok = ok && key <= r;
        if (window > 0) ok = ok && key > r - window;
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = __expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked scores are NEG_INF exactly; they get p = 0 even on a
        // row with no live key so far (m == NEG_INF)
        const float sv = s[nt][e];
        s[nt][e] = sv > 0.5f * NEG_INF ? __expf(sv - m[e >> 1]) : 0.f;
        ls[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ls[i] += __shfl_xor_sync(FULL, ls[i], 1);
      ls[i] += __shfl_xor_sync(FULL, ls[i], 2);
      l[i] = l[i] * corr[i] + ls[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      oacc[nt][0] *= corr[0];
      oacc[nt][1] *= corr[0];
      oacc[nt][2] *= corr[1];
      oacc[nt][3] *= corr[1];
    }

    // O += P V: two 8-key S tiles form one 16-key A fragment
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const __nv_bfloat16* vr = &sm.vt[nt * 8 + g][kk * 16 + 2 * t];
        mma_bf16(oacc[nt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  __nv_bfloat16* ob = o + b * osb + hq * osh;
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * oss + col) =
          pack_bf16(oacc[nt][0] * inv0, oacc[nt][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row1 * oss + col) =
          pack_bf16(oacc[nt][2] * inv1, oacc[nt][3] * inv1);
  }
}

}  // namespace

// Strides are in elements; rows must be 16-byte aligned (checked by the
// Python wrapper). kv_len_ptr may be null, then kv_len_static is used.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int Hq, int Hkv, int Sq, int Sk, int head_dim,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss,
    int causal, int window, const void* kv_len_ptr, int kv_len_static,
    float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Sq + QT - 1) / QT, Hq, B);
  flash_fwd_kernel<128><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Hq / Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
      osb, osh, oss, causal, window, static_cast<const int*>(kv_len_ptr),
      kv_len_static, scale);
  return static_cast<int>(cudaGetLastError());
}
