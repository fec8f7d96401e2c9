// Causal GQA flash attention (prefill) for Hopper: bf16 in, wgmma products
// with fp32 accumulation, fp32 online softmax, bf16 out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, _kernel, _kv_index) and its GPU-Pallas twin
// src/repro/kernels/triton_kernels.py (flash_attention). Same semantics:
// online softmax over kv tiles, causal mask, optional sliding window, a
// valid-kv length read from device memory, dead kv tiles neither loaded
// nor computed, and a fully masked row emits 0.
//
// What bounds it on the H100: at the served prompts (B = 8, S = 16, with
// qwen2-1.5b's 12 query heads over 2 kv heads) neither the bytes (0.27 us)
// nor the operations but the latency of one block's chain: a TMA load, two
// products, a store; at S = 256 the bytes, q, k, v and o once (4.4 us,
// against 1.6 us of causal tensor work); at S = 2048 the tensor cores'
// operations (103 GFLOP causal, 0.104 ms).
//
// Design. The TPU kernel walks kv on a sequential grid axis, carrying m, l
// and the accumulator in scratch; here one block runs the whole kv loop of
// its rows, and blocks of the longest loops start first. A block packs the
// rows of several query heads of one kv group into one 64-row wgmma tile:
// `nh` head slots of `np` positions each, head-major (packed row
// r = slot * np + position), so each kv tile is staged once for every head
// it serves. Every row masks by its own position; the block's kv loop runs
// from the window's first live tile of its first position to the causal
// frontier of its last. The head width is read on the card: a block loads
// and computes only the active heads of its group (a prefix), and writes
// zeros for the rest. One producer warp issues TMA loads
// (cp.async.bulk.tensor, 4-d maps over (d, position, head, batch), 128-byte
// swizzle, positions past S filled with zeros by the hardware): Q once,
// one box pair per live head slot, then K tiles of KT keys through a ring
// of 2 stages and V tiles through their own ring, each stage behind its
// own mbarriers; a K stage is handed back as soon as S = Q K^T is done, so
// the next K tile lands during the softmax and P V. One consumer
// warpgroup computes S = Q K^T by wgmma.m64n{KT}k16 with both operands in
// shared memory (K is (keys, d) row-major: a K-major B operand), the
// online softmax on the S accumulators in registers, and O += P V by
// wgmma.m64n128k16 with A = P from registers (the S accumulator layout is
// the A fragment layout, rounded to bf16) and B = the V tile, N-major (the
// transpose bit; SBO 1024 B, LBO KT * 128 B between the two 64-column
// boxes), so nothing is transposed by hand. Tiles that every row sees
// whole skip the mask. Three blocks share an SM, so one block's softmax
// and loads overlap the others' products. The packing, KT and the ring
// depths were chosen by measurement (kernels/flash_attention.py,
// pack_plan): 32-key tiles (two V stages) up to 32 positions, 64-key tiles
// (one V stage) beyond, at most 65 KB of shared memory a block either way:
// a second 64-key V stage costs the third block an SM and measured slower,
// and issuing a tile's S = Q K^T beside the previous tile's P V inside one
// warpgroup measured no faster, its unrolled code slower amid the model's
// other kernels. The epilogue stages O in the (now dead) Q rows,
// XOR-swizzled by 16-byte chunk, and writes whole 16-byte chunks. The
// tensor maps are cached by (pointer, shape, strides, box), so a call at a
// shape and buffer seen before encodes none.
//
// Head dims 64, 80, 120 and 128 run one body, instantiated at each d, on a
// head padded to HD = 128 columns on the SM: the maps are d wide, so the
// second 64-column box reads the columns past d as zeros (TMA fills what
// lies out of bounds; at d = 64 that box lies wholly past d and is all
// zeros), those columns add nothing to S = Q K^T, O's columns past d are
// 0, and only the d columns of a row are stored. The padding costs 2x the
// tensor work at d = 64, 1.6x at d = 80 and 1.07x at d = 120, and no bytes
// of device memory; the softmax scale d ** -0.5 comes from the host.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int HD = 128;                  // padded head dim: two 64-column
                                         // boxes, d <= HD
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int QM = 64;                   // packed rows per block
constexpr int THREADS = 128 + 32;        // one warpgroup + a producer warp
constexpr int Q_BYTES = 2 * QM * 128;    // two 64-column boxes

// KV tiles of KT keys: a ring of KS K tiles and one of VS V tiles, at
// most 65 KB of shared memory with Q, so that three blocks share an SM
// (two V stages of 64 keys would cost that third block). A K tile is
// handed back as soon as S = Q K^T is done, so the next one lands while
// the block does its softmax and P V.
template <int KT>
struct Tile {
  static constexpr int KS = 2;
  static constexpr int VS = KT == 32 ? 2 : 1;
  static constexpr int BOX_BYTES = KT * 128;        // one 64-column box
  static constexpr int KV_BYTES = 2 * BOX_BYTES;    // a K or a V tile
  static constexpr int NS = KT / 2;  // S accumulators of a thread
  // dynamic shared memory: Q, the K ring, the V ring; +1024 to align for
  // the swizzle
  static constexpr int SMEM = 1024 + Q_BYTES + (KS + VS) * KV_BYTES;
};

// What one block computes, decoded from its index. Blocks of the last
// position tiles (the longest kv loops) come first.
struct Work {
  int b, j;        // batch row, kv head
  int h0;          // first head slot of the group
  int q0, npos;    // first position, positions in range (<= np)
  int nls;         // live head slots (active heads from h0, <= nh)
  int lo, n;       // first kv tile, kv tiles
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64 fp32) = (accumulate ? d : 0) + A (64 x 16, K-major, desc_a)
// * B (16 x 64, K-major, desc_b)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32 fp32) = (accumulate ? d : 0) + A (64 x 16, K-major, desc_a)
// * B (16 x 32, K-major, desc_b)
__device__ __forceinline__ void wgmma_m64n32k16_ss(float* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, this thread's fragment a[0..3]) *
// B (16 x 128, N-major: the transpose bit, from desc_b)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The block's share of the launch. `hw` is the head width (-1: every
// head): under GQA the first hw / Hkv heads of every group are active,
// under MHA the first hw heads (the rule of models.attention.head_mask).
template <int KT>
__device__ Work decode(int idx, int B, int Hkv, int G, int Sq, int np,
                       int nh, int causal, int window, int kvl, int hw) {
  Work w;
  const int n_hb = (G + nh - 1) / nh, n_qb = (Sq + np - 1) / np;
  w.h0 = (idx % n_hb) * nh;
  idx /= n_hb;
  w.j = idx % Hkv;
  idx /= Hkv;
  w.b = idx % B;
  w.q0 = (n_qb - 1 - idx / B) * np;
  w.npos = min(np, Sq - w.q0);
  int active = G;
  if (hw >= 0) active = G > 1 ? min(G, hw / Hkv) : (w.j < hw ? 1 : 0);
  w.nls = max(0, min(nh, active - w.h0));
  // live kv tiles: from the window's first live tile of the first position
  // to the causal frontier of the last, clipped to kv_len (in [0, Sk])
  int hi = kvl;
  if (causal) hi = min(hi, w.q0 + w.npos);
  w.lo = window > 0 ? max(0, w.q0 - window + 1) / KT : 0;
  w.n = w.nls > 0 ? max(0, (hi + KT - 1) / KT - w.lo) : 0;
  return w;
}

// Scale (log2 domain), mask if some row sees part of the tile, and the
// online-softmax update of this thread's rows (qpos[0], qpos[1]): m and the
// thread's share of l, the factor `corr` for O, and P in bf16, laid out as
// the A fragments of P V (the S accumulator layout). Masked scores get
// p = 0 even on a row with no live key so far (m == NEG_INF).
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&s)[N], uint32_t (&pa)[N / 2], float (&m)[2], float (&l)[2],
    float (&corr)[2], bool edge, int k0, int t4, const int (&qpos)[2],
    int kvl, int causal, int window, float scale_log2) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int h = (e >> 1) & 1;
    float sv = s[e] * scale_log2;
    if (edge) {
      const int key = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
      bool ok = key < kvl;
      if (causal) ok = ok && key <= qpos[h];
      if (window > 0) ok = ok && key > qpos[h] - window;
      sv = ok ? sv : NEG_INF;
    }
    s[e] = sv;
    mx[h] = fmaxf(mx[h], sv);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const int h = (e >> 1) & 1;
    const float p0 = s[e] > 0.5f * NEG_INF ? ex2(s[e] - m[h]) : 0.f;
    const float p1 = s[e + 1] > 0.5f * NEG_INF ? ex2(s[e + 1] - m[h]) : 0.f;
    ls[h] += p0 + p1;
    pa[e >> 1] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
}

template <int KT, int D>
__global__ void __launch_bounds__(THREADS, 3)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tmq,
                 const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv,
                 __nv_bfloat16* __restrict__ o, int B, int Hkv, int G,
                 int Sq, int Sk, int np, int nh, long long osb,
                 long long osh, long long oss, int causal, int window,
                 const int* __restrict__ kv_len_ptr, int kv_len_static,
                 const int* __restrict__ hw_ptr, int hw_static,
                 float scale_log2) {
  using T = Tile<KT>;
  extern __shared__ unsigned char smem_raw[];
  // the q barrier, then full and empty barriers of each K and V stage
  __shared__ uint64_t bars[1 + 2 * (T::KS + T::VS)];
  // Q: box c (d columns 64 c..) of packed row r at c * QM * 128 + r * 128;
  // a K or V stage: two boxes of KT rows of 128 bytes
  unsigned char* qs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* kring = qs + Q_BYTES;
  unsigned char* vring = kring + T::KS * T::KV_BYTES;
  uint64_t* qbar = bars;
  uint64_t* full_k = qbar + 1;
  uint64_t* empty_k = full_k + T::KS;
  uint64_t* full_v = empty_k + T::KS;
  uint64_t* empty_v = full_v + T::VS;

  const int tid = threadIdx.x;
  if (tid == 128) {
    // the maps' descriptors, fetched while the block sets up
    asm volatile("prefetch.tensormap [%0];" :: "l"(&tmq) : "memory");
    asm volatile("prefetch.tensormap [%0];" :: "l"(&tmk) : "memory");
    asm volatile("prefetch.tensormap [%0];" :: "l"(&tmv) : "memory");
  }
  const int kvl = max(0, min(kv_len_ptr != nullptr ? *kv_len_ptr
                                                  : kv_len_static, Sk));
  const int hw = hw_ptr != nullptr ? max(0, *hw_ptr) : hw_static;
  const Work w = decode<KT>(blockIdx.x, B, Hkv, G, Sq, np, nh, causal,
                            window, kvl, hw);
  const bool live = w.n > 0;
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < T::KS; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&empty_k[i], 4);  // one arrival a consumer warp
    }
    for (int i = 0; i < T::VS; ++i) {
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_v[i], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // the producer warp: one thread loads Q, then keeps the ring full
    if (tid == 128 && live) {
      const int qh = w.j * G + w.h0;
      mbar_expect_tx(qbar, w.nls * 2 * np * 128);
      for (int s = 0; s < w.nls; ++s)
        for (int c = 0; c < 2; ++c)
          tma_load_4d(qs + c * QM * 128 + s * np * 128, &tmq, qbar, c * 64,
                      w.q0, qh + s, w.b);
      for (int it = 0; it < w.n; ++it) {
        const int ks = it % T::KS, kph = (it / T::KS) & 1;
        const int vs = it % T::VS, vph = (it / T::VS) & 1;
        const int k0 = (w.lo + it) * KT;
        unsigned char* kt = kring + ks * T::KV_BYTES;
        unsigned char* vt = vring + vs * T::KV_BYTES;
        mbar_wait(&empty_k[ks], kph ^ 1);
        mbar_expect_tx(&full_k[ks], T::KV_BYTES);
        tma_load_4d(kt, &tmk, &full_k[ks], 0, k0, w.j, w.b);
        tma_load_4d(kt + T::BOX_BYTES, &tmk, &full_k[ks], 64, k0, w.j, w.b);
        mbar_wait(&empty_v[vs], vph ^ 1);
        mbar_expect_tx(&full_v[vs], T::KV_BYTES);
        tma_load_4d(vt, &tmv, &full_v[vs], 0, k0, w.j, w.b);
        tma_load_4d(vt + T::BOX_BYTES, &tmv, &full_v[vs], 64, k0, w.j, w.b);
      }
    }
    return;
  }

  const int lane = tid & 31, t4 = lane & 3;
  // this thread's packed rows: r0 and r0 + 8
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int qpos[2] = {w.q0 + r0 % np, w.q0 + (r0 + 8) % np};
  float oacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) oacc[i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};

  if (live) {
    const int qlast = w.q0 + w.npos - 1;
    // S = Q K^T of the K tile in stage ks: 8 steps of 16 over d, four per
    // 64-column box of Q and of K
    auto qk = [&](float (&s)[T::NS], int ks) {
      const unsigned char* kt = kring + ks * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk >> 2, off = (kk & 3) * 32;
        const uint64_t da = smem_desc(qs + c * QM * 128 + off, 1, 64);
        const uint64_t db = smem_desc(kt + c * T::BOX_BYTES + off, 1, 64);
        if constexpr (KT == 64)
          wgmma_m64n64k16_ss(s, da, db, kk > 0);
        else
          wgmma_m64n32k16_ss(s, da, db, kk > 0);
      }
    };
    // O += P V of the V tile in stage vs: a step per 16 keys
    auto pv = [&](const uint32_t (&pa)[T::NS / 2], int vs) {
      const unsigned char* vt = vring + vs * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_m64n128k16_rs(oacc, &pa[4 * kk],
                            smem_desc(vt + kk * 16 * 128, T::BOX_BYTES / 16,
                                      64));
    };
    auto edge = [&](int k0) {
      return k0 + KT > kvl || (causal && k0 + KT - 1 > w.q0)
             || (window > 0 && k0 <= qlast - window);
    };
    // hand a stage back to the producer: one arrival a warp, after this
    // warp's wgmma reading it completed
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(qbar, 0);
    for (int it = 0; it < w.n; ++it) {
      const int ks = it % T::KS, kph = (it / T::KS) & 1;
      const int vs = it % T::VS, vph = (it / T::VS) & 1;
      const int k0 = (w.lo + it) * KT;
      float s[T::NS], corr[2];
      uint32_t pa[T::NS / 2];
      mbar_wait(&full_k[ks], kph);
      wgmma_fence();
      qk(s, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<T::NS>(s);
      release(&empty_k[ks]);
      softmax_tile(s, pa, m_i, l_i, corr, edge(k0), k0, t4, qpos, kvl,
                   causal, window, scale_log2);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        oacc[4 * i] *= corr[0];
        oacc[4 * i + 1] *= corr[0];
        oacc[4 * i + 2] *= corr[1];
        oacc[4 * i + 3] *= corr[1];
      }
      mbar_wait(&full_v[vs], vph);
      fence_acc(oacc);
      wgmma_fence();
      pv(pa, vs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(oacc);
      release(&empty_v[vs]);
    }
  }

  // epilogue: O / l through the Q rows (no longer read), 16-byte chunk c
  // of row r at box c / 8, chunk (c % 8) ^ (r % 8)
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_i[h] += __shfl_xor_sync(FULL, l_i[h], 1);
    l_i[h] += __shfl_xor_sync(FULL, l_i[h], 2);
    inv[h] = 1.f / fmaxf(l_i[h], 1e-30f);
  }
  if (live) {
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // consumers only
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        unsigned char* dst = qs + (i >> 3) * QM * 128 + r * 128
                             + (((i & 7) ^ (r & 7)) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(
            oacc[4 * i + 2 * h] * inv[h], oacc[4 * i + 2 * h + 1] * inv[h]);
      }
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  }
  // every packed row that is an output row of the block: a head slot below
  // nh inside the group, a position below S, its d / 8 chunks; slots at or
  // past nls (inactive heads) and blocks with no live kv tile write zeros
  for (int idx = tid; idx < QM * 16; idx += 128) {
    const int r = idx >> 4, c = idx & 15;
    const int slot = r / np, p = r % np;
    if (slot >= nh || w.h0 + slot >= G || p >= w.npos || 8 * c >= D)
      continue;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (live && slot < w.nls)
      val = *reinterpret_cast<const uint4*>(
          qs + (c >> 3) * QM * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
    __nv_bfloat16* dst = o + w.b * osb + (w.j * G + w.h0 + slot) * osh
                         + (w.q0 + p) * oss + c * 8;
    *reinterpret_cast<uint4*>(dst) = val;
  }
}

// -------------------------------------------------------------------------
// host side: tensor maps and the launch
// -------------------------------------------------------------------------

// a (B, H, S, d) bf16 tensor with element strides (sb, sh, ss), read in
// boxes of 64 columns (128 bytes) x `rows` positions of one head with the
// 128-byte swizzle; positions past S and columns past d load as zeros.
// Maps are cached by (pointer, shape, strides, box): the same key encodes
// the same map, and d is in the key, so storage reused at another head dim
// takes a map of its own.
std::mutex maps_mu;
std::map<std::array<long long, 9>, CUtensorMap> maps;
constexpr size_t MAPS_MAX = 4096;

bool tensor_map(CUtensorMap* map, const void* base, int B, int H, int S,
                int d, long long sb, long long sh, long long ss, int rows) {
  const std::array<long long, 9> key = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(base)), B, H, S, d,
      sb, sh, ss, rows};
  std::lock_guard<std::mutex> lock(maps_mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(S),
      static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (maps.size() >= MAPS_MAX) maps.clear();
  maps.emplace(key, *map);
  return true;
}

template <int KT, int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, int grid, int B, int Hkv, int G,
           int Sq, int Sk, int np, int nh, long long osb, long long osh,
           long long oss, int causal, int window, const void* kv_len_ptr,
           int kv_len_static, const void* hw_ptr, int hw_static,
           float scale_log2, cudaStream_t stream) {
  // dynamic shared memory above 48 KB, allowed once per device
  static uint64_t ready = 0;
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!(ready >> dev & 1)) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_kernel<KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          Tile<KT>::SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      ready |= 1ull << dev;
    }
  }
  flash_fwd_kernel<KT, D><<<grid, THREADS, Tile<KT>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, Hkv, G, Sq, Sk, np, nh,
      osb, osh, oss, causal, window, static_cast<const int*>(kv_len_ptr),
      kv_len_static, static_cast<const int*>(hw_ptr), hw_static, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tiles(int kt, const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, void* o, int grid, int B, int Hkv,
                 int G, int Sq, int Sk, int np, int nh, int causal, int window,
                 const void* kv_len_ptr, int kv_len_static, const void* hw_ptr,
                 int hw_static, int Hq, cudaStream_t stream) {
  static_assert(D % 8 == 0 && D <= HD, "a row is whole 16-byte chunks");
  const long long oss = static_cast<long long>(Hq) * D;
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  return kt == 64
      ? launch<64, D>(tq, tk, tv, o, grid, B, Hkv, G, Sq, Sk, np, nh,
                      Sq * oss, D, oss, causal, window, kv_len_ptr,
                      kv_len_static, hw_ptr, hw_static, scale_log2, stream)
      : launch<32, D>(tq, tk, tv, o, grid, B, Hkv, G, Sq, Sk, np, nh,
                      Sq * oss, D, oss, causal, window, kv_len_ptr,
                      kv_len_static, hw_ptr, hw_static, scale_log2, stream);
}

}  // namespace

// q: (B, Hq, Sq, d), k/v: (B, Hkv, Sk, d), bf16, d = head_dim in {64, 80,
// 120, 128}, any element strides (b, h, s) that are multiples of 8 with
// contiguous, 16-byte aligned rows (checked by the Python wrapper); o: a
// contiguous (B, Sq, Hq, d) buffer; softmax scale d ** -0.5. kv_len_ptr
// may be null, then kv_len_static is used; so may hw_ptr (the head width,
// read by every block), then hw_static (-1: every head is active).
// Inactive heads' outputs are written as zeros. `plan` packs the block's shape:
// np | nh << 8 | kt << 16, where a block takes nh head slots of np
// positions (np a multiple of 8, nh * np <= 64) and kv tiles of kt keys
// (32 or 64). The arguments are few on purpose: each
// costs the caller host time through ctypes. Returns the CUDA error code
// of the launch (0 = launched).
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int Hq, int Hkv, int Sq, int Sk, int head_dim,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    int causal, int window, const void* kv_len_ptr, int kv_len_static,
    const void* hw_ptr, int hw_static, int plan, void* stream) {
  const int np = plan & 0xff, nh = plan >> 8 & 0xff, kt = plan >> 16;
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if ((head_dim != 64 && head_dim != 80 && head_dim != 120 &&
       head_dim != HD) || Hkv <= 0 ||
      Hq % Hkv != 0 || Sk <= 0 || np <= 0 || np % 8 != 0 ||
      nh <= 0 || nh * np > QM || (kt != 32 && kt != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const long long blocks = static_cast<long long>(B) * Hkv
      * ((G + nh - 1) / nh) * ((Sq + np - 1) / np);
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  const int d = head_dim;
  if (!tensor_map(&tq, q, B, Hq, Sq, d, qsb, qsh, qss, np) ||
      !tensor_map(&tk, k, B, Hkv, Sk, d, ksb, ksh, kss, kt) ||
      !tensor_map(&tv, v, B, Hkv, Sk, d, vsb, vsh, vss, kt))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(blocks);
  switch (d) {
    case 64:
      return launch_tiles<64>(kt, tq, tk, tv, o, grid, B, Hkv, G, Sq, Sk, np,
                              nh, causal, window, kv_len_ptr, kv_len_static,
                              hw_ptr, hw_static, Hq, st);
    case 80:
      return launch_tiles<80>(kt, tq, tk, tv, o, grid, B, Hkv, G, Sq, Sk, np,
                              nh, causal, window, kv_len_ptr, kv_len_static,
                              hw_ptr, hw_static, Hq, st);
    case 120:
      return launch_tiles<120>(kt, tq, tk, tv, o, grid, B, Hkv, G, Sq, Sk,
                               np, nh, causal, window, kv_len_ptr,
                               kv_len_static, hw_ptr, hw_static, Hq, st);
    default:
      return launch_tiles<HD>(kt, tq, tk, tv, o, grid, B, Hkv, G, Sq, Sk, np,
                              nh, causal, window, kv_len_ptr, kv_len_static,
                              hw_ptr, hw_static, Hq, st);
  }
}
