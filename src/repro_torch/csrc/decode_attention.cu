// Single-token GQA decode attention over a KV cache for Hopper, in one
// launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention at :67, _kernel at :25). Same semantics: one query token
// per row against a (B, Hkv, Smax, d) cache; all G query heads of a kv head
// share one cache stream; with window == 0 only positions <= index are live
// and positions past index are neither read nor computed; with window > 0
// the rolling-buffer mask (index - pos) % Smax < min(window, index + 1).
// `index` is read from device memory, so a step is data, not a shape.
//
// What bounds it on the H100: bytes. A live position costs 4 * d bytes of
// K and V for each kv head and 4 * d FLOPs for each of its G query heads,
// so even at G = 8 the kernel does 8 FLOPs a byte against the card's 295:
// the cache has to stream at the memory rate, from many SMs at once (one
// block alone pulls far below the card's rate). At the served caches (16 to
// 256 slots) the live cache is small and the time is one block's chain of
// loads, products and stores after the launch, plus the merge of a row's
// splits.
//
// Design, for the bytes and for that chain.
// - The live range is split on the card. The TPU walks the cache in order
//   on one core; here the grid is fixed on the host from static facts alone
//   (B * Hkv rows times n_split, sized from the SM count), and every block
//   reads index (and window) and works out the live range, [0, index] or
//   the wrapped window of min(window, index + 1) slots, the chunk (the live
//   length over n_split, rounded up to UNIT positions, never below the
//   plan's least chunk), the number of live splits, and its own slice.
// - Each of a block's four warps takes its own 16-position units of the
//   slice (unit u to warp u % 4) and streams them through its own ring of
//   `STAGES` shared-memory stages of K and V filled by 16-byte cp.async, so
//   the next units' loads are in flight while this unit's products run; a
//   warp waits only for its own copies (no block-wide barrier per unit).
// - The products run on the tensor cores, mma.sync.m16n8k16 in bf16 with
//   fp32 sums, transposed so that no row is padding: S^T = K Q^T with the
//   unit's 16 positions as the rows and the group's G <= 8 query heads as
//   the 8 columns (Q^T held in registers for the whole slice, K through
//   ldmatrix); P^T, rounded to bf16 and transposed in registers
//   (movmatrix), is the B operand of O^T += V^T P^T, V through
//   ldmatrix.trans. Each warp keeps its own online-softmax state (log2
//   domain); the warps of a block merge in warp order through shared
//   memory.
// - The merge of a row's splits is folded in, through a thread-block
//   cluster: the grid's splits of a row are one cluster (n_split <= 16).
//   When the row has one live split (the served decode at caches of up to
//   64 slots), its block writes bf16 out and the others return at once.
//   Otherwise each live block leaves its fp32 partial (acc, m, l for its G
//   heads) in its own shared memory, the cluster meets at a barrier, the
//   live blocks each merge a share of the output from every split's
//   partial (distributed shared memory, split order) and write bf16, and a
//   second barrier keeps the partials until every read is done. Blocks
//   past the live splits load and write nothing and only meet the two
//   barriers. On the H100 this measured faster at every shape tried than a
//   merge through device memory (fp32 partials in scratch, the row's last
//   block found by an int32 counter), which pays three round trips to L2
//   on the critical path. No float atomics: the bits repeat from launch to
//   launch, and the wrapper allocates nothing but the output.
// - Head dims 64, 80, 120 and 128 run one body, instantiated at each d, that
//   works on a head padded to HD = 128 columns in shared memory and
//   registers: the copies past column d zero-fill, Q past d is zero, so
//   those columns add nothing to S = K Q^T and O's columns past d are 0
//   and are not stored. Rows in device memory are d wide, and d is a
//   compile-time constant of each instance, so every offset folds as it
//   did when 128 was the only width. The padding costs at most 2x the
//   tensor work (at d = 64), which is not what bounds the kernel, and no
//   bytes of device memory.
// The same schedule is written in Python (kernels/decode_attention.py,
// live_range / schedule / units) for the tests.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int HD = 128;         // head dim as laid out on the SM: d <= HD
                                // padded with zero columns
constexpr int G_MAX = 8;        // query heads per kv head: the 8 columns
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int UNIT = 16;        // cache positions a warp takes a stage
constexpr int LDS = HD + 8;     // row stride in bf16: 272 bytes, so the 8
                                // rows an ldmatrix reads fall on 8 banks
constexpr int STAGE_ELEMS = 2 * UNIT * LDS;   // K then V of one unit
constexpr int WLD = HD + 4;     // fp32 row stride of the warps' merge
constexpr int PART_TAIL = 16;   // m (8) and l (8) after a partial's G x HD
constexpr int MAX_SPLIT = 16;   // splits of a row: one cluster
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int STAGES>
constexpr int smem_bytes() {
  return WARPS * STAGES * STAGE_ELEMS * 2;
}
static_assert(smem_bytes<2>() >= (WARPS * G_MAX * WLD + 2 * WARPS * G_MAX
                                  + G_MAX * HD + PART_TAIL) * 4,
              "the merges reuse the ring");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with pred false the destination is zero-filled and
// nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// the transpose of an 8x8 b16 matrix held one row pair a lane (row
// lane / 4, columns 2 (lane % 4) and + 1), in the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// every thread of every block of the cluster; release, then acquire
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `local` in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The live range and the split of a row, from index and window: logical
// offsets j in [0, len) are cache positions (start + j) % Smax; `chunk`
// offsets a split, `n_live` splits (at least 1, so that an empty range
// still writes its zeros).
struct Schedule {
  int start, len, chunk, n_live;
};

__device__ __forceinline__ Schedule schedule(int index, int window, int smax,
                                             int n_split, int min_chunk) {
  Schedule s;
  int len = window > 0 ? min(window, index + 1) : index + 1;
  len = max(0, min(len, smax));
  s.len = len;
  s.start = window > 0 ? ((index - len + 1) % smax + smax) % smax : 0;
  const int per = (len + n_split - 1) / n_split;
  s.chunk = max(min_chunk, (per + UNIT - 1) / UNIT * UNIT);
  s.n_live = max(1, (len + s.chunk - 1) / s.chunk);
  return s;
}

template <int STAGES, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kc,
                        const __nv_bfloat16* __restrict__ vc,
                        const int* __restrict__ index_ptr,
                        __nv_bfloat16* __restrict__ out, int G, int Smax,
                        int window, int n_split, int min_chunk,
                        float scale_log2) {
  static_assert(D % 8 == 0 && D <= HD, "a row is whole 16-byte chunks");
  constexpr int d = D;                        // the row width in memory
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x / n_split;       // b * Hkv + kv head
  const int split = blockIdx.x - row * n_split;   // the rank in the cluster
  const Schedule sc = schedule(*index_ptr, window, Smax, n_split, min_chunk);
  if (split >= sc.n_live) {                   // past the live splits
    if (sc.n_live > 1) {                      // the cluster's two barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = split * sc.chunk;
  const int c1 = min(sc.len, c0 + sc.chunk);
  const int n_units = (max(c1 - c0, 0) + UNIT - 1) / UNIT;
  const int my_units = warp < n_units ? (n_units - warp + WARPS - 1) / WARPS
                                      : 0;

  const long long rbase = static_cast<long long>(row) * Smax * d;
  const __nv_bfloat16* kb = kc + rbase;
  const __nv_bfloat16* vb = vc + rbase;
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem) + warp * STAGES * STAGE_ELEMS;

  // this warp's t-th unit into ring stage st: lanes 0-15 and 16-31 take two
  // rows (2 * d contiguous bytes) an instruction; offsets past c1 and the
  // chunks at and past column d zero-fill
  auto load = [&](int st, int t) {
    const int j0 = c0 + (warp + t * WARPS) * UNIT;
    __nv_bfloat16* ks = ring + st * STAGE_ELEMS;
    __nv_bfloat16* vs = ks + UNIT * LDS;
    const int ch = (lane & 15) * 8;
#pragma unroll
    for (int i = 0; i < UNIT / 2; ++i) {
      const int r = (lane >> 4) + 2 * i;
      const int j = j0 + r;
      const bool ok = j < c1 && ch < d;
      int pos = sc.start + j;
      if (pos >= Smax) pos -= Smax;
      const long long off = ok ? static_cast<long long>(pos) * d + ch : 0;
      cp_async16(ks + r * LDS + ch, kb + off, ok);
      cp_async16(vs + r * LDS + ch, vb + off, ok);
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < my_units) load(st, st);
    cp_async_commit();
  }

  // Q^T as the B fragment of every k-step, columns = the group's heads
  // (past G zero): b0 = Q[g][16k + 2qd..], b1 = Q[g][16k + 8 + 2qd..],
  // zero at and past column d
  const int g8 = lane >> 2, qd = lane & 3;
  uint32_t qb[HD / 16][2];
  {
    const __nv_bfloat16* qrow =
        q + (static_cast<long long>(row) * G + g8) * d + 2 * qd;
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      qb[k][0] = g8 < G && 16 * k < d
                     ? *reinterpret_cast<const uint32_t*>(qrow + 16 * k)
                     : 0u;
      qb[k][1] = g8 < G && 16 * k + 8 < d
                     ? *reinterpret_cast<const uint32_t*>(qrow + 16 * k + 8)
                     : 0u;
    }
  }

  // O^T: m-tile t holds dims 16t + g8 (o[t][0..1]) and 16t + 8 + g8
  // (o[t][2..3]), heads 2qd (o[t][0], o[t][2]) and 2qd + 1
  float o[HD / 16][4];
#pragma unroll
  for (int t = 0; t < HD / 16; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  // heads 2qd and 2qd + 1; l over this lane's positions
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < my_units; ++t) {
    cp_async_wait<STAGES - 2>();              // unit t has landed
    __syncwarp();                             // every lane's copies, and
                                              // stage t-1 is consumed
    if (t + STAGES - 1 < my_units)
      load((t + STAGES - 1) % STAGES, t + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* ks = ring + (t % STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* vs = ks + UNIT * LDS;

    // S^T = K Q^T over the unit's 16 positions x 8 heads, in two chains
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      uint32_t a[4];
      ldsm_x4(a, ks + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + 16 * k
                     + (lane >> 4) * 8);
      if (k & 1)
        mma_bf16(sb, a, qb[k][0], qb[k][1]);
      else
        mma_bf16(sa, a, qb[k][0], qb[k][1]);
    }
    // s[0], s[1]: position g8, heads 2qd, 2qd + 1; s[2], s[3]: g8 + 8
    const int jb = c0 + (warp + t * WARPS) * UNIT + g8;
    const bool lo_ok = jb < c1, hi_ok = jb + 8 < c1;
    float s[4];
    s[0] = lo_ok ? (sa[0] + sb[0]) * scale_log2 : NEG;
    s[1] = lo_ok ? (sa[1] + sb[1]) * scale_log2 : NEG;
    s[2] = hi_ok ? (sa[2] + sb[2]) * scale_log2 : NEG;
    s[3] = hi_ok ? (sa[3] + sb[3]) * scale_log2 : NEG;

    // online softmax of each head over the unit: the max over the 8 lanes
    // of one qd; a unit holds a live position, so m_new is a score and
    // masked positions get exp2(NEG - m_new) = 0
    float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
    for (int x = 4; x < 32; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float c0f = exp2f(m0 - n0), c1f = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    s[0] = exp2f(s[0] - n0);
    s[1] = exp2f(s[1] - n1);
    s[2] = exp2f(s[2] - n0);
    s[3] = exp2f(s[3] - n1);
    l0 = l0 * c0f + s[0] + s[2];
    l1 = l1 * c1f + s[1] + s[3];
#pragma unroll
    for (int tt = 0; tt < HD / 16; ++tt) {
      o[tt][0] *= c0f;
      o[tt][1] *= c1f;
      o[tt][2] *= c0f;
      o[tt][3] *= c1f;
    }

    // P^T as the B fragment of O^T += V^T P^T: S^T's accumulator rounded to
    // bf16 and transposed in registers, 8 positions at a time
    const uint32_t pb0 = movmatrix_trans(pack_bf16(s[0], s[1]));
    const uint32_t pb1 = movmatrix_trans(pack_bf16(s[2], s[3]));
#pragma unroll
    for (int tt = 0; tt < HD / 16; ++tt) {
      uint32_t a[4];
      ldsm_x4_trans(a, vs + ((lane & 7) + (lane >> 4) * 8) * LDS + 16 * tt
                           + ((lane >> 3) & 1) * 8);
      mma_bf16(o[tt], a, pb0, pb1);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int x = 4; x < 32; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }

  // the warps' states merge in warp order through shared memory (the ring,
  // now free)
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem);   // [WARPS][G_MAX][WLD]
  float* wm = wacc + WARPS * G_MAX * WLD;          // [WARPS][G_MAX]
  float* wl = wm + WARPS * G_MAX;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int hd = 2 * qd + e;
    if (hd >= G) continue;
    float* dst = wacc + (warp * G_MAX + hd) * WLD + g8;
#pragma unroll
    for (int tt = 0; tt < HD / 16; ++tt) {
      dst[16 * tt] = o[tt][e];
      dst[16 * tt + 8] = o[tt][2 + e];
    }
    if (g8 == 0) {
      wm[warp * G_MAX + hd] = e ? m1 : m0;
      wl[warp * G_MAX + hd] = e ? l1 : l0;
    }
  }
  __syncthreads();

  const int dim = tid;                        // one dim a thread
  float num[G_MAX], den[G_MAX], mg[G_MAX];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g >= G) break;
    float M = wm[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, wm[w * G_MAX + g]);
    float dn = 0.f, nm = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(wm[w * G_MAX + g] - M);
      dn += f * wl[w * G_MAX + g];
      nm += f * wacc[(w * G_MAX + g) * WLD + dim];
    }
    mg[g] = M;
    den[g] = dn;
    num[g] = nm;
  }
  __nv_bfloat16* orow = out + static_cast<long long>(row) * G * d + dim;
  if (sc.n_live == 1) {                       // the only split: out, done
    if (dim < d) {
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g >= G) break;
        orow[g * d] = __float2bfloat16(num[g] / fmaxf(den[g], 1e-30f));
      }
    }
    return;
  }

  // the row's splits are one cluster: each live block's partial in its
  // own shared memory, one barrier, then each live block merges a share of
  // the output's float4 chunks, reading every split's partial in split
  // order, and a second barrier keeps the partials until all reads are done
  float* part = wl + WARPS * G_MAX;               // [G][HD], m[8], l[8]
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g >= G) break;
    part[g * HD + dim] = num[g];
    if (dim == 0) {
      part[G * HD + g] = mg[g];
      part[G * HD + 8 + g] = den[g];
    }
  }
  cluster_sync();
  // float4 chunk c of the output: head g, columns 4 (c % (d / 4)) + 0..3,
  // at chunk pc of the padded partial
  const int n_chunks = G * (d / 4);
  const int per = (n_chunks + sc.n_live - 1) / sc.n_live;   // <= THREADS
  const int c = split * per + tid;
  if (tid < per && c < n_chunks) {
    const int g = c / (d / 4);
    const int pc = g * (HD / 4) + c % (d / 4);
    const uint32_t local = smem_addr(part);
    float M = NEG, dn = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < sc.n_live; ++sp) {
      const uint32_t rp = map_rank(local, sp);
      const float ms = ld_cluster(rp + 4 * (G * HD + g));
      const float ls = ld_cluster(rp + 4 * (G * HD + 8 + g));
      const float4 v = ld_cluster4(rp + 16 * pc);
      const float mn = fmaxf(M, ms);
      const float fo = exp2f(M - mn), fs = exp2f(ms - mn);
      M = mn;
      dn = dn * fo + ls * fs;
      a.x = a.x * fo + v.x * fs;
      a.y = a.y * fo + v.y * fs;
      a.z = a.z * fo + v.z * fs;
      a.w = a.w * fo + v.w * fs;
    }
    dn = fmaxf(dn, 1e-30f);
    uint2 u;
    u.x = pack_bf16(a.x / dn, a.y / dn);
    u.y = pack_bf16(a.z / dn, a.w / dn);
    *reinterpret_cast<uint2*>(out + static_cast<long long>(row) * G * d
                              + 4 * c) = u;
  }
  cluster_sync();
}

template <int STAGES, int D>
int launch(const void* q, const void* k, const void* v, const void* index,
           void* out, int rows, int G, int Smax, int window, int n_split,
           int min_chunk, cudaStream_t stream) {
  // dynamic shared memory above 48 KB and clusters of up to 16 blocks,
  // allowed once per device
  static uint64_t ready = 0;
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!(ready >> dev & 1)) {
      cudaError_t err = cudaFuncSetAttribute(
          decode_attention_kernel<STAGES, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<STAGES>());
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            decode_attention_kernel<STAGES, D>,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
      ready |= 1ull << dev;
    }
  }
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;         // a row's splits
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * n_split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<STAGES>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<STAGES, D>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(index),
      static_cast<__nv_bfloat16*>(out), G, Smax, window, n_split, min_chunk,
      scale_log2);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int D>
int launch_stages(int stages, const void* q, const void* k, const void* v,
                  const void* index, void* out, int rows, int G, int Smax,
                  int window, int n_split, int min_chunk,
                  cudaStream_t stream) {
  switch (stages) {
    case 2:
      return launch<2, D>(q, k, v, index, out, rows, G, Smax, window,
                          n_split, min_chunk, stream);
    case 3:
      return launch<3, D>(q, k, v, index, out, rows, G, Smax, window,
                          n_split, min_chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, Hkv*G, 1, d), caches: (B, Hkv, Smax, d), out: (B, Hkv*G, 1, d),
// all contiguous bf16, d = head_dim in {64, 80, 120, 128}; softmax scale
// d ** -0.5. index: one int32 in device memory. The grid is B * Hkv
// clusters of n_split (1 to 16) blocks.
// `plan` packs min_chunk | stages << 16: the least positions a split takes
// (a multiple of 16) and the ring's depth (2 or 3). The arguments are few
// on purpose: each costs the caller host time through ctypes. Launches on
// `stream`, allocates nothing, and returns the CUDA error code of the
// launch (0 = launched).
extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* index_ptr, void* out, int B, int Hkv, int G, int Smax,
    int head_dim, int window, int n_split, int plan, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  const int min_chunk = plan & 0xffff, stages = plan >> 16;
  if (G < 1 || G > G_MAX || Smax < 1 || n_split < 1 ||
      n_split > MAX_SPLIT || min_chunk < UNIT || min_chunk % UNIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * Hkv;
  switch (head_dim) {
    case 64:
      return launch_stages<64>(stages, q, k_cache, v_cache, index_ptr, out,
                               rows, G, Smax, window, n_split, min_chunk, st);
    case 80:
      return launch_stages<80>(stages, q, k_cache, v_cache, index_ptr, out,
                               rows, G, Smax, window, n_split, min_chunk, st);
    case 120:
      return launch_stages<120>(stages, q, k_cache, v_cache, index_ptr, out,
                                rows, G, Smax, window, n_split, min_chunk,
                                st);
    case HD:
      return launch_stages<HD>(stages, q, k_cache, v_cache, index_ptr, out,
                               rows, G, Smax, window, n_split, min_chunk, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
