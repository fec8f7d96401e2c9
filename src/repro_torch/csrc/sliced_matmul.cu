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
//
// Segments. K may be cut into `nseg` equal segments of `seg` columns of x
// (rows of w), each with its own active prefix of active_in:
//   y[m, n] = sum_s sum_{k < active_in} x[m, s*seg + k] * w[s*seg + k, n].
// With nseg = 1 this is the plain WeightSlice product; with nseg = the
// number of KV heads it is the GQA output projection of a subnet that
// keeps the first active_in / head_dim query heads of every KV group, in
// one launch and with no copy of the per-group operands.
//
// What bounds it on the H100: at the serving shapes (M = 8 to 128 rows
// against 1536 x 8960 weights) the weight bytes, 2 bytes per weight for
// at most 2 * 128 FLOPs, far below the card's 295 FLOP/byte; from M = 512
// (a burst's prefill of 4 x 128 tokens) the tensor cores' operations.
//
// Schedule (for the bytes: every SM streaming, whatever the widths). The
// TPU kernel walks K on a sequential grid axis into an accumulator; on the
// card blocks run in parallel and in no order, and a grid that follows the
// output tiles leaves most SMs idle when N = 1536 or when half the columns
// are dead. So the grid is one block per SM, a static fact, and each block
// reads the widths and works out its share of the live work (make_plan):
// L live output tiles (column tiles starting below active_out) times T live
// K tiles (those below active_in, over all segments), each tile cut into S
// contiguous K ranges. S minimises the K steps of the busiest block plus
// SPLIT_COST steps for each split's fp32 partial: on the H100 a partial
// (written, fenced, counted, read back) costs about as much as 4 K steps,
// and an even division of the K steps over all blocks, which splits
// nearly every tile, measured slower than this plan at every serving
// shape. When the plan leaves blocks spare in a single round, the first
// tiles take one split more each. Unit u (a tile and a split, numbered
// tile by tile) goes to block u mod grid; dead tiles are zero-written by
// block d mod grid. A tile of one split writes bf16; otherwise every split
// writes an fp32 partial to workspace slot u, and the last block to arrive
// on the tile (an integer counter, __threadfence before the increment)
// sums the slots in split order and writes bf16, then resets the counter
// for the next launch (a 256-column tile does this for each 128-column
// half apart, with a counter and half a slot each). No float atomics: the bits repeat from launch to
// launch. The same plan is written in Python (kernels/sliced_matmul.py,
// split_plan) for the tests.
//
// A stack of experts. x (E, M, K), w (E, K, N) and y (E, M, N) hold E
// independent products that share the widths, y[e] = x[e] @ w[e] sliced as
// above, all in one launch (MoE switch mode: every expert's gate, up or
// down projection at once). The tensor maps are 3-d, so a row tile past M
// inside one expert loads zeros from the hardware, never the next
// expert's rows; the live tiles are (expert, row tile, column tile),
// expert-major, and the plan is the one above over E times as many tiles
// (at E x live tiles >= grid it splits no tile, so the scratch does not
// grow with E). A 2-d product is the stack of one.
//
// Main loop (for the bytes: many in flight without spending threads on
// them; for the operations at M >= 1024: wgmma). Tiles of BM x BN outputs
// and 64-deep K steps; BM = 64 up to M = 128 (one warpgroup; twice the
// output tiles of 128-row ones, so fewer K splits, for a second read of
// each weight tile that the other row tile's block, running beside it,
// finds in L2), else 128 (two warpgroups). A producer keeps a ring of
// STAGES shared-memory stages full with TMA (cp.async.bulk.tensor,
// 128-byte swizzle, rows past M and columns past K or N filled with zeros
// by the hardware), each stage signalled through an mbarrier; each
// consumer warpgroup issues four wgmma.mma_async.m64nBNk16 a stage, A (x)
// K-major and B (w, row-major (K, N), so N-major: the transpose bit) read
// from shared memory by descriptor, one wgmma group kept in flight. TMA
// loads whole weight rows, so on the last live K tile of a segment the
// consumers zero the w rows at and past active_in in shared memory (each
// row is one 128-byte swizzle line, which the swizzle does not move) and
// fence the async proxy before the wgmma reads them; x past active_in then
// meets zeros, whatever it holds. The epilogue stages the tile in shared
// memory, 128 columns a round, so that partials, sums and the bf16 output
// move as 16-byte chunks over the tile's live rows only (8 of 64 at a
// decode step). The tensor maps are encoded on the host: x's per call,
// w's cached by (pointer, shape, stride).
//
// Two column tiles (for the operations: the tensor cores of a burst's
// prefill). BN = 128, or 256 past M = 128: a consumer warpgroup then owns
// a 64 x 256 slice (wgmma m64n256k16, 128 fp32 accumulators a thread), a
// stage holds four 64-column boxes of w, and each stage's x tile feeds
// twice the columns, so the shared memory read and the barrier rounds per
// product halve; a whole producer warpgroup gives its registers to the
// consumers (setmaxnreg, see Tiles). The host picks BN per launch from the
// static shapes and the grid (kernels/sliced_matmul.py, block_cols),
// never from the widths: the wide tile where, at the full width, its
// tiles number at least two grids, or half a grid over at least 64 K
// steps. There it measured 1.1-1.45x faster on the H100 (qwen2-1.5b's FFN
// up from M = 1024, down from 2048; mixtral-8x7b's expert stacks from 160
// slots an expert and its wo from M = 1024); with fewer tiles a launch
// splits them, and a wide tile's partial, twice the bytes, costs more
// than its faster K steps save.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <tuple>
#include <map>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;          // depth of one K step: one 128-byte row of x
constexpr int WBOX = 64;        // columns of w per TMA box: 128 bytes
constexpr int SBN = 128;        // columns of the epilogue's staging tile
constexpr int WS_TILES = 1;     // workspace tiles per block of the grid
constexpr int SPLIT_COST = 4;   // a split's partial, in K steps (see make_plan)

// A block tile of BM x BN outputs: BM / 64 consumer warpgroups, each a
// 64 x BN slice (wgmma m64nBNk16), BN / 64 TMA boxes of w a stage. The
// 128 x 256 tile takes three stages of 48 KB (four do not fit beside the
// staging tile), the others four of 16 + 16 or 8 + 16 KB. Its 128 fp32
// accumulators a thread do not fit the 168 registers a thread of a
// 288-thread block gets (the SM allots warps by fours), so its producer
// is a whole warpgroup that hands its registers to the consumers
// (setmaxnreg): PRODUCER_REGS a producer thread, CONSUMER_REGS a
// consumer's, 384 threads in all within the SM's 65,536.
template <int BM, int BN>
struct Tiles {
  static constexpr int NWG = BM / 64;                // consumer warpgroups
  static constexpr int CONSUMERS = NWG * 128;
  static constexpr int PRODUCERS = BN == 256 ? 128 : 32;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int NBOX = BN / WBOX;             // w boxes a stage
  static constexpr int HALVES = BN / SBN;            // staging rounds
  static constexpr int ACC = BN / 2;                 // fp32 accumulators
  static constexpr int STAGES = BN == 256 ? 3 : 4;   // TMA ring depth
  static constexpr int X_BYTES = BM * BK * 2;
  static constexpr int W_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  // the epilogue's fp32 tile of SBN columns, rows padded by 8 floats so
  // that the accumulator rows of one store fall on distinct banks; a
  // 256-column tile goes through it in two rounds
  static constexpr int STG_BYTES = BM * (SBN + 8) * 4;
  // ring, staging tile, then full and empty barriers; +1024 to align
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + STG_BYTES + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "over the H100's shared memory a block");
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
  static_assert(PRODUCERS < 128 || PRODUCERS * PRODUCER_REGS
                + CONSUMERS * CONSUMER_REGS <= 65536, "over the registers");
};

// The division of the live work among the blocks of BN-column tiles (see
// the header).
template <int BN>
struct Plan {
  int ne;          // experts
  int mt, nt;      // row and column tiles of one expert's y
  int nl;          // live column tiles
  int kl, T;       // live K tiles per segment, over all segments
  int S, E, U;     // splits per live tile (S + 1 for tiles t < E), units
  int n_dead;      // dead tiles (ne x mt x (nt - nl))

  // unit u: live tile t, split s of n, numbered tile by tile
  __device__ void unit(int u, int& t, int& s, int& n) const {
    if (u < E * (S + 1)) {
      n = S + 1;
      t = u / n;
      s = u - t * n;
    } else {
      const int v = u - E * (S + 1);
      n = S;
      t = E + v / S;
      s = v - (t - E) * S;
    }
  }
  // workspace slot (= unit) of split 0 of live tile t
  __device__ int first_slot(int t) const {
    return t < E ? t * (S + 1) : E * (S + 1) + (t - E) * S;
  }
  // expert, first row and first column of live tile t: rows vary
  // fastest, then columns, then experts
  __device__ void place(int t, int bm, int& e, int& m0, int& n0) const {
    e = t / (mt * nl);
    const int r = t - e * mt * nl;
    m0 = (r % mt) * bm;
    n0 = (r / mt) * BN;
  }
  // the same of dead tile d (its columns from nl on)
  __device__ void place_dead(int d, int bm, int& e, int& m0, int& n0) const {
    const int per = mt * (nt - nl);
    e = d / per;
    const int r = d - e * per;
    m0 = (r % mt) * bm;
    n0 = (nl + r / mt) * BN;
  }
};

__device__ __forceinline__ long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// Every thread of the block calls this with the same arguments. The
// candidates S = 1..min(T, WS_TILES * grid / L) are costed in parallel:
// ceil(L * S / grid) * ceil(T / S) K steps for the busiest block, plus
// SPLIT_COST * S for a split tile's fp32 partials (written, then read back
// by its last block), which measured on the H100 at about SPLIT_COST K
// steps each; the least cost wins, the smallest S among equals.
template <int BN>
__device__ Plan<BN> make_plan(unsigned long long* best, int ne, int M, int N,
                              int nseg, int ai, int ao, int grid, int bm) {
  Plan<BN> p;
  p.ne = ne;
  p.kl = (ai + BK - 1) / BK;
  p.T = p.kl * nseg;
  p.nl = p.T > 0 ? (ao + BN - 1) / BN : 0;
  p.mt = (M + bm - 1) / bm;
  p.nt = (N + BN - 1) / BN;
  p.n_dead = ne * p.mt * (p.nt - p.nl);
  const int L = ne * p.mt * p.nl;
  if (threadIdx.x == 0) *best = ~0ull;
  __syncthreads();
  if (L > 0) {
    const int top = max(1, min(p.T, WS_TILES * grid / L));
    unsigned long long mine = ~0ull;
    for (int s = threadIdx.x + 1; s <= top; s += blockDim.x) {
      const long long cost =
          s == 1 ? cdiv(L, grid) * p.T
                 : cdiv(static_cast<long long>(L) * s, grid) * cdiv(p.T, s)
                       + SPLIT_COST * s;
      const unsigned long long key =
          (static_cast<unsigned long long>(cost) << 16) | s;
      mine = key < mine ? key : mine;
    }
    if (mine != ~0ull) atomicMin(best, mine);
  }
  __syncthreads();
  p.S = L > 0 ? static_cast<int>(*best & 0xffff) : 1;
  // one round: the spare blocks each take one more split of a tile
  p.E = L * p.S < grid && p.S < p.T ? min(L, grid - L * p.S) : 0;
  p.U = L * p.S + p.E;
  return p;
}

// d (64 x 128 fp32, this thread's 64 values) += A (64 x 16, K-major, from
// desc_a) * B (16 x 128, N-major: the transpose bit, from desc_b)
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 256 fp32, this thread's 128 values) += A (64 x 16, K-major) *
// B (16 x 256, N-major), as above with twice the columns
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// one staging round: this thread's accumulators of SBN columns (64 of
// them, acc[4 i + 2 hh + {0, 1}] at row r0 + 8 hh, columns 8 i + c0 + {0,
// 1}) into the staging tile, fenced on both sides among the consumers
template <int NC>
__device__ __forceinline__ void stage_round(float* stg, const float* acc,
                                            int r0, int c0) {
  constexpr int LD = SBN + 8;
  consumers_sync<NC>();                       // the last reads done
#pragma unroll
  for (int i = 0; i < SBN / 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(stg + (r0 + 8 * hh) * LD + 8 * i + c0) =
          make_float2(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
  consumers_sync<NC>();
}

template <int BM, int BN>
__global__ void __launch_bounds__(Tiles<BM, BN>::THREADS, 1)
sliced_matmul_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmw,
                     __nv_bfloat16* __restrict__ y, int ne, int M, int N,
                     int seg, int nseg, long long ys, long long yes,
                     const int* __restrict__ ai_ptr, int ai_static,
                     const int* __restrict__ ao_ptr, int ao_static,
                     float* __restrict__ part, int* __restrict__ counters) {
  using TL = Tiles<BM, BN>;
  constexpr int NC = TL::CONSUMERS;
  constexpr int STAGES = TL::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ unsigned long long best;
  __shared__ int last;
  // stage st: BM rows of x (128 bytes each), then the BN / 64 boxes of w
  // (BK rows of 128 bytes each), 1024-byte aligned for the swizzle
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* stg = reinterpret_cast<float*>(ring + STAGES * TL::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + STAGES * TL::STAGE_BYTES + TL::STG_BYTES);
  uint64_t* empty = full + STAGES;
  constexpr int LD = SBN + 8;                 // staging row, in floats
  constexpr int CH = SBN / 8;                 // 8-column chunks of a row
  constexpr int KCH = BM * CH / NC;           // chunks of a round per thread

  const int tid = threadIdx.x;
  int ai = ai_ptr != nullptr ? *ai_ptr : ai_static;
  int ao = ao_ptr != nullptr ? *ao_ptr : ao_static;
  ai = max(0, min(ai, seg));
  ao = max(0, min(ao, N));
  const Plan<BN> p =
      make_plan<BN>(&best, ne, M, N, nseg, ai, ao, gridDim.x, BM);
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NC) {
    // the producer: one thread walks this block's units and keeps the
    // ring full
    if constexpr (TL::PRODUCERS == 128) setmaxnreg_dec<TL::PRODUCER_REGS>();
    if (tid == NC) {
      int stage = 0, phase = 0;
      for (int u = blockIdx.x; u < p.U; u += gridDim.x) {
        int t, split, n, e, m0, n0;
        p.unit(u, t, split, n);
        p.place(t, BM, e, m0, n0);
        const int j1 = (split + 1) * p.T / n;
        for (int j = split * p.T / n; j < j1; ++j) {
          const int s = j / p.kl;
          const int k0 = s * seg + (j - s * p.kl) * BK;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * TL::STAGE_BYTES;
          mbar_expect_tx(&full[stage], TL::STAGE_BYTES);
          tma_load_3d(st, &tmx, &full[stage], k0, m0, e);
#pragma unroll
          for (int b = 0; b < TL::NBOX; ++b)
            tma_load_3d(st + TL::X_BYTES + b * BK * WBOX * 2, &tmw,
                        &full[stage], n0 + b * WBOX, k0, e);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  if constexpr (TL::PRODUCERS == 128) setmaxnreg_inc<TL::CONSUMER_REGS>();
  // consumers: dead tiles first (stores only, while the ring fills)
  for (int d = blockIdx.x; d < p.n_dead; d += gridDim.x) {
    int e, m0, n0;
    p.place_dead(d, BM, e, m0, n0);
    __nv_bfloat16* ye = y + e * yes;
    for (int i = tid; i < BM * (BN / 8); i += NC) {
      const int r = m0 + i / (BN / 8);
      const int c = n0 + (i % (BN / 8)) * 8;
      if (r < M && c < N)
        *reinterpret_cast<uint4*>(ye + r * ys + c) = make_uint4(0, 0, 0, 0);
    }
  }

  const int wg = tid >> 7, lane = tid & 31;
  // this thread's accumulator rows (+ 8) and columns (+ 8 i) in the tile
  const int r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float acc[TL::ACC];
  int stage = 0, phase = 0, prev = 0;
  for (int u = blockIdx.x; u < p.U; u += gridDim.x) {
    // unit u: K tiles [j0, j1) of live tile t, split `split` of n
    int t, split, n, e, m0, n0;
    p.unit(u, t, split, n);
    p.place(t, BM, e, m0, n0);
    const int j0 = split * p.T / n, j1 = (split + 1) * p.T / n;
    // a fresh accumulator: the last tile's is dead once staged, which
    // leaves the epilogue its registers
#pragma unroll
    for (int i = 0; i < TL::ACC; ++i) acc[i] = 0.f;
    for (int j = j0; j < j1; ++j) {
      const int kb = (j % p.kl) * BK;         // offset inside the segment
      const int live = min(BK, ai - kb);      // live rows of w in this tile
      mbar_wait(&full[stage], phase);
      unsigned char* xt = ring + stage * TL::STAGE_BYTES;
      unsigned char* wt = xt + TL::X_BYTES;
      if (live < BK) {
        // w rows at and past active_in: zero, whole 128-byte lines
        const int chunks = (BK - live) * 8;
        for (int i = tid; i < TL::NBOX * chunks; i += NC)
          *reinterpret_cast<uint4*>(wt + (i / chunks) * BK * 128 + live * 128
                                    + (i % chunks) * 16) = make_uint4(0, 0, 0, 0);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync<NC>();
      }
      fence_acc<TL::ACC>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 64 rows of 128 bytes, 8-row groups 1024 bytes apart; a 16-deep
        // step is 32 bytes along the row. B: 16 rows of 128 bytes per step,
        // each next 64-column box BK * 128 bytes on
        const uint64_t da = smem_desc(xt + wg * 64 * 128 + kk * 32, 1, 64);
        const uint64_t db = smem_desc(wt + kk * 16 * 128, BK * 128 / 16, 64);
        if constexpr (BN == 256)
          wgmma_m64n256k16(acc, da, db);
        else
          wgmma_m64n128k16(acc, da, db);
      }
      wgmma_commit();
      // one group stays in flight: the previous stage's is done, so its
      // buffer goes back to the producer
      wgmma_wait<1>();
      fence_acc<TL::ACC>(acc);
      if (j > j0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc<TL::ACC>(acc);
    mbar_arrive(&empty[prev]);

    // the tile through shared memory, SBN columns a round, so that global
    // memory sees whole 16-byte chunks of 8 columns, over the tile's live
    // rows only. A split tile's rounds are summed apart: round h of split
    // s has its own workspace slot, (first_slot(t) + s) * HALVES + h, and
    // its own arrival counter, t * HALVES + h.
    const int chunks = min(BM, M - m0) * CH;
#pragma unroll
    for (int h = 0; h < TL::HALVES; ++h) {
      stage_round<NC>(stg, acc + h * SBN / 2, r0, c0);
      if (n > 1) {
        // this split's partial of the round to its slot; the last block
        // on the round sums the slots of its splits in order 0..n-1 into
        // the staging tile
        float* slot = part + (static_cast<long long>(u) * TL::HALVES + h)
                                 * BM * SBN;
        for (int c = tid; c < chunks; c += NC) {
          const float4* src = reinterpret_cast<const float4*>(
              stg + (c / CH) * LD + (c % CH) * 8);
          float4* dst = reinterpret_cast<float4*>(slot + c * 8);
          dst[0] = src[0];
          dst[1] = src[1];
        }
        __threadfence();
        consumers_sync<NC>();
        if (tid == 0) {
          int* counter = counters + t * TL::HALVES + h;
          const int arrived = atomicAdd(counter, 1);
          last = arrived == n - 1;
          if (last) *counter = 0;             // ready for the next launch
        }
        consumers_sync<NC>();
        if (!last) continue;
        __threadfence();
        for (int s = 0; s < n; ++s) {
          // all of a slot's loads in flight at once; each thread adds into
          // the staging chunks it alone touches
          const float* src =
              part + ((static_cast<long long>(p.first_slot(t)) + s)
                          * TL::HALVES + h) * BM * SBN;
          float4 q[KCH][2];
#pragma unroll
          for (int k = 0; k < KCH; ++k) {
            const int c = tid + k * NC;
            if (c < chunks) {
              q[k][0] = __ldcg(reinterpret_cast<const float4*>(src + c * 8));
              q[k][1] =
                  __ldcg(reinterpret_cast<const float4*>(src + c * 8 + 4));
            }
          }
#pragma unroll
          for (int k = 0; k < KCH; ++k) {
            const int c = tid + k * NC;
            if (c >= chunks) continue;
            float4* acc4 =
                reinterpret_cast<float4*>(stg + (c / CH) * LD + (c % CH) * 8);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              if (s == 0) {
                acc4[hh] = q[k][hh];
              } else {
                float4 a4 = acc4[hh];
                a4.x += q[k][hh].x;
                a4.y += q[k][hh].y;
                a4.z += q[k][hh].z;
                a4.w += q[k][hh].w;
                acc4[hh] = a4;
              }
            }
          }
        }
      }
      // bf16 out from the staging tile, zeros past active_out
      for (int c = tid; c < chunks; c += NC) {
        const int col = n0 + h * SBN + (c % CH) * 8;
        if (col >= N) continue;
        const float* src = stg + (c / CH) * LD + (c % CH) * 8;
        uint32_t packed[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(
              col + 2 * q < ao ? src[2 * q] : 0.f,
              col + 2 * q + 1 < ao ? src[2 * q + 1] : 0.f);
          packed[q] = *reinterpret_cast<const uint32_t*>(&b2);
        }
        *reinterpret_cast<uint4*>(y + e * yes + (m0 + c / CH) * ys + col) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }
}

// -------------------------------------------------------------------------
// host side: tensor maps and the launch
// -------------------------------------------------------------------------

// a stack of `ne` (rows, cols) bf16 matrices, rows `stride` and matrices
// `estride` elements apart, read in boxes of box_rows x 64 columns (128
// bytes) of one matrix with the 128-byte swizzle; what lies outside a
// matrix loads as zeros
bool encode(CUtensorMap* map, const void* base, long long ne, long long rows,
            long long cols, long long stride, long long estride,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(ne)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(stride) * 2,
                                 static_cast<cuuint64_t>(estride) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// weight maps by (pointer, experts, rows, columns, strides): the weights
// live for the model's life, so each is encoded once
std::mutex weight_maps_mu;
std::map<std::tuple<const void*, int, int, int, long long, long long>,
         CUtensorMap> weight_maps;
constexpr size_t WEIGHT_MAPS_MAX = 4096;

bool weight_map(CUtensorMap* map, const void* w, int ne, int K, int N,
                long long ws, long long wes) {
  const auto key = std::make_tuple(w, ne, K, N, ws, wes);
  std::lock_guard<std::mutex> lock(weight_maps_mu);
  const auto it = weight_maps.find(key);
  if (it != weight_maps.end()) {
    *map = it->second;
    return true;
  }
  if (!encode(map, w, ne, K, N, ws, wes, BK)) return false;
  if (weight_maps.size() >= WEIGHT_MAPS_MAX) weight_maps.clear();
  weight_maps.emplace(key, *map);
  return true;
}

template <int BM, int BN>
int launch(const CUtensorMap& tmx, const CUtensorMap& tmw, void* y, int ne,
           int M, int N, int seg, int nseg, long long ys, long long yes,
           const void* ai_ptr,
           int ai_static, const void* ao_ptr, int ao_static, void* part,
           void* counters, int grid, cudaStream_t stream) {
  // dynamic shared memory above 48 KB, allowed once per device
  static uint64_t ready = 0;
  static std::mutex mu;
  int dev = 0;
  cudaGetDevice(&dev);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!(ready >> dev & 1)) {
      const cudaError_t err = cudaFuncSetAttribute(
          sliced_matmul_kernel<BM, BN>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<BM, BN>::SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      ready |= 1ull << dev;
    }
  }
  sliced_matmul_kernel<BM, BN><<<grid, Tiles<BM, BN>::THREADS,
                                 Tiles<BM, BN>::SMEM, stream>>>(
      tmx, tmw, static_cast<__nv_bfloat16*>(y), ne, M, N, seg, nseg, ys, yes,
      static_cast<const int*>(ai_ptr), ai_static,
      static_cast<const int*>(ao_ptr), ao_static, static_cast<float*>(part),
      static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// output rows of one block tile: one warpgroup's 64 up to M = 128, two
// warpgroups' 128 beyond
int block_rows(int M) { return M <= 128 ? 64 : 128; }

// the tiles there are: 64 x 128, 128 x 128 and 128 x 256 (see the header)
bool tile_ok(int M, int bn) {
  return bn == 128 || (bn == 256 && block_rows(M) == 128);
}

// the scratch one launch may touch: WS_TILES fp32 tiles per block, and one
// arrival counter per staging round (bn / SBN of them) of each live tile
// that may be split. A tile is split either
// when S > 1, and then L * S <= WS_TILES * grid gives L <= WS_TILES * grid
// / 2, or when the spare blocks of one round split it, and then L < grid.
// L counts the tiles of every expert, so neither bound depends on E.
long long workspace_elems(int M, int bn, int grid) {
  return static_cast<long long>(WS_TILES) * grid * block_rows(M) * bn;
}
long long workspace_counters(int bn, int grid) {
  return (bn / SBN) * (grid > WS_TILES * grid / 2 ? grid : WS_TILES * grid / 2);
}

}  // namespace

// The scratch of an M-row launch of bn-column tiles on `grid` blocks:
// `part_elems` fp32 elements and `n_counters` int32 counters, zero before
// the first launch (every launch leaves them zero). The wrapper sizes its
// buffers from this alone. Returns 0, or cudaErrorInvalidValue for a tile
// there is not.
extern "C" int repro_sliced_matmul_workspace(int M, int bn, int grid,
                                             long long* part_elems,
                                             long long* n_counters) {
  if (!tile_ok(M, bn)) return static_cast<int>(cudaErrorInvalidValue);
  *part_elems = workspace_elems(M, bn, grid);
  *n_counters = workspace_counters(bn, grid);
  return 0;
}

// x: E matrices (M, K) of row stride xs, xes apart; w: E matrices (K, N)
// of row stride ws, wes apart; y: E matrices (M, N) of row stride ys, yes
// apart; strides in elements, rows 16-byte aligned (checked by the Python
// wrapper); E = 1 for a 2-d product. K is cut into nseg segments of
// K / nseg columns. Block tiles are block_rows(M) x bn, bn 128 or (past
// M = 128) 256: the caller's pick from the shapes. Each
// width pointer may be null, then its static value is used. `part` holds
// `part_elems` fp32 elements and `counters` `n_counters` int32 zeros (left
// zero by every launch); a launch whose scratch is smaller than
// repro_sliced_matmul_workspace asks for is refused. `grid` blocks are
// launched whatever the widths. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int repro_sliced_matmul_bf16(
    const void* x, const void* w, void* y, int E, int M, int N, int K,
    int nseg, long long xs, long long ws, long long ys, long long xes,
    long long wes, long long yes,
    const void* ai_ptr, int ai_static, const void* ao_ptr, int ao_static,
    void* part, long long part_elems, void* counters, long long n_counters,
    int bn, int grid, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  if (nseg <= 0 || K % nseg != 0 || (K / nseg) % 8 != 0 || N % 8 != 0 ||
      xs % 8 != 0 || ws % 8 != 0 || ys % 8 != 0 || xes % 8 != 0 ||
      wes % 8 != 0 || yes % 8 != 0 || grid <= 0 || !tile_ok(M, bn) ||
      part_elems < workspace_elems(M, bn, grid) ||
      n_counters < workspace_counters(bn, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bm = block_rows(M);
  CUtensorMap tmx, tmw;
  if (!encode(&tmx, x, E, M, K, xs, xes, bm) ||
      !weight_map(&tmw, w, E, K, N, ws, wes))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int sg = K / nseg;
  if (bm == 64)
    return launch<64, 128>(tmx, tmw, y, E, M, N, sg, nseg, ys, yes, ai_ptr,
                           ai_static, ao_ptr, ao_static, part, counters, grid,
                           s);
  if (bn == 128)
    return launch<128, 128>(tmx, tmw, y, E, M, N, sg, nseg, ys, yes, ai_ptr,
                            ai_static, ao_ptr, ao_static, part, counters,
                            grid, s);
  return launch<128, 256>(tmx, tmw, y, E, M, N, sg, nseg, ys, yes, ai_ptr,
                          ai_static, ao_ptr, ao_static, part, counters, grid,
                          s);
}
