// Fused bidirectional multi-head attention straight off the fused qkv
// projection, for Hopper (sm_90a), on the tensor cores.
//
// Replaces: pathway_tpu/ops/attention.py `_attn_kernel`, the Pallas kernel
// launched by `fused_qkv_attention` (one launch per encoder layer per
// embed batch), over its whole contract: qkv in bf16, f16 or f32, any
// head width, any sequence length.
//
// What it computes, per (batch row, head): q/k/v are the head's column
// slices of qkv [b, s, 3d] (offsets hi*dh, d + hi*dh, 2d + hi*dh);
// scores = q.k^T / sqrt(dh) + bias, bias 0 for valid keys and -1e30 for
// padding keys (from the int32 token mask); an f32 softmax; probabilities
// rounded to qkv's dtype before p.v (at f32 they are not rounded); ctx =
// p.v accumulated in f32 and written in qkv's dtype into out [b, s, d] at
// the head's column offset. A row whose keys are all padding sees s equal
// scores of -1e30 and gets the uniform mean of its s keys of v, never NaN.
//
// What bounds it on the H100: bytes at the short buckets, bytes and the
// exponentials together at the long ones. The kernel must read qkv
// (b*s*3d elements) and the mask (b*s*4 B) and write ctx (b*s*d elements);
// the arithmetic is 4*b*h*s*s*dh flops, about 32 per byte at s 64 and 256
// at s 512 in bf16, against the ~295 per byte at which the bf16 tensor
// cores and not the memory would be the limit (f32: 67 TFLOP/s outside
// the tensor cores, so bytes up to s ~ 64); and b*h*s*s exponentials, which
// the SFU takes at 16 a clock an SM (on an H100 SXM at its 700 W limit and
// 1980 MHz boost clock, 0.51 ms for the 2.1e9 exp2 of b 1024, s 512, h 8,
// beside 0.64 ms for that shape's bytes at 3.35 TB/s). Four kernel
// families share the entry point.
//
// (1) The short kernel: bf16, head_dim 32 or 64, s <= 128 (the sequence
// buckets of the flagship and default embedders).
// - Layout. Block bi * n_heads + hi takes one (batch row, head). The
//   sequence is padded to SP = 16 * KT rows (KT key tiles of 16, KT a
//   power of two; the launch picks the least KT with SP >= s), and the
//   block has KT warps: warp w owns query rows 16w .. 16w + 15. At s 16
//   and 32 a block is 1 or 2 warps and many share an SM, so no warp idles
//   and short sequences keep as many bytes in flight as long ones.
// - Load: the block copies its q, k and v [SP][dh] into shared memory by
//   16-byte `cp.async`; rows past s are zero-filled (a source size of 0).
//   Rows of dh bf16 are 16-byte chunks XOR-swizzled by row, so that the 8
//   rows an `ldmatrix` reads hit 8 different bank groups. The key bias goes
//   beside them: 0, -1e30 (padding) or -inf (past s, so those keys drop
//   out of the softmax and an all-padding row still averages exactly its
//   s keys).
// - Scores: q A-fragments by `ldmatrix.x4`; k [key][dh] row-major is the
//   B operand of q.k^T as it lies, also by `ldmatrix.x4`; `mma.sync`
//   m16n8k16. A 16-row score tile of SP keys stays in registers (2 * KT
//   accumulator tiles of m16n8), so the softmax is exact in one pass: row
//   max and sum over the lane quad with two `__shfl_xor_sync` each.
// - p.v: the normalised probabilities, rounded to bf16, stay in registers:
//   two neighbouring m16n8 f32 accumulator tiles are the m16n8k16 A
//   fragment of one 16-key step. v B-fragments come by `ldmatrix.x4.trans`
//   from v [key][dh] row-major.
// - Store: ctx goes to bf16 in registers, into the warp's own q rows of
//   shared memory (no other warp reads them), and out in 16-byte stores,
//   8 or 4 lanes to a row; rows past s are never written.
// Its score tile is 2 * KT accumulators of 4 floats a thread (64 at s
// 128), and it holds all of the row's q, k and v in shared memory: at s
// 512 the tile alone would pass the 255 registers a thread may have. So
// longer sequences take the tiled kernels.
//
// The tiled kernels (2) and (3): everything else with a head width that
// is a multiple of 8 up to 256 (s > 128, f16, f32, head widths other than
// 32 and 64). Both take 128 queries of one (row, head) a
// work item, stream that head's keys once through shared memory in tiles,
// and keep one online softmax: a running max and sum a row (log2 domain),
// the f32 ctx accumulator and the sum rescaled by exp2(old max - new max)
// when the max rises, one exp2 a score, one q.k^T a score, and one
// division by the sum at the end. No [s, s] tile exists anywhere.
// - Rounding: the probabilities exp2(score - running max) are rounded to
//   qkv's dtype before p.v, and the sum adds them unrounded in f32. The
//   TPU kernel rounds the normalised probability instead; both roundings
//   are half an ulp relative to the value rounded, and scaling by the sum
//   afterwards in f32 keeps that relative error, so the two agree to the
//   order of one flipped rounding (tests/test_torch_attention_tiling.py
//   holds a plain emulation of this arithmetic to the Pallas kernel). At
//   f32 nothing is rounded and the function is the same.
// - Key 0 < s lies in the first tile, and its score is finite (bias 0 or
//   -1e30), so the running max is finite from the first tile on. A first
//   tile of padding only (max -1e30) is wiped by the rescale exp2(-1e30 -
//   max) = 0 once a valid key raises the max, and an all-padding row sums
//   exactly its s keys across any number of tiles. Keys past s (-inf)
//   give exp2(-inf) = 0.
// - Head widths: instantiated at DHP 16, 32, 64, 96, 128 and 256. Any
//   other dh that is a multiple of 8 runs in the next DHP with its columns
//   past dh zero-filled in shared memory: zero columns of q and k leave
//   the scores unchanged, and zero columns of v give ctx columns that are
//   never stored. A dh that is not a multiple of 8 breaks the 16-byte
//   alignment of head offsets in the fused layout (no tensor map, no
//   16-byte copy), and dh > 256 has no instantiation: both take (4).
//
// (2) f32, in full f32, on `mma.sync`: 8 warps of 16 query rows, block
// ((bi * n_heads) + hi) * ceil(s / 128) + query block. Key tiles of BK
// keys (32; 16 at DHP 256, where q's 128 rows take 133 KB) are
// double-buffered in shared memory by `cp.async` under two block barriers
// a tile; rows are padded by one 16-byte chunk (a stride of DHP + 4
// floats), so the fragment reads fall into 32 different banks. Each
// product is a 3xTF32 split on the tensor cores: x = big + small, big =
// tf32(x), small = tf32(x - big), and a.b is taken as small.big +
// big.small + big.big (m16n8k8 .tf32 with f32 sums); what is left out,
// small.small, is ~2^-22 of a product. The accumulator layout of the
// scores serves as the A fragment of p.v once the 8 keys of each k-step
// are permuted (k-index t <-> key 2t, t + 4 <-> key 2t + 1), and v's rows
// are read in the same permuted order. A warp whose rows all lie past s
// (s <= 64 leaves four) loads with the block and computes nothing.
//
// (3) bf16 and f16 on `wgmma`, fed by the TMA. A persistent grid, one
// block an SM, walks the work items (row, head, 128 queries) in steps of
// the grid; the items of one head sit side by side, so the blocks that
// read one head's keys run together and find them in L2. A block is three
// warpgroups; `setmaxnreg` moves registers from the producer's (24 a
// thread) to the consumers' (240).
// - One producer warp. For each item its lane 0 copies q (two buffers
//   where shared memory allows, so the next item's q lands while this one
//   runs; q is released once the item's last q.k^T is done), then each key
//   tile's k and v into two rings of 2-3 stages, with
//   4-d TMA boxes of the map {column, head slot, row, batch row} over the
//   fused layout (strides 2dh, 6d and 6sd bytes, all multiples of 16):
//   columns past dh and rows past s arrive as zeros. Its lanes build the
//   tile's key bias in f32 (0, -1e30 or -inf), once a block, and flag a
//   tile that holds no padding key and no key past s. `mbarrier`s track
//   the rings: full (the copies' bytes, and for k the 32 lanes' bias) and
//   empty (one arrival a consumer warp); k is released after the softmax
//   that reads its bias, v after the product that reads it.
// - Two consumer warpgroups of 64 query rows. Scores are m64nBKk16 `wgmma`
//   products of q and k straight from shared memory (both K-major:
//   head_dim contiguous) into BK / 2 f32 registers a thread; the
//   probabilities, rounded to T, stay in registers as the A operand of
//   the p.v `wgmma` (m64nWk16 a sub-tile of W columns), whose B operand is
//   v [key][dh] in shared memory, MN-major. Row max and sum over the lane
//   quad. Each step issues the next key tile's scores (of this item or,
//   after its last tile, of the block's next item) together with this
//   tile's p.v, and runs the next tile's softmax while the tensor cores
//   finish that product, so the pipeline runs on across items. A
//   flagged tile skips its bias: the max runs over the raw scores and the
//   scale folds into the exp2's argument (one FFMA a score fewer). The
//   code from each issue to its wait is straight-line and the roles are
//   warp-uniform (the warp index is broadcast from lane 0): ptxas
//   serializes the wgmma pipeline otherwise (advisories C7514-C7518),
//   which chip_smoke.py's `device` phase refuses.
// - Shared memory: every operand lies in sub-tiles of W columns (W = 64
//   at DHP 64, 128 and 256; 32 at DHP 32 and 96; 16 at DHP 16) whose rows
//   are 2W bytes, swizzled by the TMA at that span (128, 64 or 32 bytes:
//   16-byte chunks XOR the row within the 8-row group) and described to
//   `wgmma` with the same swizzle, 8-row groups 16W bytes apart. A k-step
//   of q.k^T advances 32 bytes inside a row; a key step of p.v advances 16
//   rows.
// - Tiles: BK 128 keys, 3 stages up to DHP 96, 2 at DHP 128; BK 64, 2
//   stages and one q buffer at DHP 256 (ctx alone is 128 f32 registers a
//   thread there). Every width runs this kernel; none keeps the two-pass
//   code.
// - Store: ctx / sum in T straight from the registers: neighbouring lanes
//   swap one column pair, so each stores 8 bytes and a warp's store fills
//   whole 32-byte sectors (4-byte stores, which fill half sectors, were
//   slower at every timed row; staging in shared memory and a TMA store
//   gained nothing measurable); rows past s and columns past dh are never
//   written. A warpgroup whose rows all lie past s (s % 128 in 1..64)
//   computes on zero rows and stores nothing.
// - What limits it (chip_smoke.py and scripts/attention_variants.py on
//   the H100; PERF.md): at s 256 and 512, dh 64, the softmax's arithmetic
//   and the stores of ctx on top of the product pipeline, not L2 (keys
//   copied once a head read no faster); at s 128, dh 128, the bytes.
//
// (4) Any head width: every dh that is not a multiple of 8 (dh 12 has
// heads at byte 24 of a row) or is past 256, in bf16, f16 and f32, at the
// Pallas kernel's rounding point: scores in f32, the exact row max and sum
// before normalising, the normalised probabilities rounded to T before
// p.v, a row of padding averaging its s keys of v.
// - Products: m16n8k16 bf16/f16 `mma.sync` with f32 sums, fragments by
//   `ldmatrix` (q and k as they lie, v transposed); the probabilities,
//   rounded to T, are exact operands. f32 takes 3xTF32 m16n8k8 with a
//   fresh accumulator a k-step (the tensor cores' own sums drifted past
//   1e-5 at dh 1024), fragments by 32-bit loads.
// - Copies: `cp.async` of the largest of 16, 8 and 4 bytes that divides
//   a head row (dh * sizeof(T)), so each lands whole inside one head in a
//   padded [head][row][column] layout (rows an odd number of 16-byte
//   chunks at 16 bits, 4 mod 8 floats at f32: the 8 rows of an `ldmatrix`
//   hit 8 bank groups); an odd dh at 16 bits goes element by element.
//   Columns past dh are zeroed once, rows past s arrive as zeros, keys
//   past s get a bias of -inf.
// - One pass with the scores in registers (any_width_one_kernel): s <=
//   128 and dh <= 128. Warp w holds rows 16w .. 16w + 15 against all keys
//   (64 floats a thread): one exp2 a score. Narrow heads share a block,
//   2 at dh <= 16, as the Pallas kernel's head loop does; a persistent
//   grid walks the items (batch row, heads) and, where two buffers fit,
//   copies the next item while this one's products run.
// - One pass with the scores in shared memory (any_width_shared_kernel):
//   s <= 512 and a wider head (dh > 128, or dh > 32 past s 128); 128
//   queries a block at s <= 256, 64 past it. Warp w holds its 16 rows'
//   scores against 256 keys (128 floats a thread; past s 256 a row's keys
//   are split over two warps, which exchange their partial max and sum
//   through shared memory), summed over column chunks of q and k streamed
//   once (128 columns, 64 past s 256; half that at f32); the rounded
//   probabilities go to shared memory, and p.v runs with its own warp
//   tiles (32 rows x 160 columns, 80 past s 256) over v streamed once a
//   320-column chunk of ctx. q, k and v are read once a block at any
//   width; ctx leaves through shared memory in 16-byte copies.
// - Two passes (any_width_kernel), past those lengths: the first takes
//   each row's max and sum online over key tiles, the second the scores
//   again, the normalised probabilities and p.v. kTwoPass for narrow
//   heads past s 128 (4 a block at dh <= 16, 2 at dh <= 32); kWide for
//   the rest past s 512: q held whole for 128 queries a block (fewer where
//   the head is wide, 16 at the least: up to dh 2192 at 16 bits, 1648 at
//   f32), key tiles double-buffered where they fit; a wider head takes
//   q.k^T in 256-column chunks (128 at f32) of q and k together, q read
//   again with every key tile. ctx in 320-column passes: a warp's ctx of
//   16 rows is 160 floats a thread at 320 columns, so past dh 320 the
//   scores are taken 1 + ceil(dh / 320) times.
// - What limits it: PERF.md has its times beside the bound and
//   scripts/attention_variants.py's ablations.
//
// Built by pathway_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, called through ctypes from
// pathway_tpu_torch/ops/attention.py.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kMaxSeq = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Element offset of chunk `ch` (8 bf16 = 16 bytes) of row `row` in a
// swizzled [rows][DH] tile. A 128-byte line holds 128 / (2 * DH) rows; the
// chunk index is XORed with the row's position among the 8 lines that one
// `ldmatrix` 8x8 read spans, so those 8 rows land in 8 bank groups.
template <int DH>
__device__ __forceinline__ int swz(int row, int ch) {
  static_assert(DH == 32 || DH == 64, "head_dim 32 or 64");
  if constexpr (DH == 64) {
    return row * DH + ((ch ^ (row & 7)) << 3);
  } else {
    return row * DH + ((ch ^ ((row >> 1) & 3)) << 3);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of one block, in bytes: q, k, v [SP][DH] bf16, then the
// key bias [SP] f32.
template <int DH, int KT>
__host__ __device__ constexpr size_t smem_bytes() {
  return 3 * 16 * KT * DH * 2 + 16 * KT * 4;
}

// KT warps a block and at least 16 / KT blocks an SM: 512 threads, which
// caps the registers at 128 a thread
template <int DH, int KT>
__global__ void __launch_bounds__(32 * KT, 16 / KT)
    fused_qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const int32_t* __restrict__ mask,
                               __nv_bfloat16* __restrict__ out, int s, int d, int n_heads,
                               float scale_log2) {
  constexpr int SP = 16 * KT;          // padded sequence length
  constexpr int NT = 32 * KT;
  constexpr int CPR = DH / 8;          // 16-byte chunks per head row
  constexpr int TILE = SP * DH;        // elements of one of q, k, v
  constexpr int NKS = DH / 16;         // k-steps of q.k^T over dh
  constexpr int NN = DH / 8;           // n-tiles of ctx over dh

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [3][SP][DH]: q, k, v
  const __nv_bfloat16* k_s = q_s + TILE;
  const __nv_bfloat16* v_s = q_s + 2 * TILE;
  float* bias = reinterpret_cast<float*>(q_s + 3 * TILE);  // [SP]

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / n_heads;
  const int hi = blockIdx.x - bi * n_heads;

  // ---- load: q, k, v of the block's (row, head), rows past s zero-filled
  const int row_stride = 3 * d;
  const __nv_bfloat16* src0 = qkv + size_t(bi) * s * row_stride + hi * DH;
  for (int c = tid; c < 3 * SP * CPR; c += NT) {
    const int which = c / (SP * CPR);
    const int r = (c / CPR) % SP;
    const int ch = c % CPR;
    const bool in = r < s;
    const __nv_bfloat16* src = in ? src0 + r * row_stride + which * d + ch * 8 : src0;
    cp_async_16(smem_addr(q_s + which * TILE + swz<DH>(r, ch)), src, in ? 16 : 0);
  }
  const int32_t* m = mask + size_t(bi) * s;
  for (int j = tid; j < SP; j += NT) {
    bias[j] = j < s ? (m[j] == 0 ? -1e30f : 0.0f) : -CUDART_INF_F;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- compute: warp qt owns query rows 16 * qt .. 16 * qt + 15
  const int qt = tid / 32;
  const int lane = tid % 32;
  if (qt * 16 >= s) return;  // no block barrier follows
  const int g = lane >> 2;  // row of the fragment (and row + 8)
  const int t4 = lane & 3;  // column pair of the fragment

  // q A-fragments: matrix (lane >> 3) is rows +0/+8 (bit 0), k +0/+8 (bit 1)
  uint32_t qf[NKS][4];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int r = qt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(qf[ks], smem_addr(q_s + swz<DH>(r, 2 * ks + (lane >> 4))));
  }

  // scores: n-tile t covers keys 8t .. 8t + 7
  float sc[2 * KT][4];
#pragma unroll
  for (int t = 0; t < 2 * KT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.0f;
#pragma unroll
  for (int p = 0; p < KT; ++p) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      // matrices: keys +0 (k lo, k hi), keys +8 (k lo, k hi)
      uint32_t kb[4];
      const int r = 16 * p + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(kb, smem_addr(k_s + swz<DH>(r, 2 * ks + ((lane >> 3) & 1))));
      mma_bf16(sc[2 * p], qf[ks], kb[0], kb[1]);
      mma_bf16(sc[2 * p + 1], qf[ks], kb[2], kb[3]);
    }
  }

  // softmax over each row (rows g and g + 8), in the log2 domain:
  // 2^(x * log2e - max) = e^(x - max / log2e); -1e30 and -inf pass through
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < 2 * KT; ++t) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * t + 2 * t4);
    sc[t][0] = fmaf(sc[t][0], scale_log2, b.x);
    sc[t][1] = fmaf(sc[t][1], scale_log2, b.y);
    sc[t][2] = fmaf(sc[t][2], scale_log2, b.x);
    sc[t][3] = fmaf(sc[t][3], scale_log2, b.y);
    mx0 = fmaxf(mx0, fmaxf(sc[t][0], sc[t][1]));
    mx1 = fmaxf(mx1, fmaxf(sc[t][2], sc[t][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  // every row has s >= 1 keys with a finite score (0 or -1e30 bias), so
  // the max is finite and exp2(-inf - max) is 0
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int t = 0; t < 2 * KT; ++t) {
    sc[t][0] = exp2_approx(sc[t][0] - mx0);
    sc[t][1] = exp2_approx(sc[t][1] - mx0);
    sc[t][2] = exp2_approx(sc[t][2] - mx1);
    sc[t][3] = exp2_approx(sc[t][3] - mx1);
    sum0 += sc[t][0] + sc[t][1];
    sum1 += sc[t][2] + sc[t][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }

  // normalised probabilities, rounded to bf16: the A fragment of key step
  // kk is n-tiles 2kk (a0, a1) and 2kk + 1 (a2, a3)
  const float inv0 = 1.0f / sum0, inv1 = 1.0f / sum1;
  uint32_t pa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    pa[kk][0] = pack_bf16(sc[2 * kk][0] * inv0, sc[2 * kk][1] * inv0);
    pa[kk][1] = pack_bf16(sc[2 * kk][2] * inv1, sc[2 * kk][3] * inv1);
    pa[kk][2] = pack_bf16(sc[2 * kk + 1][0] * inv0, sc[2 * kk + 1][1] * inv0);
    pa[kk][3] = pack_bf16(sc[2 * kk + 1][2] * inv1, sc[2 * kk + 1][3] * inv1);
  }

  // ctx = p.v: n-tile n covers columns 8n .. 8n + 7
  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int np = 0; np < NN / 2; ++np) {
      // transposed matrices: keys +0 / +8 (bit 0), columns +0 / +8 (bit 1)
      uint32_t vb[4];
      const int r = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(vb, smem_addr(v_s + swz<DH>(r, 2 * np + (lane >> 4))));
      mma_bf16(o[2 * np], pa[kk], vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], pa[kk], vb[2], vb[3]);
    }
  }

  // ---- store: bf16 ctx into this warp's q rows, then 16-byte stores
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int r = qt * 16 + g;
    *reinterpret_cast<uint32_t*>(q_s + swz<DH>(r, n) + 2 * t4) = pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(q_s + swz<DH>(r + 8, n) + 2 * t4) = pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  __nv_bfloat16* out0 = out + size_t(bi) * s * d + hi * DH;
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = qt * 16 + c / CPR;
    const int ch = c % CPR;
    if (r < s) {
      *reinterpret_cast<uint4*>(out0 + size_t(r) * d + ch * 8) =
          *reinterpret_cast<const uint4*>(q_s + swz<DH>(r, ch));
    }
  }
}

template <int DH, int KT>
int launch(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH, KT>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fused_qkv_attention_kernel<DH, KT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               int(smem));
    if (e != cudaSuccess) return int(e);
  }
  fused_qkv_attention_kernel<DH, KT><<<b * n_heads, 32 * KT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int32_t*>(mask),
      static_cast<__nv_bfloat16*>(out), s, d, n_heads, scale * kLog2e);
  return int(cudaGetLastError());
}

template <int DH>
int launch_dh(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads,
              float scale, cudaStream_t stream) {
  if (s <= 16) return launch<DH, 1>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (s <= 32) return launch<DH, 2>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (s <= 64) return launch<DH, 4>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  return launch<DH, 8>(qkv, mask, out, b, s, d, n_heads, scale, stream);
}


// ----------------------------------------------------------- the tiled kernels

constexpr int kBQ = 128;  // queries a block (a work item) of either tiled kernel

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// ----------------------------------------- (2) f32: 3xTF32 on `mma.sync`

constexpr int kF32Warps = kBQ / 16;
constexpr int kF32Threads = 32 * kF32Warps;

template <int DHP>
struct TiledF32 {
  static constexpr int BK = DHP >= 256 ? 16 : 32;  // keys a tile
  static constexpr int LD = DHP + 4;               // row stride: one spare chunk a row
  static constexpr int CPR = DHP / 4;              // 16-byte chunks of a row
  static constexpr int NT = BK / 8;                // n-tiles of a warp's score tile
  static constexpr int NN = DHP / 8;               // n-tiles of a warp's ctx
  // q [kBQ][LD], k and v [2][BK][LD], the mask [2][BK]
  static constexpr size_t smem = (size_t(kBQ) + 4 * BK) * LD * 4 + 2 * BK * 4;
  static_assert(DHP % 16 == 0 && DHP <= 256, "DHP a multiple of 16 up to 256");
  static_assert(smem <= 232448, "a block's shared memory on the H100");
};

// x = big + small, both tf32 (an f32 bit pattern with the low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in f32 by three tf32 products, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// Rows r0 .. r0 + ROWS - 1 of one of q, k, v (columns from `col0`: 0, d or
// 2d) of the head into dst [ROWS][LD]; rows past s and chunks past the
// head's own `cpr` chunks are zero-filled.
template <int DHP, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* head, size_t row_stride,
                                              int col0, int r0, int s, int cpr, int tid) {
  using C = TiledF32<DHP>;
  for (int c = tid; c < ROWS * C::CPR; c += kF32Threads) {
    const int r = c / C::CPR;
    const int ch = c - r * C::CPR;
    const bool in = r0 + r < s && ch < cpr;
    const float* src = in ? head + size_t(r0 + r) * row_stride + col0 + ch * 4 : head;
    cp_async_16(smem_addr(dst + r * C::LD + ch * 4), src, in ? 16 : 0);
  }
}

template <int DHP>
__global__ void __launch_bounds__(kF32Threads)
    tiled_f32_kernel(const float* __restrict__ qkv, const int32_t* __restrict__ mask,
                     float* __restrict__ out, int s, int d, int n_heads, int dh, int n_qb,
                     float scale_log2) {
  using C = TiledF32<DHP>;
  constexpr int BK = C::BK;
  constexpr int LD = C::LD;
  constexpr int NT = C::NT;
  constexpr int NN = C::NN;

  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                       // [kBQ][LD]
  float* k_s = q_s + kBQ * LD;                                       // [2][BK][LD]
  float* v_s = k_s + 2 * BK * LD;                                    // [2][BK][LD]
  int32_t* m_s = reinterpret_cast<int32_t*>(v_s + 2 * BK * LD);    // [2][BK]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // row of the fragment (and row + 8)
  const int t4 = lane & 3;  // column pair of the fragment
  const int qb = blockIdx.x % n_qb;
  const int bh = blockIdx.x / n_qb;
  const int bi = bh / n_heads;
  const int hi = bh - bi * n_heads;
  const int q0 = qb * kBQ;
  const size_t row_stride = size_t(3) * d;
  const float* head = qkv + size_t(bi) * s * row_stride + size_t(hi) * dh;
  const int32_t* mrow = mask + size_t(bi) * s;
  const int cpr = dh / 4;
  const int n_kt = (s + BK - 1) / BK;
  // a warp whose 16 query rows all lie past s loads and waits with the
  // block but computes nothing (at s 64, half the block)
  const bool active = q0 + warp * 16 < s;

  // key tile t into buffer t & 1: k, v and the mask
  auto load_tile = [&](int t) {
    const int buf = t & 1;
    const int k0 = t * BK;
    load_rows_f32<DHP, BK>(k_s + buf * BK * LD, head, row_stride, d, k0, s, cpr, tid);
    load_rows_f32<DHP, BK>(v_s + buf * BK * LD, head, row_stride, 2 * d, k0, s, cpr, tid);
    for (int j = tid; j < BK; j += kF32Threads) {
      const bool in = k0 + j < s;
      cp_async_4(smem_addr(m_s + buf * BK + j), in ? mrow + k0 + j : mrow, in ? 4 : 0);
    }
    cp_async_commit();
  };

  load_rows_f32<DHP, kBQ>(q_s, head, row_stride, 0, q0, s, cpr, tid);
  cp_async_commit();
  load_tile(0);

  const float* q_w = q_s + warp * 16 * LD;  // this warp's 16 query rows
  // rows g and g + 8, log2 domain: running max, this thread's share of the sum
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.0f, l1 = 0.0f;
  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int t = 0; t < n_kt; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_kt) {
      load_tile(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int k0 = t * BK;
      const float* k_t = k_s + buf * BK * LD;
      const float* v_t = v_s + buf * BK * LD;
      const int32_t* m_t = m_s + buf * BK;

      // scores of the warp's 16 rows against the tile's BK keys: n-tile t
      // covers keys 8t .. 8t + 7
      float sc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < DHP / 8; ++ks) {
        // A (16 x 8): (g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4)
        const float* qp = q_w + g * LD + 8 * ks + t4;
        uint32_t ab[4], as[4];
        split_tf32(qp[0], ab[0], as[0]);
        split_tf32(qp[8 * LD], ab[1], as[1]);
        split_tf32(qp[4], ab[2], as[2]);
        split_tf32(qp[8 * LD + 4], ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // B (8 x 8, k = dh, n = key): (t4, g), (t4 + 4, g)
          const float* kp = k_t + (8 * n + g) * LD + 8 * ks + t4;
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(kp[0], bb0, bs0);
          split_tf32(kp[4], bb1, bs1);
          mma_3xtf32(sc[n], ab, as, bb0, bb1, bs0, bs1);
        }
      }

      // scale and key bias, in the log2 domain: 0, -1e30 (padding) or
      // -inf (past s); then the running max over the lane quad
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int j = 8 * n + 2 * t4;
        const float b0 = k0 + j < s ? (m_t[j] == 0 ? -1e30f : 0.0f) : -CUDART_INF_F;
        const float b1 = k0 + j + 1 < s ? (m_t[j + 1] == 0 ? -1e30f : 0.0f) : -CUDART_INF_F;
        sc[n][0] = fmaf(sc[n][0], scale_log2, b0);
        sc[n][1] = fmaf(sc[n][1], scale_log2, b1);
        sc[n][2] = fmaf(sc[n][2], scale_log2, b0);
        sc[n][3] = fmaf(sc[n][3], scale_log2, b1);
        mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // the max is finite from the first tile on (key 0 < s); the old sums
      // rescale to the new max (exp2(-inf) = 0 on the first tile)
      const float c0 = exp2_approx(m0 - mx0), c1 = exp2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }

      // p.v, in full f32: the 8 keys of n-tile n as one k-step, permuted:
      // k-index t4 is key 8n + 2t4, k-index t4 + 4 is key 8n + 2t4 + 1
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = exp2_approx(sc[n][0] - m0), p1 = exp2_approx(sc[n][1] - m0);
        const float p2 = exp2_approx(sc[n][2] - m1), p3 = exp2_approx(sc[n][3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        uint32_t ab[4], as[4];
        split_tf32(p0, ab[0], as[0]);  // (g, key 2t4)
        split_tf32(p2, ab[1], as[1]);  // (g + 8, key 2t4)
        split_tf32(p1, ab[2], as[2]);  // (g, key 2t4 + 1)
        split_tf32(p3, ab[3], as[3]);  // (g + 8, key 2t4 + 1)
        const float* vp = v_t + (8 * n + 2 * t4) * LD + g;
#pragma unroll
        for (int c = 0; c < NN; ++c) {
          // B (k = key, n = column): (key 2t4, 8c + g), (key 2t4 + 1, 8c + g)
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(vp[8 * c], bb0, bs0);
          split_tf32(vp[LD + 8 * c], bb1, bs1);
          mma_3xtf32(o[c], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    }
    __syncthreads();  // before the next prefetch overwrites this buffer
  }
  if (!active) return;  // no block barrier follows

  // ---- store: ctx / sum into this warp's q rows (no warp reads q any
  // more), then 16-byte stores of the head's own chunks; rows past s are
  // never written
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  float* st = q_s + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    *reinterpret_cast<float2*>(st + g * LD + 8 * n + 2 * t4) = make_float2(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<float2*>(st + (g + 8) * LD + 8 * n + 2 * t4) =
        make_float2(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  float* out_h = out + size_t(bi) * s * d + size_t(hi) * dh;
  for (int c = lane; c < 16 * cpr; c += 32) {
    const int r = c / cpr;
    const int ch = c - r * cpr;
    const int row = q0 + warp * 16 + r;
    if (row < s) {
      *reinterpret_cast<uint4*>(out_h + size_t(row) * d + ch * 4) =
          *reinterpret_cast<const uint4*>(st + r * LD + ch * 4);
    }
  }
}

template <int DHP>
int launch_f32(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads,
               float scale, cudaStream_t stream) {
  using C = TiledF32<DHP>;
  const int n_qb = (s + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(b) * n_heads * n_qb;
  if (blocks >= (1ll << 31)) return int(cudaErrorInvalidConfiguration);
  if (C::smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(tiled_f32_kernel<DHP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               int(C::smem));
    if (e != cudaSuccess) return int(e);
  }
  tiled_f32_kernel<DHP><<<unsigned(blocks), kF32Threads, C::smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const int32_t*>(mask), static_cast<float*>(out),
      s, d, n_heads, d / n_heads, n_qb, scale * kLog2e);
  return int(cudaGetLastError());
}

int launch_f32_dh(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads,
                  float scale, cudaStream_t stream) {
  const int dh = d / n_heads;
  if (dh <= 16) return launch_f32<16>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 32) return launch_f32<32>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 64) return launch_f32<64>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 96) return launch_f32<96>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 128) return launch_f32<128>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  return launch_f32<256>(qkv, mask, out, b, s, d, n_heads, scale, stream);
}

// ------------------------------- (3) bf16 and f16: `wgmma`, TMA, one pass

constexpr int kConsumers = 2;                  // warpgroups of 64 query rows
constexpr int kProducerWarp = 4 * kConsumers;  // the warp that issues the copies
constexpr int kWgThreads = 128 * (kConsumers + 1);
// registers a thread after the split: the producer's warpgroup gives up
// what the consumers take (168 each at launch for 384 threads; 128 x 24 +
// 256 x 240 fits the SM's 65,536)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// launch error codes past CUDA's own: the CUDA driver's tensor-map encoder is
// missing, or refused the map (kTensorMapError + its CUresult)
constexpr int kNoEncoder = 999;
constexpr int kTensorMapError = 1000;

template <int DHP>
struct Wg {
  // columns of one sub-tile: its rows are SB = 2W bytes, the swizzle span
  // of the TMA copy and of the wgmma descriptors (32, 64 or 128 bytes)
  static constexpr int W = DHP == 16 ? 16 : (DHP == 32 || DHP == 96) ? 32 : 64;
  static constexpr int SB = 2 * W;
  static constexpr int NSUB = DHP / W;
  static constexpr int BK = DHP >= 256 ? 64 : 128;   // keys a tile
  static constexpr int STAGES = DHP >= 128 ? 2 : 3;  // k tiles and v tiles in flight
  static constexpr uint32_t Q_BYTES = kBQ * DHP * 2;  // one q buffer
  static constexpr uint32_t KV_BYTES = BK * DHP * 2;  // one k (or v) tile
  // two q buffers (the next work item's q lands while this one runs)
  // where they fit beside the rings, the bias, the barriers and the
  // alignment's slack; one at DHP 256
  static constexpr int QBUF = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8192 <= 232448 ? 2 : 1;
  // from a 1024-byte aligned base: q [QBUF][NSUB][kBQ][W]; k [STAGES][NSUB]
  // [BK][W]; v the same; the bias [STAGES][BK] f32; a flag a stage (the
  // tile holds no padding key and no key past s); the barriers
  static constexpr uint32_t OFF_K = QBUF * Q_BYTES;
  static constexpr uint32_t OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_BIAS = OFF_V + STAGES * KV_BYTES;
  static constexpr uint32_t OFF_FLAG = OFF_BIAS + STAGES * BK * 4;
  static constexpr uint32_t OFF_BAR = OFF_FLAG + 8 * ((STAGES + 1) / 2);
  static constexpr size_t smem = 1024 + OFF_BAR + (2 * QBUF + 4 * STAGES) * 8;
  // the descriptors' swizzle field: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t SWIZZLE = SB == 128 ? 1 : SB == 64 ? 2 : 3;
  static_assert(DHP % W == 0 && W % 16 == 0, "sub-tiles of whole k-steps");
  static_assert(smem <= 232448, "a block's shared memory on the H100");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive, and expect `bytes` more of copies to land before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of the 4-d map {column, head slot, row, batch row} into shared
// memory, completing its bytes on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col,
                                         int slot, int row, int bi) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(slot), "r"(row), "r"(bi), "r"(bar)
      : "memory");
}

// descriptor of a swizzled operand at shared address `addr`: 8-row groups
// `sbo` bytes apart; the leading offset is not read at these shapes (a
// K-major step stays inside its swizzle span, an MN-major operand is one
// span wide)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t sbo, uint64_t swizzle) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(sbo >> 4) << 32) |
         (swizzle << 62);
}

// scores of a key tile into `sc`: m64nBKk16 products over dh, q (the
// warpgroup's 64 rows at `q_addr`) and k (at `kb`) both K-major; a k-step
// is sub-tile ks * 16 / W, 32 bytes a step inside its rows. Issued and
// committed, not waited for.
template <typename T, int DHP>
__device__ __forceinline__ void issue_scores(float (&sc)[Wg<DHP>::BK / 2], uint32_t q_addr,
                                             uint32_t kb) {
  using C = Wg<DHP>;
#pragma unroll
  for (int ks = 0; ks < DHP / 16; ++ks) {
    const uint32_t sub = ks * 16 / C::W, step = (ks * 16 % C::W) * 2;
    wgmma::ss<T, C::BK>(sc, wg_desc(q_addr + sub * kBQ * C::SB + step, 8 * C::SB, C::SWIZZLE),
                        wg_desc(kb + sub * C::BK * C::SB + step, 8 * C::SB, C::SWIZZLE), ks > 0);
  }
  wgmma::commit();
}

// The online softmax of one tile, in place: scores to probabilities
// exp2(score * scale + bias - running max), one exp2 each, for rows g
// (m0, l0) and g + 8 (m1, l1); accumulator tile i covers keys 8i + 2t4,
// + 1. The sums add the probabilities unrounded, rescaled to the new max;
// c0, c1 is the rescale that ctx still owes. A tile whose bias is all 0
// (`plain`: no padding key, no key past s) skips the bias: its max runs
// over the raw scores (scale > 0) and the scale folds into the exp2's
// argument, one FFMA, as in FlashAttention; the arithmetic is the same.
template <int DHP>
__device__ __forceinline__ void softmax_tile(float (&sc)[Wg<DHP>::BK / 2], const float* bias,
                                             bool plain, float scale_log2, int t4, float& m0,
                                             float& m1, float& l0, float& l1, float& c0,
                                             float& c1) {
  constexpr int BK = Wg<DHP>::BK;
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
  if (plain) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    mx0 *= scale_log2;
    mx1 *= scale_log2;
  } else {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float2 b = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * t4);
      sc[4 * i] = fmaf(sc[4 * i], scale_log2, b.x);
      sc[4 * i + 1] = fmaf(sc[4 * i + 1], scale_log2, b.y);
      sc[4 * i + 2] = fmaf(sc[4 * i + 2], scale_log2, b.x);
      sc[4 * i + 3] = fmaf(sc[4 * i + 3], scale_log2, b.y);
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  // finite from the first tile on (key 0 < s; exp2(-inf) = 0 then); a
  // first tile of padding only (-1e30) is wiped by exp2(-1e30 - max) = 0
  // once a valid key raises the max
  mx0 = fmaxf(m0, mx0);
  mx1 = fmaxf(m1, mx1);
  c0 = exp2_approx(m0 - mx0);
  c1 = exp2_approx(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  // p = exp2(x - max) with x = score * scale (plain) or the biased score
  const float sc0 = plain ? scale_log2 : 1.0f;
  float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    sc[4 * i] = exp2_approx(fmaf(sc[4 * i], sc0, -m0));
    sc[4 * i + 1] = exp2_approx(fmaf(sc[4 * i + 1], sc0, -m0));
    sc[4 * i + 2] = exp2_approx(fmaf(sc[4 * i + 2], sc0, -m1));
    sc[4 * i + 3] = exp2_approx(fmaf(sc[4 * i + 3], sc0, -m1));
    r0 += sc[4 * i] + sc[4 * i + 1];
    r1 += sc[4 * i + 2] + sc[4 * i + 3];
  }
  l0 = l0 * c0 + r0;
  l1 = l1 * c1 + r1;
}

// the probabilities rounded to T as p.v's A fragments: key step kk is
// accumulator tiles 2kk (a0, a1) and 2kk + 1 (a2, a3)
template <typename T, int DHP>
__device__ __forceinline__ void pack_probs(uint32_t (&pa)[Wg<DHP>::BK / 16][4],
                                           const float (&sc)[Wg<DHP>::BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < Wg<DHP>::BK / 16; ++kk) {
    pa[kk][0] = pack2<T>(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// ctx *= the rescale owed to the running max (c0 for rows g, c1 for rows
// g + 8), before the products that read ctx and the probabilities `pa`
// are issued: nothing may touch their registers between the issue and the
// wait, or the compiler serializes the wgmma pipeline
template <int DHP>
__device__ __forceinline__ void rescale_ctx(float (&o)[Wg<DHP>::NSUB][Wg<DHP>::W / 2],
                                            uint32_t (&pa)[Wg<DHP>::BK / 16][4], float c0,
                                            float c1) {
  using C = Wg<DHP>;
#pragma unroll
  for (int sub = 0; sub < C::NSUB; ++sub) {
#pragma unroll
    for (int i = 0; i < C::W / 8; ++i) {
      o[sub][4 * i] *= c0;
      o[sub][4 * i + 1] *= c0;
      o[sub][4 * i + 2] *= c1;
      o[sub][4 * i + 3] *= c1;
    }
    wgmma::fence_regs(o[sub]);
  }
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) wgmma::fence_regs(pa[kk]);
}

// ctx += p.v of the probabilities `pa` against the v tile at shared
// address `vb`: issued and committed, not waited for
template <typename T, int DHP>
__device__ __forceinline__ void issue_pv(float (&o)[Wg<DHP>::NSUB][Wg<DHP>::W / 2],
                                         const uint32_t (&pa)[Wg<DHP>::BK / 16][4], uint32_t vb) {
  using C = Wg<DHP>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
#pragma unroll
    for (int sub = 0; sub < C::NSUB; ++sub) {
      // m64nWk16 a sub-tile: v MN-major (head_dim contiguous), 16 keys a step
      wgmma::rs<T, C::W>(o[sub], pa[kk],
                         wg_desc(vb + sub * C::BK * C::SB + kk * 16 * C::SB, 8 * C::SB, C::SWIZZLE));
    }
  }
  wgmma::commit();
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap kv_map,
                           const int32_t* __restrict__ mask, T* __restrict__ out, int s, int d,
                           int n_heads, int dh, int n_qt, int n_items, float scale_log2) {
  using C = Wg<DHP>;
  constexpr int BK = C::BK;
  constexpr int W = C::W;
  constexpr int SB = C::SB;
  constexpr int NSUB = C::NSUB;
  constexpr int STAGES = C::STAGES;
  constexpr int QBUF = C::QBUF;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's 1024-byte period
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bars = base + C::OFF_BAR;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (QBUF + i); };
  auto k_full = [&](int i) { return bars + 8 * (2 * QBUF + i); };
  auto k_empty = [&](int i) { return bars + 8 * (2 * QBUF + STAGES + i); };
  auto v_full = [&](int i) { return bars + 8 * (2 * QBUF + 2 * STAGES + i); };
  auto v_empty = [&](int i) { return bars + 8 * (2 * QBUF + 3 * STAGES + i); };

  const int tid = threadIdx.x;
  // broadcast from lane 0, so the compiler sees the roles as uniform
  // across each warp and does not serialize the wgmma pipeline in them
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < QBUF; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 4 * kConsumers);
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(k_full(i), 32);  // the producer's lanes (each wrote bias)
      mbar_init(k_empty(i), 4 * kConsumers);
      mbar_init(v_full(i), 1);
      mbar_init(v_empty(i), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    // ---- producer: q of each work item, then its key tiles through the
    // k and v rings; lane 0 of one warp issues the copies, its lanes build
    // the bias
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kProducerWarp) return;
    int kt = 0;
    int it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int qt = item % n_qt;
      const int bh = item / n_qt;
      const int bi = bh / n_heads;
      const int hi = bh - bi * n_heads;
      const int qb = it % QBUF;
      mbar_wait(q_empty(qb), ((it / QBUF) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(q_full(qb), C::Q_BYTES);
#pragma unroll
        for (int sub = 0; sub < NSUB; ++sub) {
          tma_load(base + qb * C::Q_BYTES + sub * kBQ * SB, &q_map, q_full(qb), sub * W, hi,
                   qt * kBQ, bi);
        }
      }
      const int32_t* mrow = mask + size_t(bi) * s;
      const int n_kt = (s + BK - 1) / BK;
      for (int j = 0; j < n_kt; ++j, ++kt) {
        const int st = kt % STAGES;
        const uint32_t empty_par = ((kt / STAGES) & 1) ^ 1;
        const int k0 = j * BK;
        // key bias in f32, once a block: 0, -1e30 (padding) or -inf (past
        // s); the mask is read before the wait, so its latency hides there
        float bv[BK / 32];
#pragma unroll
        for (int x = 0; x < BK / 32; ++x) {
          const int key = k0 + lane + 32 * x;
          bv[x] = key < s ? (mrow[key] == 0 ? -1e30f : 0.0f) : -CUDART_INF_F;
        }
        bool plain = true;
#pragma unroll
        for (int x = 0; x < BK / 32; ++x) plain = plain && bv[x] == 0.0f;
        plain = __all_sync(0xffffffffu, plain);
        mbar_wait(k_empty(st), empty_par);
        float* bt = reinterpret_cast<float*>(sm + C::OFF_BIAS) + st * BK;
#pragma unroll
        for (int x = 0; x < BK / 32; ++x) bt[lane + 32 * x] = bv[x];
        if (lane == 0) {
          reinterpret_cast<int*>(sm + C::OFF_FLAG)[st] = plain;
          mbar_arrive_expect_tx(k_full(st), C::KV_BYTES);
#pragma unroll
          for (int sub = 0; sub < NSUB; ++sub) {
            tma_load(base + C::OFF_K + st * C::KV_BYTES + sub * BK * SB, &kv_map, k_full(st),
                     sub * W, n_heads + hi, k0, bi);
          }
        } else {
          mbar_arrive(k_full(st));
        }
        mbar_wait(v_empty(st), empty_par);
        if (lane == 0) {
          mbar_arrive_expect_tx(v_full(st), C::KV_BYTES);
#pragma unroll
          for (int sub = 0; sub < NSUB; ++sub) {
            tma_load(base + C::OFF_V + st * C::KV_BYTES + sub * BK * SB, &kv_map, v_full(st),
                     sub * W, 2 * n_heads + hi, k0, bi);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c takes query rows 64c .. 64c + 63 of each
  // work item; its warp wq rows 16wq .. + 15 (the wgmma accumulator
  // layout). Rows past s are zero and compute to finite values that are
  // never stored. The pipeline runs on across the block's work items: each
  // step issues the next key tile's scores (of this item or the next)
  // together with this tile's p.v, and runs the next tile's softmax while
  // the tensor cores finish that product. The code from each issue to its
  // wait is straight-line, so the compiler keeps the wgmma pipeline
  // asynchronous.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = warp / 4;
  const int wq = warp % 4;
  const int g = lane >> 2;  // row of the fragment (and row + 8)
  const int t4 = lane & 3;  // column pair of the fragment
  const float* bias = reinterpret_cast<const float*>(sm + C::OFF_BIAS);
  // a stage's flag, broadcast so the compiler sees the branch as uniform
  auto plain = [&](int t) {
    return __shfl_sync(0xffffffffu, reinterpret_cast<const int*>(sm + C::OFF_FLAG)[t % STAGES], 0) != 0;
  };
  auto q_addr = [&](int it) { return base + (it % QBUF) * C::Q_BYTES + c * 64 * SB; };
  auto k_addr = [&](int t) { return base + C::OFF_K + (t % STAGES) * C::KV_BYTES; };
  auto v_addr = [&](int t) { return base + C::OFF_V + (t % STAGES) * C::KV_BYTES; };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // ctx / sum in T, straight from the registers into out, rows g and
  // g + 8 of the warp: lanes t4 and t4 ^ 1 swap one column pair, so that
  // each stores 8 bytes and a store fills whole 32-byte sectors; rows past
  // s and columns past dh are never written
  auto store_ctx = [&](const float (&acc)[NSUB][W / 2], float s0, float s1, int bi, int hi, int q0) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, x);
      s1 += __shfl_xor_sync(0xffffffffu, s1, x);
    }
    const float inv[2] = {1.0f / s0, 1.0f / s1};
    const int odd = t4 & 1;
    const int row = q0 + 64 * c + 16 * wq + g;
    T* out0 = out + (size_t(bi) * s + row) * d + size_t(hi) * dh + 2 * (t4 & ~1);
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
#pragma unroll
      for (int i = 0; i < W / 8; i += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g, g + 8
          const uint32_t a = pack2<T>(acc[sub][4 * i + 2 * h] * inv[h], acc[sub][4 * i + 2 * h + 1] * inv[h]);
          const uint32_t b =
              pack2<T>(acc[sub][4 * i + 4 + 2 * h] * inv[h], acc[sub][4 * i + 5 + 2 * h] * inv[h]);
          // an even lane keeps tile i and takes its odd neighbour's pair of
          // it; an odd lane keeps tile i + 1 and takes the even one's
          const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? a : b, 1);
          const int col = sub * W + 8 * (i + odd);
          if (col < dh && row + 8 * h < s) {
            *reinterpret_cast<uint2*>(out0 + size_t(8 * h) * d + col) =
                odd ? make_uint2(got, b) : make_uint2(a, got);
          }
        }
      }
    }
  };

  int item = blockIdx.x;
  if (item >= n_items) return;
  const int n_kt = (s + BK - 1) / BK;
  int it = 0;  // the block's work items so far
  int j = 0;   // key tile of the current item
  int t = 0;   // key tiles so far (the rings' position)
  int bh = item / n_qt;
  int bi = bh / n_heads, hi = bh - bi * n_heads, q0 = (item % n_qt) * kBQ;

  // rows g and g + 8, log2 domain: running max, this thread's share of
  // the sum, the rescale that ctx still owes to the last max
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.0f, l1 = 0.0f;
  float c0 = 1.0f, c1 = 1.0f;
  float o[NSUB][W / 2];
#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[sub][i] = 0.0f;
  }
  float sc[BK / 2];         // scores of a tile, then its probabilities
  uint32_t pa[BK / 16][4];  // probabilities of tile t, in T

  // the block's first tile: its scores alone
  mbar_wait(q_full(0), 0);
  mbar_wait(k_full(0), 0);
  wgmma::fence_regs(sc);
  wgmma::fence();
  issue_scores<T, DHP>(sc, q_addr(0), k_addr(0));
  wgmma::wait<0>();
  wgmma::fence_regs(sc);
  softmax_tile<DHP>(sc, bias, plain(0), scale_log2, t4, m0, m1, l0, l1, c0, c1);
  release(k_empty(0));  // k and its bias are read
  if (n_kt == 1) release(q_empty(0));  // the item's last q.k^T is done
  pack_probs<T, DHP>(pa, sc);

  for (;;) {
    // tile t + 1: the next of this item, or the first of the next item
    const bool next_item = j + 1 == n_kt;
    const int item_n = next_item ? item + int(gridDim.x) : item;
    if (item_n >= n_items) break;
    const int it_n = it + next_item;
    const int j_n = next_item ? 0 : j + 1;
    if (next_item) mbar_wait(q_full(it_n % QBUF), (it_n / QBUF) & 1);
    mbar_wait(k_full((t + 1) % STAGES), ((t + 1) / STAGES) & 1);
    mbar_wait(v_full(t % STAGES), (t / STAGES) & 1);
    rescale_ctx<DHP>(o, pa, c0, c1);
    wgmma::fence_regs(sc);
    wgmma::fence();
    issue_scores<T, DHP>(sc, q_addr(it_n), k_addr(t + 1));
    issue_pv<T, DHP>(o, pa, v_addr(t));
    wgmma::wait<1>();
    wgmma::fence_regs(sc);
    // a new item starts its own max and sum; this item's sum waits for
    // its last product
    const float s0 = l0, s1 = l1;
    if (next_item) {
      m0 = m1 = -CUDART_INF_F;
      l0 = l1 = 0.0f;
    }
    softmax_tile<DHP>(sc, bias + ((t + 1) % STAGES) * BK, plain(t + 1), scale_log2, t4, m0, m1, l0,
                      l1, c0, c1);
    release(k_empty((t + 1) % STAGES));
    if (j_n + 1 == n_kt) release(q_empty(it_n % QBUF));
    wgmma::wait<0>();
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) wgmma::fence_regs(o[sub]);
    release(v_empty(t % STAGES));
    if (next_item) {
      store_ctx(o, s0, s1, bi, hi, q0);
      // the next item's first product rescales ctx by exp2(-inf) = 0
      bh = item_n / n_qt;
      bi = bh / n_heads;
      hi = bh - bi * n_heads;
      q0 = (item_n % n_qt) * kBQ;
    }
    pack_probs<T, DHP>(pa, sc);
    item = item_n;
    it = it_n;
    j = j_n;
    ++t;
  }

  // the block's last tile's p.v
  mbar_wait(v_full(t % STAGES), (t / STAGES) & 1);
  rescale_ctx<DHP>(o, pa, c0, c1);
  wgmma::fence();
  issue_pv<T, DHP>(o, pa, v_addr(t));
  wgmma::wait<0>();
#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub) wgmma::fence_regs(o[sub]);
  release(v_empty(t % STAGES));
  store_ctx(o, l0, l1, bi, hi, q0);
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

template <typename T, int DHP>
int launch_wgmma(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads,
                 float scale, cudaStream_t stream) {
  using C = Wg<DHP>;
  const int dh = d / n_heads;
  const int n_qt = (s + kBQ - 1) / kBQ;
  const long long items = static_cast<long long>(b) * n_heads * n_qt;
  if (items >= (1ll << 31)) return int(cudaErrorInvalidConfiguration);
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return kNoEncoder;
  // qkv as {column of the head, head slot (q heads, then k, then v), row,
  // batch row}: a box reads one head's columns only, and columns past dh
  // and rows past s arrive as zeros
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(3 * n_heads), cuuint64_t(s), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(dh) * sizeof(T), cuuint64_t(3) * d * sizeof(T),
                                 cuuint64_t(s) * 3 * d * sizeof(T)};
  const cuuint32_t q_box[4] = {C::W, 1, kBQ, 1};
  const cuuint32_t kv_box[4] = {C::W, 1, C::BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swizzle = C::SB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : C::SB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t* boxes[2] = {q_box, kv_box};
  CUtensorMap maps[2];  // q, then k and v
  for (int i = 0; i < 2; ++i) {
    const CUresult r = encode(&maps[i], type, 4, const_cast<void*>(qkv), dims, strides, boxes[i],
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kTensorMapError + int(r);
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(wgmma_attention_kernel<T, DHP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::smem));
  }
  if (e != cudaSuccess) return int(e);
  // persistent: one block an SM walks the work items (row, head, 128
  // queries) in steps of the grid
  const int grid = int(items < sms ? items : sms);
  wgmma_attention_kernel<T, DHP><<<grid, kWgThreads, C::smem, stream>>>(
      maps[0], maps[1], static_cast<const int32_t*>(mask), static_cast<T*>(out), s, d, n_heads, dh,
      n_qt, int(items), scale * kLog2e);
  return int(cudaGetLastError());
}

// the least instantiated width >= dh
template <typename T>
int launch_wgmma_dh(const void* qkv, const void* mask, void* out, int b, int s, int d,
                    int n_heads, float scale, cudaStream_t stream) {
  const int dh = d / n_heads;
  if (dh <= 16) return launch_wgmma<T, 16>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 32) return launch_wgmma<T, 32>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 64) return launch_wgmma<T, 64>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 96) return launch_wgmma<T, 96>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 128) return launch_wgmma<T, 128>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  return launch_wgmma<T, 256>(qkv, mask, out, b, s, d, n_heads, scale, stream);
}

// --------------------------- (4) any head width: one pass, or two

constexpr int kAwThreads = 256;   // 8 warps of 16 query rows
constexpr int kAwBQ = 128;        // queries a block (fewer only where a wide q does not fit)
constexpr int kAwSP = 128;        // keys the one-pass mode holds: s <= 128
constexpr int kAwChunk = 320;     // ctx columns a pass of the wide mode
constexpr size_t kSmemMax = 232448;  // a block's shared memory on the H100

// The two-pass modes, past the one-pass lengths: kTwoPass for narrow
// heads (the column width DC 16 or 32, 4 or 2 heads a block), kWide for
// the rest (ctx in chunks of kAwChunk columns; q.k^T in chunks of KC
// columns where q does not stay whole).
enum AwMode { kTwoPass = 0, kWide = 1 };

template <typename T, int DC, int MODE>
struct Aw {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // elements a shared-memory row holds past its columns: an odd number of
  // 16-byte chunks a row at 16 bits (the 8 rows of an `ldmatrix` hit 8
  // bank groups), a row stride of 4 mod 8 floats at f32 (the fragment
  // reads of a warp hit 32 banks)
  static constexpr int PAD = F32 ? 4 : 8;
  static constexpr int HPB = MODE == kWide ? 1 : DC <= 16 ? 4 : 2;  // heads a block
  static constexpr int BK = MODE == kWide ? (F32 ? 16 : 32) : (F32 ? 32 : 64);  // keys a tile
  static constexpr int NT = BK / 8;    // n-tiles of a warp's score tile
  static constexpr int NN = DC / 8;    // n-tiles of a warp's ctx
  static constexpr int LD = DC + PAD;  // row stride: q, k and v (v only, in kWide)
  static constexpr int NST = 2;        // key-tile stages (kWide: 1 or 2, by fit)
  static constexpr int KC = F32 ? 128 : 256;  // kWide's q.k^T columns a stage, where q does not stay whole
  // kTwoPass's shared memory: q [HPB][128][LD]; a stage is k and v
  // [HPB][BK][LD] and the key bias [BK] in f32
  static constexpr size_t stage = size_t(2) * HPB * BK * LD * sizeof(T) + BK * 4;
  static constexpr size_t smem = size_t(HPB) * kAwBQ * LD * sizeof(T) + NST * stage;
  static_assert(DC % 16 == 0 && (MODE == kWide || smem <= kSmemMax), "a block's shared memory");
};

// The one-pass mode: s <= 128 and dh <= 128. A persistent block walks the
// work items (batch row, HPB heads) in steps of the grid; every key of an
// item's heads sits in shared memory with its q and v, and warp w holds
// the scores of rows 16w .. 16w + 15 against all of them in registers (64
// floats a thread): the exact max and sum, one exp2 a score. Two buffers
// where they fit: the next item's copies (one cp.async group) land while
// this one's products run. One block barrier an item.
template <typename T, int DC>
struct AwOne {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int PAD = F32 ? 4 : 8;
  static constexpr int HPB = DC <= 16 ? 2 : 1;  // heads an item
  static constexpr int NT = kAwSP / 8;
  static constexpr int NN = DC / 8;
  static constexpr int LD = DC + PAD;
  static constexpr size_t head = size_t(kAwSP) * LD * sizeof(T);  // one head's q, k or v
  // a buffer: q, k and v of the item's heads, then the key bias [128] in f32
  static constexpr size_t buf = 3 * HPB * head + kAwSP * 4;
  // two blocks an SM at the narrow widths in 16 bits: 128 registers a
  // thread (f32 spills there)
  static constexpr int MINB = DC <= 32 && !F32 ? 2 : 1;
  // two buffers where they fit: the copies run one item ahead
  static constexpr int NBUF = 2 * buf <= kSmemMax ? 2 : 1;
  static constexpr size_t smem = NBUF * buf;
  static_assert(DC % 16 == 0 && DC <= 128, "a column width of 16 to 128");
};

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(x);
  } else {
    return __float2bfloat16_rn(x);
  }
}

__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// c += a.b, m16n8k16 with f32 sums, in bf16 or f16
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    mma_bf16(c, a, b0, b1);
  }
}

// An f32 A fragment split for 3xTF32
struct SplitA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ SplitA(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

// c += a.b at f32: 3xTF32 into a fresh accumulator added to c in f32; the
// tensor cores' own accumulation drifts over a long chain (2.2e-5 from the
// plain version, past its 1e-5 bound, at dh 1024 and s 64 when c took
// every product)
__device__ __forceinline__ void mma_f32(float (&c)[4], const SplitA& a, float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_3xtf32(t, a.big, a.small, bb0, bb1, bs0, bs1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// The largest copy, in bytes, that divides a head's row: heads, their k
// and v and their rows all start on multiples of it (qkv 16-byte aligned)
__host__ __device__ constexpr int granule(int head_bytes) {
  return head_bytes % 16 == 0 ? 16 : head_bytes % 8 == 0 ? 8 : head_bytes % 4 == 0 ? 4 : 2;
}

// How a warp's lanes cover ncols columns of a head's rows in gran-byte
// copies (gran: 16, 8 or 4 bytes by cp.async, the largest that divides a
// head row, so every copy lands whole inside one head; 2, element by
// element, a head of odd width at 16 bits), worked out once a kernel or a
// chunk: ng copies a row; where ng < 32 lane takes copy c0 of row rs of
// each step of 32 / ng rows, else copies c0, c0 + 32, ... of every row, so
// that neighbouring lanes read neighbouring bytes
template <typename T>
struct HeadCopies {
  int per, ng, rs, rstep, c0;
  __device__ __forceinline__ HeadCopies(int ncols, int gran) {
    const int lane = threadIdx.x & 31;
    per = gran / int(sizeof(T));
    ng = ncols / per;
    rstep = ng < 32 ? 32 / ng : 1;
    rs = ng < 32 ? lane / ng : 0;
    c0 = ng < 32 ? lane - rs * ng : lane;
    if (rs >= rstep) c0 = ng;  // an idle lane
  }
};

// Rows r0 .. r0 + rows - 1 of one head (src: its first column at row 0)
// into dst [row][column] (stride ld), rows past s zero-filled, by the
// block's warps
template <typename T>
__device__ __forceinline__ void load_head(T* dst, int ld, int rows, const T* src, size_t row_stride, int r0,
                                          int s, const HeadCopies<T>& hc, int gran) {
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int c = hc.c0 * hc.per; c < hc.ng * hc.per; c += 32 * hc.per) {
    for (int r = warp * hc.rstep + hc.rs; r < rows; r += nw * hc.rstep) {
      const bool in = r0 + r < s;
      const T* gp = in ? src + size_t(r0 + r) * row_stride + c : src;
      T* sp = dst + size_t(r) * ld + c;
      if (gran == 16) {
        cp_async_16(smem_addr(sp), gp, in ? 16 : 0);
      } else if (gran == 8) {
        cp_async_8(smem_addr(sp), gp, in ? 8 : 0);
      } else if (gran == 4) {
        cp_async_4(smem_addr(sp), gp, in ? 4 : 0);
      } else {
        *sp = in ? *gp : from_f32<T>(0.0f);
      }
    }
  }
}

// Columns dh .. dhp - 1 of n rows (stride ld) to zero: q.k^T reads them
template <typename T>
__device__ __forceinline__ void zero_cols(T* dst, int n, int ld, int dh, int dhp) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    for (int c = dh; c < dhp; ++c) dst[size_t(r) * ld + c] = from_f32<T>(0.0f);
  }
}

// The key bias of keys k0 .. k0 + n - 1 in the log2 domain: 0, -1e30 for
// padding, -inf past s (those keys drop out of the softmax, so a row of
// padding averages exactly its s keys)
__device__ __forceinline__ void fill_bias(float* bias, int n, const int32_t* __restrict__ mrow, int k0, int s) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = k0 + i;
    bias[i] = j < s ? (mrow[j] == 0 ? -1e30f : 0.0f) : -CUDART_INF_F;
  }
}

// sc += q.k^T for the warp's 16 rows (q_w, row stride ld) against the
// tile's keys (k_t [key][column]), over columns 0 .. 16 nks - 1; 16-key
// groups from live16 on are skipped (their keys all lie past s)
template <typename T, int NT>
__device__ __forceinline__ void qk_acc(float (&sc)[NT][4], const T* q_w, const T* k_t, int ld, int nks,
                                       int live16) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2;
    const int t4 = lane & 3;
    // rolled: unrolled, the 3xTF32 splits of every k-step spilled
#pragma unroll 1
    for (int ks = 0; ks < 2 * nks; ++ks) {
      // A (16 x 8): (g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4)
      const float* qp = q_w + g * ld + 8 * ks + t4;
      const SplitA a(qp[0], qp[8 * ld], qp[4], qp[8 * ld + 4]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n / 2 < live16) {
          // B (k = column, n = key): (t4, g), (t4 + 4, g)
          const float* kp = k_t + (8 * n + g) * ld + 8 * ks + t4;
          mma_f32(sc[n], a, kp[0], kp[4]);
        }
      }
    }
  } else {
    // A: matrix (lane >> 3) is rows +0/+8 (bit 0), columns +0/+8 (bit 1);
    // B: keys +0 (columns +0, +8), keys +8 (columns +0, +8)
    const uint32_t qa = smem_addr(q_w + (lane & 15) * ld + 8 * (lane >> 4));
    const uint32_t ka = smem_addr(k_t + ((lane & 7) + 8 * (lane >> 4)) * ld + 8 * ((lane >> 3) & 1));
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + 32 * ks);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        if (p < live16) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ka + 2 * (16 * p * ld) + 32 * ks);
          mma16<T>(sc[2 * p], a, kb[0], kb[1]);
          mma16<T>(sc[2 * p + 1], a, kb[2], kb[3]);
        }
      }
    }
  }
}

// o += p.v: p the warp's normalised probabilities over the tile's keys
// (the scores' accumulator layout), rounded to T here, the Pallas kernel's
// rounding point (at f32 nothing is rounded); v_t [key][column]; 16-key
// groups from live16 on and 16-column groups from live_c16 on are skipped
template <typename T, int NT, int NN>
__device__ __forceinline__ void pv_acc(float (&o)[NN][4], const float (&p)[NT][4], const T* v_t, int ld,
                                       int live16, int live_c16) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2;
    const int t4 = lane & 3;
    // the 8 keys of n-tile n as one k-step, permuted: k-index t4 is key
    // 8n + 2t4, k-index t4 + 4 is key 8n + 2t4 + 1
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n / 2 < live16) {
        const SplitA a(p[n][0], p[n][2], p[n][1], p[n][3]);
        const float* vp = v_t + (8 * n + 2 * t4) * ld + g;
#pragma unroll
        for (int c = 0; c < NN; ++c) {
          // B (k = key, n = column): (key 2t4, 8c + g), (key 2t4 + 1, 8c + g)
          if (c / 2 < live_c16) mma_f32(o[c], a, vp[8 * c], vp[ld + 8 * c]);
        }
      }
    }
  } else {
    // a narrow ctx takes the odd key steps into a second accumulator, so
    // that two chains of products run side by side
    constexpr bool TWO = NN <= 4;
    float o2[TWO ? NN : 1][4];
#pragma unroll
    for (int c = 0; c < (TWO ? NN : 1); ++c) o2[c][0] = o2[c][1] = o2[c][2] = o2[c][3] = 0.0f;
    // transposed matrices: keys +0/+8 (bit 0), columns +0/+8 (bit 1)
    const uint32_t va = smem_addr(v_t + (lane & 15) * ld + 8 * (lane >> 4));
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk < live16) {
        // A of key step kk: n-tiles 2kk (a0, a1) and 2kk + 1 (a2, a3)
        const uint32_t a[4] = {pack2<T>(p[2 * kk][0], p[2 * kk][1]), pack2<T>(p[2 * kk][2], p[2 * kk][3]),
                               pack2<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                               pack2<T>(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
        for (int cc = 0; cc < NN / 2; ++cc) {
          if (cc < live_c16) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, va + 2 * (16 * kk * ld + 16 * cc));
            if (TWO && (kk & 1)) {
              mma16<T>(o2[2 * cc], a, vb[0], vb[1]);
              mma16<T>(o2[2 * cc + 1], a, vb[2], vb[3]);
            } else {
              mma16<T>(o[2 * cc], a, vb[0], vb[1]);
              mma16<T>(o[2 * cc + 1], a, vb[2], vb[3]);
            }
          }
        }
      }
    }
    if constexpr (TWO) {
#pragma unroll
      for (int c = 0; c < NN; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o[c][i] += o2[c][i];
      }
    }
  }
}

// sc = sc * scale_log2 + bias (the tile's key bias); with MAX, the row
// maxima of rows g and g + 8 over the tile, across the lane quad
template <int NT, bool MAX = true>
__device__ __forceinline__ void scale_bias(float (&sc)[NT][4], const float* bias, float scale_log2,
                                           float& mx0, float& mx1) {
  const int t4 = threadIdx.x & 3;
  // four partial maxima a row: short dependency chains
  float a0[4], a1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a0[i] = a1[i] = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * t4);
    sc[n][0] = fmaf(sc[n][0], scale_log2, b.x);
    sc[n][1] = fmaf(sc[n][1], scale_log2, b.y);
    sc[n][2] = fmaf(sc[n][2], scale_log2, b.x);
    sc[n][3] = fmaf(sc[n][3], scale_log2, b.y);
    a0[n & 3] = fmaxf(a0[n & 3], fmaxf(sc[n][0], sc[n][1]));
    a1[n & 3] = fmaxf(a1[n & 3], fmaxf(sc[n][2], sc[n][3]));
  }
  mx0 = fmaxf(fmaxf(a0[0], a0[1]), fmaxf(a0[2], a0[3]));
  mx1 = fmaxf(fmaxf(a1[0], a1[1]), fmaxf(a1[2], a1[3]));
  if (MAX) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
  }
}

// sc = exp2(sc - max) for the 16-key groups below live16 (0 past them),
// and the row sums of rows g and g + 8 across the lane quad
template <int NT>
__device__ __forceinline__ void exp_sum(float (&sc)[NT][4], float m0, float m1, int live16, float& l0,
                                        float& l1) {
  float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n / 2 < live16) {
      sc[n][0] = exp2_approx(sc[n][0] - m0);
      sc[n][1] = exp2_approx(sc[n][1] - m0);
      sc[n][2] = exp2_approx(sc[n][2] - m1);
      sc[n][3] = exp2_approx(sc[n][3] - m1);
      s0[n & 3] += sc[n][0] + sc[n][1];
      s1[n & 3] += sc[n][2] + sc[n][3];
    } else {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
    }
  }
  l0 = (s0[0] + s0[1]) + (s0[2] + s0[3]);
  l1 = (s1[0] + s1[1]) + (s1[2] + s1[3]);
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
}

// Rows r = w rstep + rs, + nw rstep, ... below `rows` of src (stride ld)
// out to dst (row stride `stride`) in the plan's gran-byte copies: warp w
// of nw
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, size_t stride, const T* src, int ld, int rows,
                                          const HeadCopies<T>& hc, int gran, int w, int nw) {
  for (int c = hc.c0 * hc.per; c < hc.ng * hc.per; c += 32 * hc.per) {
    for (int r = w * hc.rstep + hc.rs; r < rows; r += nw * hc.rstep) {
      const T* sp = src + r * ld + c;
      T* gp = dst + size_t(r) * stride + c;
      if (gran == 16) {
        *reinterpret_cast<uint4*>(gp) = *reinterpret_cast<const uint4*>(sp);
      } else if (gran == 8) {
        *reinterpret_cast<uint2*>(gp) = *reinterpret_cast<const uint2*>(sp);
      } else if (gran == 4) {
        *reinterpret_cast<uint32_t*>(gp) = *reinterpret_cast<const uint32_t*>(sp);
      } else {
        *gp = *sp;
      }
    }
  }
}

// ctx of 16 rows (a warp's, g and g + 8 of each m-tile) in T into stage
// (stride ld), columns below dcols
template <typename T, int NN>
__device__ __forceinline__ void stage_ctx(const float (&o)[NN][4], T* stage, int ld, int dcols) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    if (8 * n < dcols) {
      T* r0 = stage + g * ld + 8 * n + 2 * t4;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(r0) = make_float2(o[n][0], o[n][1]);
        *reinterpret_cast<float2*>(r0 + 8 * ld) = make_float2(o[n][2], o[n][3]);
      } else {
        *reinterpret_cast<uint32_t*>(r0) = pack2<T>(o[n][0], o[n][1]);
        *reinterpret_cast<uint32_t*>(r0 + 8 * ld) = pack2<T>(o[n][2], o[n][3]);
      }
    }
  }
}

// ctx of the warp's 16 rows in T into its own rows of q (stage, stride
// ld; no other warp reads them), then rows below `rows` out to dst (row
// stride `stride`) in the plan's copies
template <typename T, int NN>
__device__ __forceinline__ void store_ctx(const float (&o)[NN][4], T* stage, int ld, int dcols, T* dst,
                                          size_t stride, int rows, const HeadCopies<T>& hc, int gran) {
  __syncwarp();
  stage_ctx<T, NN>(o, stage, ld, dcols);
  __syncwarp();
  copy_rows(dst, stride, stage, ld, min(rows, 16), hc, gran, 0, 1);
}

// ctx of the warp's 16 rows straight from the registers, for a chunk of
// columns c0 .. c0 + ncols - 1 of a head that has more (q still holds the
// head): column pairs where the head width is even, else one at a time
template <typename T, int NN>
__device__ __forceinline__ void store_ctx_direct(const float (&o)[NN][4], T* dst, size_t stride, int rows,
                                                 int ncols, bool pairs) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = 8 * n + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      T* gp = dst + size_t(r) * stride + col;
      if (r < rows && col < ncols) {
        if (pairs) {
          if constexpr (std::is_same<T, float>::value) {
            *reinterpret_cast<float2*>(gp) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
          } else {
            *reinterpret_cast<uint32_t*>(gp) = pack2<T>(o[n][2 * h], o[n][2 * h + 1]);
          }
        } else {
          gp[0] = from_f32<T>(o[n][2 * h]);
          if (col + 1 < ncols) gp[1] = from_f32<T>(o[n][2 * h + 1]);
        }
      }
    }
  }
}

// One block: up to HPB heads (head group) of one batch row and a block of
// bq = 16 * warps queries; warp w owns query rows 16w .. 16w + 15 of each
// head. Block ((bi * head groups) + group) * n_qb + query block.
template <typename T, int DC, int MODE>
__global__ void __launch_bounds__(kAwThreads, 1)
    any_width_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ mask, T* __restrict__ out, int s,
                     int d, int n_heads, int dh, int n_qb, int nst_wide, int kc_wide, int gran,
                     float scale_log2) {
  using A = Aw<T, DC, MODE>;
  constexpr int HPB = A::HPB;
  constexpr int BK = A::BK;
  constexpr int NT = A::NT;
  constexpr int NN = A::NN;
  constexpr int LDV = A::LD;
  constexpr bool WIDE = MODE == kWide;

  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int bq = WIDE ? int(blockDim.x >> 1) : kAwBQ;
  const int nst = WIDE ? nst_wide : A::NST;
  const int n_hg = (n_heads + HPB - 1) / HPB;
  const int qb = blockIdx.x % n_qb;
  const int bh = blockIdx.x / n_qb;
  const int bi = bh / n_hg;
  const int h0 = (bh - bi * n_hg) * HPB;
  const int nh = min(HPB, n_heads - h0);
  const int q0 = qb * bq;
  const int row0 = q0 + warp * 16;  // the warp's first query row
  // a warp whose 16 query rows all lie past s loads and waits with the
  // block but computes nothing
  const bool active = row0 < s;
  // q and k rows hold the head's columns padded to 16 (the kWide head), or
  // DC; a kWide head too wide for q to stay whole takes q.k^T in chunks
  // of kc columns, q's with k's in every stage (q read again each key tile)
  const int dhp = WIDE ? (dh + 15) & ~15 : DC;
  const int kc = WIDE ? kc_wide : DC;
  const bool q_whole = kc >= dhp;
  const int n_ch = q_whole ? 1 : (dhp + kc - 1) / kc;
  const int ldk = (q_whole ? dhp : kc) + A::PAD;
  const size_t row_stride = size_t(3) * d;
  const T* q_g = qkv + size_t(bi) * s * row_stride + size_t(h0) * dh;
  const T* k_g = q_g + d;
  const T* v_g = q_g + 2 * size_t(d);
  const int32_t* mrow = mask + size_t(bi) * s;
  T* out_w = out + (size_t(bi) * s + row0) * d + size_t(h0) * dh;

  // q [HPB][bq][ldk] where it stays whole; then nst stages of q's chunk
  // [bq][ldk] (where it does not), k [HPB][BK][ldk], v [HPB][BK][LDV],
  // bias [BK]
  T* q_s = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + (q_whole ? size_t(HPB) * bq * ldk * sizeof(T) : 0);
  const size_t qc_bytes = q_whole ? 0 : size_t(bq) * ldk * sizeof(T);
  const size_t k_bytes = size_t(HPB) * BK * ldk * sizeof(T);
  const size_t stage_bytes = qc_bytes + k_bytes + size_t(HPB) * BK * LDV * sizeof(T) + BK * 4;
  auto qc_st = [&](int st) { return reinterpret_cast<T*>(ring + st * stage_bytes); };
  auto k_st = [&](int st, int j) {
    return reinterpret_cast<T*>(ring + st * stage_bytes + qc_bytes) + j * BK * ldk;
  };
  auto v_st = [&](int st, int j) {
    return reinterpret_cast<T*>(ring + st * stage_bytes + qc_bytes + k_bytes) + j * BK * LDV;
  };
  auto bias_st = [&](int st) { return reinterpret_cast<float*>(ring + (st + 1) * stage_bytes - BK * 4); };
  // the warp's rows of head j's q, whole or the stage's chunk
  auto q_w = [&](int j, int st) {
    return (q_whole ? q_s + j * bq * ldk : qc_st(st)) + warp * 16 * ldk;
  };

  if (q_whole && dh < dhp) {
    zero_cols(q_s, HPB * bq, ldk, dh, dhp);
    for (int st = 0; st < nst; ++st) zero_cols(k_st(st, 0), HPB * BK, ldk, dh, dhp);
  }

  const HeadCopies<T> hc(dh, gran);
  if (q_whole) {
    for (int j = 0; j < nh; ++j) {
      load_head(q_s + j * bq * ldk, ldk, bq, q_g + j * dh, row_stride, q0, s, hc, gran);
    }
  }
  cp_async_commit();
  const int n_kt = (s + BK - 1) / BK;
  const int n_units = n_kt * n_ch;  // (key tile, column chunk of q.k^T)
  // unit u (key tile u / n_ch, chunk u % n_ch) into stage u % nst as one
  // cp.async group: k (and where q is not whole, q) at the chunk's
  // columns; with the tile's last chunk its bias and, with a plan hv, v's
  // columns from c0
  auto issue = [&](int u, int c0, const HeadCopies<T>* hv) {
    const int st = u % nst;
    const int t = u / n_ch;
    const int c = u - t * n_ch;
    if (q_whole) {
      for (int j = 0; j < nh; ++j) load_head(k_st(st, j), ldk, BK, k_g + j * dh, row_stride, t * BK, s, hc, gran);
    } else {
      const int ncols = min(kc, dh - c * kc);
      if (ncols < kc) {  // the last chunk: zeros past the head, which q.k^T reads
        zero_cols(qc_st(st), bq, ldk, ncols, kc);
        zero_cols(k_st(st, 0), BK, ldk, ncols, kc);
      }
      const HeadCopies<T> hk(ncols, gran);
      load_head(qc_st(st), ldk, bq, q_g + c * kc, row_stride, q0, s, hk, gran);
      load_head(k_st(st, 0), ldk, BK, k_g + c * kc, row_stride, t * BK, s, hk, gran);
    }
    if (c == n_ch - 1) {
      if (hv) {
        for (int j = 0; j < nh; ++j) {
          load_head(v_st(st, j), LDV, BK, v_g + j * dh + c0, row_stride, t * BK, s, *hv, gran);
        }
      }
      fill_bias(bias_st(st), BK, mrow, t * BK, s);
    }
    cp_async_commit();
  };
  // body(chunk, stage) over the units: with two stages the next unit's
  // copies are in flight while this one's products run
  auto key_loop = [&](int c0, const HeadCopies<T>* hv, auto&& body) {
    issue(0, c0, hv);
    for (int u = 0; u < n_units; ++u) {
      if (nst > 1 && u + 1 < n_units) {
        issue(u + 1, c0, hv);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      body(u % n_ch, u % nst);
      __syncthreads();  // every warp is done with the stage the next copies overwrite
      if (nst == 1 && u + 1 < n_units) issue(u + 1, c0, hv);
    }
  };
  // the scores of the warp's rows of head j against the unit's keys,
  // summed over the chunks: zeroed at a tile's first chunk
  float sc[NT][4];
  auto scores = [&](int j, int c, int st) {
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
    }
    qk_acc<T, NT>(sc, q_w(j, st), k_st(st, j), ldk, min(kc, dhp - c * kc) / 16, NT / 2);
  };

  // pass 1: each row's max and sum, online over the key tiles; key 0 < s
  // lies in the first tile with a finite score, so the max is finite
  // from there on and the first rescale is exp2(-inf) = 0
  float m[HPB][2], l[HPB][2];
#pragma unroll
  for (int j = 0; j < HPB; ++j) {
    m[j][0] = m[j][1] = -CUDART_INF_F;
    l[j][0] = l[j][1] = 0.0f;
  }
  key_loop(0, nullptr, [&](int c, int st) {
    if (!active) return;
#pragma unroll
    for (int j = 0; j < HPB; ++j) {
      if (j < nh) {
        scores(j, c, st);
        if (c < n_ch - 1) continue;
        float mx0, mx1;
        scale_bias<NT>(sc, bias_st(st), scale_log2, mx0, mx1);
        mx0 = fmaxf(mx0, m[j][0]);
        mx1 = fmaxf(mx1, m[j][1]);
        l[j][0] *= exp2_approx(m[j][0] - mx0);
        l[j][1] *= exp2_approx(m[j][1] - mx1);
        m[j][0] = mx0;
        m[j][1] = mx1;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          l[j][0] += exp2_approx(sc[n][0] - mx0) + exp2_approx(sc[n][1] - mx0);
          l[j][1] += exp2_approx(sc[n][2] - mx1) + exp2_approx(sc[n][3] - mx1);
        }
      }
    }
  });
#pragma unroll
  for (int j = 0; j < HPB; ++j) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l[j][0] += __shfl_xor_sync(0xffffffffu, l[j][0], x);
      l[j][1] += __shfl_xor_sync(0xffffffffu, l[j][1], x);
    }
    l[j][0] = 1.0f / l[j][0];
    l[j][1] = 1.0f / l[j][1];
  }

  // pass 2: the scores again, the normalised probabilities rounded to T
  // and p.v over the whole head (kWide: DC columns of ctx a pass)
  for (int c0 = 0; c0 < dh; c0 += DC) {
    const int vcols = min(DC, dh - c0);
    float o[HPB][NN][4];
#pragma unroll
    for (int j = 0; j < HPB; ++j) {
#pragma unroll
      for (int c = 0; c < NN; ++c) o[j][c][0] = o[j][c][1] = o[j][c][2] = o[j][c][3] = 0.0f;
    }
    const int live_c16 = (vcols + 15) >> 4;
    const HeadCopies<T> hv(vcols, gran);
    key_loop(c0, &hv, [&](int c, int st) {
      if (!active) return;
#pragma unroll
      for (int j = 0; j < HPB; ++j) {
        if (j < nh) {
          scores(j, c, st);
          if (c < n_ch - 1) continue;
          float unused0, unused1;
          scale_bias<NT, false>(sc, bias_st(st), scale_log2, unused0, unused1);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            sc[n][0] = exp2_approx(sc[n][0] - m[j][0]) * l[j][0];
            sc[n][1] = exp2_approx(sc[n][1] - m[j][0]) * l[j][0];
            sc[n][2] = exp2_approx(sc[n][2] - m[j][1]) * l[j][1];
            sc[n][3] = exp2_approx(sc[n][3] - m[j][1]) * l[j][1];
          }
          pv_acc<T, NT, NN>(o[j], sc, v_st(st, j), LDV, NT / 2, live_c16);
        }
      }
    });
    if (active) {
#pragma unroll
      for (int j = 0; j < HPB; ++j) {
        if (j < nh) {
          if (!WIDE || (q_whole && vcols == dh)) {
            // q is done with: ctx through the warp's own q rows
            store_ctx<T, NN>(o[j], q_w(j, 0), ldk, dhp, out_w + j * dh, d, s - row0, hc, gran);
          } else {
            store_ctx_direct<T, NN>(o[j], out_w + c0, d, s - row0, vcols, dh % 2 == 0);
          }
        }
      }
    }
  }
}

// One head of a one-pass item for the warp's 16 rows (q_w, row stride LD)
// against the item's keys (k and v [128][LD], their bias): the scores,
// the exact max and sum, one exp2 a score, the normalised probabilities
// rounded to T, p.v, and ctx out through q_w's rows. LIVE16: the 16-key
// groups that hold a key < s, where the launch knows it; 0 reads live16.
template <typename T, int DC, int LIVE16>
__device__ __forceinline__ void one_head(T* q_w, const T* k, const T* v, const float* bias, int live16,
                                         float scale_log2, T* out_w, int d, int rows, const HeadCopies<T>& hc,
                                         int gran) {
  using A = AwOne<T, DC>;
  constexpr int NT = A::NT;
  constexpr int NN = A::NN;
  const int lv = LIVE16 > 0 ? LIVE16 : live16;
  float sc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
  qk_acc<T, NT>(sc, q_w, k, A::LD, DC / 16, lv);
  float m0, m1, l0, l1;
  scale_bias<NT>(sc, bias, scale_log2, m0, m1);
  exp_sum<NT>(sc, m0, m1, lv, l0, l1);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    sc[n][0] *= inv0;
    sc[n][1] *= inv0;
    sc[n][2] *= inv1;
    sc[n][3] *= inv1;
  }
  float o[NN][4];
#pragma unroll
  for (int c = 0; c < NN; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
  pv_acc<T, NT, NN>(o, sc, v, A::LD, lv, NN / 2);
  // q is done with: ctx through the warp's own q rows
  store_ctx<T, NN>(o, q_w, A::LD, DC, out_w, d, rows, hc, gran);
}

template <typename T, int DC>
__global__ void __launch_bounds__(kAwThreads, AwOne<T, DC>::MINB)
    any_width_one_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ mask, T* __restrict__ out, int s,
                         int d, int n_heads, int dh, int items, int gran, float scale_log2) {
  using A = AwOne<T, DC>;
  constexpr int HPB = A::HPB;
  constexpr int NT = A::NT;
  constexpr int LD = A::LD;
  constexpr int NB = A::NBUF;

  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int row0 = warp * 16;  // the warp's first query row
  // a warp whose 16 query rows all lie past s loads and waits with the
  // block but computes nothing
  const bool active = row0 < s;
  const int n_hg = (n_heads + HPB - 1) / HPB;
  const size_t row_stride = size_t(3) * d;
  const int live16 = (s + 15) >> 4;  // 16-key groups that hold a key < s
  // buffer bf: q, k, v (which 0, 1, 2) of head j; the key bias
  auto head = [&](int bf, int which, int j) {
    return reinterpret_cast<T*>(smem + bf * A::buf + (which * HPB + j) * A::head);
  };
  auto bias = [&](int bf) { return reinterpret_cast<float*>(smem + bf * A::buf + 3 * HPB * A::head); };
  // q and k read their columns past dh; v's past dh are zero too, so that
  // ctx is 0 there and leaves q's zeros as they were when it passes
  // through q's rows
  if (dh < DC) {
    for (int bf = 0; bf < NB; ++bf) zero_cols(head(bf, 0, 0), 3 * HPB * kAwSP, LD, dh, DC);
  }
  const HeadCopies<T> hc(dh, gran);
  // item `it` (batch row, head group) into buffer bf as one cp.async group
  // (an empty one past the last item, so that the counts line up)
  auto issue = [&](int it, int bf) {
    const int bi = it / n_hg;
    const int h0 = (it - bi * n_hg) * HPB;
    const int nh = min(HPB, n_heads - h0);
    const T* q_g = qkv + size_t(bi) * s * row_stride + size_t(h0) * dh;
#pragma unroll
    for (int j = 0; j < HPB; ++j) {
      if (it < items && j < nh) {
#pragma unroll
        for (int which = 0; which < 3; ++which) {
          load_head(head(bf, which, j), LD, kAwSP, q_g + size_t(which) * d + j * dh, row_stride, 0, s, hc, gran);
        }
      }
    }
    cp_async_commit();
  };
  // the key bias of item `it`, read into a register of each of the first
  // 128 threads before the item's products and written to buffer bf after
  // them, so that no warp waits on the mask
  auto mask_of = [&](int it) {
    const int key = threadIdx.x;
    if (it >= items || key >= kAwSP) return 0.0f;
    return key < s ? (mask[size_t(it / n_hg) * s + key] == 0 ? -1e30f : 0.0f) : -CUDART_INF_F;
  };

  int bf = 0;
  issue(blockIdx.x, 0);
  if (threadIdx.x < kAwSP) bias(0)[threadIdx.x] = mask_of(blockIdx.x);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    float next_bias = 0.0f;
    if (NB > 1) {
      issue(it + gridDim.x, bf ^ 1);
      next_bias = mask_of(it + gridDim.x);
    }
    const int bi = it / n_hg;
    const int h0 = (it - bi * n_hg) * HPB;
    const int nh = min(HPB, n_heads - h0);
    T* out_w = out + (size_t(bi) * s + row0) * d + size_t(h0) * dh;
    cp_async_wait<NB - 1>();  // this item's copies, not the later ones'
    __syncthreads();
#pragma unroll
    for (int j = 0; j < HPB; ++j) {
      if (j < nh && active) {
        // the scores of the whole row: without guards where every 16-key
        // group holds a key < s
        T* q_w = head(bf, 0, j) + row0 * LD;
        if (live16 == NT / 2) {
          one_head<T, DC, NT / 2>(q_w, head(bf, 1, j), head(bf, 2, j), bias(bf), live16, scale_log2,
                                  out_w + j * dh, d, s - row0, hc, gran);
        } else {
          one_head<T, DC, 0>(q_w, head(bf, 1, j), head(bf, 2, j), bias(bf), live16, scale_log2,
                             out_w + j * dh, d, s - row0, hc, gran);
        }
      }
    }
    if (NB > 1 && threadIdx.x < kAwSP) bias(bf ^ 1)[threadIdx.x] = next_bias;
    __syncthreads();  // every warp is done with buffer bf, the item after next's
    if (NB == 1 && it + int(gridDim.x) < items) {
      issue(it + gridDim.x, 0);
      if (threadIdx.x < kAwSP) bias(0)[threadIdx.x] = mask_of(it + gridDim.x);
    }
    bf ^= NB - 1;
  }
}

template <typename T, int DC>
int launch_aw_one(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads, float scale,
                  cudaStream_t stream) {
  using A = AwOne<T, DC>;
  const int dh = d / n_heads;
  const long long items = static_cast<long long>(b) * ((n_heads + A::HPB - 1) / A::HPB);
  if (items >= (1ll << 31)) return int(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && A::smem > 48 * 1024) {
    e = cudaFuncSetAttribute(any_width_one_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(A::smem));
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, any_width_one_kernel<T, DC>, kAwThreads, A::smem);
  }
  if (e != cudaSuccess) return int(e);
  // persistent: as many blocks as the SMs hold at once
  const long long full = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = int(items < full ? items : full);
  any_width_one_kernel<T, DC><<<grid, kAwThreads, A::smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int32_t*>(mask), static_cast<T*>(out), s, d, n_heads, dh,
      int(items), granule(dh * int(sizeof(T))), scale * kLog2e);
  return int(cudaGetLastError());
}

template <typename T, int DC, int MODE>
int launch_aw(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads, float scale,
              cudaStream_t stream) {
  using A = Aw<T, DC, MODE>;
  const int dh = d / n_heads;
  int bq = kAwBQ;
  int nst = A::NST;
  int kc = DC;
  size_t smem = A::smem;
  if (MODE == kWide) {
    // the largest block of queries whose q, at the head's whole width,
    // fits beside its key tiles, with two stages where they fit
    const int dhp = (dh + 15) & ~15;
    const size_t ldk = size_t(dhp + A::PAD) * sizeof(T);
    const size_t stage = A::BK * (ldk + A::LD * sizeof(T)) + A::BK * 4;
    kc = dhp;
    smem = 0;
    for (int cand = kAwBQ; cand >= 16 && smem == 0; cand /= 2) {
      for (int ns = 2; ns >= 1 && smem == 0; --ns) {
        if (cand * ldk + ns * stage <= kSmemMax) {
          bq = cand;
          nst = ns;
          smem = cand * ldk + ns * stage;
        }
      }
    }
    if (smem == 0) {
      // not even 16 queries of q fit whole: 128 queries, q.k^T in chunks
      // of KC columns of q and k, two stages
      const size_t ldc = size_t(A::KC + A::PAD) * sizeof(T);
      bq = kAwBQ;
      nst = 2;
      kc = A::KC;
      smem = 2 * (kAwBQ * ldc + A::BK * (ldc + A::LD * sizeof(T)) + A::BK * 4);
    }
  }
  const int n_qb = (s + bq - 1) / bq;
  const long long blocks = static_cast<long long>(b) * ((n_heads + A::HPB - 1) / A::HPB) * n_qb;
  if (blocks >= (1ll << 31)) return int(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(any_width_kernel<T, DC, MODE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  any_width_kernel<T, DC, MODE><<<unsigned(blocks), 2 * bq, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int32_t*>(mask), static_cast<T*>(out), s, d, n_heads,
      dh, n_qb, nst, kc, granule(dh * int(sizeof(T))), scale * kLog2e);
  return int(cudaGetLastError());
}

// The one-pass wide mode (kShared): s <= SP keys (256 or 512) and a head
// past the register one pass (dh > 128, or dh > 32 at s > 128). A block
// takes BQ queries (128 at SP 256, 64 at SP 512): warp w holds the scores
// of the 16 rows 16 (w % RT) .. + 15 against SP / KH keys (KH = 1 or 2
// key ranges a row, from (w / RT) SP / KH) in registers (128 floats a
// thread), summed over KC-column chunks of q and k streamed once through
// two stages; then the exact max and sum (across a row's KH warps through
// shared memory), one exp2 a score, and the normalised probabilities,
// rounded to T, into shared memory, where they replace the chunks. p.v
// follows with its own warp tiles: warp w takes rows 32 (w % RP) .. + 31
// and WC columns (w / RP) of each 320-column chunk of ctx, v streamed in
// tiles of 64 keys (32 at f32) through two stages.
template <typename T, int SP_>
struct AwShared {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int PAD = F32 ? 4 : 8;
  static constexpr int SP = SP_;
  static constexpr int BQ = SP == 256 ? 128 : 64;  // queries a block
  static constexpr int RT = BQ / 16;               // row tiles of the scores
  static constexpr int KH = 8 / RT;                // key ranges a row's scores are split in
  static constexpr int NT = SP / KH / 8;           // n-tiles of a warp's scores
  // columns a stage of q.k^T
  static constexpr int KC = (F32 ? 64 : 128) * 256 / SP;
  static constexpr int LDC = KC + PAD;  // q and k chunk row stride
  static constexpr int LDP = SP + PAD;  // probabilities row stride
  static constexpr int CW = 320;        // ctx columns a pass of p.v
  static constexpr int RP = BQ / 32;    // p.v row pairs of m-tiles
  static constexpr int WC = CW / (8 / RP);  // ctx columns a warp
  static constexpr int NN = WC / 8;         // n-tiles of a warp's ctx rows
  // v row stride: an odd number of 16-byte chunks at 16 bits; 8 mod 32
  // floats at f32 (the B fragments of a warp, keys t4 and columns g, hit
  // 32 banks)
  static constexpr int LDV = CW + 8;
  static constexpr int BKV = F32 ? 32 : 64;  // keys a v tile
  static constexpr size_t qk_stage = size_t(BQ + SP) * LDC * sizeof(T);
  static constexpr size_t p_bytes = size_t(BQ) * LDP * sizeof(T);
  static constexpr size_t v_stage = size_t(BKV) * LDV * sizeof(T);
  static constexpr size_t bias = SP * 4;
  // a row's partial maxima and sums from its KH warps
  static constexpr size_t red = KH > 1 ? size_t(2) * KH * BQ * 4 : 0;
  static constexpr size_t region = 2 * qk_stage > p_bytes + 2 * v_stage ? 2 * qk_stage : p_bytes + 2 * v_stage;
  static constexpr size_t smem = bias + red + region;
  static_assert(NT == 32 && NN % 2 == 0, "128 score floats a thread, 16-column steps of ctx");
  static_assert(smem <= kSmemMax && size_t(BQ) * LDV * sizeof(T) <= region, "a block's shared memory");
};

// o += p.v for a warp's 32 rows: p_w the probabilities (two m-tiles, row
// stride ldp, from the tile's first key), v_t the tile's v from the
// warp's first column; NK16 16-key steps; 16-column groups from live_c16
// on are skipped
template <typename T, int NK16, int NN>
__device__ __forceinline__ void pv_acc_smem(float (&o)[2][NN][4], const T* p_w, int ldp, const T* v_t, int ldv,
                                            int live_c16) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2;
    const int t4 = lane & 3;
#pragma unroll
    for (int kk = 0; kk < 2 * NK16; ++kk) {
      const float* pp = p_w + g * ldp + 8 * kk + t4;
      const SplitA a0(pp[0], pp[8 * ldp], pp[4], pp[8 * ldp + 4]);
      const SplitA a1(pp[16 * ldp], pp[24 * ldp], pp[16 * ldp + 4], pp[24 * ldp + 4]);
      const float* vp = v_t + (8 * kk + t4) * ldv + g;
#pragma unroll
      for (int c = 0; c < NN; ++c) {
        if (c / 2 < live_c16) {
          // B (k = key, n = column): (key t4, 8c + g), (key t4 + 4, 8c + g)
          mma_f32(o[0][c], a0, vp[8 * c], vp[4 * ldv + 8 * c]);
          mma_f32(o[1][c], a1, vp[8 * c], vp[4 * ldv + 8 * c]);
        }
      }
    }
  } else {
    const uint32_t pa = smem_addr(p_w + (lane & 15) * ldp + 8 * (lane >> 4));
    const uint32_t va = smem_addr(v_t + (lane & 15) * ldv + 8 * (lane >> 4));
#pragma unroll
    for (int kk = 0; kk < NK16; ++kk) {
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, pa + 32 * kk);
      ldmatrix_x4(a1, pa + 2 * 16 * ldp + 32 * kk);
#pragma unroll
      for (int cc = 0; cc < NN / 2; ++cc) {
        if (cc < live_c16) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, va + 2 * (16 * kk * ldv + 16 * cc));
          mma16<T>(o[0][2 * cc], a0, vb[0], vb[1]);
          mma16<T>(o[0][2 * cc + 1], a0, vb[2], vb[3]);
          mma16<T>(o[1][2 * cc], a1, vb[0], vb[1]);
          mma16<T>(o[1][2 * cc + 1], a1, vb[2], vb[3]);
        }
      }
    }
  }
}

// One block: one head of one batch row, BQ queries (8 warps). Block
// (bi * n_heads + head) * n_qb + query block.
template <typename T, int SP>
__global__ void __launch_bounds__(kAwThreads, 1)
    any_width_shared_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ mask, T* __restrict__ out,
                            int s, int d, int n_heads, int dh, int n_qb, int gran, float scale_log2) {
  using A = AwShared<T, SP>;
  constexpr int NT = A::NT;
  constexpr int LDC = A::LDC;
  constexpr int LDP = A::LDP;
  constexpr int LDV = A::LDV;
  constexpr int BQ = A::BQ;
  constexpr int KH = A::KH;

  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int qb = blockIdx.x % n_qb;
  const int bh = blockIdx.x / n_qb;
  const int bi = bh / n_heads;
  const int hi = bh - bi * n_heads;
  const int q0 = qb * BQ;
  const int rt = warp % A::RT;  // the warp's score rows 16 rt .. 16 rt + 15
  const int kh = warp / A::RT;  // and keys kh SP / KH .. of them
  const bool active = q0 + 16 * rt < s;
  const size_t row_stride = size_t(3) * d;
  const T* q_g = qkv + size_t(bi) * s * row_stride + size_t(hi) * dh;
  const T* k_g = q_g + d;
  const T* v_g = q_g + 2 * size_t(d);
  const int32_t* mrow = mask + size_t(bi) * s;
  T* out_h = out + (size_t(bi) * s + q0) * d + size_t(hi) * dh;

  // the key bias [SP] f32; a row's partial maxima and sums [KH][BQ] f32
  // each (KH > 1); then either two stages of q [BQ][LDC] and k [SP][LDC]
  // chunks, or the probabilities [BQ][LDP] and two stages of v [BKV][LDV]
  float* bias = reinterpret_cast<float*>(smem);
  float* red_m = reinterpret_cast<float*>(smem + A::bias);
  float* red_l = red_m + KH * BQ;
  unsigned char* region = smem + A::bias + A::red;
  auto q_st = [&](int st) { return reinterpret_cast<T*>(region + st * A::qk_stage); };
  T* p_s = reinterpret_cast<T*>(region);
  auto v_st = [&](int st) { return reinterpret_cast<T*>(region + A::p_bytes + st * A::v_stage); };

  fill_bias(bias, A::SP, mrow, 0, s);
  // 16-key groups that hold a key < s, of all and of the warp's keys
  const int live16 = (s + 15) >> 4;
  const int lv = min(NT / 2, max(0, live16 - kh * (NT / 2)));
  const int n_kc = (dh + A::KC - 1) / A::KC;
  // column chunk c of q and of the keys into stage c % 2; a last chunk
  // narrower than KC gets zeros past the head, which q.k^T reads
  auto issue_qk = [&](int c) {
    T* qd = q_st(c & 1);
    T* kd = qd + BQ * LDC;
    const int ncols = min(A::KC, dh - c * A::KC);
    if (ncols < A::KC) {
      zero_cols(qd, BQ, LDC, ncols, A::KC);
      zero_cols(kd, 16 * live16, LDC, ncols, A::KC);
    }
    const HeadCopies<T> hc(ncols, gran);
    load_head(qd, LDC, BQ, q_g + c * A::KC, row_stride, q0, s, hc, gran);
    load_head(kd, LDC, 16 * live16, k_g + c * A::KC, row_stride, 0, s, hc, gran);
    cp_async_commit();
  };
  float sc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
  issue_qk(0);
  for (int c = 0; c < n_kc; ++c) {
    if (c + 1 < n_kc) {
      issue_qk(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const T* qd = q_st(c & 1);
      const T* kd = qd + (BQ + kh * 16 * (NT / 2)) * LDC;
      const int nks = (min(A::KC, dh - c * A::KC) + 15) >> 4;
      // without guards where every 16-key group holds a key < s
      if (lv == NT / 2) {
        qk_acc<T, NT>(sc, qd + rt * 16 * LDC, kd, LDC, nks, NT / 2);
      } else {
        qk_acc<T, NT>(sc, qd + rt * 16 * LDC, kd, LDC, nks, lv);
      }
    }
    __syncthreads();  // every warp is done with the stage the next copies overwrite
  }

  // the exact row max and sum, one exp2 a score (a row's KH warps
  // exchange their partial maxima and sums through shared memory; each
  // holds a key < s); the normalised probabilities rounded to T (the
  // Pallas kernel's rounding point; at f32 nothing is rounded) into p_s,
  // zero for keys past s
  const int sr = 16 * rt + g;  // the block's rows sr and sr + 8
  float m0 = 0.0f, m1 = 0.0f, l0 = 1.0f, l1 = 1.0f;
  if (active) scale_bias<NT>(sc, bias + kh * 8 * NT, scale_log2, m0, m1);
  if (KH > 1) {
    if (active && t4 == 0) {
      red_m[kh * BQ + sr] = m0;
      red_m[kh * BQ + sr + 8] = m1;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        m0 = fmaxf(m0, red_m[k * BQ + sr]);
        m1 = fmaxf(m1, red_m[k * BQ + sr + 8]);
      }
    }
  }
  if (active) {
    if (lv == NT / 2) {
      exp_sum<NT>(sc, m0, m1, NT / 2, l0, l1);
    } else {
      exp_sum<NT>(sc, m0, m1, lv, l0, l1);
    }
  }
  if (KH > 1) {
    if (active && t4 == 0) {
      red_l[kh * BQ + sr] = l0;
      red_l[kh * BQ + sr + 8] = l1;
    }
    __syncthreads();
    if (active) {
      l0 = l1 = 0.0f;
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        l0 += red_l[k * BQ + sr];
        l1 += red_l[k * BQ + sr + 8];
      }
    }
  }
  if (active) {
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    T* pr = p_s + sr * LDP + kh * 8 * NT + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if constexpr (A::F32) {
        *reinterpret_cast<float2*>(pr + 8 * n) = make_float2(sc[n][0] * inv0, sc[n][1] * inv0);
        *reinterpret_cast<float2*>(pr + 8 * LDP + 8 * n) = make_float2(sc[n][2] * inv1, sc[n][3] * inv1);
      } else {
        *reinterpret_cast<uint32_t*>(pr + 8 * n) = pack2<T>(sc[n][0] * inv0, sc[n][1] * inv0);
        *reinterpret_cast<uint32_t*>(pr + 8 * LDP + 8 * n) = pack2<T>(sc[n][2] * inv1, sc[n][3] * inv1);
      }
    }
  }
  __syncthreads();  // p_s whole; the chunk stages are free for v

  const int pr = warp % A::RP;         // p.v rows 32 pr .. 32 pr + 31
  const int wc = A::WC * (warp / A::RP);  // and columns wc .. wc + WC - 1 of each chunk
  const bool pv_active = q0 + 32 * pr < s;
  const int n_vt = (s + A::BKV - 1) / A::BKV;
  for (int c0 = 0; c0 < dh; c0 += A::CW) {
    const int vcols = min(A::CW, dh - c0);
    const int live_c16 = max(0, min(A::NN / 2, (vcols - wc + 15) >> 4));
    float o[2][A::NN][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int c = 0; c < A::NN; ++c) o[m][c][0] = o[m][c][1] = o[m][c][2] = o[m][c][3] = 0.0f;
    }
    const HeadCopies<T> hv(vcols, gran);
    auto issue_v = [&](int t) {
      load_head(v_st(t & 1), LDV, A::BKV, v_g + c0, row_stride, t * A::BKV, s, hv, gran);
      cp_async_commit();
    };
    issue_v(0);
    for (int t = 0; t < n_vt; ++t) {
      if (t + 1 < n_vt) {
        issue_v(t + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (pv_active && live_c16 > 0) {
        pv_acc_smem<T, A::BKV / 16, A::NN>(o, p_s + 32 * pr * LDP + t * A::BKV, LDP, v_st(t & 1) + wc, LDV,
                                           live_c16);
      }
      __syncthreads();
    }
    if (c0 + A::CW >= dh) {
      // the last chunk: p_s and the v stages are free (the loop's last
      // barrier), so ctx goes out through them in gran-byte copies of
      // whole rows
      T* cs = reinterpret_cast<T*>(region);  // [BQ][LDV]
      if (pv_active) {
#pragma unroll
        for (int m = 0; m < 2; ++m) stage_ctx<T, A::NN>(o[m], cs + (32 * pr + 16 * m) * LDV + wc, LDV, vcols - wc);
      }
      __syncthreads();
      copy_rows(out_h + c0, d, cs, LDV, min(BQ, s - q0), hv, gran, threadIdx.x >> 5, kAwThreads / 32);
    } else if (pv_active) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = 32 * pr + 16 * m;
        store_ctx_direct<T, A::NN>(o[m], out_h + size_t(r) * d + c0 + wc, d, s - q0 - r, vcols - wc,
                                   dh % 2 == 0);
      }
    }
  }
}

template <typename T, int SP>
int launch_aw_shared(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads,
                     float scale, cudaStream_t stream) {
  using A = AwShared<T, SP>;
  const int dh = d / n_heads;
  const int n_qb = (s + A::BQ - 1) / A::BQ;
  const long long blocks = static_cast<long long>(b) * n_heads * n_qb;
  if (blocks >= (1ll << 31)) return int(cudaErrorInvalidConfiguration);
  const cudaError_t e = cudaFuncSetAttribute(any_width_shared_kernel<T, SP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(A::smem));
  if (e != cudaSuccess) return int(e);
  any_width_shared_kernel<T, SP><<<unsigned(blocks), kAwThreads, A::smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int32_t*>(mask), static_cast<T*>(out), s, d, n_heads,
      dh, n_qb, granule(dh * int(sizeof(T))), scale * kLog2e);
  return int(cudaGetLastError());
}

// one pass where every key fits in the block (s <= 128), else two
template <typename T, int DC>
int launch_aw_s(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads, float scale,
                cudaStream_t stream) {
  if (s <= kAwSP) return launch_aw_one<T, DC>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  return launch_aw<T, DC, kTwoPass>(qkv, mask, out, b, s, d, n_heads, scale, stream);
}

// Narrow heads (dh <= 32, 4 or 2 to a block): one pass with the scores in
// registers (s <= 128), else two. Wider heads: the register one pass at
// dh <= 128 and s <= 128; kShared at s <= 256 and at s <= 512; past that
// kWide's two passes.
template <typename T>
int launch_any_width_dh(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads,
                        float scale, cudaStream_t stream) {
  const int dh = d / n_heads;
  if (dh <= 16) return launch_aw_s<T, 16>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 32) return launch_aw_s<T, 32>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (s <= kAwSP && dh <= 64) return launch_aw_one<T, 64>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (s <= kAwSP && dh <= 128) return launch_aw_one<T, 128>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (s <= 256) return launch_aw_shared<T, 256>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (s <= 512) return launch_aw_shared<T, 512>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  return launch_aw<T, kAwChunk, kWide>(qkv, mask, out, b, s, d, n_heads, scale, stream);
}

}  // namespace

extern "C" {

// qkv [b, s, 3d] and mask [b, s] int32, both contiguous, qkv 16-byte
// aligned; out [b, s, d] in qkv's dtype (0 bf16, 1 f16, 2 f32). s >= 1,
// any head width d / n_heads, and b * n_heads * ceil(s / 128) < 2^31 (the
// Python wrapper checks all of it). A head width that is not a multiple
// of 8, or past 256, takes the any-width kernel; otherwise bf16 at
// head_dim 32 or 64 and s <= 128 takes the short kernel, other bf16 and
// f16 the wgmma kernel, f32 the 3xTF32 kernel. Returns the cudaGetLastError() code of
// the launch (0 on success), or kNoEncoder / kTensorMapError + CUresult
// where the CUDA driver gives no tensor map.
int pw_fused_qkv_attention(const void* qkv, const void* mask, void* out, int dtype, int b,
                           int s, int d, int n_heads, float scale, void* stream) {
  if (b < 1 || s < 1 || n_heads < 1 || d % n_heads != 0) return int(cudaErrorInvalidValue);
  const int dh = d / n_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh % 8 != 0 || dh > 256) {
    if (dtype == 0) return launch_any_width_dh<__nv_bfloat16>(qkv, mask, out, b, s, d, n_heads, scale, st);
    if (dtype == 1) return launch_any_width_dh<__half>(qkv, mask, out, b, s, d, n_heads, scale, st);
    if (dtype == 2) return launch_any_width_dh<float>(qkv, mask, out, b, s, d, n_heads, scale, st);
    return int(cudaErrorInvalidValue);
  }
  if (dtype == 0 && s <= kMaxSeq && (dh == 32 || dh == 64)) {
    if (static_cast<long long>(b) * n_heads >= (1ll << 31)) {
      return int(cudaErrorInvalidConfiguration);
    }
    if (dh == 64) return launch_dh<64>(qkv, mask, out, b, s, d, n_heads, scale, st);
    return launch_dh<32>(qkv, mask, out, b, s, d, n_heads, scale, st);
  }
  if (dtype == 0) return launch_wgmma_dh<__nv_bfloat16>(qkv, mask, out, b, s, d, n_heads, scale, st);
  if (dtype == 1) return launch_wgmma_dh<__half>(qkv, mask, out, b, s, d, n_heads, scale, st);
  if (dtype == 2) return launch_f32_dh(qkv, mask, out, b, s, d, n_heads, scale, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
