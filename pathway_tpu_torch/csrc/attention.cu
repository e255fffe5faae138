// Fused bidirectional multi-head attention straight off the fused qkv
// projection, for Hopper (sm_90a), on the tensor cores.
//
// Replaces: pathway_tpu/ops/attention.py `_attn_kernel`, the Pallas kernel
// launched by `fused_qkv_attention` (one launch per encoder layer per
// embed batch), over its whole contract: qkv in bf16, f16 or f32, any
// head width that is a multiple of 8 up to 256, any sequence length.
//
// What it computes, per (batch row, head): q/k/v are the head's column
// slices of qkv [b, s, 3d] (offsets hi*dh, d + hi*dh, 2d + hi*dh);
// scores = q.k^T / sqrt(dh) + bias, bias 0 for valid keys and -1e30 for
// padding keys (from the int32 token mask); an f32 softmax; probabilities
// rounded to qkv's dtype, as the TPU kernel rounds them (at f32 they are
// not rounded); ctx = p.v accumulated in f32 and written in qkv's dtype
// into out [b, s, d] at the head's column offset. A row whose keys are all
// padding sees s equal scores of -1e30 and gets the uniform mean of its s
// keys of v, never NaN.
//
// What bounds it on the H100: bytes, at the encoders' shapes. The kernel
// must read qkv (b*s*3d elements) and the mask (b*s*4 B) and write ctx
// (b*s*d elements); the arithmetic is 4*b*h*s*s*dh flops, about 32 per
// byte at s 64 and 256 at s 512 in bf16, against the ~295 per byte at
// which the bf16 tensor cores and not the memory would be the limit (f32:
// 67 TFLOP/s outside the tensor cores, so bytes up to s ~ 64). What the
// design does about it: every qkv byte a block needs is copied by 16-byte
// `cp.async.cg` straight from the fused layout into shared memory, the
// scores and probabilities never leave the registers, and both products
// run on the tensor cores (`mma.sync`). Two kernels share that design.
//
// (1) The short kernel: bf16, head_dim 32 or 64, s <= 128 (the sequence
// buckets of the flagship and default embedders).
// - Layout. Block bi * n_heads + hi takes one (batch row, head). The
//   sequence is padded to SP = 16 * KT rows (KT key tiles of 16, KT a
//   power of two; the launch picks the least KT with SP >= s), and the
//   block has KT warps: warp w owns query rows 16w .. 16w + 15. At s 16
//   and 32 a block is 1 or 2 warps and many share an SM, so no warp idles
//   and short sequences keep as many bytes in flight as long ones.
// - Load: the block copies its q, k and v [SP][dh] into shared memory;
//   rows past s are zero-filled (cp.async with a source size of 0). Rows
//   of dh bf16 are 16-byte chunks XOR-swizzled by row, so that the 8 rows
//   an `ldmatrix` reads hit 8 different bank groups. The key bias goes
//   beside them: 0, -1e30 (padding) or -inf (past s, so those keys drop
//   out of the softmax and an all-padding row still averages exactly its
//   s keys).
// - Scores: q A-fragments by `ldmatrix.x4`; k [key][dh] row-major is the
//   B operand of q.k^T as it lies, also by `ldmatrix.x4`. A 16-row score
//   tile of SP keys stays in registers (2 * KT accumulator tiles of
//   m16n8), so the softmax is exact in one pass: row max and sum over the
//   lane quad with two `__shfl_xor_sync` each.
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
// longer sequences take the second kernel.
//
// (2) The tiled kernel: everything else (s > 128, f16, f32, head widths
// other than 32 and 64).
// - Layout. A block takes one (row, head) and 64 queries, 4 warps of 16
//   query rows; block ((bi * n_heads) + hi) * ceil(s / 64) + query block,
//   so the blocks that read one head's keys run side by side and find
//   them in L2. The wrapper checks b * n_heads * ceil(s / 64) < 2^31.
// - Keys stream through shared memory in tiles of BK keys (64 at 16 bits,
//   32 at f32), double-buffered with `cp.async`: the next tile's copy is
//   in flight while the warps compute on this one. Keys past s are
//   zero-filled and get bias -inf, so they drop out of the softmax. No
//   [s, s] tile exists anywhere: a warp holds 16 x BK scores.
// - Rounding: an exact two-pass softmax. Pass 1 walks the key tiles for
//   each row's max and sum (a running max; the sum is rescaled when the
//   max rises). Pass 2 walks them again, recomputes the same scores,
//   normalises them with the final max and sum, rounds the probabilities
//   to qkv's dtype and multiplies them by v: the probabilities round
//   where the TPU kernel rounds them, at 1.5 times the q.k^T products of
//   one pass. (A one-pass online softmax would round probabilities that
//   are not normalised yet.) The first key tile always holds key 0 < s,
//   whose score is finite (bias 0 or -1e30), so the running max is finite
//   from the first tile on, and an all-padding row sums exactly its s keys
//   across any number of tiles.
// - Head widths: instantiated at DHP 16, 32, 64, 96, 128 and 256. Any
//   other dh that is a multiple of 8 runs in the next DHP with its columns
//   past dh zero-filled in shared memory: zero columns of q and k leave
//   the scores unchanged, and zero columns of v give ctx columns that are
//   never stored. A dh that is not a multiple of 8 breaks the 16-byte
//   alignment of head offsets in the fused layout, and dh > 256 has no
//   instantiation: the wrapper raises for both.
// - Shared-memory rows are padded by one 16-byte chunk (a stride of DHP +
//   16 / sizeof(T) elements): at every DHP the 8 rows one `ldmatrix` reads
//   fall into 8 different bank groups, and the f32 fragment reads into 32
//   different banks.
// - bf16 and f16: `ldmatrix` fragments and `mma.sync` m16n8k16 (f16 is the
//   bf16 code with f16 products); q's fragments stay in registers up to
//   DHP 128 and are read again from shared memory at 256, where the 128
//   f32 accumulators of ctx take the registers.
// - f32, in full f32: each product is a 3xTF32 split on the tensor cores.
//   x = big + small, big = tf32(x), small = tf32(x - big), and a.b is
//   taken as small.big + big.small + big.big (`mma.sync` m16n8k8 .tf32
//   with f32 sums); what is left out, small.small, is ~2^-22 of a
//   product. The probabilities are split the same way and never rounded
//   to 16 bits. The accumulator layout of the scores serves as the A
//   fragment of p.v once the 8 keys of each k-step are permuted (k-index
//   t <-> key 2t, t + 4 <-> key 2t + 1), and v's rows are read in the same
//   permuted order.
//
// Built by pathway_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, called through ctypes from
// pathway_tpu_torch/ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

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


// ------------------------------------------------------------ the tiled kernel

constexpr int kTiledWarps = 4;
constexpr int kBQ = 16 * kTiledWarps;  // queries a block
constexpr int kThreads = 32 * kTiledWarps;

template <typename T, int DHP>
struct Tiled {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int EPC = 16 / int(sizeof(T));  // elements of a 16-byte chunk
  static constexpr int BK = kF32 ? 32 : 64;        // keys a tile
  static constexpr int LD = DHP + EPC;             // row stride: one spare chunk a row
  static constexpr int CPR = DHP / EPC;            // chunks of a row
  static constexpr int NT = BK / 8;                // n-tiles of a warp's score tile
  static constexpr int NN = DHP / 8;               // n-tiles of a warp's ctx
  static constexpr bool KEEP_Q = !kF32 && DHP <= 128;  // q fragments in registers
  // q [kBQ][LD], k and v [2][BK][LD], the mask [2][BK]
  static constexpr size_t smem =
      (size_t(kBQ) + 4 * BK) * LD * sizeof(T) + 2 * BK * sizeof(int32_t);
  static_assert(DHP % 16 == 0 && DHP <= 256, "DHP a multiple of 16 up to 256");
  static_assert(smem <= 232448, "a block's shared memory on the H100");
};

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

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16(c, a, b0, b1);
  } else {
    mma_bf16(c, a, b0, b1);
  }
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

// two neighbouring ctx values into shared memory in T
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack2<T>(lo, hi);
  }
}

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
template <typename T, int DHP, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* head, size_t row_stride, int col0,
                                          int r0, int s, int cpr, int tid) {
  using C = Tiled<T, DHP>;
  for (int c = tid; c < ROWS * C::CPR; c += kThreads) {
    const int r = c / C::CPR;
    const int ch = c - r * C::CPR;
    const bool in = r0 + r < s && ch < cpr;
    const T* src = in ? head + size_t(r0 + r) * row_stride + col0 + ch * C::EPC : head;
    cp_async_16(smem_addr(dst + r * C::LD + ch * C::EPC), src, in ? 16 : 0);
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads)
    tiled_attention_kernel(const T* __restrict__ qkv, const int32_t* __restrict__ mask,
                           T* __restrict__ out, int s, int d, int n_heads, int dh, int n_qb,
                           float scale_log2) {
  using C = Tiled<T, DHP>;
  constexpr int BK = C::BK;
  constexpr int LD = C::LD;
  constexpr int NT = C::NT;
  constexpr int NN = C::NN;

  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                             // [kBQ][LD]
  T* k_s = q_s + kBQ * LD;                                         // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;                                      // [2][BK][LD]
  int32_t* m_s = reinterpret_cast<int32_t*>(v_s + 2 * BK * LD);  // [2][BK]

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
  const T* head = qkv + size_t(bi) * s * row_stride + size_t(hi) * dh;
  const int32_t* mrow = mask + size_t(bi) * s;
  const int cpr = dh / C::EPC;
  const int n_kt = (s + BK - 1) / BK;
  const int total = 2 * n_kt;

  // step i < n_kt: pass 1 over key tile i (k and the mask); step n_kt + i:
  // pass 2 over key tile i (k, v and the mask); buffer step & 1
  auto load_step = [&](int step) {
    const int buf = step & 1;
    const bool pass2 = step >= n_kt;
    const int k0 = (pass2 ? step - n_kt : step) * BK;
    load_rows<T, DHP, BK>(k_s + buf * BK * LD, head, row_stride, d, k0, s, cpr, tid);
    if (pass2) load_rows<T, DHP, BK>(v_s + buf * BK * LD, head, row_stride, 2 * d, k0, s, cpr, tid);
    for (int j = tid; j < BK; j += kThreads) {
      const bool in = k0 + j < s;
      cp_async_4(smem_addr(m_s + buf * BK + j), in ? mrow + k0 + j : mrow, in ? 4 : 0);
    }
    cp_async_commit();
  };

  load_rows<T, DHP, kBQ>(q_s, head, row_stride, 0, q0, s, cpr, tid);
  cp_async_commit();
  load_step(0);
  cp_async_wait<1>();  // q has landed
  __syncthreads();

  const T* q_w = q_s + warp * 16 * LD;  // this warp's 16 query rows
  // 16-bit q A-fragments: matrix (lane >> 3) is rows +0/+8 (bit 0), k +0/+8 (bit 1)
  const int qr = (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t qf[C::KEEP_Q ? DHP / 16 : 1][4];
  if constexpr (C::KEEP_Q) {
#pragma unroll
    for (int ks = 0; ks < DHP / 16; ++ks) {
      ldmatrix_x4(qf[ks], smem_addr(q_w + qr * LD + (2 * ks + (lane >> 4)) * 8));
    }
  }

  // rows g and g + 8, log2 domain: running max, this thread's share of the sum
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.0f, l1 = 0.0f;
  float inv0 = 0.0f, inv1 = 0.0f;
  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  for (int step = 0; step < total; ++step) {
    const int buf = step & 1;
    if (step + 1 < total) {
      load_step(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = step >= n_kt;
    const int k0 = (pass2 ? step - n_kt : step) * BK;
    const T* k_t = k_s + buf * BK * LD;
    const T* v_t = v_s + buf * BK * LD;
    const int32_t* m_t = m_s + buf * BK;

    // scores of the warp's 16 rows against the tile's BK keys: n-tile t
    // covers keys 8t .. 8t + 7
    float sc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.0f;
    if constexpr (!C::kF32) {
#pragma unroll
      for (int ks = 0; ks < DHP / 16; ++ks) {
        uint32_t a[4];
        if constexpr (C::KEEP_Q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
        } else {
          ldmatrix_x4(a, smem_addr(q_w + qr * LD + (2 * ks + (lane >> 4)) * 8));
        }
#pragma unroll
        for (int p = 0; p < BK / 16; ++p) {
          // matrices: keys +0 (k lo, k hi), keys +8 (k lo, k hi)
          uint32_t kb[4];
          const int r = 16 * p + (lane & 7) + (lane >> 4) * 8;
          ldmatrix_x4(kb, smem_addr(k_t + r * LD + (2 * ks + ((lane >> 3) & 1)) * 8));
          mma16<T>(sc[2 * p], a, kb[0], kb[1]);
          mma16<T>(sc[2 * p + 1], a, kb[2], kb[3]);
        }
      }
    } else {
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
        for (int t = 0; t < NT; ++t) {
          // B (8 x 8, k = dh, n = key): (t4, g), (t4 + 4, g)
          const float* kp = k_t + (8 * t + g) * LD + 8 * ks + t4;
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(kp[0], bb0, bs0);
          split_tf32(kp[4], bb1, bs1);
          mma_3xtf32(sc[t], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    }

    // scale and key bias, in the log2 domain: 0, -1e30 (padding) or -inf
    // (past s); -1e30 and -inf pass through the scale unchanged
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int j = 8 * t + 2 * t4;
      const float b0 = k0 + j < s ? (m_t[j] == 0 ? -1e30f : 0.0f) : -CUDART_INF_F;
      const float b1 = k0 + j + 1 < s ? (m_t[j + 1] == 0 ? -1e30f : 0.0f) : -CUDART_INF_F;
      sc[t][0] = fmaf(sc[t][0], scale_log2, b0);
      sc[t][1] = fmaf(sc[t][1], scale_log2, b1);
      sc[t][2] = fmaf(sc[t][2], scale_log2, b0);
      sc[t][3] = fmaf(sc[t][3], scale_log2, b1);
    }

    if (!pass2) {
      // pass 1: running max over the lane quad, the sum rescaled to it
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        mx0 = fmaxf(mx0, fmaxf(sc[t][0], sc[t][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[t][2], sc[t][3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // finite from the first tile on (key 0 < s): exp2(-inf - mx) is 0
      l0 *= exp2_approx(m0 - mx0);
      l1 *= exp2_approx(m1 - mx1);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        l0 += exp2_approx(sc[t][0] - mx0) + exp2_approx(sc[t][1] - mx0);
        l1 += exp2_approx(sc[t][2] - mx1) + exp2_approx(sc[t][3] - mx1);
      }
      m0 = mx0;
      m1 = mx1;
    } else {
      if (step == n_kt) {
        // the sums over the lane quad, once
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, x);
          l1 += __shfl_xor_sync(0xffffffffu, l1, x);
        }
        inv0 = 1.0f / l0;
        inv1 = 1.0f / l1;
      }
      // pass 2: normalised probabilities times v; n-tile n of ctx covers
      // columns 8n .. 8n + 7
      if constexpr (!C::kF32) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // rounded to T: the A fragment of key step kk is n-tiles 2kk
          // (a0, a1) and 2kk + 1 (a2, a3)
          uint32_t pa[4];
          pa[0] = pack2<T>(exp2_approx(sc[2 * kk][0] - m0) * inv0,
                           exp2_approx(sc[2 * kk][1] - m0) * inv0);
          pa[1] = pack2<T>(exp2_approx(sc[2 * kk][2] - m1) * inv1,
                           exp2_approx(sc[2 * kk][3] - m1) * inv1);
          pa[2] = pack2<T>(exp2_approx(sc[2 * kk + 1][0] - m0) * inv0,
                           exp2_approx(sc[2 * kk + 1][1] - m0) * inv0);
          pa[3] = pack2<T>(exp2_approx(sc[2 * kk + 1][2] - m1) * inv1,
                           exp2_approx(sc[2 * kk + 1][3] - m1) * inv1);
#pragma unroll
          for (int np = 0; np < DHP / 16; ++np) {
            // transposed matrices: keys +0 / +8 (bit 0), columns +0 / +8 (bit 1)
            uint32_t vb[4];
            const int r = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldmatrix_x4_trans(vb, smem_addr(v_t + r * LD + (2 * np + (lane >> 4)) * 8));
            mma16<T>(o[2 * np], pa, vb[0], vb[1]);
            mma16<T>(o[2 * np + 1], pa, vb[2], vb[3]);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          // the 8 keys of n-tile t as one k-step, permuted: k-index t4 is
          // key 8t + 2t4, k-index t4 + 4 is key 8t + 2t4 + 1
          uint32_t ab[4], as[4];
          split_tf32(exp2_approx(sc[t][0] - m0) * inv0, ab[0], as[0]);  // (g, key 2t4)
          split_tf32(exp2_approx(sc[t][2] - m1) * inv1, ab[1], as[1]);  // (g + 8, key 2t4)
          split_tf32(exp2_approx(sc[t][1] - m0) * inv0, ab[2], as[2]);  // (g, key 2t4 + 1)
          split_tf32(exp2_approx(sc[t][3] - m1) * inv1, ab[3], as[3]);  // (g + 8, key 2t4 + 1)
          const float* vp = v_t + (8 * t + 2 * t4) * LD + g;
#pragma unroll
          for (int n = 0; n < NN; ++n) {
            // B (k = key, n = column): (key 2t4, 8n + g), (key 2t4 + 1, 8n + g)
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(vp[8 * n], bb0, bs0);
            split_tf32(vp[LD + 8 * n], bb1, bs1);
            mma_3xtf32(o[n], ab, as, bb0, bb1, bs0, bs1);
          }
        }
      }
    }
    __syncthreads();  // before the next prefetch overwrites this buffer
  }

  // ---- store: ctx in T into this warp's q rows (no warp reads q any
  // more), then 16-byte stores of the head's own chunks; rows past s are
  // never written
  T* st = q_s + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    store2<T>(st + g * LD + 8 * n + 2 * t4, o[n][0], o[n][1]);
    store2<T>(st + (g + 8) * LD + 8 * n + 2 * t4, o[n][2], o[n][3]);
  }
  __syncwarp();
  T* out_h = out + size_t(bi) * s * d + size_t(hi) * dh;
  for (int c = lane; c < 16 * cpr; c += 32) {
    const int r = c / cpr;
    const int ch = c - r * cpr;
    const int row = q0 + warp * 16 + r;
    if (row < s) {
      *reinterpret_cast<uint4*>(out_h + size_t(row) * d + ch * C::EPC) =
          *reinterpret_cast<const uint4*>(st + r * LD + ch * C::EPC);
    }
  }
}

template <typename T, int DHP>
int launch_tiled(const void* qkv, const void* mask, void* out, int b, int s, int d, int n_heads,
                 float scale, cudaStream_t stream) {
  using C = Tiled<T, DHP>;
  const int n_qb = (s + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(b) * n_heads * n_qb;
  if (blocks >= (1ll << 31)) return int(cudaErrorInvalidConfiguration);
  if (C::smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(tiled_attention_kernel<T, DHP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               int(C::smem));
    if (e != cudaSuccess) return int(e);
  }
  tiled_attention_kernel<T, DHP><<<unsigned(blocks), kThreads, C::smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const int32_t*>(mask), static_cast<T*>(out), s, d,
      n_heads, d / n_heads, n_qb, scale * kLog2e);
  return int(cudaGetLastError());
}

// the least instantiated width >= dh
template <typename T>
int launch_tiled_dh(const void* qkv, const void* mask, void* out, int b, int s, int d,
                    int n_heads, float scale, cudaStream_t stream) {
  const int dh = d / n_heads;
  if (dh <= 16) return launch_tiled<T, 16>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 32) return launch_tiled<T, 32>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 64) return launch_tiled<T, 64>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 96) return launch_tiled<T, 96>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  if (dh <= 128) return launch_tiled<T, 128>(qkv, mask, out, b, s, d, n_heads, scale, stream);
  return launch_tiled<T, 256>(qkv, mask, out, b, s, d, n_heads, scale, stream);
}

}  // namespace

extern "C" {

// qkv [b, s, 3d] and mask [b, s] int32, both contiguous, qkv 16-byte
// aligned; out [b, s, d] in qkv's dtype (0 bf16, 1 f16, 2 f32). s >= 1,
// d / n_heads a multiple of 8 up to 256, and b * n_heads * ceil(s / 64) <
// 2^31 (the Python wrapper checks all of it). Returns the
// cudaGetLastError() code of the launch: 0 on success.
int pw_fused_qkv_attention(const void* qkv, const void* mask, void* out, int dtype, int b,
                           int s, int d, int n_heads, float scale, void* stream) {
  if (b < 1 || s < 1 || n_heads < 1 || d % n_heads != 0) return int(cudaErrorInvalidValue);
  const int dh = d / n_heads;
  if (dh % 8 != 0 || dh > 256) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && s <= kMaxSeq && (dh == 32 || dh == 64)) {
    if (static_cast<long long>(b) * n_heads >= (1ll << 31)) {
      return int(cudaErrorInvalidConfiguration);
    }
    if (dh == 64) return launch_dh<64>(qkv, mask, out, b, s, d, n_heads, scale, st);
    return launch_dh<32>(qkv, mask, out, b, s, d, n_heads, scale, st);
  }
  if (dtype == 0) return launch_tiled_dh<__nv_bfloat16>(qkv, mask, out, b, s, d, n_heads, scale, st);
  if (dtype == 1) return launch_tiled_dh<__half>(qkv, mask, out, b, s, d, n_heads, scale, st);
  if (dtype == 2) return launch_tiled_dh<float>(qkv, mask, out, b, s, d, n_heads, scale, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
