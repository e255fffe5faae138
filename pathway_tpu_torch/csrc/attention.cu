// Fused bidirectional multi-head attention straight off the fused qkv
// projection, for Hopper (sm_90a), on the tensor cores.
//
// Replaces: pathway_tpu/ops/attention.py `_attn_kernel`, the Pallas kernel
// launched by `fused_qkv_attention` (one launch per encoder layer per
// embed batch).
//
// What it computes, per (batch row, head): q/k/v are the head's column
// slices of qkv [b, s, 3d] (offsets hi*dh, d + hi*dh, 2d + hi*dh);
// scores = q.k^T / sqrt(dh) + bias, bias 0 for valid keys and -1e30 for
// padding keys (from the int32 token mask); an f32 softmax; probabilities
// rounded to bf16 (as the TPU kernel rounds them to the input dtype);
// ctx = p.v accumulated in f32 and written as bf16 into out [b, s, d] at
// the head's column offset. A row whose keys are all padding sees s equal
// scores of -1e30 and gets the uniform mean of its s keys of v, never NaN.
//
// What bounds it on the H100: bytes. The kernel must read qkv (b*s*3d*2 B)
// and the mask (b*s*4 B) and write ctx (b*s*d*2 B); the arithmetic is
// 4*b*h*s*s*dh flops, about 32 per byte at s = 64, against the ~295 per
// byte at which the bf16 tensor cores and not the memory would be the
// limit. What the design does about it:
// - every qkv byte is read from device memory once, by 16-byte
//   `cp.async.cg` copies straight from the fused layout into shared
//   memory, and the [b, h, s, s] scores and probabilities never leave the
//   registers;
// - a block is small (one (row, head), 24 KB of shared memory at s 64 and
//   at s 128, dh 32), so several blocks share an SM and one block's loads
//   are in flight while another computes;
// - both products run on the tensor cores (`mma.sync` m16n8k16, bf16 in,
//   f32 accumulate), fed by `ldmatrix` from XOR-swizzled tiles, so that the
//   math stays far below the memory time instead of being bound by
//   shared-memory loads.
//
// Layout. Block bi * n_heads + hi takes one (batch row, head). The
// sequence is padded to SP = 16 * KT rows (KT key tiles of 16, KT a power
// of two; the launch picks the least KT with SP >= s), and the block has
// KT warps: warp w owns query rows 16w .. 16w + 15. At s 16 and 32 a block
// is 1 or 2 warps and many share an SM, so no warp idles and short
// sequences keep as many bytes in flight as long ones.
// - Load: the block copies its q, k and v [SP][dh] into shared
//   memory; rows past s are zero-filled (cp.async with a source size of
//   0). Rows of dh bf16 are 16-byte chunks XOR-swizzled by row, so that
//   the 8 rows an `ldmatrix` reads hit 8 different bank groups. The key
//   bias goes beside them: 0, -1e30 (padding) or -inf (past s, so those
//   keys drop out of the softmax and an all-padding row still averages
//   exactly its s keys).
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
//
// Built by pathway_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, called through ctypes from
// pathway_tpu_torch/ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// qkv [b, s, 3d] bf16 and mask [b, s] int32, both contiguous, qkv 16-byte
// aligned; out [b, s, d] bf16. s <= 128, d / n_heads in {32, 64}, and
// b * n_heads < 2^31 (the Python wrapper checks all of it). Returns the
// cudaGetLastError() code of the launch: 0 on success.
int pw_fused_qkv_attention_bf16(const void* qkv, const void* mask, void* out, int b, int s,
                                int d, int n_heads, float scale, void* stream) {
  if (s < 1 || s > kMaxSeq || n_heads < 1 || d % n_heads != 0) {
    return int(cudaErrorInvalidValue);
  }
  const int dh = d / n_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_dh<64>(qkv, mask, out, b, s, d, n_heads, scale, st);
  if (dh == 32) return launch_dh<32>(qkv, mask, out, b, s, d, n_heads, scale, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
