// Fused bidirectional multi-head attention straight off the fused qkv
// projection, for Hopper (sm_90a).
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
// scores of -1e30 and gets the uniform mean of v, never NaN.
//
// What bounds it on the H100: bytes. The kernel must read qkv (b*s*3d*2 B)
// and the mask (b*s*4 B) and write ctx (b*s*d*2 B); the arithmetic is
// 4*b*h*s*s*dh flops, about 1/30 of what the tensor cores could do in the
// time the memory needs at s = 64 (PERF.md has the numbers per shape).
// What the design does about it: every qkv byte is read from device
// memory once, with 16-byte loads, and the [b, h, s, s] scores and
// probabilities never leave the SM (registers and shared memory), which
// is the device-memory contract of the TPU kernel. The scores and the
// value contraction run on the CUDA cores, not the tensor cores: at these
// head sizes the tensor cores are not the limit. Making it reach the
// memory bound (wider blocks, asynchronous copies, mma) is later work.
//
// Layout: one block per (batch row, head), kWarps warps. The block loads
// its head's q, k and v into shared memory (k with a padded row so that
// 32 lanes reading 32 different key rows hit 32 different banks), then
// each warp takes query rows in turn: lane j scores keys j, j+32, ...,
// warp shuffles reduce the max and the sum, the bf16-rounded
// probabilities go to a per-warp row in shared memory, and lane l
// accumulates output columns l*DH/32 ... (l+1)*DH/32 - 1 over all keys.
//
// Built by pathway_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, called through ctypes from
// pathway_tpu_torch/ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxSeq = 128;
constexpr int kKeysPerLane = kMaxSeq / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one block, in bytes: q and v [s][DH], k [s][DH + 2],
// the key bias [s] and one probability row per warp [kWarps][s].
__host__ __device__ constexpr size_t smem_bytes(int s, int dh) {
  return size_t(s) * dh * 2 * 2 + size_t(s) * (dh + 2) * 2 + size_t(s) * 4 +
         size_t(kWarps) * s * 4;
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    fused_qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const int32_t* __restrict__ mask,
                               __nv_bfloat16* __restrict__ out, int s, int d,
                               int n_heads, float scale) {
  static_assert(DH % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int KS = DH + 2;   // padded k row (elements): conflict-free row reads
  constexpr int CPR = DH / 8;  // 16-byte chunks per head row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = q_s + s * DH;
  __nv_bfloat16* k_s = v_s + s * DH;
  float* bias_s = reinterpret_cast<float*>(k_s + s * KS);
  float* p_s = bias_s + s;

  const int bi = blockIdx.x / n_heads;
  const int hi = blockIdx.x % n_heads;
  const int row_stride = 3 * d;
  const __nv_bfloat16* base = qkv + size_t(bi) * s * row_stride + hi * DH;

  // q, k, v of this head: 16-byte loads straight from the fused layout
  for (int c = threadIdx.x; c < 3 * s * CPR; c += blockDim.x) {
    const int which = c / (s * CPR);
    const int rem = c - which * s * CPR;
    const int r = rem / CPR;
    const int ch = rem - r * CPR;
    const uint4 val = *reinterpret_cast<const uint4*>(
        base + size_t(r) * row_stride + which * d + ch * 8);
    if (which == 0) {
      *reinterpret_cast<uint4*>(q_s + r * DH + ch * 8) = val;
    } else if (which == 2) {
      *reinterpret_cast<uint4*>(v_s + r * DH + ch * 8) = val;
    } else {  // the padded k row is only 4-byte aligned
      uint32_t* dst = reinterpret_cast<uint32_t*>(k_s + r * KS + ch * 8);
      dst[0] = val.x;
      dst[1] = val.y;
      dst[2] = val.z;
      dst[3] = val.w;
    }
  }
  for (int j = threadIdx.x; j < s; j += blockDim.x) {
    bias_s[j] = mask[size_t(bi) * s + j] == 0 ? -1e30f : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p_w = p_s + warp * s;
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(k_s);

  for (int r = warp; r < s; r += kWarps) {
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(q_s + r * DH);
    float sc[kKeysPerLane];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      sc[t] = -CUDART_INF_F;
      if (j < s) {
        const __nv_bfloat162* kr = k2 + j * (KS / 2);
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < DH / 2; ++w) {
          const float2 qf = __bfloat1622float2(q2[w]);
          const float2 kf = __bfloat1622float2(kr[w]);
          acc = fmaf(qf.x, kf.x, acc);
          acc = fmaf(qf.y, kf.y, acc);
        }
        sc[t] = acc * scale + bias_s[j];
        m = fmaxf(m, sc[t]);
      }
    }
    m = warp_max(m);
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      if (lane + 32 * t < s) {
        sc[t] = expf(sc[t] - m);
        sum += sc[t];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < s) p_w[j] = __bfloat162float(__float2bfloat16(sc[t] / sum));
    }
    __syncwarp();

    __nv_bfloat16* orow = out + (size_t(bi) * s + r) * d + hi * DH;
    if constexpr (DH == 64) {
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(v_s);
      float a0 = 0.0f, a1 = 0.0f;
      for (int j = 0; j < s; ++j) {
        const float p = p_w[j];
        const float2 vf = __bfloat1622float2(v2[j * (DH / 2) + lane]);
        a0 = fmaf(p, vf.x, a0);
        a1 = fmaf(p, vf.y, a1);
      }
      reinterpret_cast<__nv_bfloat162*>(orow)[lane] = __floats2bfloat162_rn(a0, a1);
    } else {
      static_assert(DH == 32, "head_dim 32 or 64");
      float a0 = 0.0f;
      for (int j = 0; j < s; ++j) {
        a0 = fmaf(p_w[j], __bfloat162float(v_s[j * DH + lane]), a0);
      }
      orow[lane] = __float2bfloat16(a0);
    }
    __syncwarp();  // the next row overwrites p_w
  }
}

template <int DH>
int launch(const void* qkv, const void* mask, void* out, int b, int s, int d,
           int n_heads, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(s, DH);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_qkv_attention_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  fused_qkv_attention_kernel<DH><<<b * n_heads, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const int32_t*>(mask),
      static_cast<__nv_bfloat16*>(out), s, d, n_heads, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv [b, s, 3d] bf16 and mask [b, s] int32, both contiguous, qkv 16-byte
// aligned; out [b, s, d] bf16. s <= 128, d / n_heads in {32, 64}, and
// b * n_heads < 2^31 (the Python wrapper checks all of it). Returns the
// cudaGetLastError() code of the launch: 0 on success.
int pw_fused_qkv_attention_bf16(const void* qkv, const void* mask, void* out,
                                int b, int s, int d, int n_heads, float scale,
                                void* stream) {
  if (s < 1 || s > kMaxSeq || n_heads < 1 || d % n_heads != 0) {
    return int(cudaErrorInvalidValue);
  }
  const int dh = d / n_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch<64>(qkv, mask, out, b, s, d, n_heads, scale, st);
  if (dh == 32) return launch<32>(qkv, mask, out, b, s, d, n_heads, scale, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
