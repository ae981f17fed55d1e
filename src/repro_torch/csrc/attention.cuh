// Flash-Attention-2 forward for Hopper (sm_90a), shared by the two
// attention kernels of the CAPSim port:
//
//   flash_attention.cu     replaces repro/kernels/flash_attention/kernel.py
//                          _fa_kernel: binary per-key validity mask, causal
//                          and sliding-window masks, q aligned to the end
//                          of kv (q_offset = skv - sq).
//   weighted_attention.cu  replaces repro/kernels/fused_serving/kernel.py
//                          _wa_kernel: a per-key f32 weight multiplies the
//                          max-shifted exponential; the row max runs over
//                          every in-range key, zero-weight keys included.
//
// Both keep the TPU kernels' contract: f32 running max m, normalizer l and
// accumulator acc; masked scores are -1e30; p is rounded to the value dtype
// before the PV product; a row with no valid key (l == 0) writes zeros.
//
// What bounds it on the card.  At the main path's shapes (head_dim 32,
// 4 heads, block self-attention over 360 context rows, batch 256) one call
// does 1.7e10 FLOPs over 189 MB in f32: 254 us of f32 FMA issue at the
// published 67 TFLOP/s against 56 us of HBM traffic, so the kernel is
// bound by operations.  Tensor cores cannot help f32 parity (TF32 keeps
// ~3 decimal digits), so the f32 path stays on the FMA pipes.
//
// What the design does about it.  One CTA per (batch, head, tile of BQ
// queries); each thread owns one query row and keeps q, acc, m and l in
// registers, so the softmax needs no cross-thread reduction.  K/V tiles of
// BK keys are staged once per CTA in shared memory as f32 and read back
// as 16-byte broadcasts (every thread of a warp reads the same key), i.e.
// one shared-memory load feeds four FMAs per thread.  Scores are processed
// in chunks of CH keys: one rescale of acc per chunk instead of per key.
// The kernel indexes the (B, S, H, D) layout directly by batch and row
// strides, so the split q/k/v views of a fused QKV projection need no
// copy, transpose or padding.  Causal CTAs skip key tiles that lie wholly
// after their last query.  wgmma/TMA for the bf16 path is later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace capsim_attn {

constexpr float NEG_INF = -1e30f;
constexpr int CH = 16;                       // keys per online-softmax step

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kv_aux;  // flash: (B, Skv) validity or null; weighted: weights
  void* o;
  int B, Sq, Skv, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;  // in elements
  int causal, window, q_offset;
  float scale;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);              // round to nearest even
}

template <typename T, int D, int BQ, int BK, bool WEIGHTED>
__global__ void __launch_bounds__(BQ) attn_fwd(Args a) {
  static_assert(BK % CH == 0, "key tile must hold whole chunks");
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float ws[BK];  // flash: 1 valid / 0 masked; weighted: weight

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int q0 = blockIdx.y * BQ;
  const int qi = q0 + threadIdx.x;
  const bool row_ok = qi < a.Sq;
  const int qpos = qi + a.q_offset;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * D;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * D;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * D;

  float q[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = row_ok ? to_f32<T>(qp[qi * a.q_ss + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  int kv_end = a.Skv;
  if (!WEIGHTED && a.causal) {
    // every key after the CTA's last query position is masked for all rows
    const int last = min(q0 + BQ, a.Sq) - 1 + a.q_offset;
    kv_end = min(kv_end, last + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                       // the previous tile is consumed
    for (int idx = threadIdx.x; idx < BK * D; idx += BQ) {
      const int r = idx / D;
      const int c = idx % D;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < a.Skv) {
        kv = to_f32<T>(kp[kr * a.k_ss + c]);
        vv = to_f32<T>(vp[kr * a.v_ss + c]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    for (int r = threadIdx.x; r < BK; r += BQ) {
      const int kr = k0 + r;
      float w = 0.f;
      if (kr < a.Skv) {
        w = a.kv_aux != nullptr ? a.kv_aux[(long long)b * a.Skv + kr] : 1.f;
      }
      ws[r] = w;
    }
    __syncthreads();
    if (!row_ok) continue;

    const int nk = min(BK, a.Skv - k0);     // in-range keys of this tile
    for (int j0 = 0; j0 < nk; j0 += CH) {
      float s[CH];
      unsigned live = 0u;
      float cmax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = j0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
          dot = fmaf(q[d], kk.x, dot);
          dot = fmaf(q[d + 1], kk.y, dot);
          dot = fmaf(q[d + 2], kk.z, dot);
          dot = fmaf(q[d + 3], kk.w, dot);
        }
        bool ok = j < nk;
        if (!WEIGHTED) {
          const int kpos = k0 + j;
          ok = ok && ws[j] > 0.f;
          if (a.causal) {
            ok = ok && qpos >= kpos &&
                 (a.window <= 0 || qpos - kpos < a.window);
          }
        }
        s[jj] = ok ? dot * a.scale : NEG_INF;
        live |= ok ? (1u << jj) : 0u;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        float p = ((live >> jj) & 1u) ? expf(s[jj] - m_new) : 0.f;
        if (WEIGHTED) p *= ws[j0 + jj];
        s[jj] = p;
        psum += p;
      }
      l = l * alpha + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        // p.astype(v.dtype): the PV product sees p in the value dtype
        const float p = to_f32<T>(from_f32<T>(s[jj]));
        const int j = j0 + jj;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float den = l == 0.f ? 1.f : l;  // fully masked row -> zeros
    T* op = static_cast<T*>(a.o) + b * a.o_sb + qi * a.o_ss + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d] / den);
  }
}

// Key tile: 64 keys up to head_dim 64, 32 at 128, so K+V stay at or
// below 32 KB of static shared memory.
template <int D>
constexpr int key_tile() { return D <= 64 ? 64 : 32; }

template <typename T, int D, bool WEIGHTED>
int launch_d(const Args& a, cudaStream_t stream) {
  constexpr int BK = key_tile<D>();
  if (a.Sq <= 32) {
    dim3 grid(a.B * a.H, (a.Sq + 31) / 32);
    attn_fwd<T, D, 32, BK, WEIGHTED><<<grid, 32, 0, stream>>>(a);
  } else {
    dim3 grid(a.B * a.H, (a.Sq + 63) / 64);
    attn_fwd<T, D, 64, BK, WEIGHTED><<<grid, 64, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t, or -1 for
// a (dtype, head_dim) pair the kernel is not built for.
template <bool WEIGHTED>
int launch(int dtype, int head_dim, const Args& a, cudaStream_t stream) {
  if (a.B == 0 || a.Sq == 0 || a.H == 0) return 0;
#define CAPSIM_ATTN_CASE(DD)                                             \
  case DD:                                                               \
    return dtype == 0 ? launch_d<float, DD, WEIGHTED>(a, stream)         \
                      : launch_d<__nv_bfloat16, DD, WEIGHTED>(a, stream);
  if (dtype != 0 && dtype != 1) return -1;
  switch (head_dim) {
    CAPSIM_ATTN_CASE(16)
    CAPSIM_ATTN_CASE(32)
    CAPSIM_ATTN_CASE(64)
    CAPSIM_ATTN_CASE(128)
    default:
      return -1;
  }
#undef CAPSIM_ATTN_CASE
}

}  // namespace capsim_attn
