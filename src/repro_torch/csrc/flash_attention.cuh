// Flash-attention forward for Hopper (sm_90a): the body behind two entry
// points, each of which instantiates only its own variant (W, a template
// parameter, never a runtime branch):
//
//   flash_attention.cu     W = false, replaces the TPU kernel
//                          repro/kernels/flash_attention/kernel.py::_fa_kernel
//   weighted_attention.cu  W = true, replaces the TPU kernel
//                          repro/kernels/fused_serving/kernel.py::_wa_kernel
//
// Flash contract (the TPU kernel's, repeated by flash_attention_plain):
// q (B, Sq, H, D), k/v (B, Skv, H, D) read by batch and row strides with
// dense head and feature axes; an optional contiguous f32 (B, Skv)
// validity mask; causal and sliding-window masks with q aligned to the
// end of kv (q_offset = Skv - Sq).  Masked scores are -1e30 and the max
// runs over live scores; m, l and acc are f32; p is rounded to the value
// dtype before the PV product; a row with no valid key writes zeros.
//
// Weighted contract (weighted_attention_plain): the same layout with a
// contiguous f32 (B, Skv) weight per key in the mask's slot and no causal
// or window mask.  The row max runs over every key before Skv, zero-weight
// keys included, so a tile's bits are "key < Skv" and every full tile
// skips the per-score tests; the weight multiplies the max-shifted
// exponential, p = w * 2^(s*scale*log2e - m); l sums the f32 p and the
// PV product sees p in the value dtype.  A row whose keys all weigh 0
// writes exact zeros (l == 0, every p == 0).
//
// What bounds it on the card.  At the block encoder's shapes (B 256, H 4,
// D 32, 360 queries over 360 or 128 keys) one call moves 24-94 MB and
// does 3-17 GFLOP of products.  In bf16 that is 0.02-0.03 ms of HBM
// traffic against ~0.02 ms of tensor-core work at mma.sync rates, plus
// one exponential per score: 1.3e8 for block self, ~0.03-0.04 ms on the
// SFUs at boost clock.  In f32 the products bound it: 0.25 ms of FMA
// issue at the published 67 TFLOP/s.  The fused step's weighted shapes
// (B 256, H 4, D 32, U = 64 or 128 over 64 or 128 keys) are 8-30x
// smaller: 0.005-0.01 ms of bytes in bf16, 0.01-0.03 ms of FMA in f32.
//
// What the design does about it.  One CTA of NW warps (4, or 1-2 when
// Sq <= 32) per (batch, head, 16*NW queries); each warp owns 16 query
// rows and walks every key tile of 64 keys that its rows can see.  The
// query tiles of one (batch, head) are neighbours in the 1-D grid, so
// they read its K/V from L2 rather than each from HBM.  K/V tiles and
// their validity words (or weights) stream through shared memory by
// cp.async in a two-stage ring, so the next tile's copy overlaps this
// tile's products; rows past Skv are zero-filled by the copy (weight 0).
// Causal and windowed CTAs start and stop at the first and last tile any
// of their rows can see, and a tile that all of a warp's rows see whole
// skips the per-score mask tests.  Exponentials are 2^x on the SFU (ex2.approx.ftz) with
// scale*log2(e) folded into one FFMA.
//
//   bf16: a Flash-Attention-2 forward on
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.  Q fragments are loaded
//   once with ldmatrix; S = Q K^T stays in f32 accumulator fragments; the
//   online softmax runs on the fragments, with the row max and sum taken
//   across the lane quad by shuffles; P is rounded to bf16 and packed
//   straight into the A fragments of P V (no shared-memory round trip); O
//   accumulates in f32.  Shared rows are padded by 16 bytes, so every
//   ldmatrix (and .trans for V) is free of bank conflicts.
//
//   Asked (Args::lse), either flash body also stores each row's
//   log-sum-exp for the backward (flash_attention_bwd.cu), after O and
//   without touching it.
//
//   f32: the same tiling on the FMA pipes, in full f32 (no mma of any
//   precision, no TF32).  Each thread owns 4 queries x 8 keys of S (rows
//   16w + lane/8 + 4i, keys lane%8 + 8j), so per 4 features four 16-byte
//   Q loads and eight K loads feed 128 FMAs; the row max and sum reduce
//   over the 8 lanes of a row.  P goes through a per-warp slice of shared
//   memory (only __syncwarp), and each thread then owns the same 4 rows x
//   D/8 features of O, so a P load and a V load of 16 bytes each feed 16
//   FMAs and m, l and the rescale stay in the thread.
//
// The bf16 body is bound by neither pipe: per warp and key tile it
// issues 32 HMMA and 34 MUFU among a few hundred other instructions
// (cuobjdump -sass), and stalls on the chain mma -> max -> shuffle ->
// exp -> mma within a warp.  Two row blocks a warp, sharing the K/V
// fragments, ran slower (fewer resident warps).  The next step is wgmma
// with TMA-fed K/V tiles, a producer warp and ping-pong softmax between
// warpgroups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace capsim_fa {

using namespace capsim;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int BK = 64;       // keys per tile
constexpr int MAX_WARPS = 4;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kv_mask;  // (B, Skv): flash validity or null; W: weights
  void* o;
  int B, Sq, Skv, H;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;  // in elements
  int causal, window, q_offset;
  float scale;
  // (B, H, Sq) f32 or null: where either flash body (W = false) stores
  // each row's log-sum-exp of its scaled live scores, ln(sum exp(s*scale)),
  // for the backward (flash_attention_bwd.cu); +inf for a row with no
  // valid key, so every p recomputed from it is exactly 0
  float* lse = nullptr;
};

// ----------------------------------------------------------------------
// Shared between the two bodies
// ----------------------------------------------------------------------

// The key tiles [lo, hi) that rows [r0, r1) can see (hi <= lo: none).
struct KeyRange {
  int lo, hi;
};

__device__ __forceinline__ KeyRange key_range(const Args& a, int r0, int r1) {
  KeyRange kr{0, a.Skv};
  if (a.causal) {
    kr.hi = min(kr.hi, r1 - 1 + a.q_offset + 1);
    if (a.window > 0) kr.lo = max(0, r0 + a.q_offset - a.window + 1);
  }
  return kr;
}

// Per-row visible key positions [kmin, kmax] for query row qi.
__device__ __forceinline__ void row_limits(const Args& a, int qi, int& kmin,
                                           int& kmax) {
  kmin = -0x7fffffff;
  kmax = 0x7fffffff;
  if (a.causal) {
    kmax = qi + a.q_offset;
    if (a.window > 0) kmin = kmax - a.window + 1;
  }
}

// Rows [row0, row0 + nrows) of a (rows, D) slab of T into shared rows of
// `stride` elements, 16 bytes a copy; rows at or past `limit` read zeros.
// Each thread keeps one column and steps over rows by pointer increments.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int stride, const T* src,
                                          long long src_rs, int row0,
                                          int nrows, int limit) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;           // divides 32
  const int col = (threadIdx.x % PER_ROW) * VEC;
  const int rstep = blockDim.x / PER_ROW;
  int r = threadIdx.x / PER_ROW;
  const T* sp = src + (long long)(row0 + r) * src_rs + col;
  const long long sstep = (long long)rstep * src_rs;
  T* dp = dst + r * stride + col;
  for (; r < nrows; r += rstep, sp += sstep, dp += rstep * stride) {
    const bool in = row0 + r < limit;
    cp_async16(dp, in ? sp : src, in);
  }
}

// The K/V rows and validity words of successive key tiles, as one thread
// copies them: one 16-byte column, every rstep-th row, pointers computed
// once and advanced a tile at a time.  Rows past Skv read zeros; their
// validity word is 0.
template <typename T, int D, int STRIDE>
struct KVStream {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = D / VEC;    // divides 32
  const T* k;
  const T* v;
  const float* m;                            // null without a mask
  long long k_step, v_step, k_tile, v_tile;
  int r0, rstep, dst0;

  __device__ KVStream(const Args& a, const T* kp, const T* vp, int b,
                      int first) {
    const int col = (threadIdx.x % PER_ROW) * VEC;
    r0 = threadIdx.x / PER_ROW;
    rstep = blockDim.x / PER_ROW;
    k = kp + (long long)(first + r0) * a.k_ss + col;
    v = vp + (long long)(first + r0) * a.v_ss + col;
    k_step = (long long)rstep * a.k_ss;
    v_step = (long long)rstep * a.v_ss;
    k_tile = (long long)BK * a.k_ss;
    v_tile = (long long)BK * a.v_ss;
    m = a.kv_mask == nullptr
            ? nullptr
            : a.kv_mask + (long long)b * a.Skv + first + threadIdx.x;
    dst0 = r0 * STRIDE + col;
  }

  // keys [k0, k0 + BK) into one stage, then on to the next tile
  __device__ __forceinline__ void load(const Args& a, int k0, T* kd, T* vd,
                                       float* md) {
    const int lim = a.Skv - k0;
    const T* kp = k;
    const T* vp = v;
    int d = dst0;
    for (int r = r0; r < BK; r += rstep) {
      const bool in = r < lim;
      cp_async16(kd + d, in ? kp : static_cast<const T*>(a.k), in);
      cp_async16(vd + d, in ? vp : static_cast<const T*>(a.v), in);
      kp += k_step;
      vp += v_step;
      d += rstep * STRIDE;
    }
    for (int r = threadIdx.x, i = 0; r < BK; r += blockDim.x, ++i) {
      const bool in = r < lim;
      if (m != nullptr) {
        cp_async4(md + r, in ? m + i * blockDim.x : a.kv_mask, in);
      } else {
        md[r] = in ? 1.f : 0.f;
      }
    }
    k += k_tile;
    v += v_tile;
    if (m != nullptr) m += BK;
  }
};

// The tile's 64 keys as two words: bit j of lo (hi) is key j (32 + j).
// Flash: set if the key is valid and before Skv (two ballots of the
// validity words).  W: set if the key is before Skv, whatever its weight,
// since the row max runs over zero-weight keys too.
template <bool W>
__device__ __forceinline__ void tile_bits(const Args& a, const float* mt,
                                          int k0, int lane, unsigned& lo,
                                          unsigned& hi) {
  if constexpr (W) {
    const int n = a.Skv - k0;
    lo = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
    hi = n >= 64 ? 0xffffffffu : n > 32 ? (1u << (n - 32)) - 1u : 0u;
  } else {
    lo = __ballot_sync(0xffffffffu, mt[lane] > 0.f);
    hi = __ballot_sync(0xffffffffu, mt[lane + 32] > 0.f);
  }
}

// True on every lane when the warp's rows see all keys [k0, k0 + BK):
// none masked or past Skv, none cut by the causal or window limits
// (kmin/kmax: this lane's rows), so the per-score tests can be skipped.
template <int R>
__device__ __forceinline__ bool tile_whole(const Args& a, unsigned lo,
                                           unsigned hi, int k0,
                                           const int (&kmin)[R],
                                           const int (&kmax)[R]) {
  if ((lo & hi) != 0xffffffffu) return false;
  if (!a.causal) return true;
  bool in = true;
#pragma unroll
  for (int i = 0; i < R; ++i)
    in = in && k0 >= kmin[i] && k0 + BK - 1 <= kmax[i];
  return __all_sync(0xffffffffu, in);
}

// ----------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
// ----------------------------------------------------------------------

template <int D>
struct Bf16Smem {
  static constexpr int STRIDE = D + 8;                // +16 bytes a row
  static constexpr int Q = MAX_WARPS * 16 * STRIDE;   // elements
  static constexpr int TILE = BK * STRIDE;
  static constexpr size_t BYTES =
      (Q + 4 * TILE) * sizeof(__nv_bfloat16) + 2 * BK * sizeof(float);
};

template <int D, bool W>
__global__ void __launch_bounds__(MAX_WARPS * 32) fa_fwd_bf16(Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  using S = Bf16Smem<D>;
  using T = __nv_bfloat16;
  constexpr int NT = BK / 8;       // key n-tiles of S
  constexpr int DT = D / 8;        // feature n-tiles of O
  constexpr int KS = D / 16;       // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + S::Q;                                   // [2][BK][STRIDE]
  T* vs = ks + 2 * S::TILE;                            // [2][BK][STRIDE]
  float* ms = reinterpret_cast<float*>(vs + 2 * S::TILE);  // [2][BK]

  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the query tiles of one (batch, head) are neighbours in the grid, so
  // they run together and read its K/V from L2, not each from HBM
  const int n_qt = (a.Sq + nw * 16 - 1) / (nw * 16);
  const int bh = blockIdx.x / n_qt;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = (blockIdx.x % n_qt) * nw * 16;
  const int q_end = min(q0 + nw * 16, a.Sq);

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * D;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * D;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * D;

  const KeyRange cta = key_range(a, q0, q_end);
  const int first = cta.lo / BK * BK;
  const int n_tiles = cta.hi > first ? (cta.hi - first + BK - 1) / BK : 0;

  // this warp's rows (a lane holds rows g and g + 8) and the keys they see
  const int w0 = q0 + warp * 16;
  const bool warp_live = w0 < a.Sq;
  const KeyRange wr = key_range(a, w0, min(w0 + 16, a.Sq));
  int kmin[2], kmax[2];
  row_limits(a, w0 + g, kmin[0], kmax[0]);
  row_limits(a, w0 + g + 8, kmin[1], kmax[1]);
  const float sl2 = a.scale * LOG2E;

  // shared-space addresses of this lane's ldmatrix rows in stage 0: Q (A
  // fragments), K (B fragments of Q K^T), V (.trans: B fragments of P V);
  // the loops below add only constants and the stage
  constexpr unsigned ROW = S::STRIDE * sizeof(T);
  constexpr unsigned TILE_BYTES = S::TILE * sizeof(T);
  const unsigned q_addr = smem_u32(
      qs + (warp * 16 + lane % 8 + 8 * (lane / 8 % 2)) * S::STRIDE +
      8 * (lane / 16));
  const unsigned k_addr = smem_u32(
      ks + (lane % 8 + 8 * (lane / 16)) * S::STRIDE + 8 * (lane / 8 % 2));
  const unsigned v_addr = smem_u32(
      vs + (lane % 8 + 8 * (lane / 8 % 2)) * S::STRIDE + 8 * (lane / 16));

  KVStream<T, D, S::STRIDE> kv(a, kp, vp, b, first);
  auto load_tile = [&](int tile, int stage) {
    kv.load(a, first + tile * BK, ks + stage * S::TILE,
            vs + stage * S::TILE, ms + stage * BK);
  };

  load_rows<T, D>(qs, S::STRIDE, qp + (long long)q0 * a.q_ss, a.q_ss, 0,
                  nw * 16, a.Sq - q0);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  unsigned qf[KS][4];
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    // this tile's copy (the one group in flight) has landed for every
    // thread, and every warp is done with the other stage: refill it
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], q_addr + kk * 32);
    }
    const int k0 = first + tile * BK;
    if (warp_live && k0 < wr.hi && k0 + BK > wr.lo) {
      const unsigned kt = k_addr + stage * TILE_BYTES;
      const unsigned vt = v_addr + stage * TILE_BYTES;
      const float* mt = ms + stage * BK;

      // S = Q K^T, 16 rows x 64 keys in f32 fragments
      float s[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          unsigned kb[4];
          ldsm_x4(kb, kt + p * 16 * ROW + kk * 32);
          mma_bf16(s[2 * p], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * p + 1], qf[kk], kb[2], kb[3]);
        }
      }

      // masks: lane holds rows g, g+8 and keys 8n + 2t, 8n + 2t + 1; a
      // masked score becomes -1e30.  The row max runs over raw scores
      // (scale > 0), and p = 2^(s*scale*log2e - m) is one FFMA and one
      // MUFU.EX2.
      unsigned lo, hi;
      tile_bits<W>(a, mt, k0, lane, lo, hi);
      float mx[2];
      if (tile_whole(a, lo, hi, k0, kmin, kmax)) {
        // a tree, not a chain of 16 dependent max operations
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          float t4[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            t4[c] = fmaxf(fmaxf(s[2 * c][2 * row], s[2 * c][2 * row + 1]),
                          fmaxf(s[2 * c + 1][2 * row],
                                s[2 * c + 1][2 * row + 1]));
          mx[row] = fmaxf(fmaxf(t4[0], t4[1]), fmaxf(t4[2], t4[3]));
        }
      } else {
        mx[0] = mx[1] = NEG_INF;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e / 2;
            const int key = n * 8 + 2 * t + (e & 1);
            const bool ok = (((n < 4 ? lo : hi) >> (key % 32)) & 1u) &&
                            k0 + key >= kmin[row] && k0 + key <= kmax[row];
            s[n][e] = ok ? s[n][e] : NEG_INF;
            mx[row] = fmaxf(mx[row], s[n][e]);
          }
      }
      float alpha[2], mref[2];
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
        const float m_new =
            fmaxf(m[row], mx[row] == NEG_INF ? NEG_INF : mx[row] * sl2);
        alpha[row] = exp2_sfu(m[row] - m_new);
        m[row] = m_new;
        mref[row] = m_new == NEG_INF ? 0.f : m_new;
        l[row] *= alpha[row];
      }
      // a masked score (-1e30) gives exactly 0, also in a row that has
      // no live key yet (mref = 0); W: the key's weight multiplies p
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float2 wk = make_float2(1.f, 1.f);
        if constexpr (W)
          wk = *reinterpret_cast<const float2*>(mt + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_sfu(fmaf(s[n][e], sl2, -mref[e / 2]));
          if constexpr (W) p *= (e & 1) ? wk.y : wk.x;
          s[n][e] = p;
          l[e / 2] += p;           // this lane's part of the row sum
        }
      }
#pragma unroll
      for (int i = 0; i < DT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e / 2];

      // O += P V, P rounded to bf16 in the A fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int p = 0; p < DT / 2; ++p) {
          unsigned vb[4];
          ldsm_x4_trans(vb, vt + kk * 16 * ROW + p * 32);
          mma_bf16(o[2 * p], pa, vb[0], vb[1]);
          mma_bf16(o[2 * p + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float sum = l[row];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[row] = sum;
    const float den = sum == 0.f ? 1.f : sum;   // keyless row -> zeros
    const int qi = w0 + g + 8 * row;
    if (qi >= a.Sq) continue;
    T* op = static_cast<T*>(a.o) + b * a.o_sb + qi * a.o_ss + h * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const unsigned packed = pack_bf16(o[i][2 * row] / den,
                                        o[i][2 * row + 1] / den);
      *reinterpret_cast<unsigned*>(op + i * 8 + 2 * t) = packed;
    }
  }
  // the rows' log-sum-exp, after O, as the f32 body stores it: lane t < 2
  // of a quad its row g + 8t, ln 2 (m + log2 l) (l >= 1 on a row with a
  // live key), +inf on a keyless row
  if constexpr (!W) {
    if (a.lse != nullptr && t < 2) {
      const float lv = t == 0 ? l[0] : l[1];
      const float mv = t == 0 ? m[0] : m[1];
      const int qi = w0 + g + 8 * t;
      if (qi < a.Sq)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qi] =
            lv == 0.f ? __int_as_float(0x7f800000)
                      : (mv + __log2f(lv)) * LN2;
    }
  }
}

// ----------------------------------------------------------------------
// f32: register-tiled on the FMA pipes
// ----------------------------------------------------------------------

template <int D>
struct F32Smem {
  static constexpr int STRIDE = D + 4;                // +16 bytes a row
  static constexpr int PSTRIDE = BK + 8;              // conflict-free P
  static constexpr int Q = MAX_WARPS * 16 * STRIDE;   // floats
  static constexpr int TILE = BK * STRIDE;
  static constexpr int P = MAX_WARPS * 16 * PSTRIDE;
  static constexpr size_t BYTES = (Q + 4 * TILE + P + 2 * BK) * sizeof(float);
};

template <int D, bool W>
__global__ void __launch_bounds__(MAX_WARPS * 32) fa_fwd_f32(Args a) {
  using S = F32Smem<D>;
  constexpr int QI = 4;                       // query rows a thread
  constexpr int KJ = BK / 8;                  // keys a thread
  constexpr int VEC = D >= 32 ? 4 : 2;        // O features a load
  constexpr int NC = D / 8 / VEC;             // O loads a key
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + S::Q;                      // [2][BK][STRIDE]
  float* vs = ks + 2 * S::TILE;               // [2][BK][STRIDE]
  float* ps = vs + 2 * S::TILE;               // [16 * MAX_WARPS][PSTRIDE]
  float* ms = ps + S::P;                      // [2][BK]

  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qy = lane / 8, kx = lane % 8;
  // the query tiles of one (batch, head) are neighbours in the grid, so
  // they run together and read its K/V from L2, not each from HBM
  const int n_qt = (a.Sq + nw * 16 - 1) / (nw * 16);
  const int bh = blockIdx.x / n_qt;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = (blockIdx.x % n_qt) * nw * 16;
  const int q_end = min(q0 + nw * 16, a.Sq);

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * D;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * D;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * D;

  const KeyRange cta = key_range(a, q0, q_end);
  const int first = cta.lo / BK * BK;
  const int n_tiles = cta.hi > first ? (cta.hi - first + BK - 1) / BK : 0;

  // rows warp*16 + qy + 4i of the CTA; keys kx + 8j of a tile
  const int w0 = q0 + warp * 16;
  const bool warp_live = w0 < a.Sq;
  const KeyRange wr = key_range(a, w0, min(w0 + 16, a.Sq));
  int kmin[QI], kmax[QI];
#pragma unroll
  for (int i = 0; i < QI; ++i) row_limits(a, w0 + qy + 4 * i, kmin[i], kmax[i]);
  const float sl2 = a.scale * LOG2E;

  KVStream<float, D, S::STRIDE> kv(a, kp, vp, b, first);
  auto load_tile = [&](int tile, int stage) {
    kv.load(a, first + tile * BK, ks + stage * S::TILE,
            vs + stage * S::TILE, ms + stage * BK);
  };

  load_rows<float, D>(qs, S::STRIDE, qp + (long long)q0 * a.q_ss, a.q_ss, 0,
                      nw * 16, a.Sq - q0);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  float o[QI][D / 8];
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[i][c] = 0.f;
  float m[QI], l[QI];
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const float* qrow = qs + (warp * 16 + qy) * S::STRIDE;
  float* prow = ps + (warp * 16 + qy) * S::PSTRIDE;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    // this tile's copy (the one group in flight) has landed for every
    // thread, and every warp is done with the other stage: refill it
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    const int k0 = first + tile * BK;
    if (warp_live && k0 < wr.hi && k0 + BK > wr.lo) {
      const float* kt = ks + stage * S::TILE;
      const float* vt = vs + stage * S::TILE;
      const float* mt = ms + stage * BK;

      float s[QI][KJ];
#pragma unroll
      for (int i = 0; i < QI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 qv[QI];
#pragma unroll
        for (int i = 0; i < QI; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qrow + 4 * i * S::STRIDE +
                                                   d);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kt + (kx + 8 * j) * S::STRIDE +
                                               d);
#pragma unroll
          for (int i = 0; i < QI; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }

      unsigned lo, hi;
      tile_bits<W>(a, mt, k0, lane, lo, hi);
      const bool whole = tile_whole(a, lo, hi, k0, kmin, kmax);
      float wk[KJ];                 // W: this lane's keys' weights
#pragma unroll
      for (int j = 0; j < KJ; ++j) wk[j] = W ? mt[kx + 8 * j] : 1.f;
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int key = kx + 8 * j;
          const bool ok = whole ||
                          ((((j < 4 ? lo : hi) >> (key % 32)) & 1u) &&
                           k0 + key >= kmin[i] && k0 + key <= kmax[i]);
          s[i][j] = ok ? s[i][j] : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[i], mx == NEG_INF ? NEG_INF : mx * sl2);
        const float alpha = exp2_sfu(m[i] - m_new);
        const float mref = m_new == NEG_INF ? 0.f : m_new;
        m[i] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          float p = exp2_sfu(fmaf(s[i][j], sl2, -mref));  // masked: 0
          if constexpr (W) p *= wk[j];
          prow[4 * i * S::PSTRIDE + kx + 8 * j] = p;
          psum += p;
        }
        l[i] = l[i] * alpha + psum;   // this lane's part of the row sum
#pragma unroll
        for (int c = 0; c < D / 8; ++c) o[i][c] *= alpha;
      }
      __syncwarp();

      // O += P V: rows qy + 4i, features VEC*kx + 8*VEC*c
#pragma unroll 2
      for (int j = 0; j < BK; j += 4) {
        float4 pv[QI];
#pragma unroll
        for (int i = 0; i < QI; ++i)
          pv[i] = *reinterpret_cast<const float4*>(prow + 4 * i * S::PSTRIDE +
                                                   j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vrow = vt + (j + jj) * S::STRIDE + VEC * kx;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            float vv[VEC];
            if constexpr (VEC == 4) {
              const float4 x =
                  *reinterpret_cast<const float4*>(vrow + 8 * VEC * c);
              vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
            } else {
              const float2 x =
                  *reinterpret_cast<const float2*>(vrow + 8 * VEC * c);
              vv[0] = x.x; vv[1] = x.y;
            }
#pragma unroll
            for (int i = 0; i < QI; ++i) {
              const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                            : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                o[i][c * VEC + e] = fmaf(p, vv[e], o[i][c * VEC + e]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    l[i] = sum;
    const float den = sum == 0.f ? 1.f : sum;   // keyless row -> zeros
    const int qi = w0 + qy + 4 * i;
    if (qi >= a.Sq) continue;
    float* op = static_cast<float*>(a.o) + b * a.o_sb + qi * a.o_ss + h * D +
                VEC * kx;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(op + 8 * VEC * c) =
            make_float4(o[i][4 * c] / den, o[i][4 * c + 1] / den,
                        o[i][4 * c + 2] / den, o[i][4 * c + 3] / den);
      } else {
        *reinterpret_cast<float2*>(op + 8 * VEC * c) =
            make_float2(o[i][2 * c] / den, o[i][2 * c + 1] / den);
      }
    }
  }
  // the rows' log-sum-exp, after O, lane kx < 4 of a row group its row
  // qy + 4 kx (one store a warp, 16 rows in a row): ln 2 (m + log2 l),
  // where l >= 1 on a row with a live key (its max scores 2^0), so
  // lg2.approx's absolute error (~2^-22) holds; +inf on a keyless row
  if constexpr (!W) {
    if (a.lse != nullptr && kx < QI) {
      float lv = l[0], mv = m[0];
#pragma unroll
      for (int i = 1; i < QI; ++i) {
        lv = kx == i ? l[i] : lv;
        mv = kx == i ? m[i] : mv;
      }
      const int qi = w0 + qy + 4 * kx;
      if (qi < a.Sq)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qi] =
            lv == 0.f ? __int_as_float(0x7f800000)
                      : (mv + __log2f(lv)) * LN2;
    }
  }
}

// ----------------------------------------------------------------------
// Launch
// ----------------------------------------------------------------------

// Dynamic shared memory of one instantiation, in bytes.
template <int D>
constexpr size_t smem_bytes(int dtype) {
  return dtype == 0 ? F32Smem<D>::BYTES : Bf16Smem<D>::BYTES;
}

// Warps a CTA: 1 for Sq <= 16, 2 for Sq <= 32, else 4, so short queries
// (the instruction encoder, decode) are not padded to 64 rows.
inline int warps_for(int sq) { return sq <= 16 ? 1 : sq <= 32 ? 2 : MAX_WARPS; }

// Launch `kernel` on ceil(Sq / 16 nw) CTAs per (batch, head).  A kernel
// that asks for more than 48 KB of dynamic shared memory gets the
// attribute once per device (`ready`: one bit per device).
template <typename Kernel>
int launch_kernel(Kernel kernel, size_t smem, unsigned long long& ready,
                  const Args& a, cudaStream_t stream) {
  const int nw = warps_for(a.Sq);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(ready & bit)) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      ready |= bit;
    }
  }
  const long long n_ctas =
      (long long)a.B * a.H * ((a.Sq + nw * 16 - 1) / (nw * 16));
  if (n_ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(n_ctas), nw * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool W>
int launch_d(int dtype, const Args& a, cudaStream_t stream) {
  static unsigned long long ready_f32 = 0, ready_bf16 = 0;
  return dtype == 0 ? launch_kernel(fa_fwd_f32<D, W>, F32Smem<D>::BYTES,
                                    ready_f32, a, stream)
                    : launch_kernel(fa_fwd_bf16<D, W>, Bf16Smem<D>::BYTES,
                                    ready_bf16, a, stream);
}

// The kernel copies q/k/v rows 16 bytes at a time: each must start on 16
// bytes and step by whole 16-byte units per batch and row (the stride of
// an axis of length 1 is never used).
inline bool aligned16(const void* p, long long sb, long long ss, int nb,
                      int ns, int elem) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 &&
         (nb <= 1 || (sb * elem) % 16 == 0) &&
         (ns <= 1 || (ss * elem) % 16 == 0);
}

// dtype: 0 = float32, 1 = bfloat16; W: weighted attention (a.kv_mask
// holds the weights; causal and window must be 0).  Returns 0, a
// cudaError_t, -1 for a (dtype, head_dim) pair the kernel is not built
// for, or -2 for q/k/v that are not 16-byte aligned (aligned16).
template <bool W>
int launch(int dtype, int head_dim, const Args& a, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (a.B == 0 || a.Sq == 0 || a.H == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  if (!aligned16(a.q, a.q_sb, a.q_ss, a.B, a.Sq, elem) ||
      !aligned16(a.k, a.k_sb, a.k_ss, a.B, a.Skv, elem) ||
      !aligned16(a.v, a.v_sb, a.v_ss, a.B, a.Skv, elem))
    return -2;
  switch (head_dim) {
    case 16: return launch_d<16, W>(dtype, a, stream);
    case 32: return launch_d<32, W>(dtype, a, stream);
    case 64: return launch_d<64, W>(dtype, a, stream);
    case 128: return launch_d<128, W>(dtype, a, stream);
    default: return -1;
  }
}

// Dynamic shared memory a launch asks for, or -1 (not built).
inline long long shared_bytes(int dtype, int head_dim) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (head_dim) {
    case 16: return static_cast<long long>(smem_bytes<16>(dtype));
    case 32: return static_cast<long long>(smem_bytes<32>(dtype));
    case 64: return static_cast<long long>(smem_bytes<64>(dtype));
    case 128: return static_cast<long long>(smem_bytes<128>(dtype));
    default: return -1;
  }
}

}  // namespace capsim_fa
