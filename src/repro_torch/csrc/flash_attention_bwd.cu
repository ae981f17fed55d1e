// Flash-attention backward for Hopper (sm_90a), in f32 and in bf16: dQ,
// dK and dV of the flash forward (flash_attention.cuh, W = false) from q,
// k, v, the forward's output O, the output gradient dO and the log-sum-exp
// of each row that the forward body stores when asked (Args::lse).  It
// replaces no TPU kernel: the JAX package's custom VJP recomputes the
// attention through `attention_ref` (repro/kernels/flash_attention/ops.py)
// and leaves its gradient to XLA, and the port did the same through
// flash_attention_plain until these kernels (autograd over its key tiles
// moved the whole f32 score tensor about three times a tile).  Loaded
// from Python with ctypes (repro_torch/kernels/flash_attention/ops.py).
// The dtype code of the one C entry point chooses between two paths that
// share only the Grad/Args contract and the key- and query-range helpers:
// f32 on the FMA pipes, (a)-(d), sized for the CAPSim predictor's D = 32,
// and bf16 on the tensor cores, (e)-(g), sized for D = 128.
//
// Contract (flash_attention_backward_plain repeats it): with
// s = scale q.k over the live keys (kv_mask, causal and window as the
// forward reads them, q aligned to the end of kv),
//   P  = exp(s - lse)                  (0 for a masked key, and for every
//                                       key of a row whose lse is +inf)
//   Δ  = rowsum(dO ∘ O)
//   dV = Pᵀ dO,  dS = P ∘ (dO Vᵀ - Δ),  dQ = scale dS K,  dK = scale dSᵀ Q.
// P is recomputed as the forward computes it, 2^(s*scale*log2e - lse*log2e)
// on the SFU (ex2.approx) with scale*log2e folded into one FFMA.
//
// What bounds it on the card.  Five products over the live (query, key)
// pairs (S = QKᵀ again, dP = dO Vᵀ, dV, dQ, dK: 2.5x the forward's
// FLOPs), all in full f32 on the FMA pipes at 67 TFLOP/s (no mma of any
// precision, no TF32: TF32 fails the train cells' checks).  At the CAPSim
// train shapes (H 4, D 32) that is 0.63 ms for block self 256 x 360^2 and
// 1.33 ms for 32 x 1476^2; the instruction encoder's 4096 x 16^2 passes
// are bound by their bytes (~0.08 ms: q, k, v, O and dO read, dQ, dK and
// dV written).
//
// What the design does about it.  Three kernels on the stream (one where
// a (batch, head) fits one tile, (d)), each sum in a fixed order and every
// output element written by one thread (no atomics), so a call gives the
// same bits every time:
//   (a) fa_bwd_delta_f32<D>   Δ per row: D/4 lanes a row, a 16-byte load
//       of O and of dO each, a shuffle tree.
//   (b) fa_bwd_dkdv_f32<D>    one CTA per (batch, head, 16 NW keys), NW
//       warps of 16 keys each (1-2 warps for 16-32 keys).  K and V rows
//       stay in shared memory, dK and dV in registers (4 keys x D/8
//       features a thread).  The CTA walks the query tiles that can see
//       its keys (8 KJ queries: 64, or 32 at D = 128 to fit the
//       registers), Q, dO, lse and Δ streamed through a two-stage cp.async
//       ring.  Each thread holds 4 keys x KJ queries of Sᵀ and dPᵀ (the
//       forward's register tile with the roles of rows and keys swapped),
//       so P and dS go to a per-warp slice of shared memory with only
//       __syncwarp before the Pᵀ dO and dSᵀ Q products.
//   (c) fa_bwd_dq_f32<D>      the forward's own tiling: one CTA per
//       (batch, head, 16 NW queries), Q and dO rows in shared memory, K/V
//       tiles of 64 keys and their validity words streamed by the
//       forward's KVStream; dS through the per-warp slice into dQ.
//   (d) fa_bwd_small_f32<D>   where Sq <= 16 and Skv <= 16 (the
//       instruction encoder's 16 tokens): one launch, one warp per
//       (batch, head), four a CTA.  The five inputs' rows land in the
//       warp's shared memory together, Δ, P and dS are formed there, and
//       the lane pair of a row (or key) writes its dQ, dK and dV rows:
//       (a)-(c) would give such a pair one 16-row tile of a CTA sized for
//       64 rows, and the card a few warps an SM.
// S and dP are computed in both (b) and (c), seven products where five
// would do: the price of no atomics and no (B, H, Sq, Skv) intermediate.
// A warp whose keys are all masked (the clip_mask's padded instructions)
// skips its work in (b), and a tile that all of a warp's pairs see whole
// skips the per-score tests, as in the forward.
//
// bf16 (NemotronH's causal GQA attention in training, (2, 4096, 32, 128)
// with the KV heads repeated): the five products are 687 GFLOP a call,
// 0.69 ms at the tensor cores' 989 TFLOP/s; the bytes (q, k, v, O, dO
// read, dQ, dK, dV written: ~0.2 GB) are 0.06 ms.  mma.sync (not wgmma)
// keeps the design the bf16 forward's; a warp issues one ldmatrix.x4 (512
// bytes of shared memory) for every 1.6-1.7 HMMA, so shared memory
// bandwidth, not the tensor cores, is the first limit.  Three launches, the
// same order of sums every call (no atomics):
//   (e) fa_bwd_delta_bf16<D>  Δ per row from the bf16 O and dO.
//   (f) fa_bwd_dkdv_bf16<D>   one CTA per (batch, head, 16 NW keys), the
//       query tiles its keys can see (a causal CTA starts at its first
//       key's query); Sᵀ and dPᵀ in fragments, dV, dK in registers.
//   (g) fa_bwd_dq_bf16<D>     one CTA per (batch, head, 16 NW queries), the
//       key tiles its rows can see; dQ in registers.
// S and dP again computed in both, as in f32.
#include "flash_attention.cuh"

namespace capsim_fa_bwd {

using namespace capsim;
using capsim_fa::Args;
using capsim_fa::BK;
using capsim_fa::KeyRange;
using capsim_fa::KVStream;
using capsim_fa::LOG2E;
using capsim_fa::MAX_WARPS;

constexpr unsigned FULL = 0xffffffffu;

struct Grad {
  Args f;              // q, k, v, kv_mask, O (f.o), sizes, strides, masks
  const float* g;      // dO, (B, Sq, H, D) by g_sb / g_ss
  const float* lse;    // (B, H, Sq), the forward's
  float* delta;        // (B, H, Sq), written by (a)
  float* dq;           // (B, Sq, H, D) contiguous
  float* dk;           // (B, Skv, H, D) contiguous
  float* dv;           // (B, Skv, H, D) contiguous
  long long g_sb, g_ss;
};

// Grad's fields for the bf16 kernels: dO and the three gradients in bf16,
// lse and Δ in f32
struct GradBf16 {
  Args f;
  const __nv_bfloat16* g;
  const float* lse;
  float* delta;        // written by (e)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long g_sb, g_ss;
};

// Whether query row q sees key `key` under the causal and window masks.
__device__ __forceinline__ bool sees(const Args& a, int q, int key) {
  if (!a.causal) return true;
  const int kmax = q + a.q_offset;
  return key <= kmax && (a.window <= 0 || key > kmax - a.window);
}

// The query rows [lo, hi) that see some key of [k0, k1) (hi <= lo: none).
__device__ __forceinline__ KeyRange query_range(const Args& a, int k0,
                                                int k1) {
  KeyRange r{0, a.Sq};
  if (a.causal) {
    r.lo = max(0, k0 - a.q_offset);
    if (a.window > 0) r.hi = min(r.hi, k1 - 1 - a.q_offset + a.window);
  }
  return r;
}

// 4 or 2 f32 at p, as an array
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* x,
                                          float mul) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(x[0] * mul, x[1] * mul, x[2] * mul, x[3] * mul);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0] * mul, x[1] * mul);
  }
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

__device__ __forceinline__ float lane4(float4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// ----------------------------------------------------------------------
// (a) Δ = rowsum(dO ∘ O)
// ----------------------------------------------------------------------

constexpr int DELTA_THREADS = 256;

template <int D>
__global__ void __launch_bounds__(DELTA_THREADS) fa_bwd_delta_f32(Grad g) {
  const Args& a = g.f;
  constexpr int LPR = D / 4;                  // lanes a row
  const long long rows = static_cast<long long>(a.B) * a.Sq * a.H;
  const long long row =
      (static_cast<long long>(blockIdx.x) * DELTA_THREADS + threadIdx.x) / LPR;
  const int col = (threadIdx.x % LPR) * 4;
  float acc = 0.f;
  long long out = 0;
  if (row < rows) {
    const int h = static_cast<int>(row % a.H);
    const long long bs = row / a.H;
    const int s = static_cast<int>(bs % a.Sq);
    const int b = static_cast<int>(bs / a.Sq);
    const float4 x = *reinterpret_cast<const float4*>(
        static_cast<const float*>(a.o) + b * a.o_sb + s * a.o_ss + h * D + col);
    const float4 y = *reinterpret_cast<const float4*>(
        g.g + b * g.g_sb + s * g.g_ss + h * D + col);
    acc = dot4(x, y, 0.f);
    out = (static_cast<long long>(b) * a.H + h) * a.Sq + s;
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (row < rows && threadIdx.x % LPR == 0) g.delta[out] = acc;
}

// ----------------------------------------------------------------------
// (b) dK, dV: one CTA per (batch, head, key tile)
// ----------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int KJ = D >= 128 ? 4 : 8;          // queries a thread
  static constexpr int BQ = 8 * KJ;                    // queries a tile
  static constexpr int STRIDE = D + 4;                 // +16 bytes a row
  static constexpr int PSTRIDE = BQ + 8;               // conflict-free P
  static constexpr int KV = MAX_WARPS * 16 * STRIDE;   // K rows; V rows
  static constexpr int TILE = BQ * STRIDE;             // a Q or dO tile
  static constexpr int P = MAX_WARPS * 16 * PSTRIDE;   // Pᵀ; dSᵀ
  static constexpr size_t BYTES =
      (2 * KV + 4 * TILE + 2 * P + 4 * BQ) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32) fa_bwd_dkdv_f32(Grad g) {
  const Args& a = g.f;
  using S = DkvSmem<D>;
  constexpr int KI = 4;                       // keys a thread
  constexpr int KJ = S::KJ;
  constexpr int BQ = S::BQ;
  constexpr int VEC = D >= 32 ? 4 : 2;        // dK/dV features a load
  constexpr int NC = D / 8 / VEC;             // loads a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + S::KV;
  float* qs = vs + S::KV;                     // [2][BQ][STRIDE]
  float* gs = qs + 2 * S::TILE;               // [2][BQ][STRIDE]
  float* pt = gs + 2 * S::TILE;               // [16 * MAX_WARPS][PSTRIDE]
  float* dt = pt + S::P;                      // [16 * MAX_WARPS][PSTRIDE]
  float* ls = dt + S::P;                      // [2][BQ] lse
  float* ds = ls + 2 * BQ;                    // [2][BQ] Δ

  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ky = lane / 8, qx = lane % 8;
  // the key tiles of one (batch, head) are neighbours in the grid, so they
  // read its Q and dO from L2
  const int n_kt = (a.Skv + nw * 16 - 1) / (nw * 16);
  const int bh = blockIdx.x / n_kt;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int k0 = (blockIdx.x % n_kt) * nw * 16;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * D;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * D;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * D;
  const float* gp = g.g + b * g.g_sb + h * D;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const float* lp = g.lse + row0;
  const float* dp0 = g.delta + row0;

  const KeyRange cta = query_range(a, k0, min(k0 + nw * 16, a.Skv));
  const int first = cta.lo / BQ * BQ;
  const int n_tiles = cta.hi > first ? (cta.hi - first + BQ - 1) / BQ : 0;

  // this lane's keys w0 + ky + 4i, and whether each is valid
  const int w0 = k0 + warp * 16;
  bool kok[KI];
  bool all_ok = true, any_ok = false;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = w0 + ky + 4 * i;
    kok[i] = key < a.Skv &&
             (a.kv_mask == nullptr ||
              a.kv_mask[static_cast<long long>(b) * a.Skv + key] > 0.f);
    all_ok = all_ok && kok[i];
    any_ok = any_ok || kok[i];
  }
  const bool warp_live = __any_sync(FULL, any_ok);
  all_ok = __all_sync(FULL, all_ok);
  const KeyRange wr = query_range(a, w0, min(w0 + 16, a.Skv));
  const float sl2 = a.scale * LOG2E;

  auto load_tile = [&](int tile, int stage) {
    const int t0 = first + tile * BQ;
    capsim_fa::load_rows<float, D>(qs + stage * S::TILE, S::STRIDE, qp,
                                   a.q_ss, t0, BQ, a.Sq);
    capsim_fa::load_rows<float, D>(gs + stage * S::TILE, S::STRIDE, gp,
                                   g.g_ss, t0, BQ, a.Sq);
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      const bool in = t0 + r < a.Sq;
      cp_async4(ls + stage * BQ + r, in ? lp + t0 + r : lp, in);
      cp_async4(ds + stage * BQ + r, in ? dp0 + t0 + r : dp0, in);
    }
  };

  capsim_fa::load_rows<float, D>(ks, S::STRIDE, kp, a.k_ss, k0, nw * 16,
                                 a.Skv);
  capsim_fa::load_rows<float, D>(vs, S::STRIDE, vp, a.v_ss, k0, nw * 16,
                                 a.Skv);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  float dk[KI][D / 8], dv[KI][D / 8];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.f;
  const float* krow = ks + (warp * 16 + ky) * S::STRIDE;
  const float* vrow = vs + (warp * 16 + ky) * S::STRIDE;
  float* prow = pt + (warp * 16 + ky) * S::PSTRIDE;
  float* drow = dt + (warp * 16 + ky) * S::PSTRIDE;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    const int t0 = first + tile * BQ;
    if (!(warp_live && t0 < wr.hi && t0 + BQ > wr.lo)) continue;
    const float* qt = qs + stage * S::TILE;
    const float* gt = gs + stage * S::TILE;
    const float* lt = ls + stage * BQ;
    const float* dlt = ds + stage * BQ;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: keys ky + 4i, queries qx + 8j
    float s[KI][KJ], dpt[KI][KJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[KI], vv[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(krow + 4 * i * S::STRIDE + d);
        vv[i] = *reinterpret_cast<const float4*>(vrow + 4 * i * S::STRIDE + d);
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qt + (qx + 8 * j) * S::STRIDE + d);
        const float4 gv =
            *reinterpret_cast<const float4*>(gt + (qx + 8 * j) * S::STRIDE + d);
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          s[i][j] = dot4(kv[i], qv, s[i][j]);
          dpt[i][j] = dot4(vv[i], gv, dpt[i][j]);
        }
      }
    }

    // P and dS; every pair of the tile is live when the warp's keys are
    // all valid, the tile is full and the masks cut none of it
    bool whole = all_ok && t0 + BQ <= a.Sq;
    if (a.causal)
      whole = whole && w0 + 15 <= t0 + a.q_offset &&
              (a.window <= 0 || w0 > t0 + BQ - 1 + a.q_offset - a.window);
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int q = t0 + qx + 8 * j;
      const float l2 = lt[qx + 8 * j] * LOG2E;
      const float dl = dlt[qx + 8 * j];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const bool ok =
            whole || (kok[i] && q < a.Sq && sees(a, q, w0 + ky + 4 * i));
        const float p = ok ? exp2_sfu(fmaf(s[i][j], sl2, -l2)) : 0.f;
        prow[4 * i * S::PSTRIDE + qx + 8 * j] = p;
        drow[4 * i * S::PSTRIDE + qx + 8 * j] = p * (dpt[i][j] - dl);
      }
    }
    __syncwarp();

    // dV += Pᵀ dO, dK += dSᵀ Q: keys ky + 4i, features VEC*qx + 8*VEC*c
#pragma unroll 2
    for (int j = 0; j < BQ; j += 4) {
      float4 pv[KI], dsv[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(prow + 4 * i * S::PSTRIDE + j);
        dsv[i] =
            *reinterpret_cast<const float4*>(drow + 4 * i * S::PSTRIDE + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* grow = gt + (j + jj) * S::STRIDE + VEC * qx;
        const float* qrow = qt + (j + jj) * S::STRIDE + VEC * qx;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float gvv[VEC], qvv[VEC];
          load_vec<VEC>(grow + 8 * VEC * c, gvv);
          load_vec<VEC>(qrow + 8 * VEC * c, qvv);
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            const float p = lane4(pv[i], jj);
            const float dsc = lane4(dsv[i], jj);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              dv[i][c * VEC + e] = fmaf(p, gvv[e], dv[i][c * VEC + e]);
              dk[i][c * VEC + e] = fmaf(dsc, qvv[e], dk[i][c * VEC + e]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // every key before Skv is written, a masked one with zeros
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = w0 + ky + 4 * i;
    if (key >= a.Skv) continue;
    const long long at =
        ((static_cast<long long>(b) * a.Skv + key) * a.H + h) * D + VEC * qx;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store_vec<VEC>(g.dk + at + 8 * VEC * c, &dk[i][c * VEC], a.scale);
      store_vec<VEC>(g.dv + at + 8 * VEC * c, &dv[i][c * VEC], 1.f);
    }
  }
}

// ----------------------------------------------------------------------
// (c) dQ: one CTA per (batch, head, query tile), the forward's tiling
// ----------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int STRIDE = D + 4;                // +16 bytes a row
  static constexpr int PSTRIDE = BK + 8;              // conflict-free dS
  static constexpr int Q = MAX_WARPS * 16 * STRIDE;   // Q rows; dO rows
  static constexpr int TILE = BK * STRIDE;
  static constexpr int P = MAX_WARPS * 16 * PSTRIDE;
  static constexpr size_t BYTES = (2 * Q + 4 * TILE + P + 2 * BK) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32) fa_bwd_dq_f32(Grad g) {
  const Args& a = g.f;
  using S = DqSmem<D>;
  constexpr int QI = 4;                       // query rows a thread
  constexpr int KJ = BK / 8;                  // keys a thread
  constexpr int VEC = D >= 32 ? 4 : 2;        // dQ features a load
  constexpr int NC = D / 8 / VEC;             // loads a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* gs = qs + S::Q;
  float* ks = gs + S::Q;                      // [2][BK][STRIDE]
  float* vs = ks + 2 * S::TILE;               // [2][BK][STRIDE]
  float* ps = vs + 2 * S::TILE;               // [16 * MAX_WARPS][PSTRIDE]
  float* ms = ps + S::P;                      // [2][BK]

  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qy = lane / 8, kx = lane % 8;
  const int n_qt = (a.Sq + nw * 16 - 1) / (nw * 16);
  const int bh = blockIdx.x / n_qt;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = (blockIdx.x % n_qt) * nw * 16;
  const int q_end = min(q0 + nw * 16, a.Sq);

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * D;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * D;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * D;
  const float* gp = g.g + b * g.g_sb + h * D;

  const KeyRange cta = capsim_fa::key_range(a, q0, q_end);
  const int first = cta.lo / BK * BK;
  const int n_tiles = cta.hi > first ? (cta.hi - first + BK - 1) / BK : 0;

  // rows w0 + qy + 4i; keys kx + 8j of a tile
  const int w0 = q0 + warp * 16;
  const bool warp_live = w0 < a.Sq;
  const KeyRange wr = capsim_fa::key_range(a, w0, min(w0 + 16, a.Sq));
  int kmin[QI], kmax[QI];
  float l2[QI], dl[QI];
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int qi = w0 + qy + 4 * i;
    capsim_fa::row_limits(a, qi, kmin[i], kmax[i]);
    const bool in = qi < a.Sq;
    l2[i] = in ? g.lse[row0 + qi] * LOG2E : __int_as_float(0x7f800000);
    dl[i] = in ? g.delta[row0 + qi] : 0.f;
  }
  const float sl2 = a.scale * LOG2E;

  KVStream<float, D, S::STRIDE> kv(a, kp, vp, b, first);
  auto load_tile = [&](int tile, int stage) {
    kv.load(a, first + tile * BK, ks + stage * S::TILE, vs + stage * S::TILE,
            ms + stage * BK);
  };

  capsim_fa::load_rows<float, D>(qs, S::STRIDE, qp + (long long)q0 * a.q_ss,
                                 a.q_ss, 0, nw * 16, a.Sq - q0);
  capsim_fa::load_rows<float, D>(gs, S::STRIDE, gp + (long long)q0 * g.g_ss,
                                 g.g_ss, 0, nw * 16, a.Sq - q0);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  float dq[QI][D / 8];
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dq[i][c] = 0.f;
  const float* qrow = qs + (warp * 16 + qy) * S::STRIDE;
  const float* grow = gs + (warp * 16 + qy) * S::STRIDE;
  float* prow = ps + (warp * 16 + qy) * S::PSTRIDE;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    const int k0 = first + tile * BK;
    if (!(warp_live && k0 < wr.hi && k0 + BK > wr.lo)) continue;
    const float* kt = ks + stage * S::TILE;
    const float* vt = vs + stage * S::TILE;
    const float* mt = ms + stage * BK;

    // S = Q Kᵀ and dP = dO Vᵀ: rows qy + 4i, keys kx + 8j
    float s[QI][KJ], dp[QI][KJ];
#pragma unroll
    for (int i = 0; i < QI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[QI], gv[QI];
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qrow + 4 * i * S::STRIDE + d);
        gv[i] = *reinterpret_cast<const float4*>(grow + 4 * i * S::STRIDE + d);
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kt + (kx + 8 * j) * S::STRIDE + d);
        const float4 vv =
            *reinterpret_cast<const float4*>(vt + (kx + 8 * j) * S::STRIDE + d);
#pragma unroll
        for (int i = 0; i < QI; ++i) {
          s[i][j] = dot4(qv[i], kk, s[i][j]);
          dp[i][j] = dot4(gv[i], vv, dp[i][j]);
        }
      }
    }

    unsigned lo, hi;
    capsim_fa::tile_bits<false>(a, mt, k0, lane, lo, hi);
    const bool whole = capsim_fa::tile_whole(a, lo, hi, k0, kmin, kmax);
#pragma unroll
    for (int i = 0; i < QI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int key = kx + 8 * j;
        const bool ok = whole ||
                        ((((j < 4 ? lo : hi) >> (key % 32)) & 1u) &&
                         k0 + key >= kmin[i] && k0 + key <= kmax[i]);
        const float p = ok ? exp2_sfu(fmaf(s[i][j], sl2, -l2[i])) : 0.f;
        prow[4 * i * S::PSTRIDE + key] = p * (dp[i][j] - dl[i]);
      }
    __syncwarp();

    // dQ += dS K: rows qy + 4i, features VEC*kx + 8*VEC*c
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 dsv[QI];
#pragma unroll
      for (int i = 0; i < QI; ++i)
        dsv[i] = *reinterpret_cast<const float4*>(prow + 4 * i * S::PSTRIDE + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* krow = kt + (j + jj) * S::STRIDE + VEC * kx;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float kvv[VEC];
          load_vec<VEC>(krow + 8 * VEC * c, kvv);
#pragma unroll
          for (int i = 0; i < QI; ++i) {
            const float dsc = lane4(dsv[i], jj);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dq[i][c * VEC + e] = fmaf(dsc, kvv[e], dq[i][c * VEC + e]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int qi = w0 + qy + 4 * i;
    if (qi >= a.Sq) continue;
    const long long at =
        ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * D + VEC * kx;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_vec<VEC>(g.dq + at + 8 * VEC * c, &dq[i][c * VEC], a.scale);
  }
}

// ----------------------------------------------------------------------
// (d) one tile: Sq <= 16 and Skv <= 16, dQ, dK and dV in one launch
// ----------------------------------------------------------------------

constexpr int SMALL = 16;          // rows and keys the one tile holds
constexpr int SMALL_WARPS = 4;     // (batch, head) pairs a CTA, one a warp

template <int D>
struct SmallSmem {
  static constexpr int STRIDE = D + 4;                // +16 bytes a row
  static constexpr int ROWS = SMALL * STRIDE;         // one of Q K V O dO
  static constexpr int PS = SMALL + 1;                // P, dS rows
  static constexpr int WARP = 5 * ROWS + 2 * SMALL * PS + 3 * SMALL;
  static constexpr size_t BYTES = SMALL_WARPS * WARP * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(SMALL_WARPS * 32)
    fa_bwd_small_f32(Grad g) {
  const Args& a = g.f;
  using S = SmallSmem<D>;
  constexpr int HALF = D / 2;                 // features a lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long bh =
      static_cast<long long>(blockIdx.x) * SMALL_WARPS + warp;
  if (bh >= static_cast<long long>(a.B) * a.H) return;   // whole warps
  const int b = static_cast<int>(bh / a.H);
  const int h = static_cast<int>(bh % a.H);
  float* qs = reinterpret_cast<float*>(smem) + warp * S::WARP;
  float* ks = qs + S::ROWS;
  float* vs = ks + S::ROWS;
  float* os = vs + S::ROWS;
  float* gs = os + S::ROWS;
  float* ps = gs + S::ROWS;                   // P [row][key]
  float* dss = ps + SMALL * S::PS;            // dS [row][key]
  float* ms = dss + SMALL * S::PS;            // key validity
  float* ls = ms + SMALL;                     // lse * log2e
  float* dl = ls + SMALL;                     // Δ

  // rows of the five inputs, 16 bytes a copy, zeros past Sq / Skv
  auto rows = [&](float* dst, const float* src, long long rs, int n) {
    for (int i = lane; i < SMALL * (D / 4); i += 32) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool in = r < n;
      cp_async16(dst + r * S::STRIDE + c, in ? src + r * rs + c : src, in);
    }
  };
  rows(qs, static_cast<const float*>(a.q) + b * a.q_sb + h * D, a.q_ss, a.Sq);
  rows(ks, static_cast<const float*>(a.k) + b * a.k_sb + h * D, a.k_ss,
       a.Skv);
  rows(vs, static_cast<const float*>(a.v) + b * a.v_sb + h * D, a.v_ss,
       a.Skv);
  rows(os, static_cast<const float*>(a.o) + b * a.o_sb + h * D, a.o_ss, a.Sq);
  rows(gs, g.g + b * g.g_sb + h * D, g.g_ss, a.Sq);
  cp_async_commit();
  if (lane < SMALL) {
    const int key = lane;
    ms[key] = key < a.Skv &&
                      (a.kv_mask == nullptr ||
                       a.kv_mask[static_cast<long long>(b) * a.Skv + key] > 0.f)
                  ? 1.f : 0.f;
    ls[lane] = lane < a.Sq ? g.lse[bh * a.Sq + lane] * LOG2E
                           : __int_as_float(0x7f800000);
  }
  cp_async_wait<0>();
  __syncwarp();

  // lane = 2 r + half: row (or key) r, features half * D/2 .. + D/2
  const int r = lane / 2, half = lane % 2, f0 = half * HALF;
  {
    float acc = 0.f;
#pragma unroll
    for (int f = 0; f < HALF; f += 4)
      acc = dot4(*reinterpret_cast<const float4*>(os + r * S::STRIDE + f0 + f),
                 *reinterpret_cast<const float4*>(gs + r * S::STRIDE + f0 + f),
                 acc);
    acc += __shfl_xor_sync(FULL, acc, 1);
    if (half == 0) dl[r] = acc;
  }
  __syncwarp();

  // P and dS at row r, keys half + 2j
  const float sl2 = a.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < SMALL / 2; ++j) {
    const int key = half + 2 * j;
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + r * S::STRIDE + d);
      const float4 gv = *reinterpret_cast<const float4*>(gs + r * S::STRIDE + d);
      s = dot4(qv, *reinterpret_cast<const float4*>(ks + key * S::STRIDE + d),
               s);
      dp = dot4(gv, *reinterpret_cast<const float4*>(vs + key * S::STRIDE + d),
                dp);
    }
    const bool ok = ms[key] > 0.f && r < a.Sq && sees(a, r, key);
    const float p = ok ? exp2_sfu(fmaf(s, sl2, -ls[r])) : 0.f;
    ps[r * S::PS + key] = p;
    dss[r * S::PS + key] = p * (dp - dl[r]);
  }
  __syncwarp();

  // dQ[r] = scale Σ_key dS[r, key] K[key]
  float acc[HALF];
#pragma unroll
  for (int f = 0; f < HALF; ++f) acc[f] = 0.f;
#pragma unroll
  for (int key = 0; key < SMALL; ++key) {
    const float w = dss[r * S::PS + key];
#pragma unroll
    for (int f = 0; f < HALF; f += 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(ks + key * S::STRIDE + f0 + f);
      acc[f] = fmaf(w, x.x, acc[f]);
      acc[f + 1] = fmaf(w, x.y, acc[f + 1]);
      acc[f + 2] = fmaf(w, x.z, acc[f + 2]);
      acc[f + 3] = fmaf(w, x.w, acc[f + 3]);
    }
  }
  if (r < a.Sq) {
    float* out = g.dq + ((static_cast<long long>(b) * a.Sq + r) * a.H + h) * D +
                 f0;
#pragma unroll
    for (int f = 0; f < HALF; f += 4) store_vec<4>(out + f, acc + f, a.scale);
  }

  // dK[key] = scale Σ_r dS[r, key] Q[r], dV[key] = Σ_r P[r, key] dO[r],
  // with key = r of this lane
  const int key = r;
  const long long at =
      ((static_cast<long long>(b) * a.Skv + key) * a.H + h) * D + f0;
#pragma unroll
  for (int out = 0; out < 2; ++out) {
    const float* w = out == 0 ? dss : ps;
    const float* x = out == 0 ? qs : gs;
#pragma unroll
    for (int f = 0; f < HALF; ++f) acc[f] = 0.f;
#pragma unroll
    for (int q = 0; q < SMALL; ++q) {
      const float wq = w[q * S::PS + key];
#pragma unroll
      for (int f = 0; f < HALF; f += 4) {
        const float4 xv =
            *reinterpret_cast<const float4*>(x + q * S::STRIDE + f0 + f);
        acc[f] = fmaf(wq, xv.x, acc[f]);
        acc[f + 1] = fmaf(wq, xv.y, acc[f + 1]);
        acc[f + 2] = fmaf(wq, xv.z, acc[f + 2]);
        acc[f + 3] = fmaf(wq, xv.w, acc[f + 3]);
      }
    }
    if (key < a.Skv) {
      float* dst = (out == 0 ? g.dk : g.dv) + at;
#pragma unroll
      for (int f = 0; f < HALF; f += 4)
        store_vec<4>(dst + f, acc + f, out == 0 ? a.scale : 1.f);
    }
  }
}

// ----------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulators)
// ----------------------------------------------------------------------
//
// The fragments are the bf16 forward's: a warp owns 16 rows of the
// product it accumulates (keys in (f), queries in (g)); A fragments come
// by ldmatrix from rows padded by 16 bytes, B fragments by ldmatrix where
// the operand's rows are the product's n and by ldmatrix.trans where they
// are its k; a C fragment of two n-tiles packs straight into the A
// fragment of the next product's k-step.  S and dP stay in f32
// accumulators, P = 2^(s*scale*log2e - lse*log2e) on the SFU, P is rounded
// to bf16 for dV and dS for dK and dQ (flash-attention-2's rounding
// points); every sum is f32, and dQ, dK and dV are rounded to bf16 once,
// at the store.

using T16 = __nv_bfloat16;

// (e) Δ = rowsum(dO ∘ O): D/8 lanes a row, a 16-byte load of each.
template <int D>
__global__ void __launch_bounds__(DELTA_THREADS)
    fa_bwd_delta_bf16(GradBf16 g) {
  const Args& a = g.f;
  constexpr int LPR = D / 8;                  // lanes a row
  const long long rows = static_cast<long long>(a.B) * a.Sq * a.H;
  const long long row =
      (static_cast<long long>(blockIdx.x) * DELTA_THREADS + threadIdx.x) / LPR;
  const int col = (threadIdx.x % LPR) * 8;
  float acc = 0.f;
  long long out = 0;
  if (row < rows) {
    const int h = static_cast<int>(row % a.H);
    const long long bs = row / a.H;
    const int s = static_cast<int>(bs % a.Sq);
    const int b = static_cast<int>(bs / a.Sq);
    const uint4 x = *reinterpret_cast<const uint4*>(
        static_cast<const T16*>(a.o) + b * a.o_sb + s * a.o_ss + h * D + col);
    const uint4 y = *reinterpret_cast<const uint4*>(
        g.g + b * g.g_sb + s * g.g_ss + h * D + col);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(xp[i]);
      const float2 yf = __bfloat1622float2(yp[i]);
      acc = fmaf(xf.x, yf.x, acc);
      acc = fmaf(xf.y, yf.y, acc);
    }
    out = (static_cast<long long>(b) * a.H + h) * a.Sq + s;
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (row < rows && threadIdx.x % LPR == 0) g.delta[out] = acc;
}

// Shared-space byte addresses of this lane's ldmatrix rows in a block of
// 16-byte-padded rows (`stride` elements): `a_rows` for A fragments of 16
// rows (the forward's Q) and for .trans B fragments whose rows are the
// product's k (the forward's V); `b_rows` for B fragments whose rows are
// the product's n (the forward's K).
__device__ __forceinline__ unsigned a_rows(const T16* base, int stride,
                                           int lane) {
  return smem_u32(base + (lane % 8 + 8 * (lane / 8 % 2)) * stride +
                  8 * (lane / 16));
}

__device__ __forceinline__ unsigned b_rows(const T16* base, int stride,
                                           int lane) {
  return smem_u32(base + (lane % 8 + 8 * (lane / 16)) * stride +
                  8 * (lane / 8 % 2));
}

// two C fragments (n-tiles 2k, 2k + 1) as the A fragment of k-step k,
// rounded to bf16
__device__ __forceinline__ void pack_a(unsigned (&x)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  x[0] = pack_bf16(c0[0], c0[1]);
  x[1] = pack_bf16(c0[2], c0[3]);
  x[2] = pack_bf16(c1[0], c1[1]);
  x[3] = pack_bf16(c1[2], c1[3]);
}

// (f) dK, dV: one CTA per (batch, head, 16 NW keys), NW warps of 16 keys.
// K and V rows stay in shared memory; the CTA walks the query tiles of BQ
// that can see its keys, Q, dO, lse and Δ through a two-stage cp.async
// ring.  A warp holds Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for QC queries at a time
// (32 at D = 128, so dK, dV, Sᵀ and dPᵀ fit the registers), forms Pᵀ and
// dSᵀ in the fragments and accumulates dV += Pᵀ dO and dK += dSᵀ Q, dO
// and Q read again by ldmatrix.trans from the same tiles.
template <int D>
struct DkvBf16Smem {
  static constexpr int BQ = 64;                        // queries a tile
  static constexpr int STRIDE = D + 8;                 // +16 bytes a row
  static constexpr int KV = MAX_WARPS * 16 * STRIDE;   // K rows; V rows
  static constexpr int TILE = BQ * STRIDE;             // a Q or dO tile
  static constexpr size_t BYTES =
      (2 * KV + 4 * TILE) * sizeof(T16) + 4 * BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    fa_bwd_dkdv_bf16(GradBf16 g) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  const Args& a = g.f;
  using S = DkvBf16Smem<D>;
  constexpr int BQ = S::BQ;
  constexpr int QC = D >= 128 ? 32 : 64;      // queries a warp holds
  constexpr int NQ = QC / 8;                  // query n-tiles of Sᵀ
  constexpr int DT = D / 8;                   // feature n-tiles of dK, dV
  constexpr int KS = D / 16;                  // k-steps of Sᵀ and dPᵀ
  constexpr unsigned ROW = S::STRIDE * sizeof(T16);
  constexpr unsigned TILE_BYTES = S::TILE * sizeof(T16);
  extern __shared__ __align__(16) unsigned char smem[];
  T16* ks = reinterpret_cast<T16*>(smem);
  T16* vs = ks + S::KV;
  T16* qs = vs + S::KV;                       // [2][BQ][STRIDE]
  T16* gs = qs + 2 * S::TILE;                 // [2][BQ][STRIDE]
  float* ls = reinterpret_cast<float*>(gs + 2 * S::TILE);   // [2][BQ] lse
  float* ds = ls + 2 * BQ;                    // [2][BQ] Δ

  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  // the key tiles of one (batch, head) are neighbours in the grid, so they
  // read its Q and dO from L2
  const int n_kt = (a.Skv + nw * 16 - 1) / (nw * 16);
  const int bh = blockIdx.x / n_kt;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int k0 = (blockIdx.x % n_kt) * nw * 16;

  const T16* qp = static_cast<const T16*>(a.q) + b * a.q_sb + h * D;
  const T16* kp = static_cast<const T16*>(a.k) + b * a.k_sb + h * D;
  const T16* vp = static_cast<const T16*>(a.v) + b * a.v_sb + h * D;
  const T16* gp = g.g + b * g.g_sb + h * D;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const float* lp = g.lse + row0;
  const float* dp0 = g.delta + row0;

  const KeyRange cta = query_range(a, k0, min(k0 + nw * 16, a.Skv));
  const int first = cta.lo / BQ * BQ;
  const int n_tiles = cta.hi > first ? (cta.hi - first + BQ - 1) / BQ : 0;

  // this lane's keys w0 + gr and w0 + gr + 8, and whether each is valid
  const int w0 = k0 + warp * 16;
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = w0 + gr + 8 * i;
    kok[i] = key < a.Skv &&
             (a.kv_mask == nullptr ||
              a.kv_mask[static_cast<long long>(b) * a.Skv + key] > 0.f);
  }
  const bool warp_live = __any_sync(FULL, kok[0] || kok[1]);
  const bool all_ok = __all_sync(FULL, kok[0] && kok[1]);
  const KeyRange wr = query_range(a, w0, min(w0 + 16, a.Skv));
  const float sl2 = a.scale * LOG2E;

  const unsigned k_a = a_rows(ks + warp * 16 * S::STRIDE, S::STRIDE, lane);
  const unsigned v_a = a_rows(vs + warp * 16 * S::STRIDE, S::STRIDE, lane);
  const unsigned q_b = b_rows(qs, S::STRIDE, lane);
  const unsigned g_b = b_rows(gs, S::STRIDE, lane);
  const unsigned q_bt = a_rows(qs, S::STRIDE, lane);
  const unsigned g_bt = a_rows(gs, S::STRIDE, lane);

  auto load_tile = [&](int tile, int stage) {
    const int t0 = first + tile * BQ;
    capsim_fa::load_rows<T16, D>(qs + stage * S::TILE, S::STRIDE, qp,
                                 a.q_ss, t0, BQ, a.Sq);
    capsim_fa::load_rows<T16, D>(gs + stage * S::TILE, S::STRIDE, gp,
                                 g.g_ss, t0, BQ, a.Sq);
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      const bool in = t0 + r < a.Sq;
      cp_async4(ls + stage * BQ + r, in ? lp + t0 + r : lp, in);
      cp_async4(ds + stage * BQ + r, in ? dp0 + t0 + r : dp0, in);
    }
  };

  capsim_fa::load_rows<T16, D>(ks, S::STRIDE, kp, a.k_ss, k0, nw * 16,
                               a.Skv);
  capsim_fa::load_rows<T16, D>(vs, S::STRIDE, vp, a.v_ss, k0, nw * 16,
                               a.Skv);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    const int t0 = first + tile * BQ;
    if (!(warp_live && t0 < wr.hi && t0 + BQ > wr.lo)) continue;
    const unsigned st = stage * TILE_BYTES;
    const float* lt = ls + stage * BQ;
    const float* dlt = ds + stage * BQ;

#pragma unroll
    for (int c = 0; c < BQ; c += QC) {
      const int c0 = t0 + c;
      if (c0 >= wr.hi || c0 + QC <= wr.lo) continue;

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: keys gr, gr + 8; queries 8n + 2t (+1)
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned kf[4], vf[4];
        ldsm_x4(kf, k_a + kk * 32);
        ldsm_x4(vf, v_a + kk * 32);
#pragma unroll
        for (int p = 0; p < NQ / 2; ++p) {
          unsigned qb[4], gb[4];
          ldsm_x4(qb, q_b + st + (c + p * 16) * ROW + kk * 32);
          mma_bf16(s[2 * p], kf, qb[0], qb[1]);
          mma_bf16(s[2 * p + 1], kf, qb[2], qb[3]);
          ldsm_x4(gb, g_b + st + (c + p * 16) * ROW + kk * 32);
          mma_bf16(dp[2 * p], vf, gb[0], gb[1]);
          mma_bf16(dp[2 * p + 1], vf, gb[2], gb[3]);
        }
      }

      // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ - Δ) in the fragments; every pair of the
      // chunk is live when the warp's keys are all valid, the chunk is
      // full and the masks cut none of it
      bool whole = all_ok && c0 + QC <= a.Sq;
      if (a.causal)
        whole = whole && w0 + 15 <= c0 + a.q_offset &&
                (a.window <= 0 || w0 > c0 + QC - 1 + a.q_offset - a.window);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 lq =
            *reinterpret_cast<const float2*>(lt + c + 8 * n + 2 * t);
        const float2 dl =
            *reinterpret_cast<const float2*>(dlt + c + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = c0 + 8 * n + 2 * t + (e & 1);
          const bool ok = whole || (kok[e / 2] && q < a.Sq &&
                                    sees(a, q, w0 + gr + 8 * (e / 2)));
          const float l2 = ((e & 1) ? lq.y : lq.x) * LOG2E;
          const float p = ok ? exp2_sfu(fmaf(s[n][e], sl2, -l2)) : 0.f;
          dp[n][e] = p * (dp[n][e] - ((e & 1) ? dl.y : dl.x));
          s[n][e] = p;
        }
      }

      // dV += Pᵀ dO, dK += dSᵀ Q: k-steps of 16 queries
#pragma unroll
      for (int kq = 0; kq < QC / 16; ++kq) {
        unsigned pa[4], da[4];
        pack_a(pa, s[2 * kq], s[2 * kq + 1]);
        pack_a(da, dp[2 * kq], dp[2 * kq + 1]);
        const unsigned off = st + (c + kq * 16) * ROW;
#pragma unroll
        for (int p = 0; p < DT / 2; ++p) {
          unsigned gb[4], qb[4];
          ldsm_x4_trans(gb, g_bt + off + p * 32);
          mma_bf16(dv[2 * p], pa, gb[0], gb[1]);
          mma_bf16(dv[2 * p + 1], pa, gb[2], gb[3]);
          ldsm_x4_trans(qb, q_bt + off + p * 32);
          mma_bf16(dk[2 * p], da, qb[0], qb[1]);
          mma_bf16(dk[2 * p + 1], da, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // every key before Skv is written, a masked one with zeros
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int key = w0 + gr + 8 * row;
    if (key >= a.Skv) continue;
    const long long at =
        ((static_cast<long long>(b) * a.Skv + key) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      *reinterpret_cast<unsigned*>(g.dk + at + 8 * i) = pack_bf16(
          dk[i][2 * row] * a.scale, dk[i][2 * row + 1] * a.scale);
      *reinterpret_cast<unsigned*>(g.dv + at + 8 * i) =
          pack_bf16(dv[i][2 * row], dv[i][2 * row + 1]);
    }
  }
}

// (g) dQ: one CTA per (batch, head, 16 NW queries), the bf16 forward's
// tiling: Q and dO rows in shared memory, K/V tiles of 64 keys and their
// validity words streamed by the forward's KVStream.  A warp holds S and
// dP for its 16 rows x 64 keys, forms dS in the fragments and accumulates
// dQ += dS K, K read again by ldmatrix.trans.
template <int D>
struct DqBf16Smem {
  static constexpr int STRIDE = D + 8;                 // +16 bytes a row
  static constexpr int Q = MAX_WARPS * 16 * STRIDE;    // Q rows; dO rows
  static constexpr int TILE = BK * STRIDE;
  static constexpr size_t BYTES =
      (2 * Q + 4 * TILE) * sizeof(T16) + 2 * BK * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32) fa_bwd_dq_bf16(GradBf16 g) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  const Args& a = g.f;
  using S = DqBf16Smem<D>;
  constexpr int NT = BK / 8;                  // key n-tiles of S and dP
  constexpr int DT = D / 8;                   // feature n-tiles of dQ
  constexpr int KS = D / 16;                  // k-steps of S and dP
  constexpr unsigned ROW = S::STRIDE * sizeof(T16);
  constexpr unsigned TILE_BYTES = S::TILE * sizeof(T16);
  extern __shared__ __align__(16) unsigned char smem[];
  T16* qs = reinterpret_cast<T16*>(smem);
  T16* gs = qs + S::Q;
  T16* ks = gs + S::Q;                        // [2][BK][STRIDE]
  T16* vs = ks + 2 * S::TILE;                 // [2][BK][STRIDE]
  float* ms = reinterpret_cast<float*>(vs + 2 * S::TILE);   // [2][BK]

  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int n_qt = (a.Sq + nw * 16 - 1) / (nw * 16);
  const int bh = blockIdx.x / n_qt;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = (blockIdx.x % n_qt) * nw * 16;
  const int q_end = min(q0 + nw * 16, a.Sq);

  const T16* qp = static_cast<const T16*>(a.q) + b * a.q_sb + h * D;
  const T16* kp = static_cast<const T16*>(a.k) + b * a.k_sb + h * D;
  const T16* vp = static_cast<const T16*>(a.v) + b * a.v_sb + h * D;
  const T16* gp = g.g + b * g.g_sb + h * D;

  const KeyRange cta = capsim_fa::key_range(a, q0, q_end);
  const int first = cta.lo / BK * BK;
  const int n_tiles = cta.hi > first ? (cta.hi - first + BK - 1) / BK : 0;

  // this lane's rows w0 + gr and w0 + gr + 8
  const int w0 = q0 + warp * 16;
  const bool warp_live = w0 < a.Sq;
  const KeyRange wr = capsim_fa::key_range(a, w0, min(w0 + 16, a.Sq));
  int kmin[2], kmax[2];
  float l2[2], dl[2];
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = w0 + gr + 8 * i;
    capsim_fa::row_limits(a, qi, kmin[i], kmax[i]);
    const bool in = qi < a.Sq;
    l2[i] = in ? g.lse[row0 + qi] * LOG2E : __int_as_float(0x7f800000);
    dl[i] = in ? g.delta[row0 + qi] : 0.f;
  }
  const float sl2 = a.scale * LOG2E;

  const unsigned q_a = a_rows(qs + warp * 16 * S::STRIDE, S::STRIDE, lane);
  const unsigned g_a = a_rows(gs + warp * 16 * S::STRIDE, S::STRIDE, lane);
  const unsigned k_b = b_rows(ks, S::STRIDE, lane);
  const unsigned v_b = b_rows(vs, S::STRIDE, lane);
  const unsigned k_bt = a_rows(ks, S::STRIDE, lane);

  KVStream<T16, D, S::STRIDE> kv(a, kp, vp, b, first);
  auto load_tile = [&](int tile, int stage) {
    kv.load(a, first + tile * BK, ks + stage * S::TILE, vs + stage * S::TILE,
            ms + stage * BK);
  };

  capsim_fa::load_rows<T16, D>(qs, S::STRIDE, qp + (long long)q0 * a.q_ss,
                               a.q_ss, 0, nw * 16, a.Sq - q0);
  capsim_fa::load_rows<T16, D>(gs, S::STRIDE, gp + (long long)q0 * g.g_ss,
                               g.g_ss, 0, nw * 16, a.Sq - q0);
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    const int k0 = first + tile * BK;
    if (!(warp_live && k0 < wr.hi && k0 + BK > wr.lo)) continue;
    const unsigned st = stage * TILE_BYTES;
    const float* mt = ms + stage * BK;

    // S = Q Kᵀ and dP = dO Vᵀ: rows gr, gr + 8; keys 8n + 2t (+1)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned qf[4], gf[4];
      ldsm_x4(qf, q_a + kk * 32);
      ldsm_x4(gf, g_a + kk * 32);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        unsigned kb[4], vb[4];
        ldsm_x4(kb, k_b + st + p * 16 * ROW + kk * 32);
        mma_bf16(s[2 * p], qf, kb[0], kb[1]);
        mma_bf16(s[2 * p + 1], qf, kb[2], kb[3]);
        ldsm_x4(vb, v_b + st + p * 16 * ROW + kk * 32);
        mma_bf16(dp[2 * p], gf, vb[0], vb[1]);
        mma_bf16(dp[2 * p + 1], gf, vb[2], vb[3]);
      }
    }

    // dS = P ∘ (dP - Δ), P from the forward's lse
    unsigned lo, hi;
    capsim_fa::tile_bits<false>(a, mt, k0, lane, lo, hi);
    const bool whole = capsim_fa::tile_whole(a, lo, hi, k0, kmin, kmax);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e / 2;
        const int key = n * 8 + 2 * t + (e & 1);
        const bool ok = whole ||
                        ((((n < 4 ? lo : hi) >> (key % 32)) & 1u) &&
                         k0 + key >= kmin[row] && k0 + key <= kmax[row]);
        const float p = ok ? exp2_sfu(fmaf(s[n][e], sl2, -l2[row])) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[row]);
      }

    // dQ += dS K: k-steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned da[4];
      pack_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int p = 0; p < DT / 2; ++p) {
        unsigned kb[4];
        ldsm_x4_trans(kb, k_bt + st + kk * 16 * ROW + p * 32);
        mma_bf16(dq[2 * p], da, kb[0], kb[1]);
        mma_bf16(dq[2 * p + 1], da, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int qi = w0 + gr + 8 * row;
    if (qi >= a.Sq) continue;
    T16* out =
        g.dq + ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<unsigned*>(out + 8 * i) =
          pack_bf16(dq[i][2 * row] * a.scale, dq[i][2 * row + 1] * a.scale);
  }
}

// ----------------------------------------------------------------------
// Launch
// ----------------------------------------------------------------------

// `kernel` on `ctas` CTAs of `threads`; a kernel that asks for more than
// 48 KB of dynamic shared memory gets the attribute once per device.
template <typename Kernel, typename G>
int launch_kernel(Kernel kernel, long long ctas, int threads, size_t smem,
                  unsigned long long& ready, const G& g,
                  cudaStream_t stream) {
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
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
  kernel<<<static_cast<unsigned>(ctas), threads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Grad& g, cudaStream_t stream) {
  static unsigned long long ready_dkdv = 0, ready_dq = 0, ready_delta = 0,
                            ready_small = 0;
  const Args& a = g.f;
  const long long bh = static_cast<long long>(a.B) * a.H;
  if (a.Sq <= SMALL && a.Skv <= SMALL)
    return launch_kernel(fa_bwd_small_f32<D>,
                         (bh + SMALL_WARPS - 1) / SMALL_WARPS,
                         SMALL_WARPS * 32, SmallSmem<D>::BYTES, ready_small,
                         g, stream);
  const long long delta_threads = bh * a.Sq * (D / 4);
  int rc = launch_kernel(fa_bwd_delta_f32<D>,
                         (delta_threads + DELTA_THREADS - 1) / DELTA_THREADS,
                         DELTA_THREADS, 0, ready_delta, g, stream);
  if (rc != 0) return rc;
  const int nk = capsim_fa::warps_for(a.Skv);
  rc = launch_kernel(fa_bwd_dkdv_f32<D>,
                     bh * ((a.Skv + nk * 16 - 1) / (nk * 16)), nk * 32,
                     DkvSmem<D>::BYTES, ready_dkdv, g, stream);
  if (rc != 0) return rc;
  const int nq = capsim_fa::warps_for(a.Sq);
  return launch_kernel(fa_bwd_dq_f32<D>,
                       bh * ((a.Sq + nq * 16 - 1) / (nq * 16)), nq * 32,
                       DqSmem<D>::BYTES, ready_dq, g, stream);
}

template <int D>
int launch_d_bf16(const GradBf16& g, cudaStream_t stream) {
  static unsigned long long ready_dkdv = 0, ready_dq = 0, ready_delta = 0;
  const Args& a = g.f;
  const long long bh = static_cast<long long>(a.B) * a.H;
  const long long delta_threads = bh * a.Sq * (D / 8);
  int rc = launch_kernel(fa_bwd_delta_bf16<D>,
                         (delta_threads + DELTA_THREADS - 1) / DELTA_THREADS,
                         DELTA_THREADS, 0, ready_delta, g, stream);
  if (rc != 0) return rc;
  const int nk = capsim_fa::warps_for(a.Skv);
  rc = launch_kernel(fa_bwd_dkdv_bf16<D>,
                     bh * ((a.Skv + nk * 16 - 1) / (nk * 16)), nk * 32,
                     DkvBf16Smem<D>::BYTES, ready_dkdv, g, stream);
  if (rc != 0) return rc;
  const int nq = capsim_fa::warps_for(a.Sq);
  return launch_kernel(fa_bwd_dq_bf16<D>,
                       bh * ((a.Sq + nq * 16 - 1) / (nq * 16)), nq * 32,
                       DqBf16Smem<D>::BYTES, ready_dq, g, stream);
}

}  // namespace capsim_fa_bwd

// dtype: 0 = float32, 1 = bfloat16, the type of q, k, v, O, dO, dq, dk
// and dv (kv_mask, lse and delta are f32).  Returns 0, a cudaError_t, -1 for a
// (dtype, head_dim) pair the kernels are not built for, or -2 for
// q/k/v/O/dO that are not 16-byte aligned.  dq, dk and dv are contiguous
// (B, S, H, D); lse and delta (B, H, Sq).
extern "C" int capsim_flash_attention_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* o, const void* g, const float* kv_mask, const float* lse,
    float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
    int H, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    long long g_sb, long long g_ss, int causal, int window, float scale,
    void* stream) {
  using capsim_fa::aligned16;
  if (dtype != 0 && dtype != 1) return -1;
  if (B == 0 || H == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  if (!aligned16(q, q_sb, q_ss, B, Sq, elem) ||
      !aligned16(k, k_sb, k_ss, B, Skv, elem) ||
      !aligned16(v, v_sb, v_ss, B, Skv, elem) ||
      !aligned16(o, o_sb, o_ss, B, Sq, elem) ||
      !aligned16(g, g_sb, g_ss, B, Sq, elem))
    return -2;
  const capsim_fa::Args args{q,      k,      v,        kv_mask,
                             const_cast<void*>(o),
                             B,      Sq,     Skv,      H,
                             q_sb,   q_ss,   k_sb,     k_ss,
                             v_sb,   v_ss,   o_sb,     o_ss,
                             causal, window, Skv - Sq, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const capsim_fa_bwd::Grad gr{
        args, static_cast<const float*>(g), lse, delta,
        static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), g_sb, g_ss};
    switch (head_dim) {
      case 16: return capsim_fa_bwd::launch_d<16>(gr, s);
      case 32: return capsim_fa_bwd::launch_d<32>(gr, s);
      case 64: return capsim_fa_bwd::launch_d<64>(gr, s);
      case 128: return capsim_fa_bwd::launch_d<128>(gr, s);
      default: return -1;
    }
  }
  using T16 = __nv_bfloat16;
  const capsim_fa_bwd::GradBf16 gr{
      args, static_cast<const T16*>(g), lse, delta,
      static_cast<T16*>(dq), static_cast<T16*>(dk), static_cast<T16*>(dv),
      g_sb, g_ss};
  switch (head_dim) {
    case 16: return capsim_fa_bwd::launch_d_bf16<16>(gr, s);
    case 32: return capsim_fa_bwd::launch_d_bf16<32>(gr, s);
    case 64: return capsim_fa_bwd::launch_d_bf16<64>(gr, s);
    case 128: return capsim_fa_bwd::launch_d_bf16<128>(gr, s);
    default: return -1;
  }
}

extern "C" const char* capsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
