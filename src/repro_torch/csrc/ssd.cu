// Mamba2 SSD chunked scan for Hopper (sm_90a), the CUDA replacement of
// the TPU kernel repro/kernels/ssd/kernel.py::_ssd_kernel (reached
// through ssd_scan_grid).  Loaded from Python with ctypes
// (repro_torch/kernels/ssd/ops.py).
//
// What it computes, per (batch row b, head h) and chunk of q steps, with
// seg = cumsum(dt * A) over the chunk (A < 0, so seg falls):
//
//   y_i    = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//            + exp(seg_i) (C_i . state)
//   state <- state exp(seg_last) + sum_j dt_j exp(seg_last - seg_j) x_j (x) B_j
//
// x (Bt, S, H, P) and y in float32 or bfloat16, dt (Bt, S, H) and A (H,)
// float32, B/C (Bt, S, N) in x's type and shared by every head, state
// (Bt, H, P, N) float32, zero before the first chunk.  seg is accumulated
// in f64: over a 256-step chunk it reaches -1e4 at large dt*|A|, where
// f32 keeps only ~1e-3 of seg_i - seg_j.  The decay is always one exp of
// a difference, never exp(seg_i) / exp(seg_j), which is 0/0 there.  S need
// not be a multiple of q: the last chunk stops at S, which is what the
// Pallas wrapper's padding with dt = 0 computes (a padded step neither
// decays nor injects), without copying anything.
//
// What bounds it on the card.  At the Mamba2-780m prefill shape (Bt=4,
// S=4096, H=48, P=64, N=128, q=256, 16 chunks) the function needs 39.24
// GFLOP: C.B^T once per (batch row, chunk) over the causal half, 0.54
// GFLOP, and per head the causal (C.B^T o L) (x dt), C . state and the
// state update, 38.71 GFLOP.  It moves 219 MB in bf16 (x read, y
// written, B/C/dt read, the f32 state written): 0.065 ms of HBM traffic
// against 0.040 ms of tensor-core work at 989 TFLOP/s, so bytes bound it;
// in f32 on the FMA pipes (67 TFLOP/s) the work takes 0.586 ms.
//
// What the design does about it: Mamba2's own GPU algorithm, as four
// launches on the caller's stream, every one of them parallel over chunks.
//
//   (a) ssd_cb          per (b, chunk, lower 64 x 64 tile): C . B^T,
//                       once for all heads, into an f32 workspace
//                       (Bt, nc, QP, QP).
//   (b) ssd_chunk_state per (b, h, chunk, P tile, N tile): seg, and the
//                       chunk's own state contribution, transposed,
//                       sum_j B_j (x) (w_j x_j), w_j = dt_j exp(seg_last -
//                       seg_j), into an f32 workspace (Bt, H, nc, N, P),
//                       with exp(seg_last) per chunk.
//   (c) ssd_state_pass  per (b, h, 4 state elements): the short
//                       sequential pass over the chunks, state <- state
//                       exp(seg_last) + contribution in f32, which writes
//                       each chunk's incoming state over its contribution
//                       and the final state to the output.
//   (d) ssd_chunk_out   per (b, h, chunk, P tile): y = exp(seg_i) (C_i .
//                       state_in) + sum_{j<=i} (CB_ij exp(seg_i - seg_j)
//                       dt_j) x_j, by 64-row sub-tiles of the chunk over
//                       its causal 64-key tiles; dt is folded into the
//                       decayed C.B^T tile, so x is used as it is stored.
//
// At the path shape that is 3072 independent (b, h, chunk) tasks in (b)
// and (d) (the old one-kernel design had 384 CTAs walking 16 chunks in
// series), and C.B^T is formed 64 times a call instead of once per head
// and column tile.  The price is the workspace: the per-chunk states are
// written by (b), read and rewritten by (c) and read by (d), 4 x 101 MB
// of f32 at the path shape, ~0.12 ms at HBM rate beside the 0.065 ms
// bound (the C.B^T workspace, 17 MB, stays in L2).
//
// x, B and C tiles reach shared memory by cp.async, 16 bytes a copy with
// zero fill past S, N or the chunk (a plain copy where a source is not
// 16-byte aligned); the C.B^T tile goes to registers, is decayed there
// (one SFU ex2 of the f64 difference of seg in log2 units) and is stored
// as the A operand.  Every product is a warp tile of 16 rows x W columns
// over operands in shared memory with 16-byte padded rows (Warp::gemm),
// either operand stored k-major or transposed:
//
//   bf16: mma.sync.m16n8k16 bf16 with f32 accumulation, fragments by
//   ldmatrix (.trans where the layout asks).  x, B and C enter the
//   products as given; the operands formed in f32 (CB exp(..) dt, w x)
//   and the f32 incoming state are rounded to bf16 where they are staged,
//   which is this kernel's precision choice (its error at the prefill
//   shape: PERF.md).  Sums, seg, decays and the state pass stay in f32
//   (seg in f64).
//
//   f32: the same tiles on the FMA pipes in full f32 (no mma of any
//   precision, no TF32): each thread owns 4 rows x W/8 columns, so per 4
//   steps of k four 16-byte A loads and W/8 16-byte B loads feed 2 W
//   FMAs.
//
// Where the time goes (PERF.md, an H100 at 700 W): in f32, (d)'s and (b)'s
// FMA products, at about two thirds of the FMA peak; in bf16, (d)'s
// per-head decay of the C.B^T tiles and the staging around its products,
// not the HMMAs.  Two stages of the x tile with the next C.B^T tile
// prefetched into registers ran slower (fewer CTAs an SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "ptx.cuh"

namespace capsim_ssd {

using namespace capsim;

constexpr int TILE = 64;          // steps of a chunk sub-tile
constexpr int MAX_STATE = 256;    // largest d_state
constexpr int MAX_CHUNK = 1024;   // largest q
constexpr int PASS_THREADS = 256;

struct Args {
  const void* x;
  const float* dt;
  const void* B;
  const void* C;
  const float* A;
  void* y;
  float* state;
  int Bt, S, H, P, N, q;
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss;
  // derived on the host
  int nc;        // chunks
  int QP;        // q rounded up to TILE
  int NP;        // N rounded up to 16 (zero-filled columns)
  int vec;       // x, B and C rows start on 16 bytes: copy by cp.async
  float* cb;     // (Bt, nc, QP, QP) C.B^T, lower tiles only
  float* chunk;  // (Bt, H, nc, N, P) contribution, then incoming state
  float* decay;  // (Bt, H, nc) exp(seg_last)
};

// shared-memory row stride of an operand with `cols` columns: +16 bytes
template <typename T>
__host__ __device__ constexpr int pad(int cols) {
  return cols + 16 / static_cast<int>(sizeof(T));
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// ----------------------------------------------------------------------
// Copies into shared memory
// ----------------------------------------------------------------------

// dst[r][c] = src[r * ss + c] for r < rows, c < cols (cols * sizeof(T) a
// multiple of 16), zero where r >= row_lim or c >= col_lim.  vec: by
// cp.async (src rows on 16 bytes, col_lim a multiple of 16 bytes; the
// caller commits and waits), else by plain loads.  `base` is any valid
// address of the source tensor (a zero-filling copy reads nothing).
template <typename T>
__device__ void copy_tile(T* dst, int ds, const T* src, long long ss,
                          int rows, int cols, int row_lim, int col_lim,
                          bool vec, const void* base) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = cols / V;
    for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
      const int r = e / cpr, c = e % cpr * V;
      const bool in = r < row_lim && c < col_lim;
      cp_async16(dst + r * ds + c, in ? src + r * ss + c : base, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e % cols;
      dst[r * ds + c] = r < row_lim && c < col_lim ? src[r * ss + c]
                                                   : from_f32<T>(0.f);
    }
  }
}

__device__ __forceinline__ void copy_wait() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// ----------------------------------------------------------------------
// The warp tile: acc (16 x W) += A (16 x k_len) B (k_len x W) over
// shared memory, k_len % 16 == 0.  A is stored [m][k] (stride as), or
// [k][m] when AT; B is stored [k][n] (stride bs), or [n][k] when BT.
// acc[n][e] is at (row, col) = rc(lane, n, e).
// ----------------------------------------------------------------------

template <typename T, int W, bool AT, bool BT>
struct Warp;

template <int W, bool AT, bool BT>
struct Warp<__nv_bfloat16, W, AT, BT> {
  using T = __nv_bfloat16;
  __device__ static void rc(int lane, int n, int e, int& r, int& c) {
    r = lane / 4 + 8 * (e / 2);
    c = 8 * n + 2 * (lane % 4) + (e & 1);
  }
  __device__ static void gemm(float (&acc)[W / 8][4], const T* A, int as,
                              const T* B, int bs, int k_len) {
    const int lane = threadIdx.x % 32;
    // ldmatrix rows: the non-transposed A / transposed B pattern reads
    // (row lane%8 + 8 (lane/8%2), column 8 (lane/16)); the other reads
    // (row lane%8 + 8 (lane/16), column 8 (lane/8%2))
    const int r1 = lane % 8 + 8 * (lane / 8 % 2), c1 = 8 * (lane / 16);
    const int r2 = lane % 8 + 8 * (lane / 16), c2 = 8 * (lane / 8 % 2);
    const unsigned a_addr =
        AT ? smem_u32(A + r2 * as + c2) : smem_u32(A + r1 * as + c1);
    const unsigned b_addr =
        BT ? smem_u32(B + r2 * bs + c2) : smem_u32(B + r1 * bs + c1);
    for (int k = 0; k < k_len; k += 16) {
      unsigned af[4];
      if constexpr (AT) ldsm_x4_trans(af, a_addr + k * as * sizeof(T));
      else ldsm_x4(af, a_addr + k * sizeof(T));
#pragma unroll
      for (int p = 0; p < W / 16; ++p) {
        unsigned bf[4];
        if constexpr (BT) ldsm_x4(bf, b_addr + (p * 16 * bs + k) * sizeof(T));
        else ldsm_x4_trans(bf, b_addr + (k * bs + p * 16) * sizeof(T));
        mma_bf16(acc[2 * p], af, bf[0], bf[1]);
        mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
  }
  // out[r][c] = acc (O: bf16 or float) for the tile's rows r < rows, two
  // columns a store
  template <typename O>
  __device__ static void store(const float (&acc)[W / 8][4], O* out,
                               long long rs, int rows) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane / 4 + 8 * h;
        if (r >= rows) continue;
        O* o = out + r * rs + 8 * n + 2 * (lane % 4);
        if constexpr (sizeof(O) == 4)
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
        else
          *reinterpret_cast<unsigned*>(o) =
              pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
      }
  }
};

template <int W, bool AT, bool BT>
struct Warp<float, W, AT, BT> {
  static constexpr int VEC = W >= 32 ? 4 : 2;   // B columns a load (!BT)
  static constexpr int NC = W / 8 / VEC;
  // rows lane/8 + 4e (4 (lane/8) + e when AT); columns 8 apart by lane%8
  // when BT, else VEC-wide runs
  __device__ static void rc(int lane, int n, int e, int& r, int& c) {
    r = AT ? 4 * (lane / 8) + e : lane / 8 + 4 * e;
    c = BT ? lane % 8 + 8 * n : VEC * (lane % 8) + n % VEC + 8 * VEC * (n / VEC);
  }
  __device__ static void gemm(float (&acc)[W / 8][4], const float* A,
                              int as, const float* B, int bs, int k_len) {
    const int lane = threadIdx.x % 32;
    const int qy = lane / 8, kx = lane % 8;
#pragma unroll 2
    for (int k = 0; k < k_len; k += 4) {
      float a[4][4];                            // a[row e][k + kk]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = AT ? *reinterpret_cast<const float4*>(
                                  A + (k + i) * as + 4 * qy)
                            : *reinterpret_cast<const float4*>(
                                  A + (qy + 4 * i) * as + k);
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (AT) a[j][i] = f[j];
          else a[i][j] = f[j];
        }
      }
      float b[W / 8][4];                        // b[column n][k + kk]
      if constexpr (BT) {
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          const float4 v =
              *reinterpret_cast<const float4*>(B + (kx + 8 * n) * bs + k);
          b[n][0] = v.x; b[n][1] = v.y; b[n][2] = v.z; b[n][3] = v.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* brow = B + (k + kk) * bs + VEC * kx;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if constexpr (VEC == 4) {
              const float4 v =
                  *reinterpret_cast<const float4*>(brow + 32 * c);
              b[4 * c][kk] = v.x; b[4 * c + 1][kk] = v.y;
              b[4 * c + 2][kk] = v.z; b[4 * c + 3][kk] = v.w;
            } else {
              const float2 v =
                  *reinterpret_cast<const float2*>(brow + 16 * c);
              b[2 * c][kk] = v.x; b[2 * c + 1][kk] = v.y;
            }
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < W / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = fmaf(a[e][kk], b[n][kk], acc[n][e]);
    }
  }
  // out[r][c] = acc for the tile's rows r < rows, VEC columns a store
  // (B not transposed)
  __device__ static void store(const float (&acc)[W / 8][4], float* out,
                               long long rs, int rows) {
    static_assert(!BT, "stores rows of VEC-wide column runs");
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = AT ? 4 * (lane / 8) + i : lane / 8 + 4 * i;
      if (r >= rows) continue;
      float* o = out + r * rs + VEC * (lane % 8);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if constexpr (VEC == 4)
          *reinterpret_cast<float4*>(o + 32 * c) =
              make_float4(acc[4 * c][i], acc[4 * c + 1][i],
                          acc[4 * c + 2][i], acc[4 * c + 3][i]);
        else
          *reinterpret_cast<float2*>(o + 16 * c) =
              make_float2(acc[2 * c][i], acc[2 * c + 1][i]);
      }
    }
  }
};

template <int W>
__device__ __forceinline__ void zero(float (&acc)[W / 8][4]) {
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// ----------------------------------------------------------------------
// seg of one (b, h, chunk)
// ----------------------------------------------------------------------

// seg[i] = sum_{t<=i} dt[t] * A in f64, for i < n, by the first warp:
// each lane sums a run of ceil(n/32) steps, a shuffle scan offsets them.
__device__ void chunk_cumsum(const float* dts, float A, double* seg, int n) {
  const int lane = threadIdx.x;
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n);
  const int hi = min(lo + per, n);
  double run = 0.0;
  for (int i = lo; i < hi; ++i) run += (double)__fmul_rn(dts[i], A);
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  double acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.0;
  for (int i = lo; i < hi; ++i) {
    acc += (double)__fmul_rn(dts[i], A);
    seg[i] = acc;
  }
}

// dts[i] = dt of step t0 + i (0 at or past qlen) and seg over QP steps.
__device__ void chunk_seg(const Args& a, int b, int h, int t0, int qlen,
                          float* dts, double* seg) {
  const float* dtg = a.dt + b * a.dt_sb + h;
  for (int i = threadIdx.x; i < a.QP; i += blockDim.x)
    dts[i] = i < qlen ? dtg[(t0 + i) * a.dt_ss] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, a.A[h], seg, a.QP);
  __syncthreads();
}

// ----------------------------------------------------------------------
// (a) C.B^T per (b, chunk, lower tile)
// ----------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(128) ssd_cb(Args a) {
  const int b = blockIdx.x / a.nc;
  const int c = blockIdx.x % a.nc;
  const int t0 = c * a.q;
  const int qlen = min(a.q, a.S - t0);
  int it = 0, jt = blockIdx.y;                 // lower tile (it, jt <= it)
  while (jt > it) jt -= ++it;
  if (it * TILE >= qlen) return;
  const int NP = a.NP, cs = pad<T>(NP);
  extern __shared__ __align__(16) unsigned char smem[];
  T* Cs = reinterpret_cast<T*>(smem);          // [64][NP] C rows i
  T* Bs = Cs + TILE * cs;                      // [64][NP] B rows j
  const int i0 = it * TILE, j0 = jt * TILE;
  const T* cg = static_cast<const T*>(a.C) + b * a.c_sb + t0 * a.c_ss;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb + t0 * a.b_ss;
  copy_tile(Cs, cs, cg + i0 * a.c_ss, a.c_ss, TILE, NP, qlen - i0, a.N,
            a.vec, a.C);
  copy_tile(Bs, cs, bg + j0 * a.b_ss, a.b_ss, TILE, NP, qlen - j0, a.N,
            a.vec, a.B);
  copy_wait();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  using G = Warp<T, TILE, false, true>;
  float acc[TILE / 8][4];
  zero<TILE>(acc);
  G::gemm(acc, Cs + warp * 16 * cs, cs, Bs, cs, NP);
  float* out = a.cb + ((long long)blockIdx.x * a.QP + i0 + warp * 16) * a.QP
               + j0;
#pragma unroll
  for (int n = 0; n < TILE / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r, col;
      G::rc(lane, n, e, r, col);
      out[r * a.QP + col] = acc[n][e];
    }
}

// ----------------------------------------------------------------------
// (b) a chunk's own state contribution, transposed, per (b, h, chunk,
// PT columns of P, NT rows of N); NT / 16 warps
// ----------------------------------------------------------------------

template <typename T, int PT>
__global__ void __launch_bounds__(256) ssd_chunk_state(Args a, int NT) {
  const int n_nt = a.NP / NT, n_pt = a.P / PT;
  const int nt = blockIdx.x % n_nt;
  const int pt = blockIdx.x / n_nt % n_pt;
  const int bhc = blockIdx.x / n_nt / n_pt;
  const int c = bhc % a.nc;
  const int h = bhc / a.nc % a.H;
  const int b = bhc / a.nc / a.H;
  const int t0 = c * a.q;
  const int qlen = min(a.q, a.S - t0);
  const int p0 = pt * PT, n0 = nt * NT;
  const int bs = pad<T>(NT);
  constexpr int XS = pad<T>(PT);
  extern __shared__ __align__(16) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);                  // [64][PT] w x
  T* Bs = Xs + TILE * XS;                              // [64][NT]
  double* seg = reinterpret_cast<double*>(
      smem + align16(sizeof(T) * TILE * (XS + bs)));
  float* dts = reinterpret_cast<float*>(seg + a.QP);
  float* wts = dts + a.QP;

  chunk_seg(a, b, h, t0, qlen, dts, seg);
  const double seg_last = seg[qlen - 1];
  for (int i = threadIdx.x; i < a.QP; i += blockDim.x)
    wts[i] = dts[i] * expf((float)(seg_last - seg[i]));   // 0 past qlen
  if (pt == 0 && nt == 0 && threadIdx.x == 0)
    a.decay[bhc] = expf((float)seg_last);

  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + t0 * a.x_ss +
                h * a.P + p0;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb + t0 * a.b_ss + n0;
  const int warp = threadIdx.x / 32;
  using G = Warp<T, PT, true, false>;
  float acc[PT / 8][4];
  zero<PT>(acc);
  for (int j0 = 0; j0 < qlen; j0 += TILE) {
    __syncthreads();               // the last tile is consumed
    copy_tile(Xs, XS, xg + j0 * a.x_ss, a.x_ss, TILE, PT, qlen - j0, PT,
              a.vec, a.x);
    copy_tile(Bs, bs, bg + j0 * a.b_ss, a.b_ss, TILE, NT, qlen - j0,
              a.N - n0, a.vec, a.B);
    copy_wait();
    // x_j <- w_j x_j in place, 16 bytes a thread and step
    constexpr int V = 16 / sizeof(T), CPR = PT / V;
    for (int e = threadIdx.x; e < TILE * CPR; e += blockDim.x) {
      const int r = e / CPR;
      T* v = Xs + r * XS + e % CPR * V;
      const float w = wts[j0 + r];
      if constexpr (sizeof(T) == 4) {
        float4 f = *reinterpret_cast<float4*>(v);
        *reinterpret_cast<float4*>(v) =
            make_float4(f.x * w, f.y * w, f.z * w, f.w * w);
      } else {
        uint4 u = *reinterpret_cast<uint4*>(v);
        unsigned* p = reinterpret_cast<unsigned*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p + k));
          p[k] = pack_bf16(f.x * w, f.y * w);
        }
        *reinterpret_cast<uint4*>(v) = u;
      }
    }
    __syncthreads();
    G::gemm(acc, Bs + warp * 16, bs, Xs, XS, TILE);
  }
  G::store(acc, a.chunk + (long long)bhc * a.P * a.N +
                    (long long)(n0 + warp * 16) * a.P + p0,
           a.P, a.N - n0 - warp * 16);
}

// ----------------------------------------------------------------------
// (c) the pass over chunks, 4 state elements a thread
// ----------------------------------------------------------------------

__global__ void __launch_bounds__(PASS_THREADS) ssd_state_pass(Args a) {
  constexpr int AHEAD = 4;         // chunks whose loads are in flight
  const long long pn = (long long)a.P * a.N;
  const long long e = 4 * ((long long)blockIdx.y * PASS_THREADS +
                           threadIdx.x);
  if (e >= pn) return;
  const int bh = blockIdx.x;
  float* u = a.chunk + (long long)bh * a.nc * pn + e;   // [n][p] layout
  const float* d = a.decay + (long long)bh * a.nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.nc; c0 += AHEAD) {
    float4 v[AHEAD];
    float g[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k < a.nc) {
        v[k] = *reinterpret_cast<const float4*>(u + (c0 + k) * pn);
        g[k] = d[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k < a.nc) {
        // the chunk's incoming state over its contribution
        *reinterpret_cast<float4*>(u + (c0 + k) * pn) = s;
        s = make_float4(s.x * g[k] + v[k].x, s.y * g[k] + v[k].y,
                        s.z * g[k] + v[k].z, s.w * g[k] + v[k].w);
      }
    }
  }
  const int n = static_cast<int>(e / a.P), p = static_cast<int>(e % a.P);
  float* so = a.state + bh * pn + (long long)p * a.N + n;   // [p][n]
  so[0] = s.x;
  so[a.N] = s.y;
  so[2 * a.N] = s.z;
  so[3 * a.N] = s.w;
}

// ----------------------------------------------------------------------
// (d) y per (b, h, chunk, PT columns of P)
// ----------------------------------------------------------------------

template <typename T, int PT>
struct OutSmem {
  static constexpr int SS = pad<T>(PT), XS = pad<T>(PT), MS = pad<T>(TILE);
  __host__ __device__ static int cs(int NP) { return pad<T>(NP); }
  // state_in^T [NP][PT], C [64][NP], CB exp(..) dt [64][64] and x
  // [64][PT], all in T; then seg (f64, then seg log2(e)), dt, exp(seg)
  __host__ __device__ static size_t tiles(int NP) {
    return align16(sizeof(T) * ((size_t)NP * SS + TILE * (cs(NP) + MS + XS)));
  }
  __host__ __device__ static size_t bytes(int NP, int QP) {
    return tiles(NP) + (size_t)QP * (sizeof(double) + 2 * sizeof(float));
  }
};

template <typename T, int PT>
__global__ void __launch_bounds__(128) ssd_chunk_out(Args a) {
  using S = OutSmem<T, PT>;
  using G = Warp<T, PT, false, false>;
  constexpr double LOG2E = 1.4426950408889634;
  const int bhc = blockIdx.x;
  const int c = bhc % a.nc;
  const int h = bhc / a.nc % a.H;
  const int b = bhc / a.nc / a.H;
  const int t0 = c * a.q;
  const int qlen = min(a.q, a.S - t0);
  const int p0 = blockIdx.y * PT;
  const int NP = a.NP, cs = S::cs(NP);
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ss = reinterpret_cast<T*>(smem);          // [NP][PT] state_in^T
  T* Cs = Ss + NP * S::SS;                     // [64][NP]
  T* Ms = Cs + TILE * cs;                      // [64][64] CB exp(..) dt
  T* Xs = Ms + TILE * S::MS;                   // [64][PT] x
  double* seg = reinterpret_cast<double*>(smem + S::tiles(NP));
  float* dts = reinterpret_cast<float*>(seg + a.QP);
  float* es = dts + a.QP;

  // the incoming state, (N, P) f32 in the workspace: a copy in f32, a
  // conversion in bf16
  const float* sg = a.chunk + (long long)bhc * a.P * a.N + p0;
  if constexpr (sizeof(T) == 4) {
    copy_tile(reinterpret_cast<float*>(Ss), S::SS, sg, a.P, NP, PT, a.N,
              PT, true, a.chunk);
  } else {
    for (int e = threadIdx.x; e < NP * PT / 4; e += blockDim.x) {
      const int n = e / (PT / 4), p = e % (PT / 4) * 4;
      const float4 v = n < a.N
          ? *reinterpret_cast<const float4*>(sg + (long long)n * a.P + p)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      unsigned* d = reinterpret_cast<unsigned*>(Ss + n * S::SS + p);
      d[0] = pack_bf16(v.x, v.y);
      d[1] = pack_bf16(v.z, v.w);
    }
  }
  chunk_seg(a, b, h, t0, qlen, dts, seg);        // syncs
  for (int i = threadIdx.x; i < a.QP; i += blockDim.x) {
    es[i] = expf((float)seg[i]);
    seg[i] *= LOG2E;               // from here on, seg in log2 units
  }

  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + t0 * a.x_ss +
                h * a.P + p0;
  const T* cg = static_cast<const T*>(a.C) + b * a.c_sb + t0 * a.c_ss;
  const float* cbg = a.cb + (long long)(b * a.nc + c) * a.QP * a.QP;
  T* yg = static_cast<T*>(a.y) + b * a.y_sb + t0 * a.y_ss + h * a.P + p0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this thread's part of the decayed C.B^T tile: rows tid/16 + 8k,
  // columns jc .. jc + 3
  const int r0 = threadIdx.x / 16, jc = threadIdx.x % 16 * 4;

  for (int i0 = 0; i0 < qlen; i0 += TILE) {
    float acc[PT / 8][4];
    for (int j0 = 0; j0 <= i0; j0 += TILE) {
      // C.B^T rows of this pair, straight to registers (8 loads in
      // flight a thread)
      float4 g[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        g[k] = *reinterpret_cast<const float4*>(
            cbg + (long long)(i0 + r0 + 8 * k) * a.QP + j0 + jc);
      __syncthreads();             // the last tiles are consumed
      if (j0 == 0)
        copy_tile(Cs, cs, cg + i0 * a.c_ss, a.c_ss, TILE, NP, qlen - i0,
                  a.N, a.vec, a.C);
      copy_tile(Xs, S::XS, xg + j0 * a.x_ss, a.x_ss, TILE, PT, qlen - j0,
                PT, a.vec, a.x);
      cp_async_commit();
      // CB_ij exp(seg_i - seg_j) dt_j for j <= i < qlen, else 0: one
      // ex2 of the f64 difference in log2 units
      double sj[4];
      float dj[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sj[u] = seg[j0 + jc + u];
        dj[u] = dts[j0 + jc + u];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int gi = i0 + r0 + 8 * k;
        const double si = seg[gi];
        const float gv[4] = {g[k].x, g[k].y, g[k].z, g[k].w};
        float m[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          m[u] = j0 + jc + u <= gi && gi < qlen
                     ? gv[u] * exp2_sfu((float)(si - sj[u])) * dj[u]
                     : 0.f;
        T* dst = Ms + (r0 + 8 * k) * S::MS + jc;
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(m[0], m[1], m[2], m[3]);
        } else {
          reinterpret_cast<unsigned*>(dst)[0] = pack_bf16(m[0], m[1]);
          reinterpret_cast<unsigned*>(dst)[1] = pack_bf16(m[2], m[3]);
        }
      }
      cp_async_wait<0>();
      __syncthreads();
      if (j0 == 0) {               // exp(seg_i) (C_i . state_in)
        zero<PT>(acc);
        G::gemm(acc, Cs + warp * 16 * cs, cs, Ss, S::SS, NP);
#pragma unroll
        for (int n = 0; n < PT / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int r, col;
            G::rc(lane, n, e, r, col);
            acc[n][e] *= es[i0 + warp * 16 + r];
          }
      }
      G::gemm(acc, Ms + warp * 16 * S::MS, S::MS, Xs, S::XS, TILE);
    }
    G::store(acc, yg + (long long)(i0 + warp * 16) * a.y_ss, a.y_ss,
             qlen - i0 - warp * 16);
  }
}

// ----------------------------------------------------------------------
// Launch
// ----------------------------------------------------------------------

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// The workspace behind Args::cb, chunk and decay, each on 256 bytes.
struct Workspace {
  size_t cb, chunk, decay;
  static size_t up(size_t n) { return (n + 255) / 256 * 256; }
  Workspace(int Bt, int S, int H, int P, int N, int q) {
    const long long nc = ceil_div(S, q);
    const long long QP = (long long)ceil_div(q, TILE) * TILE;
    cb = up(sizeof(float) * Bt * nc * QP * QP);
    chunk = up(sizeof(float) * Bt * H * nc * (long long)P * N);
    decay = up(sizeof(float) * Bt * H * nc);
  }
  size_t bytes() const { return cb + chunk + decay; }
};

template <typename Kernel, typename... Extra>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, const Args& a, Extra... extra) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(a, extra...);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the four kernels, in launch order.  PT: the
// largest of 64/32/16 that divides P; NT: of 128/64/32/16 that divides NP.
struct Plan {
  int NT;
  size_t smem[4];
};

template <typename T, int PT>
Plan plan(const Args& a) {
  Plan p;
  p.NT = a.NP % 128 == 0 ? 128 : a.NP % 64 == 0 ? 64
       : a.NP % 32 == 0 ? 32 : 16;
  p.smem[0] = sizeof(T) * 2 * TILE * pad<T>(a.NP);
  p.smem[1] = align16(sizeof(T) * TILE * (pad<T>(PT) + pad<T>(p.NT))) +
              (size_t)a.QP * (sizeof(double) + 2 * sizeof(float));
  p.smem[2] = 0;
  p.smem[3] = OutSmem<T, PT>::bytes(a.NP, a.QP);
  return p;
}

template <typename T, int PT>
int launch_pt(const Args& a, cudaStream_t stream) {
  const Plan p = plan<T, PT>(a);
  const int nt = ceil_div(a.q, TILE);
  int rc = launch_kernel(ssd_cb<T>, dim3(a.Bt * a.nc, nt * (nt + 1) / 2),
                         128, p.smem[0], stream, a);
  if (rc != 0) return rc;
  rc = launch_kernel(
      ssd_chunk_state<T, PT>,
      dim3(a.Bt * a.H * a.nc * (a.P / PT) * (a.NP / p.NT)), p.NT * 2,
      p.smem[1], stream, a, p.NT);
  if (rc != 0) return rc;
  rc = launch_kernel(ssd_state_pass,
                     dim3(a.Bt * a.H, ceil_div((long long)a.P * a.N,
                                               4 * PASS_THREADS)),
                     PASS_THREADS, p.smem[2], stream, a);
  if (rc != 0) return rc;
  return launch_kernel(ssd_chunk_out<T, PT>,
                       dim3(a.Bt * a.H * a.nc, a.P / PT), 128, p.smem[3],
                       stream, a);
}

template <typename T>
int launch_t(const Args& a, cudaStream_t stream) {
  if (a.P % 64 == 0) return launch_pt<T, 64>(a, stream);
  if (a.P % 32 == 0) return launch_pt<T, 32>(a, stream);
  return launch_pt<T, 16>(a, stream);
}

template <typename T>
Plan plan_t(const Args& a) {
  if (a.P % 64 == 0) return plan<T, 64>(a);
  if (a.P % 32 == 0) return plan<T, 32>(a);
  return plan<T, 16>(a);
}

// p starts on 16 bytes and steps by 16-byte units per batch and row
inline bool aligned16(const void* p, long long sb, long long ss, int elem) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 &&
         (sb * elem) % 16 == 0 && (ss * elem) % 16 == 0;
}

}  // namespace capsim_ssd

// Bytes of device workspace a call of capsim_ssd_scan needs (the caller
// allocates it; the kernels allocate nothing).
extern "C" long long capsim_ssd_workspace_bytes(int Bt, int S, int H, int P,
                                                int N, int q) {
  if (Bt <= 0 || S <= 0 || H <= 0 || q <= 0) return 0;
  return static_cast<long long>(
      capsim_ssd::Workspace(Bt, S, H, P, N, q).bytes());
}

// dtype: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t, or -1 for
// what the kernel is not built for: the one place that states its limits
// (head_dim P a multiple of 16, d_state N a multiple of 4 and at most
// MAX_STATE, chunk 0 < q <= MAX_CHUNK, y rows on 16 bytes).  Strides are
// in elements; x, B, C, dt and y need a dense last axis, x and y dense
// heads (stride P), and y is (Bt, S, H, P) like x.  `workspace` holds
// capsim_ssd_workspace_bytes(Bt, S, H, P, N, q) bytes on 256 bytes.
extern "C" int capsim_ssd_scan(
    int dtype, const void* x, const float* dt, const void* B, const void* C,
    const float* A, void* y, float* state, int Bt, int S, int H, int P,
    int N, int q, long long x_sb, long long x_ss, long long dt_sb,
    long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, long long y_sb, long long y_ss, void* workspace,
    void* stream) {
  using namespace capsim_ssd;
  if (Bt == 0 || S == 0 || H == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || P % 16 != 0 || N % 4 != 0 ||
      N > MAX_STATE || q <= 0 || q > MAX_CHUNK ||
      !aligned16(y, y_sb, y_ss, elem))
    return -1;
  const bool vec = aligned16(x, x_sb, x_ss, elem) &&
                   aligned16(B, b_sb, b_ss, elem) &&
                   aligned16(C, c_sb, c_ss, elem) && (N * elem) % 16 == 0;
  const Workspace ws(Bt, S, H, P, N, q);
  unsigned char* w = static_cast<unsigned char*>(workspace);
  Args a{x,     dt,    B,     C,     A,     y,     state, Bt,    S,
         H,     P,     N,     q,     x_sb,  x_ss,  dt_sb, dt_ss, b_sb,
         b_ss,  c_sb,  c_ss,  y_sb,  y_ss,  ceil_div(S, q),
         ceil_div(q, TILE) * TILE,   (N + 15) / 16 * 16,   vec,
         reinterpret_cast<float*>(w),
         reinterpret_cast<float*>(w + ws.cb),
         reinterpret_cast<float*>(w + ws.cb + ws.chunk)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_t<float>(a, s)
                    : launch_t<__nv_bfloat16>(a, s);
}

// Dynamic shared memory of the four kernels (C.B^T, chunk states, state
// pass, y) for a call of this shape, in out[0..3]; -1 if not built for it.
extern "C" int capsim_ssd_shared_bytes(int dtype, int P, int N, int q,
                                       long long* out) {
  using namespace capsim_ssd;
  if ((dtype != 0 && dtype != 1) || P % 16 != 0 || N % 4 != 0 ||
      N > MAX_STATE || q <= 0 || q > MAX_CHUNK)
    return -1;
  Args a{};
  a.P = P;
  a.N = N;
  a.q = q;
  a.QP = ceil_div(q, TILE) * TILE;
  a.NP = (N + 15) / 16 * 16;
  const Plan p = dtype == 0 ? plan_t<float>(a) : plan_t<__nv_bfloat16>(a);
  for (int k = 0; k < 4; ++k) out[k] = static_cast<long long>(p.smem[k]);
  return 0;
}

extern "C" const char* capsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
