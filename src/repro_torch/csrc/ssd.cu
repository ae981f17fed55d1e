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
// (Bt, H, P, N) float32, zero before the first chunk.  Everything is f32
// except seg, which is accumulated in f64: over a 256-step chunk seg
// reaches -1e4 at large dt*|A|, where f32 keeps only ~1e-3 of
// seg_i - seg_j.  The decay is always one exp of a difference, never
// exp(seg_i) / exp(seg_j), which is 0/0 there.  S need not be a multiple
// of q: the last chunk stops at S, which is what the Pallas wrapper's
// padding with dt = 0 computes (a padded step neither decays nor
// injects), without copying anything.
//
// What bounds it on the card.  At the Mamba2-780m prefill shape (Bt=4,
// S=4096, H=48, P=64, N=128, q=256) one call needs 64.6 GFLOP (only the
// causal half of the q x q scores) over 219 MB in bf16: 0.065 ms of bf16
// tensor-core work at 989 TFLOP/s and 0.065 ms of HBM traffic, a tie; in
// f32 outside the tensor cores (67 TFLOP/s) the work would take 0.96 ms.
//
// What the design does about it (a first, simple kernel: f32 FMAs, no
// tensor cores yet).  One CTA per (b, h, tile of PT head columns), so the
// 192 (b, h) pairs of the path become 384 CTAs on 132 SMs, two resident
// per SM.  The CTA walks the chunks in order with its (PT, N) f32 state
// in shared memory, which replaces the TPU grid's sequential chunk axis.
// Within a chunk it works on 64-row sub-tiles (a full 256-row chunk of B
// and C in f32 is 128 KB each): for each query tile and each causal key
// tile it forms the 64 x 64 score tile (C.B^T masked and decayed) with
// 4 x 4 register blocking over float4 shared-memory reads, then
// accumulates scores . (x dt) into registers; the state update runs over
// the key tiles once more.  C.B^T is recomputed per head and per column
// tile (B and C are shared by every head): the price of the simple
// mapping, and the first thing a faster kernel shares.  x and dt are read
// in the model's (Bt, S, H, ...) layout through their strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace capsim_ssd {

using capsim::from_f32;
using capsim::to_f32;

constexpr int THREADS = 256;
constexpr int TILE = 64;          // rows of a query or key sub-tile
constexpr int SS = TILE + 4;      // row stride of the score tile
constexpr int MAX_STATE = 256;    // largest d_state (register blocking)
constexpr int MAX_CHUNK = 1024;   // largest q (seg and dt in shared memory)

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
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// TILE rows [row0, row0 + TILE) of a (rows, n) operand into f32 shared
// memory with row stride ns; rows at or past `valid` read as zero.
template <typename T>
__device__ void load_rows(float* dst, const T* src, long long row_stride,
                          int row0, int valid, int n, int ns) {
  for (int e = threadIdx.x; e < TILE * n; e += THREADS) {
    const int r = e / n;
    const int c = e - r * n;
    dst[r * ns + c] =
        r < valid ? to_f32<T>(src[(row0 + r) * row_stride + c]) : 0.f;
  }
}

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

template <typename T, int PT>
__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(Args a) {
  // (row, p) accumulators of y: each thread owns RPT rows x 4 columns,
  // columns pc + CG * c so that its state rows are conflict-free
  constexpr int CG = PT / 4;
  constexpr int RG = THREADS / CG;
  constexpr int RPT = TILE / RG;
  // state update: 4 x 4 blocks of (p, n), BPT blocks per thread at most
  constexpr int BPT = (PT * MAX_STATE / 16 + THREADS - 1) / THREADS;
  static_assert(TILE % RG == 0, "rows must split evenly over threads");

  const int N = a.N;
  const int NS = N + 4;            // float4-aligned, conflict-free rows
  const int QP = (a.q + TILE - 1) / TILE * TILE;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* st = reinterpret_cast<float*>(smem_raw);  // PT x NS   state
  float* cs = st + PT * NS;                         // TILE x NS C rows
  float* bs = cs + TILE * NS;                       // TILE x NS B rows
  float* ss = bs + TILE * NS;                       // TILE x SS scores
  float* xs = ss + TILE * SS;                       // TILE x PT x*dt / x*w
  double* seg = reinterpret_cast<double*>(xs + TILE * PT);  // QP
  float* dts = reinterpret_cast<float*>(seg + QP);          // QP

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int p0 = blockIdx.y * PT;
  const float A = a.A[h];
  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + h * a.P + p0;
  const float* dtg = a.dt + b * a.dt_sb + h;
  const T* bg = static_cast<const T*>(a.B) + b * a.b_sb;
  const T* cg = static_cast<const T*>(a.C) + b * a.c_sb;
  T* yg = static_cast<T*>(a.y) + b * a.y_sb + h * a.P + p0;

  const int pc = tid % CG;
  const int ri = tid / CG;
  const int ty = tid / 16;         // score tile: rows ty + 16u
  const int tx = tid % 16;         //             cols tx + 16v
  const int nblk = PT * N / 16;

  for (int e = tid; e < PT * NS; e += THREADS) st[e] = 0.f;

  const int nchunks = (a.S + a.q - 1) / a.q;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * a.q;
    const int qlen = min(a.q, a.S - t0);
    const int ntiles = (qlen + TILE - 1) / TILE;
    __syncthreads();               // the previous chunk is done with dts
    for (int i = tid; i < QP; i += THREADS)
      dts[i] = i < qlen ? dtg[(t0 + i) * a.dt_ss] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, A, seg, QP);
    __syncthreads();

    // ---- y: incoming state + causal within-chunk part ----
    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TILE;
      load_rows<T>(cs, cg, a.c_ss, t0 + i0, qlen - i0, N, NS);
      __syncthreads();
      float acc[RPT][4];
#pragma unroll
      for (int k = 0; k < RPT; ++k)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[k][cc] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[RPT];
#pragma unroll
        for (int k = 0; k < RPT; ++k) cv[k] = ld4(&cs[(ri + k * RG) * NS + n]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 sv = ld4(&st[(pc + cc * CG) * NS + n]);
#pragma unroll
          for (int k = 0; k < RPT; ++k) acc[k][cc] = dot4(cv[k], sv, acc[k][cc]);
        }
      }
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float e = expf((float)seg[i0 + ri + k * RG]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[k][cc] *= e;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TILE;
        __syncthreads();           // bs, xs, ss of the last tile are read
        load_rows<T>(bs, bg, a.b_ss, t0 + j0, qlen - j0, N, NS);
        for (int e = tid; e < TILE * PT; e += THREADS) {
          const int j = j0 + e / PT;
          xs[e] = j < qlen
                      ? to_f32<T>(xg[(t0 + j) * a.x_ss + e % PT]) * dts[j]
                      : 0.f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) s[u][v] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) cv[u] = ld4(&cs[(ty + 16 * u) * NS + n]);
#pragma unroll
          for (int v = 0; v < 4; ++v) bv[v] = ld4(&bs[(tx + 16 * v) * NS + n]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) s[u][v] = dot4(cv[u], bv[v], s[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int gi = i0 + ty + 16 * u;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int gj = j0 + tx + 16 * v;
            ss[(ty + 16 * u) * SS + tx + 16 * v] =
                gj <= gi ? s[u][v] * expf((float)(seg[gi] - seg[gj])) : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < TILE; ++j) {
          float xv[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) xv[cc] = xs[j * PT + pc + cc * CG];
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            const float sv = ss[(ri + k * RG) * SS + j];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              acc[k][cc] = fmaf(sv, xv[cc], acc[k][cc]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int row = i0 + ri + k * RG;
        if (row < qlen) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            yg[(t0 + row) * a.y_ss + pc + cc * CG] = from_f32<T>(acc[k][cc]);
        }
      }
    }

    // ---- state <- state * exp(seg_last) + sum_j (x_j w_j) (x) B_j ----
    const double seg_last = seg[qlen - 1];
    float u[BPT][4][4];
#pragma unroll
    for (int k = 0; k < BPT; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) u[k][r][cc] = 0.f;
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * TILE;
      __syncthreads();             // bs, xs (and st's readers) are done
      load_rows<T>(bs, bg, a.b_ss, t0 + j0, qlen - j0, N, NS);
      for (int e = tid; e < TILE * PT; e += THREADS) {
        const int j = j0 + e / PT;
        xs[e] = j < qlen
                    ? to_f32<T>(xg[(t0 + j) * a.x_ss + e % PT]) *
                          (dts[j] * expf((float)(seg_last - seg[j])))
                    : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BPT; ++k) {
        const int blk = tid + k * THREADS;
        if (blk >= nblk) break;
        const int pb = blk / (N / 4);
        const int nb = blk % (N / 4);
        for (int j = 0; j < TILE; ++j) {
          const float4 xv = ld4(&xs[j * PT + pb * 4]);
          const float4 bv = ld4(&bs[j * NS + nb * 4]);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              u[k][r][cc] = fmaf(xr[r], br[cc], u[k][r][cc]);
        }
      }
    }
    const float decay = expf((float)seg_last);
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const int blk = tid + k * THREADS;
      if (blk >= nblk) break;
      const int pb = blk / (N / 4);
      const int nb = blk % (N / 4);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float& sv = st[(pb * 4 + r) * NS + nb * 4 + cc];
          sv = sv * decay + u[k][r][cc];
        }
    }
  }

  __syncthreads();
  float* so = a.state + ((long long)(b * a.H + h) * a.P + p0) * N;
  for (int e = tid; e < PT * N; e += THREADS)
    so[e] = st[(e / N) * NS + e % N];
}

template <typename T, int PT>
int launch_t(const Args& a, cudaStream_t stream) {
  const int NS = a.N + 4;
  const int QP = (a.q + TILE - 1) / TILE * TILE;
  const size_t smem =
      sizeof(float) * (size_t)(PT * NS + 2 * TILE * NS + TILE * SS +
                               TILE * PT + QP) +
      sizeof(double) * (size_t)QP;
  auto kern = ssd_scan_kernel<T, PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.Bt * a.H, a.P / PT);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const Args& a, cudaStream_t stream) {
  if (a.P % 32 == 0) return launch_t<T, 32>(a, stream);
  return launch_t<T, 16>(a, stream);
}

}  // namespace capsim_ssd

// dtype: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t, or -1 for
// what the kernel is not built for: the one place that states its limits
// (head_dim P a multiple of 16, d_state N a multiple of 4 and at most
// MAX_STATE, chunk 0 < q <= MAX_CHUNK).  Strides are in elements; x, B,
// C, dt and y need a dense last axis, x and y dense heads (stride P), and
// y is (Bt, S, H, P) like x.
extern "C" int capsim_ssd_scan(
    int dtype, const void* x, const float* dt, const void* B, const void* C,
    const float* A, void* y, float* state, int Bt, int S, int H, int P,
    int N, int q, long long x_sb, long long x_ss, long long dt_sb,
    long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, long long y_sb, long long y_ss, void* stream) {
  if (Bt == 0 || S == 0 || H == 0) return 0;
  if ((dtype != 0 && dtype != 1) || P % 16 != 0 || N % 4 != 0 ||
      N > capsim_ssd::MAX_STATE || q <= 0 || q > capsim_ssd::MAX_CHUNK)
    return -1;
  capsim_ssd::Args a{x,    dt,   B,    C,     A,     y,     state, Bt,
                     S,    H,    P,    N,     q,     x_sb,  x_ss,  dt_sb,
                     dt_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? capsim_ssd::launch_p<float>(a, s)
                    : capsim_ssd::launch_p<__nv_bfloat16>(a, s);
}

extern "C" const char* capsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
