// Gradient of an embedding gather, grad_table[v] = sum of grad_out[r] over
// the rows r with ids[r] == v, for Hopper (sm_90a).  It replaces no TPU
// kernel: the JAX package leaves this gradient to XLA.  It was added for
// PyTorch's own gradient of `table[ids]` (index_put_ with accumulate, the
// `indexing_backward_kernel`), which sorts the ids and gives each distinct
// id one warp that walks that id's rows in series.  The CAPSim predictor's
// token table is small (512 x 128 f32, ~380 ids in use) and a train step
// gathers ~600k rows from it (the <PAD> id alone fills most of them), so a
// few hundred warps walked thousands of rows each while the card idled.
// Loaded from Python with ctypes (repro_torch/kernels/embedding/ops.py).
//
// What bounds it on the card: bytes.  It adds N x E f32 values (one FLOP
// each) and must read them once, N ids, and write V x E: at batch 256 a
// step's 616,448 rows of 128 f32 are 316 MB, 0.09 ms at 3.35 TB/s.  What
// bounds this design is the chain of adds each warp walks, one row after
// another, with three warps an SM: the add is branch-free (a row that
// ends no run adds 0 to the spare row), which took a pass of 4096 x 16
// ids from 0.068 to 0.049 ms on the H100, against branches on the run's
// end and on ids outside the tile.
//
// What the design does about it: it is parallel over rows, never over
// distinct ids, since the ids' histogram is skewed, and it reads each
// gradient row once, coalesced, with no atomics, so its sum is the same
// bits on every call.
//
//   (1) embgrad_partial  per (chunk of rows, 32 columns, vocabulary tile of
//       up to VT ids): one warp whose lane owns one column.  It holds a
//       shared-memory table of VT x 32 f32 and a spare row (64.1 KB at
//       VT = 512, three blocks an SM), zeroes it, and walks its chunk's
//       rows in order, 32 rows a batch: the batch's ids (one a lane,
//       shuffled to all) and 32 gradient values a lane (one 128-byte row
//       slice each), two batches in flight, so the loads of one batch
//       overlap the adds of the other.  A run of equal ids (the <PAD>
//       slots that end every instruction) adds up in a register and meets
//       the table once.  Each table address has one writer, its lane, and
//       rows are added in order: no atomics.  The block writes its table
//       to its chunk's partial, (chunks, V, E).
//   (2) embgrad_sum  per (id, column): the chunks' partials summed in
//       chunk order into grad_table.
//
// The partials add 2 x chunks x V x E x 4 bytes (26 MB written and read
// at 99 chunks of the 512 x 128 table; pass (2) takes 6.4 us on the H100,
// the partials still in its 50 MB L2); the wrapper picks the chunk
// count so that pass (1) fills the card once.  A table wider than VT ids
// takes a grid axis of vocabulary tiles: each tile's blocks read every
// row of their chunk and add the rows of their own ids.  Rows whose id is
// out of [-V, V) add nothing (the forward gather refuses them); a
// negative id counts as id + V, as `table[ids]` reads it.
#include <cuda_runtime.h>

namespace capsim_emb {

constexpr int COLS = 32;    // columns a block owns: one a lane
constexpr int VT = 512;     // ids a block's table holds
constexpr int BATCH = 32;   // rows a batch: one id a lane
constexpr unsigned FULL = 0xffffffffu;

template <typename Id>
struct Rows {
  const float* __restrict__ g;
  const Id* __restrict__ ids;
  long long end;            // the chunk's last row + 1
  int V, E, v0, vt, c;
  bool col_ok;

  // The batch at r0: this lane's row id as a tile index (-1: not in the
  // tile, or past the chunk) and this lane's column of the 32 rows.
  __device__ __forceinline__ void fetch(long long r0, int& v,
                                        float (&val)[BATCH]) const {
    const long long r = r0 + threadIdx.x;
    v = -1;
    if (r < end) {
      long long id = static_cast<long long>(ids[r]);
      if (id < 0) id += V;
      if (id >= v0 && id < v0 + vt) v = static_cast<int>(id - v0);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      val[k] = (col_ok && r0 + k < end)
                   ? __ldg(g + (r0 + k) * static_cast<long long>(E) + c)
                   : 0.f;
  }
};

// Add a batch's rows (ids v, one a lane; values val) to the table in
// order, without a branch: a row whose id differs from the run's `cur`
// ends the run and adds `acc` to the run's row of the table, any other
// row adds 0 to the spare row `spare`, so each row is one shared-memory
// add.  A row outside the tile (id -1) starts a run that adds nowhere.
__device__ __forceinline__ void add_batch(int v, const float (&val)[BATCH],
                                          float* tab, int spare, int lane,
                                          int& cur, float& acc) {
  int vk[BATCH];
#pragma unroll
  for (int k = 0; k < BATCH; ++k) vk[k] = __shfl_sync(FULL, v, k);
#pragma unroll
  for (int k = 0; k < BATCH; ++k) {
    const bool ends = vk[k] != cur;
    float* p = tab + (ends && cur >= 0 ? cur : spare) * COLS + lane;
    *p = *p + (ends ? acc : 0.f);
    acc = ends ? val[k] : acc + val[k];
    cur = vk[k];
  }
}

template <typename Id>
__global__ void __launch_bounds__(COLS)
    embgrad_partial(const float* __restrict__ g, const Id* __restrict__ ids,
                    long long N, int V, int E, long long rows_per,
                    float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x;
  const long long begin = blockIdx.x * rows_per;
  Rows<Id> rows{g, ids, begin + rows_per < N ? begin + rows_per : N, V, E,
                static_cast<int>(blockIdx.z) * VT, 0,
                static_cast<int>(blockIdx.y) * COLS + lane, false};
  rows.vt = V - rows.v0 < VT ? V - rows.v0 : VT;
  rows.col_ok = rows.c < E;
  const int spare = rows.vt;  // the table's row past the tile
  for (int i = lane; i < (rows.vt + 1) * COLS / 4; i += COLS)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();

  int cur = -1;             // the id of the run in `acc`
  float acc = 0.f;
  const long long end = rows.end;
  int va = -1, vb = -1;     // two batches in flight: a, then b
  float a[BATCH], b[BATCH];
  if (begin < end) rows.fetch(begin, va, a);
  if (begin + BATCH < end) rows.fetch(begin + BATCH, vb, b);
  for (long long r0 = begin; r0 < end; r0 += 2 * BATCH) {
    add_batch(va, a, tab, spare, lane, cur, acc);
    if (r0 + 2 * BATCH < end) rows.fetch(r0 + 2 * BATCH, va, a);
    if (r0 + BATCH >= end) break;
    add_batch(vb, b, tab, spare, lane, cur, acc);
    if (r0 + 3 * BATCH < end) rows.fetch(r0 + 3 * BATCH, vb, b);
  }
  if (cur >= 0) tab[cur * COLS + lane] += acc;
  __syncwarp();

  if (!rows.col_ok) return;
  float* dst = part + (static_cast<long long>(blockIdx.x) * V + rows.v0) * E +
               rows.c;
#pragma unroll 8
  for (int i = 0; i < rows.vt; ++i)
    dst[static_cast<long long>(i) * E] = tab[i * COLS + lane];
}

__global__ void embgrad_sum(const float* __restrict__ part, long long VE,
                            int chunks, float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= VE) return;
  const float* p = part + i;
  float acc = 0.f;
  int k = 0;
  for (; k + 8 <= chunks; k += 8) {
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = __ldg(p + (k + j) * VE);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += a[j];
  }
  for (; k < chunks; ++k) acc += __ldg(p + k * VE);
  out[i] = acc;
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <typename Id>
int launch(const float* g, const Id* ids, long long N, int V, int E,
           int chunks, float* part, float* out, cudaStream_t stream) {
  const int vt = V < VT ? V : VT;
  const int smem = (vt + 1) * COLS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      embgrad_partial<Id>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_per = ceil_div(ceil_div(N, chunks), BATCH) * BATCH;
  const dim3 grid(static_cast<unsigned>(chunks),
                  static_cast<unsigned>(ceil_div(E, COLS)),
                  static_cast<unsigned>(ceil_div(V, VT)));
  embgrad_partial<Id><<<grid, COLS, smem, stream>>>(g, ids, N, V, E,
                                                    rows_per, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long VE = static_cast<long long>(V) * E;
  embgrad_sum<<<static_cast<unsigned>(ceil_div(VE, 256)), 256, 0, stream>>>(
      part, VE, chunks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace capsim_emb

// grad (N, E) f32 and ids (N,) int32 (ids_int64 = 0) or int64 (1), both
// dense; `partial` holds chunks x V x E f32, `out` V x E f32.  Returns 0,
// a cudaError_t, or -1 for what the kernel does not take: no chunk, an
// empty table, a grid axis past its limit.
extern "C" int capsim_embedding_grad(const float* grad, const void* ids,
                                     int ids_int64, long long N, int V,
                                     int E, int chunks, float* partial,
                                     float* out, void* stream) {
  using namespace capsim_emb;
  if (chunks < 1 || V < 1 || E < 1 || N < 0 ||
      (ids_int64 != 0 && ids_int64 != 1) || ceil_div(E, COLS) > 65535 ||
      ceil_div(V, VT) > 65535 ||
      ceil_div(static_cast<long long>(V) * E, 256) > 0x7fffffff)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ids_int64
             ? launch(grad, static_cast<const long long*>(ids), N, V, E,
                      chunks, partial, out, s)
             : launch(grad, static_cast<const int*>(ids), N, V, E, chunks,
                      partial, out, s);
}

extern "C" const char* capsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
