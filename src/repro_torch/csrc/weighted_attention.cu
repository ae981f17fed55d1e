// Weighted-attention forward, the CUDA replacement of the TPU kernel
// repro/kernels/fused_serving/kernel.py::_wa_kernel (reached through
// weighted_attention_bhsd).  The kernel bodies are flash attention's
// (flash_attention.cuh: bf16 on the tensor cores, f32 register-tiled on
// the FMA pipes), instantiated here with W = true: the per-key weight
// multiplies the max-shifted exponential and the row max runs over every
// key before Skv.  This file is their plain-C entry point, loaded from
// Python with ctypes (repro_torch/kernels/fused_serving/ops.py).
#include "flash_attention.cuh"

// Returns 0, a cudaError_t, -1 for a (dtype, head_dim) pair the kernel is
// not built for, or -2 for q/k/v that are not 16-byte aligned in start,
// batch stride and row stride.
extern "C" int capsim_weighted_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const float* kv_weight, void* o, int B, int Sq, int Skv, int H,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    float scale, void* stream) {
  capsim_fa::Args a{q,    k,    v,    kv_weight, o,    B,    Sq,
                    Skv,  H,    q_sb, q_ss,      k_sb, k_ss, v_sb,
                    v_ss, o_sb, o_ss, 0,         0,    0,    scale};
  return capsim_fa::launch<true>(dtype, head_dim, a,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* capsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
