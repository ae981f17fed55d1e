// Flash-attention forward, the CUDA replacement of the TPU kernel
// repro/kernels/flash_attention/kernel.py::_fa_kernel (reached through
// flash_attention_bhsd).  The kernel body, what bounds it and the design
// are in attention.cuh; this file is its plain-C entry point, loaded
// from Python with ctypes (repro_torch/kernels/flash_attention/ops.py).
#include "attention.cuh"

extern "C" int capsim_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const float* kv_mask, void* o, int B, int Sq, int Skv, int H,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    int causal, int window, float scale, void* stream) {
  capsim_attn::Args a{q,    k,    v,    kv_mask, o,    B,    Sq,
                      Skv,  H,    q_sb, q_ss,    k_sb, k_ss, v_sb,
                      v_ss, o_sb, o_ss, causal,  window, Skv - Sq, scale};
  return capsim_attn::launch<false>(dtype, head_dim, a,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* capsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
