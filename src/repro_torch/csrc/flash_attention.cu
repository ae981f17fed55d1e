// Flash-attention forward, the CUDA replacement of the TPU kernel
// repro/kernels/flash_attention/kernel.py::_fa_kernel (reached through
// flash_attention_bhsd).  The kernel bodies (bf16 on the tensor cores,
// f32 register-tiled on the FMA pipes), what bounds them and the design
// are in flash_attention.cuh; this file instantiates them without weights
// (W = false) and is their plain-C entry point, loaded from Python with
// ctypes (repro_torch/kernels/flash_attention/ops.py).
#include "flash_attention.cuh"

extern "C" int capsim_flash_attention_fwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const float* kv_mask, void* o, int B, int Sq, int Skv, int H,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    int causal, int window, float scale, void* stream) {
  capsim_fa::Args a{q,    k,    v,    kv_mask, o,    B,    Sq,
                    Skv,  H,    q_sb, q_ss,    k_sb, k_ss, v_sb,
                    v_ss, o_sb, o_ss, causal,  window, Skv - Sq, scale};
  return capsim_fa::launch<false>(dtype, head_dim, a,
                           static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one launch of (dtype, head_dim) asks for, in
// bytes; -1 for a pair the kernel is not built for.
extern "C" long long capsim_flash_attention_smem(int dtype, int head_dim) {
  return capsim_fa::shared_bytes(dtype, head_dim);
}

extern "C" const char* capsim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
