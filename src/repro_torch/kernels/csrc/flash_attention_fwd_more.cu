// Flash-attention forward (online softmax) for the LM backbones, written
// by hand for Hopper (sm_90a), at head widths 80, 96 and 160 (Phi-2's 80,
// Phi-3-mini's 96). The kernels are flash_attention_fwd.cuh's; see there
// for the design, its bound and what it replaces
// (src/repro/kernels/flash_attention.py::_flash_kernel).
#include "flash_attention_fwd.cuh"

// the head widths this source instantiates
#define FLASH_WIDTHS 80, 96, 160

// C entry, bound with ctypes. hd is the operands' (built) head width,
// scale_hd the unpadded one (the scale is 1/sqrt(scale_hd)); dtype 0 is
// float (CUDA cores), 1 is bf16 (tensor cores); cap <= 0 means no
// softcap; window <= 0 means global. One launch on `stream` (PyTorch's
// current stream); allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head width or type
// that is not instantiated here, a scale_hd outside 1..hd, or H not a
// multiple of KV.
extern "C" int flash_attention_fwd_more_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int kv_len, int hd, int scale_hd, int causal, int window,
    float cap, int dtype, void* stream) {
  return flash_entry<FLASH_WIDTHS>(q, k, v, o, B, H, KV, S, kv_len, hd,
                                   scale_hd, causal, window, cap, dtype,
                                   static_cast<cudaStream_t>(stream));
}
