// Kernel K2: multi-head attention on the packed (B, T, H*64) layout,
// float32, for sm_90a.
//
// Replaces the TPU kernel quickvc_tpu/ops/fused_attention.py:
// fused_attention_packed (pallas_call at fused_attention.py:113; body
// _packed_kernel at :58-85): for each batch item and head,
// softmax(q_h k_h^T * scale) v_h with float32 scores, read from and written
// back to the packed layout the HuBERT in-projection produces.
//
// What bounds it on this card: operations, 4*T*T*64 flops per (batch, head)
// against 4*T*64 floats moved. In float32 the ceiling is the 67 TFLOP/s FMA
// rate; TF32 tensor cores would round q and k to 10 mantissa bits.
//
// Design: the TPU kernel keeps a head's whole (T, T) score tile in VMEM
// (1 MB at T = 500); a block here has 227 KB of shared memory at most. So
// one block per (query tile of 64 rows, head, batch item) walks the key
// tiles of 32 with an online softmax (running max and sum in float32), the
// flash-attention recurrence. q, k and v are read straight from the packed
// rows at column offset h*64 with the caller's row stride (the wrapper
// passes views of the fused qkv projection, no copy, no head transpose),
// and the output is written back packed. Thread (r, c0) of the block owns
// query row r: scores of keys c0 + 4i and output columns c0 + 4i; the four
// threads of a row reduce with warp shuffles. Shared rows are padded by one
// float so row-parallel reads hit distinct banks. Keys past T in the last
// tile are masked to -inf in the kernel; nothing is padded in memory. The
// kernel body is in fused_attention.cuh, which K8's layer shares.

#include "fused_attention.cuh"

extern "C" int qvc_attention_packed(const void* q, const void* k, const void* v,
                                    void* o, int batch, int T, int H,
                                    long long q_bs, long long q_ts,
                                    long long k_bs, long long k_ts,
                                    long long v_bs, long long v_ts, float scale,
                                    void* stream) {
  return (int)attn::launch((const float*)q, (const float*)k, (const float*)v, (float*)o, batch,
                           T, H, q_bs, q_ts, k_bs, k_ts, v_bs, v_ts, scale,
                           (cudaStream_t)stream);
}
