// Kernels K2, K9 and K10: multi-head attention, float32, for sm_90a, on
// three layouts of q/k/v; and their bf16 modes (fused_attention_bf16.cuh):
// K2 and K9 (D = 128) through qvc_attention_packed_bf16, K10 through
// qvc_attention_headed_bf16. For bf16 inputs the TPU kernels' _prec leaves
// the MXU one bf16 pass with float32 results (quickvc_tpu/ops/
// fused_attention.py:31-56, 137-161): float32 scores and softmax, p rounded
// to bf16 for the PV product, the output rounded to bf16.
//
// Replaces the TPU kernels of quickvc_tpu/ops/fused_attention.py:
//   K2  fused_attention_packed          (pallas_call at :113, body _packed_kernel :58-85):
//       q/k/v (B, T, H*D), head h at columns h*D, output packed the same way;
//   K9  fused_attention_packed_aligned  (pallas_call at :194, body _packed_kernel_aligned
//       :137-161): (B, T, H*128), each head zero-padded to 128 lanes;
//   K10 fused_attention                 (pallas_call at :231, body _attn_kernel :39-55):
//       (B, H, T, D).
// Each computes, per batch item and head, softmax(q_h k_h^T * scale) v_h
// with float32 scores.
//
// What bounds them on this card: operations, 4*T*T*D flops per (batch,
// head) against 4*T*D floats moved. Float32-accurate products on the tensor
// cores take three TF32 products (3xTF32), so the least time is 3 * flops
// at the 495 TFLOP/s dense TF32 rate; single-pass TF32 would round q, k, p
// and v to 10 mantissa bits and is not used.
//
// Design: the TPU kernels keep a head's whole (T, T) score tile in VMEM
// (1 MB at T = 500); a block here has 227 KB of shared memory at most. So
// one block per (query tile of 64 rows, head, batch item) walks the key
// tiles with an online softmax (running max and sum in float32), the
// flash-attention-2 recurrence, on mma.sync TF32 tensor cores in 3xTF32.
// q, k and v are read in place through their (batch, head, row) strides (K2
// gets views of the fused qkv projection: no copy, no head transpose) and
// the output is written in the caller's layout. K9 is the D = 128 body over
// the padded lanes: zero q/k lanes add nothing to a score and zero v lanes
// give exactly zero output lanes, so the padding needs no code of its own.
// The body, templated on D, and the notes on its tiles, fragments and
// copies are in fused_attention.cuh, which K8's layer shares.

#include "fused_attention.cuh"
#include "fused_attention_bf16.cuh"

// K2, and K9 with D = 128: q/k/v (B, T, H*D) with row strides q_ts, k_ts,
// v_ts and batch strides q_bs, k_bs, v_bs (head h at column offset h*D) into
// the packed (B, T, H*D) output o. D is 16, 32, 64 or 128.
extern "C" int qvc_attention_packed(const void* q, const void* k, const void* v, void* o,
                                    int batch, int T, int H, int D, long long q_bs,
                                    long long q_ts, long long k_bs, long long k_ts,
                                    long long v_bs, long long v_ts, float scale, void* stream) {
  const attn::Strides so{(long long)T * H * D, D, (long long)H * D};
  return (int)attn::launch_any(D, (const float*)q, (const float*)k, (const float*)v, (float*)o,
                               batch, T, H, {q_bs, D, q_ts}, {k_bs, D, k_ts}, {v_bs, D, v_ts},
                               so, scale, (cudaStream_t)stream);
}

// K10: q/k/v (B, H, T, D) through their (batch, head, row) strides into the
// contiguous (B, H, T, D) output o. D is 16, 32, 64 or 128.
extern "C" int qvc_attention_headed(const void* q, const void* k, const void* v, void* o,
                                    int batch, int H, int T, int D, long long q_bs,
                                    long long q_hs, long long q_ts, long long k_bs,
                                    long long k_hs, long long k_ts, long long v_bs,
                                    long long v_hs, long long v_ts, float scale, void* stream) {
  const attn::Strides so{(long long)H * T * D, (long long)T * D, D};
  return (int)attn::launch_any(D, (const float*)q, (const float*)k, (const float*)v, (float*)o,
                               batch, T, H, {q_bs, q_hs, q_ts}, {k_bs, k_hs, k_ts},
                               {v_bs, v_hs, v_ts}, so, scale, (cudaStream_t)stream);
}

// K2 at bf16, and K9 at bf16 with D = 128: q/k/v (B, T, H*D) bfloat16 with
// row strides q_ts, k_ts, v_ts and batch strides q_bs, k_bs, v_bs (in values;
// head h at column h*D) into the packed bfloat16 (B, T, H*D) output o. D is
// 16, 32, 64 or 128; (rows, bn, stages) the body and its configuration from
// ops/fused_attention.py:bf16_attention_plan (rows 0: the mma.sync body).
extern "C" int qvc_attention_packed_bf16(const void* q, const void* k, const void* v, void* o,
                                         int batch, int T, int H, int D, long long q_bs,
                                         long long q_ts, long long k_bs, long long k_ts,
                                         long long v_bs, long long v_ts, float scale, int rows,
                                         int bn, int stages, void* stream) {
  using attn_bf16::bf16_t;
  const attn_bf16::Strides so{(long long)T * H * D, D, (long long)H * D};
  return (int)attn_bf16::launch_any(D, {rows, bn, stages}, (const bf16_t*)q, (const bf16_t*)k,
                                    (const bf16_t*)v, (bf16_t*)o, batch, T, H, {q_bs, D, q_ts},
                                    {k_bs, D, k_ts}, {v_bs, D, v_ts}, so, scale,
                                    (cudaStream_t)stream);
}

// K10 at bf16: q/k/v (B, H, T, D) bfloat16 through their (batch, head, row)
// strides (in values) into the contiguous bfloat16 (B, H, T, D) output o.
// D is 16, 32, 64 or 128; (rows, bn, stages) as for the packed entry.
extern "C" int qvc_attention_headed_bf16(const void* q, const void* k, const void* v, void* o,
                                         int batch, int H, int T, int D, long long q_bs,
                                         long long q_hs, long long q_ts, long long k_bs,
                                         long long k_hs, long long k_ts, long long v_bs,
                                         long long v_hs, long long v_ts, float scale, int rows,
                                         int bn, int stages, void* stream) {
  using attn_bf16::bf16_t;
  const attn_bf16::Strides so{(long long)H * T * D, (long long)T * D, D};
  return (int)attn_bf16::launch_any(D, {rows, bn, stages}, (const bf16_t*)q, (const bf16_t*)k,
                                    (const bf16_t*)v, (bf16_t*)o, batch, T, H,
                                    {q_bs, q_hs, q_ts}, {k_bs, k_hs, k_ts}, {v_bs, v_hs, v_ts},
                                    so, scale, (cudaStream_t)stream);
}

// The bf16 body a plan names at head dim D (rows 0: the mma.sync body): out[0]
// the CTAs an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// out[1] a thread's registers, out[2] the dynamic shared memory a CTA.
extern "C" int qvc_attention_bf16_occupancy(int D, int rows, int bn, int stages, int* out) {
  return (int)attn_bf16::occupancy_any(D, {rows, bn, stages}, out);
}
