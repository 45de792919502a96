// One-token GQA decode attention over an int8 paged KV cache, for Hopper
// sm_90a.
//
// Replaces: the TPU kernel `_paged_decode_packed_kernel` with
// `quantized=True`, launched by `_paged_decode_packed`
// (move2kube_tpu/ops/attention.py). Its fp branch has the contract of
// `_paged_decode_kernel`, which csrc/paged_decode.cu serves.
//
// Contract: q [b, h, d] fp32 or bf16; k_pages/v_pages [num_pages,
// block_size, kvh, d] int8; k_scale/v_scale [num_pages, block_size, kvh]
// fp32, one scale per written (token, kv-head) row; o [b, h, d] in q's
// type. The scales are folded in after the contractions, as in the TPU
// kernel (attention.py, the `quantized` branches of `_tile`):
//   score = ((q * scale) . k8) * k_scale
//   l    += p                        (no v_scale)
//   acc  += (p * v_scale) * v8
//   o     = acc / l
// so no dequantized context exists anywhere, not even in registers; the
// split pass carries (m, l, acc) with the scales already folded in, so the
// merge is the fp kernel's.
//
// What bounds it on an H100: bytes. A live context token costs
// 2 * kvh * (d + 4) bytes (int8 K and V rows plus their fp32 scales),
// 0.52x the bf16 kernel's 2 * kvh * 2d at d = 128, read once and used for
// a handful of FLOPs per byte; 3.35 TB/s of device memory is the roofline.
//
// Design: csrc/paged_split.cuh's split and merge, the same as
// csrc/paged_decode.cu's with int8 rows: grid (n_split, kvh, b), a split
// of whole pages per block instead of one block per (sequence, KV head),
// so the 64 blocks at batch 8 and the longest sequence's serial chain give
// way to as many blocks as there are live splits. The TPU kernel packs
// `pages_per_tile` pages into one VMEM tile because the int8 minimum tile
// is 32 sublanes and a page holds 8-16 rows; here the unit of copy is a
// 16-byte cp.async (8 lanes a 128-byte row at d = 128), so the packing and
// its tuning sweep have no counterpart. A row's scales are strided by kvh
// * 4 bytes in their pools, which no 16-byte copy can gather: each comes
// by its own 4-byte cp.async into the same ring stage as its row.
#include "paged_split.cuh"

M2KT_EXPORT_ERROR_STRING

// q [b, h, d] and o [b, h, d] of one type (dtype: 0 fp32, 1 bf16);
// k_pages/v_pages [num_pages, block_size, kvh, d] int8, 16-byte aligned;
// k_scale/v_scale [num_pages, block_size, kvh] fp32; block_tables
// [b, max_blocks] and seq_lens [b] int32; all contiguous. block_size % 8
// == 0, h / kvh in {1, 2, 4, 8}, d in {64, 128}; n_split *
// pages_per_split >= max_blocks; ws holds b * kvh * n_split * (h / kvh) *
// (d + 2) fp32 (null when n_split == 1). Launches the split pass and, when
// n_split > 1, the merge pass on `stream` of `device`, and returns
// cudaGetLastError().
extern "C" int m2kt_paged_decode_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* seq_lens, void* o, void* ws, int b, int h, int kvh, int d,
    int block_size, int max_blocks, int pages_per_split, int n_split,
    float scale, int dtype, int device, void* stream) {
  using namespace m2kt::paged;
  const Args a{q,
               k_pages,
               v_pages,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(seq_lens),
               o,
               static_cast<float*>(ws),
               b,
               h,
               kvh,
               block_size,
               max_blocks,
               pages_per_split,
               n_split,
               0,  // the ring, set at launch
               scale};
  return launch<int8_t>(a, d, dtype, device, stream);
}
