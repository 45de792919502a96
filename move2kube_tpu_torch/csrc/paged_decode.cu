// One-token GQA decode attention over a paged KV cache, for Hopper sm_90a.
//
// Replaces: the TPU kernel `_paged_decode_kernel`, launched by
// `_paged_decode_tpu` (move2kube_tpu/ops/attention.py), for fp32/bf16 page
// pools. The int8 pools (`_paged_decode_packed_kernel`) are
// csrc/paged_decode_int8.cu's.
//
// What bounds it on an H100: bytes. Each live context token's K and V rows
// are read once and used for a handful of FLOPs per byte (rep query heads
// share them), so the 3.35 TB/s of device memory is the roofline:
// sum_b seq_len_b * kvh * d * 2 (K and V) * sizeof(T), plus q and o.
//
// Design: csrc/paged_split.cuh's split and merge. The TPU grid (b, pages)
// carries acc/m/l across its sequential page axis in scratch; blocks on
// Hopper run in parallel and carry nothing, so the page axis becomes a
// split over blocks, grid (n_split, kvh, b), each block a split of whole
// pages of one (sequence, KV head) whose stages are all in flight at once
// (16-byte cp.async copies), and a second pass merges the live splits'
// partial softmax states in split order. One block per (sequence, KV head), the earlier
// design, gave 64 blocks at batch 8 on 132 SMs, and the longest sequence's
// 2048 tokens were eight blocks' serial chains of 32 rounds of loads;
// splits of pages_per_split pages (`paged_split_plan` in ops/attention.py)
// spread that sequence over as many blocks as it has splits. A sequence
// that fits in one split skips the workspace and the merge. The merge is a
// second kernel launched from this entry point on the same stream, not the
// last-arriving split block: the workspace comes from one torch.empty a
// call, so a self-resetting arrival counter would need memory that lives
// across calls.
#include "paged_split.cuh"

M2KT_EXPORT_ERROR_STRING

// q [b, h, d]; k_pages/v_pages [num_pages, block_size, kvh, d], 16-byte
// aligned; o [b, h, d]; all of one type (dtype: 0 fp32, 1 bf16);
// block_tables [b, max_blocks] and seq_lens [b] int32; all contiguous.
// block_size % 8 == 0, h / kvh in {1, 2, 4, 8}, d in {64, 128};
// n_split * pages_per_split >= max_blocks; ws holds b * kvh * n_split *
// (h / kvh) * (d + 2) fp32 (null when n_split == 1). Launches the split
// pass and, when n_split > 1, the merge pass on `stream` of `device`, and
// returns cudaGetLastError().
extern "C" int m2kt_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages,
                                 const void* block_tables,
                                 const void* seq_lens, void* o, void* ws,
                                 int b, int h, int kvh, int d, int block_size,
                                 int max_blocks, int pages_per_split,
                                 int n_split, float scale, int dtype,
                                 int device, void* stream) {
  using namespace m2kt::paged;
  const Args a{q,
               k_pages,
               v_pages,
               nullptr,
               nullptr,
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
  if (dtype == m2kt::kFloat32) {
    return launch<float>(a, d, dtype, device, stream);
  }
  if (dtype == m2kt::kBFloat16) {
    return launch<__nv_bfloat16>(a, d, dtype, device, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
