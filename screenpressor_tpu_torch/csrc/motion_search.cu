// First-match motion search (K5) for Hopper (sm_90a).
//
// Stands for the JAX package's device-resident search: jx/blocks.py
// motion_search (:119) and motion_search_pruned (:389, a lax.while_loop
// reached through analyze_compact :856). It has no Pallas site there: XLA
// compiles the loop. The port's plain version is
// blocks.motion_search_streams_plain, whose chunks each end in a host
// sync; this kernel runs the whole search on the card with none.
//
// For every block of every stream (C x nb), with the frames packed to one
// int32 a pixel (r | g << 8 | b << 16, blocks.pack_pixels): an unchanged
// block gets n_cand; a changed block gets the lowest candidate index ci
// (mv_candidates order) whose shift (mx, my) keeps the block's sub-rect
// [x1, x2) x [y1, y2) inside the frame and whose shifted previous frame
// equals the current frame at every position of the sub-rect (the box,
// not only its changed pixels), or n_cand when none does.
//
// Design: one warp a block, eight blocks a thread block.
//   1. The warp holds the block's sub-rect (at most 256 positions) in
//      registers, position p = lane + 32 k in lane `lane`, slot k: its
//      offset from the sub-rect's origin and its current pixel. Comparing
//      it against the previous frame at shift 0 gives, by ballot, the
//      first and the last changed pixel: the two probes (the ones jx's
//      run_search takes, first and last changed pixel of the block).
//   2. The 32 lanes take 32 consecutive candidates at a time. Each lane
//      runs its candidate's bounds test, then reads the previous frame at
//      the two shifted probes. A true match equals the current frame at
//      every position of the sub-rect, so a probe that differs rejects
//      only candidates the full compare would reject.
//   3. The candidates that pass their probes (a ballot) are verified in
//      ascending order by the whole warp: each lane compares its <= 8
//      positions (independent loads, coalesced along the sub-rect's rows)
//      and __any_sync decides. The first that verifies is the block's
//      answer; the warp stops at the first group with one.
// Reads of the previous frame go through L1 / L2: the shifted windows of
// neighbouring candidates overlap, and a 1080p packed frame is 8.3 MB.
// A frame's pixel offsets are int32 (the wrapper checks H * W < 2^31); a
// stream's base offset is int64, so C * H * W may pass 2^31.
//
// What bounds it on this card: not bytes (both frames once: 0.0050 ms for
// a 1080p pair at 3.35 TB/s) but the dependent L2 reads of the candidate
// loop: a block with no match walks all ceil(n_cand / 32) groups, one
// candidate load and one probe load each (40 groups at the defaults'
// 1,278 candidates). Every warp walks its own block, so the blocks of a
// frame overlap their latencies; the warp's cost is set by its block's
// first match (a scroll resolves in the first group) or by n_cand (noise).

#include <cuda_runtime.h>

#define FULL 0xffffffffu
#define SEARCH_WARPS 8   // blocks of the frame per thread block
#define PER_LANE 8       // 256 positions of a 16 x 16 block over 32 lanes

__global__ void __launch_bounds__(SEARCH_WARPS * 32)
motion_search_kernel(const int* __restrict__ cur, const int* __restrict__ prev,
                     const int* __restrict__ rects, const unsigned char* __restrict__ changed,
                     const int* __restrict__ cands, int* __restrict__ choice,
                     long long n_blocks, int nb, int h, int w, int n_cand) {
  const int lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * SEARCH_WARPS + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;
  if (!changed[blk]) {
    if (lane == 0) choice[blk] = n_cand;
    return;
  }
  const int x1 = rects[4 * blk], y1 = rects[4 * blk + 1];
  const int x2 = rects[4 * blk + 2], y2 = rects[4 * blk + 3];
  const int bw = x2 - x1, area = bw * (y2 - y1);
  if (bw < 1 || y2 <= y1 || area > 32 * PER_LANE) {  // outside the contract: no read
    if (lane == 0) choice[blk] = n_cand;
    return;
  }
  const long long base = (blk / nb) * (long long)h * w;
  const int* cf = cur + base;
  const int* pf = prev + base;
  const int origin = y1 * w + x1;

  // 1. the sub-rect in registers; the probes from ballots at shift 0
  int rel[PER_LANE], val[PER_LANE];
  unsigned in_rect = 0;
  int first = area, last = -1;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int p = lane + 32 * k;
    const bool in = p < area;
    rel[k] = in ? (p / bw) * w + p % bw : 0;
    val[k] = in ? cf[origin + rel[k]] : 0;
    in_rect |= (unsigned)in << k;
    const unsigned diff = __ballot_sync(FULL, in && val[k] != pf[origin + rel[k]]);
    if (diff) {
      first = min(first, 32 * k + __ffs(diff) - 1);
      last = max(last, 32 * k + 31 - __clz(diff));
    }
  }
  if (last < 0) first = last = 0;  // a changed block's sub-rect holds a change
  const int rel_a = (first / bw) * w + first % bw, rel_b = (last / bw) * w + last % bw;
  const int va = cf[origin + rel_a], vb = cf[origin + rel_b];

  for (int g = 0; g < n_cand; g += 32) {
    // 2. bounds and probes, a candidate a lane
    const int ci = g + lane;
    bool ok = false;
    int shifted = 0;
    if (ci < n_cand) {
      const int mx = cands[2 * ci], my = cands[2 * ci + 1];
      if (x1 + mx >= 0 && x2 + mx <= w && y1 + my >= 0 && y2 + my <= h) {
        shifted = origin + my * w + mx;
        ok = pf[shifted + rel_a] == va && pf[shifted + rel_b] == vb;
      }
    }
    // 3. the survivors verified in order by the whole warp
    unsigned pass = __ballot_sync(FULL, ok);
    while (pass) {
      const int src = __ffs(pass) - 1;
      const int s = __shfl_sync(FULL, shifted, src);
      bool bad = false;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k)
        bad |= ((in_rect >> k) & 1u) && pf[s + rel[k]] != val[k];
      if (!__any_sync(FULL, bad)) {
        if (lane == 0) choice[blk] = g + src;
        return;
      }
      pass &= pass - 1;
    }
  }
  if (lane == 0) choice[blk] = n_cand;
}

extern "C" int sptc_motion_search(const int* cur, const int* prev, const int* rects,
                                  const unsigned char* changed, const int* cands, int* choice,
                                  long long n_blocks, int nb, int h, int w, int n_cand,
                                  void* stream) {
  if (n_blocks < 1 || nb < 1 || h < 1 || w < 1 || n_cand < 0 ||
      (long long)h * w >= 0x80000000LL)
    return (int)cudaErrorInvalidValue;
  const long long grid = (n_blocks + SEARCH_WARPS - 1) / SEARCH_WARPS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  motion_search_kernel<<<(unsigned)grid, SEARCH_WARPS * 32, 0, (cudaStream_t)stream>>>(
      cur, prev, rects, changed, cands, choice, n_blocks, nb, h, w, n_cand);
  return (int)cudaGetLastError();
}
