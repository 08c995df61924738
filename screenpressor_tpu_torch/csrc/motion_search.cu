// The P analysis's block front end (K5) for Hopper (sm_90a): change map,
// sub-rects, flat flags and first-match motion search in one launch.
//
// Stands for the JAX package's jitted analyze_compact (jx/blocks.py :856):
// its change_analysis (:45), the probe pixels and channel packing of its
// search (:436-437) and motion_search_pruned (:389, a lax.while_loop).
// None of them has a Pallas site: XLA fuses them into one program. The
// port's plain version is blocks.analyze_blocks_streams_plain
// (change_analysis_streams, flat_blocks_streams, motion_search_streams_plain).
//
// For every 16 x 16 block of block rows [row0, row0 + nby) of every stream
// (C x nby x nbx, reading the uint8 [C, H, W, 3] frames and previous
// frames where they lie; block rows past the frame have no pixel):
//   changed  the block holds a pixel that differs from the previous frame;
//   rects    its minimal changed sub-rect (x1, y1, x2, y2), absolute and
//            exclusive; an unchanged block gets (bx + 16, by + 16, bx, by),
//            the plain version's value;
//   flat     every in-frame pixel of the block equals the frame's pixel
//            (0, 0);
//   choice   the lowest candidate index ci (mv_candidates order) whose
//            shift (mx, my) keeps the sub-rect inside the frame and whose
//            shifted previous frame equals the current frame at every
//            position of the sub-rect; n_cand for an unchanged block or
//            when none does.
//
// What bounds it on this card: bytes. Both frames are read once (784 MB
// for the 1080p batch's 63 pairs, 0.234 ms at 3.35 TB/s); the search
// reads the previous frame again only for the candidates of changed
// blocks, which are few in screen content. The design:
//   1. A thread block takes a strip of 8 adjacent blocks of one block row
//      (16 rows x 128 pixels) and stages both frames' strip into shared
//      memory (6 KB each), a warp two rows of each: cp.async 16-byte
//      copies where a row's start is 16-byte aligned (3W a multiple of 16,
//      as at 640, 1920 and 3840), 4-byte or single-byte loads otherwise.
//      No packed copy and no change map in device memory. The pixel
//      (0, 0) of the stream's frame is loaded beside the strip.
//   2. A warp a block, from shared memory: lane l holds column l & 15 of
//      rows 2k + (l >> 4), k < 8, each pixel packed into one int
//      (r | g << 8 | b << 16). One ballot per k gives the changed
//      positions of two rows: their OR gives the changed columns, their
//      halves the changed rows, so x1, x2, y1, y2 and the change bit fall
//      out with no shuffle; __all_sync gives the flat bit. The first and
//      the last changed position are the two probes (as jx's run_search).
//   3. Only a changed block searches, PR 13's shape: 32 candidates at a
//      time, a lane a candidate, its bounds test and the previous frame
//      at the two shifted probes (three bytes each, through L1 / L2);
//      the survivors verified in ascending order by the whole warp (each
//      lane its <= 8 sub-rect positions, held in registers since step 2);
//      the first that verifies is the answer, lowest index first.
// Six thread blocks an SM (40 registers a thread): the strip loads of the
// resident blocks are what overlaps one block's analysis and search, so
// residency sets the rate (at 59 registers, four blocks an SM, it was
// slower on the 1080p batch and the serving steps; noise, where every
// block searches every candidate, is a little faster there).
// A frame's byte offsets are int32 (the launcher checks 3 H W < 2^31); a
// stream's base offset is int64, so C * H * W * 3 may pass 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define BLK 16
#define STRIP_BLOCKS 8                     // blocks (warps) a thread block
#define STRIP_BYTES (STRIP_BLOCKS * BLK * 3)  // 384: a strip row's RGB bytes

__device__ __forceinline__ int packed(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16);
}

__device__ __forceinline__ int packed_ldg(const unsigned char* p) {
  return __ldg(p) | (__ldg(p + 1) << 8) | (__ldg(p + 2) << 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// one strip row of one frame (n bytes at src) into shared memory by a warp
__device__ __forceinline__ void stage_row(unsigned char* dst, const unsigned char* src, int n,
                                          int lane) {
  const uintptr_t a = (uintptr_t)src;
  int done = 0;
  if ((a & 15) == 0) {
    done = n & ~15;
    for (int i = 16 * lane; i < done; i += 16 * 32) cp_async16(dst + i, src + i);
  } else if ((a & 3) == 0) {
    done = n & ~3;
    for (int i = 4 * lane; i < done; i += 4 * 32)
      *(unsigned*)(dst + i) = __ldg((const unsigned*)(src + i));
  }
  for (int i = done + lane; i < n; i += 32) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(STRIP_BLOCKS * 32, 6)  // 40 registers: 6 blocks an SM
analyze_blocks_kernel(const unsigned char* __restrict__ cur,
                      const unsigned char* __restrict__ prev, const int* __restrict__ cands,
                      unsigned char* __restrict__ changed, int* __restrict__ rects,
                      int* __restrict__ choice, unsigned char* __restrict__ flat, int h, int w,
                      int row0, int nby, int nbx, int n_strips, int n_cand) {
  __shared__ __align__(16) unsigned char s_cur[BLK][STRIP_BYTES];
  __shared__ __align__(16) unsigned char s_prev[BLK][STRIP_BYTES];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long strip = blockIdx.x;
  const int sx = (int)(strip % n_strips);
  const long long row = strip / n_strips;  // stream * nby + block row
  const int by = row0 + (int)(row % nby);
  const long long base = (row / nby) * 3LL * h * w;
  const int x0 = sx * STRIP_BLOCKS * BLK, y0 = by * BLK;
  const int nrows = max(0, min(BLK, h - y0));
  const int nbytes = 3 * min(STRIP_BLOCKS * BLK, w - x0);
  const unsigned char* cf = cur + base;
  const unsigned char* pf = prev + base;
  const int c0 = packed_ldg(cf);  // the frame's pixel (0, 0), loaded beside the strip

  // 1. the strip of both frames into shared memory, a warp two rows each
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = 2 * wid + j;
    if (r < nrows) {
      const int off = 3 * ((y0 + r) * w + x0);
      stage_row(s_cur[r], cf + off, nbytes, lane);
      stage_row(s_prev[r], pf + off, nbytes, lane);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int bx = sx * STRIP_BLOCKS + wid;
  if (bx >= nbx) return;  // no barrier below
  const long long blk = row * nbx + bx;
  const int lc = lane & 15, lr = lane >> 4;
  const int bx0 = bx * BLK;
  const bool col_in = bx0 + lc < w;

  // 2. change and flat bits a position; ballots give rows, columns, probes
  int val[8];
  unsigned rowmask = 0, colmask = 0;
  int first = -1, last = -1;
  bool is_flat = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = 2 * k + lr;
    const bool in = col_in && r < nrows;
    int cv = 0, pv = 0;
    if (in) {
      cv = packed(&s_cur[r][3 * (wid * BLK + lc)]);
      pv = packed(&s_prev[r][3 * (wid * BLK + lc)]);
    }
    val[k] = cv;
    is_flat &= !in || cv == c0;
    const unsigned m = __ballot_sync(FULL, in && cv != pv);
    if (m) {
      if (first < 0) first = 32 * k + __ffs(m) - 1;
      last = 32 * k + 31 - __clz(m);
    }
    // two ifs: the unrolled select-and-shift form of these lines compiled
    // wrong at -O3 on sm_90a (row bits 0 and 7 lost, row 8's moved to bit 0)
    if (m & 0xffffu) rowmask |= 1u << (2 * k);
    if (m & 0xffff0000u) rowmask |= 2u << (2 * k);
    colmask |= (m & 0xffffu) | (m >> 16);
  }
  is_flat = __all_sync(FULL, is_flat);
  int x1 = BLK, y1 = BLK, x2 = 0, y2 = 0;
  if (rowmask) {
    y1 = __ffs(rowmask) - 1;
    y2 = 32 - __clz(rowmask);
    x1 = __ffs(colmask) - 1;
    x2 = 32 - __clz(colmask);
  }
  if (lane == 0) {
    changed[blk] = rowmask != 0;
    flat[blk] = is_flat;
    int4 rc = make_int4(bx0 + x1, y0 + y1, bx0 + x2, y0 + y2);
    *(int4*)(rects + 4 * blk) = rc;
  }
  if (!rowmask || n_cand == 0) {
    if (lane == 0) choice[blk] = n_cand;
    return;
  }

  // 3. the search: bounds and two probes a lane, survivors verified in order
  const int ax = bx0 + (first & 15), ay = y0 + (first >> 4);
  const int bpx = bx0 + (last & 15), bpy = y0 + (last >> 4);
  const int va = packed(&s_cur[first >> 4][3 * (wid * BLK + (first & 15))]);
  const int vb = packed(&s_cur[last >> 4][3 * (wid * BLK + (last & 15))]);
  const int rx1 = bx0 + x1, rx2 = bx0 + x2, ry1 = y0 + y1, ry2 = y0 + y2;
  unsigned in_rect = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = 2 * k + lr;
    in_rect |= (unsigned)(r >= y1 && r < y2 && lc >= x1 && lc < x2) << k;
  }
  for (int g = 0; g < n_cand; g += 32) {
    const int ci = g + lane;
    bool ok = false;
    int mx = 0, my = 0;
    if (ci < n_cand) {
      mx = __ldg(cands + 2 * ci);
      my = __ldg(cands + 2 * ci + 1);
      if (rx1 + mx >= 0 && rx2 + mx <= w && ry1 + my >= 0 && ry2 + my <= h)
        ok = packed_ldg(pf + 3 * ((ay + my) * w + ax + mx)) == va &&
             packed_ldg(pf + 3 * ((bpy + my) * w + bpx + mx)) == vb;
    }
    unsigned pass = __ballot_sync(FULL, ok);
    while (pass) {
      const int src = __ffs(pass) - 1;
      const int smx = __shfl_sync(FULL, mx, src), smy = __shfl_sync(FULL, my, src);
      const unsigned char* sh = pf + 3 * ((y0 + lr + smy) * w + bx0 + lc + smx);
      bool bad = false;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if ((in_rect >> k) & 1u) bad |= packed_ldg(sh + 3 * 2 * k * w) != val[k];
      if (!__any_sync(FULL, bad)) {
        if (lane == 0) choice[blk] = g + src;
        return;
      }
      pass &= pass - 1;
    }
  }
  if (lane == 0) choice[blk] = n_cand;
}

extern "C" int sptc_analyze_blocks(const unsigned char* cur, const unsigned char* prev,
                                   const int* cands, unsigned char* changed, int* rects,
                                   int* choice, unsigned char* flat, long long n_streams, int h,
                                   int w, int row0, int nby, int n_cand, void* stream) {
  if (n_streams < 1 || h < 1 || w < 1 || row0 < 0 || nby < 1 || n_cand < 0 ||
      3LL * h * w >= 0x80000000LL || (long long)(row0 + nby) * BLK >= 0x80000000LL)
    return (int)cudaErrorInvalidValue;
  const int nbx = (w + BLK - 1) / BLK;
  const int n_strips = (nbx + STRIP_BLOCKS - 1) / STRIP_BLOCKS;
  const long long grid = n_streams * nby * n_strips;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  analyze_blocks_kernel<<<(unsigned)grid, STRIP_BLOCKS * 32, 0, (cudaStream_t)stream>>>(
      cur, prev, cands, changed, rects, choice, flat, h, w, row0, nby, nbx, n_strips, n_cand);
  return (int)cudaGetLastError();
}
