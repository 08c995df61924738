// The P-frame data-block rebuild (K6) for Hopper (sm_90a): every data-block
// slot of a decode call in one launch.
//
// Stands for the JAX package's reconstruct_blocks (jx/pframe.py :253; one
// block is _reconstruct_one_block :183, a lax.scan of row_step over 16
// rows), which has no Pallas site: XLA compiles it with the motion apply
// into one program a frame (rebuild_frame_device :331). The port's plain
// version is pframe.reconstruct_blocks_streams_plain, a Python loop over
// the 16 rows of about 35 small tensor ops each.
//
// For every slot b (rects [B, 4] absolute exclusive sub-rects, bsid [B] the
// slot's stream, ptypes / rlens [B, 256] and lits [B, 256, 3] its records
// as decode_p_resolve_streams' to_grid lays them out):
//   1. the records expand to the positions of the slot's sequence: record
//      i covers [start_i, start_i + rlen_i), starts an exclusive prefix sum
//      of rlens; a record with rlen > 0 and 0 <= start < 256 marks its
//      start, and position p takes record (marks at or before p) - 1,
//      clamped to [0, 255] (the plain version's marks / cumsum, damaged
//      input included; the decoder's run lengths are >= 0);
//   2. position p < bw * bh sits at row p / bw, column p % bw of the
//      sub-rect (bw, bh clamped to [0, 16]); the rest is never written and
//      no written pixel depends on it (the recurrence reads only left and
//      above), so it is not computed;
//   3. 16 rows in sequence, v[x] = reset ? known : v[x - 1] + d with
//      v[-1] = 0: literal, above, prevframe and aboveleft reset; gradient
//      adds above - aboveleft; at column 0 left and gradient reset from the
//      left edge. Neighbours outside the sub-rect (the row above at row 0,
//      the left edge and the aboveleft column, prevframe) come from prev,
//      the true previous frames, never from out, and read 0 outside the
//      frame (the 1-pixel apron of the plain _windows_streams);
//   4. each pixel of the sub-rect that lies in the frame goes into the
//      slot's own stream's frame of out (the sink row is never written).
//
// What bounds it on this card: bytes, and those are few (a 16 x 16 block
// needs at most its apron and its PT_PREVFRAME pixels of prev, the run
// lengths, a ptype and three literals a record it uses, and writes 768 B):
// for the work of a decode call (at most some hundred slots) the bound is
// microseconds, so a launch is latency-bound. What it removes is the plain
// version's ~600 launches a call. The design:
//   - a warp a slot, four slots a thread block (no barrier across warps);
//   - the expansion: lane l holds records and positions 8l .. 8l + 7; a
//     warp prefix sum of the run lengths places the marks (shared memory),
//     a second one of the marks gives each position its record; the
//     position's ptype and packed literal go to shared memory;
//   - the rows: lane x holds column x; a pixel is one word r | g << 8 |
//     b << 16, and every step is an add or a subtract, so the row runs in
//     8-bit lanes (__vadd4 / __vsub4) and equals the plain int32 rows
//     masked to 8 bits. A row is a scan of affine maps (reset, a) over the
//     16 lanes by shuffles (4 steps); the row before stays in a register
//     and gives above (the lane's own) and aboveleft (__shfl_up by 1).
// Offsets into out and prev are int64: C * H * W * 3 may pass 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define BLK 16
#define AREA 256
#define SLOTS 4  // warps (slots) a thread block

// the codec's predictor types (config.py PT_*)
#define PT_LITERAL 0
#define PT_LEFT 1
#define PT_ABOVE 2
#define PT_PREVFRAME 3
#define PT_GRADIENT 4
#define PT_ABOVELEFT 5
#define PT_OTHER 6  // a value no record holds: carries v[x - 1]

// prev's pixel (y, x) of the frame at base, packed; 0 outside the frame
__device__ __forceinline__ unsigned pixel(const unsigned char* __restrict__ frame, long long y,
                                          long long x, int h, int w) {
  if (y < 0 || y >= h || x < 0 || x >= w) return 0u;
  const unsigned char* p = frame + 3 * (y * w + x);
  return __ldg(p) | (__ldg(p + 1) << 8) | (__ldg(p + 2) << 16);
}

// warp-inclusive prefix sum
template <typename T>
__device__ __forceinline__ T warp_incl(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(SLOTS * 32)
rebuild_blocks_kernel(unsigned char* __restrict__ out, const unsigned char* __restrict__ prev,
                      const int* __restrict__ rects, const long long* __restrict__ bsid,
                      const int* __restrict__ ptypes, const int* __restrict__ rlens,
                      const int* __restrict__ lits, long long nblk, int c, int h, int w) {
  __shared__ int s_mark[SLOTS][AREA];
  __shared__ unsigned s_lit[SLOTS][AREA];
  __shared__ unsigned char s_pt[SLOTS][AREA];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * SLOTS + wid;
  if (b >= nblk) return;  // no barrier across warps
  const int* rc = rects + 4 * b;
  const int bw = (int)min(max((long long)rc[2] - rc[0], 0LL), (long long)BLK);
  const int bh = (int)min(max((long long)rc[3] - rc[1], 0LL), (long long)BLK);
  const long long sid = bsid[b];
  if (bw == 0 || bh == 0 || sid < 0 || sid >= c) return;  // writes nothing
  const int n_pos = bw * bh;
  int* mark = s_mark[wid];
  unsigned* slit = s_lit[wid];
  unsigned char* spt = s_pt[wid];

  // 1. the records' starts: a prefix sum of the run lengths, marks in smem
  int rl[8];
  long long own = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) own += rl[j] = rlens[AREA * b + 8 * lane + j];
  long long start = warp_incl(own, lane) - own;
#pragma unroll
  for (int j = 0; j < 8; ++j) mark[8 * lane + j] = 0;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (rl[j] > 0 && start >= 0 && start < AREA) atomicAdd(&mark[start], 1);
    start += rl[j];
  }
  __syncwarp();

  // 2. each position's record: a prefix sum of the marks
  int cnt[8], tot = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) cnt[j] = (tot += mark[8 * lane + j]);
  const int before = warp_incl(tot, lane) - tot;
  const int* pt_b = ptypes + AREA * b;
  const int* lt_b = lits + 3LL * AREA * b;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = 8 * lane + j;
    if (p < n_pos) {
      const int rid = min(max(before + cnt[j] - 1, 0), AREA - 1);
      const int pt = __ldg(pt_b + rid);
      spt[p] = (pt >= PT_LITERAL && pt <= PT_ABOVELEFT) ? (unsigned char)pt : PT_OTHER;
      slit[p] = (__ldg(lt_b + 3 * rid) & 0xff) | ((__ldg(lt_b + 3 * rid + 1) & 0xff) << 8) |
                ((__ldg(lt_b + 3 * rid + 2) & 0xff) << 16);
    }
  }
  __syncwarp();

  // 3. the rows: lane x holds column x, the row before in v
  const unsigned char* pf = prev + sid * h * w * 3LL;
  unsigned char* of = out + sid * h * w * 3LL;
  const int x = lane;
  const bool col = x < bw;
  const long long x1 = rc[0], y1 = rc[1];
  unsigned v = 0;
  for (int r = 0; r < bh; ++r) {
    const unsigned left_of = __shfl_up_sync(FULL, v, 1);
    int pt = PT_LITERAL;
    unsigned known = 0, d = 0;
    bool reset = true;
    if (col) {
      const long long y = y1 + r, xx = x1 + x;
      pt = spt[r * bw + x];
      const unsigned above = r == 0 ? pixel(pf, y - 1, xx, h, w) : v;
      const unsigned tl = (r == 0 || x == 0) ? pixel(pf, y - 1, xx - 1, h, w) : left_of;
      switch (pt) {
        case PT_LITERAL: known = slit[r * bw + x]; break;
        case PT_ABOVE: known = above; break;
        case PT_PREVFRAME: known = pixel(pf, y, xx, h, w); break;
        case PT_ABOVELEFT: known = tl; break;
        case PT_LEFT:
          if (x == 0) known = pixel(pf, y, xx - 1, h, w);
          else reset = false;
          break;
        case PT_GRADIENT:
          if (x == 0) known = __vsub4(__vadd4(pixel(pf, y, xx - 1, h, w), above), tl);
          else { reset = false; d = __vsub4(above, tl); }
          break;
        default: reset = false; break;
      }
    }
    // inclusive scan of the maps v -> reset ? a : v + a over the lanes
    unsigned a = reset ? known : d;
    bool rs = reset;
#pragma unroll
    for (int o = 1; o < BLK; o <<= 1) {
      const unsigned pa = __shfl_up_sync(FULL, a, o);
      const bool prs = __shfl_up_sync(FULL, (int)rs, o) != 0;
      if (lane >= o && !rs) {
        a = __vadd4(pa, a);
        rs = prs;
      }
    }
    v = a;  // v[-1] = 0
    if (col) {
      const long long y = y1 + r, xx = x1 + x;
      if (y >= 0 && y < h && xx >= 0 && xx < w) {
        unsigned char* o = of + 3 * (y * w + xx);
        o[0] = (unsigned char)v;
        o[1] = (unsigned char)(v >> 8);
        o[2] = (unsigned char)(v >> 16);
      }
    }
  }
}

extern "C" int sptc_rebuild_blocks(unsigned char* out, const unsigned char* prev,
                                   const int* rects, const long long* bsid, const int* ptypes,
                                   const int* rlens, const int* lits, long long nblk, int c,
                                   int h, int w, void* stream) {
  if (nblk < 1 || c < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (nblk + SLOTS - 1) / SLOTS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rebuild_blocks_kernel<<<(unsigned)grid, SLOTS * 32, 0, (cudaStream_t)stream>>>(
      out, prev, rects, bsid, ptypes, rlens, lits, nblk, c, h, w);
  return (int)cudaGetLastError();
}
