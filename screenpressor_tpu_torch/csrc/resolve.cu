// The P decode's block resolution (K8) for Hopper (sm_90a): every coded P
// stream of a decode call in three kernels, no host sync.
//
// Stands for the JAX package's decode_p_resolve (jx/pframe.py :510) after
// its section scans, which has no Pallas site: XLA fuses it into the P
// decode program. The port's plain version is
// pframe.decode_p_resolve_streams_plain, about a hundred small tensor ops
// (cumsums, index_put_, searchsorted, gathers) over a call's streams, and
// its contract is this kernel's: the same outputs, bit for bit, and the
// same error word, for clean and for damaged streams. Its inputs are what
// the section decode gives: run and run-length fields of 0 (a row past a
// stream's count) or a symbol + 1, so every prefix sum below is
// non-decreasing and every search sees sorted keys.
//
// For each stream s (records bt [C, cap, 2], sxy [C, cap, 4], mv [C, cap, 2],
// rec [C, cap, 2], col [C, cap, 3]; its header row hdr [C, 8] and its slot
// ranges mcap / moff and bcap / boff of the ragged motion and data-block
// axes):
//   1. the BT runs expand over the blocks xx1 .. xx2: relative position q
//      takes bt row (the runs of nvals > 0 that start at or before q) - 1,
//      clamped to the stream's own rows; block p takes q = p - xx1 (clamped
//      to the last block) where 0 <= q < xx2 - xx1 + 1;
//   2. each block is classified (partial, motion, data); the running counts
//      of each class pick its sub-rect and motion vector records (clamped
//      to the stream's own rows), its motion slot and its data slot; a slot
//      past the stream's own count is left 0, a block past its stream's
//      slots writes nothing; the areas of the data slots give a prefix sum;
//   3. record i of the rec section (valid below the header's count) starts
//      at rstart, a prefix sum of the run lengths; it belongs to the last
//      own data slot jb whose area starts at or before rstart, and takes
//      position i - first_rec[jb] of that slot, first_rec[j] being the
//      number of valid records that start before slot j's area;
//   4. a literal record takes col row (literal records up to it) - 1,
//      clamped to the stream's own rows.
// The error bits are the plain version's: 1-32 from the blocks, 64 from
// the totals, 128 a record crossing its slot's end, 256 a record past its
// slot's 256 positions, 512 more literal records than col rows.
//
// What bounds it on this card: launches, not bytes. A call reads at most a
// few MB of records and writes its slots (20 B a data-block position); the
// plain version's ~320 launches a call cost the host ~10 ms. The design:
//   - kernel 1, grid C + C * n_tiles: block s < C walks its stream's runs
//     and blocks with block-wide scans (1,024 threads, 8 items each, so a
//     1080p frame's 8,160 blocks are one chunk; larger frames loop with a
//     carry), the three class counts packed in 21-bit fields of one scan;
//     it writes every motion and data slot of its stream, the area prefix
//     and its error word. The other blocks sum the run lengths and literal
//     flags of one tile of 4,096 records;
//   - kernel 2, grid C * n_tiles: a tile adds the sums of the tiles before
//     it, scans its records, finds each record's slot (one binary search a
//     thread, then a cursor over the thread's consecutive records), and
//     writes each record's slot and literal row and first_rec (record i is
//     first in the slots whose area starts in (rstart[i - 1], rstart[i]]);
//     tile 0 sets bits 64 and 512 from the totals;
//   - kernel 3, grid B, 256 threads: slot b's position k gathers record
//     first_rec[b] + k if that record is valid and belongs to b, else 0, so
//     every position of pt / rlg / lt is written once and nothing is zeroed
//     first; records of one slot are consecutive, so a slot has a record
//     past its 256 positions exactly where record first_rec[b] + 256 still
//     belongs to it (bit 256).
// Offsets are int64; sums of run lengths are int64 as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 1024     // threads of kernels 1 and 2
#define IPT 8       // blocks, runs or slots a thread per chunk (kernel 1)
#define CHUNK (NT * IPT)
#define RIPT 4      // records a thread (kernel 2)
#define TILE (NT * RIPT)
#define GT 256      // threads of kernel 3: a data-block slot's positions
#define FIELD 21    // bits of each class count in the packed scan
#define FMASK ((1ull << FIELD) - 1)
#define FULL 0xffffffffu

// the codec's block types (config.py BT_*) and literal ptype
#define BT_FULL_DATA 1
#define BT_PARTIAL_DATA 2
#define BT_FULL_MOTION 3
#define BT_PARTIAL_MOTION 4
#define PT_LITERAL 0
#define BLK 16
#define AREA 256

struct Params {
  const int *bt, *sxy, *mv, *rec, *col;  // records [C, cap, W]
  const long long *hdr;                  // [C, 8]: bt sxy mv rec col xx1 xx2 n_data
  const long long *mcap, *bcap, *moff, *boff, *bsid;
  int *mo_rects, *mo_mvs, *d_rects, *pt, *rlg, *lt, *err;  // outputs
  long long *bstart;  // [C, cap_bt] each run's start
  int *nzc;           // [C, cap_bt] runs of nvals > 0 up to each
  long long *astart;  // [C, b_max + 1] data slots' area starts, then the total
  int *first_rec;     // [C, b_max]
  long long *tsum;    // [C, n_tiles, 2] run lengths and literal records a tile
  int *jbs;           // [C, cap_rec] each valid record's slot
  int *litrow;        // [C, cap_rec] each valid literal record's col row, else -1
  int c, cap_bt, cap_sxy, cap_mv, cap_rec, cap_col, b_max, n_tiles;
  int nbx, nby, h, w;
};

template <typename T>
__device__ __forceinline__ T warp_incl(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// exclusive prefix of v over the block's threads, and the block's total;
// sh holds 32 values. Every thread of the block must call it.
template <typename T>
__device__ T block_excl(T v, T* sh, T& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const T inc = warp_incl(v, lane);
  __syncthreads();  // sh is free: the last call's readers are done
  if (lane == 31) sh[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    const T x = warp_incl(lane < nw ? sh[lane] : T(0), lane);
    sh[lane] = x;
  }
  __syncthreads();
  total = sh[nw - 1];
  return (wid ? sh[wid - 1] : T(0)) + inc - v;
}

// the number of keys a[0 .. n) at or below x (a sorted)
__device__ __forceinline__ int keys_at_most(const long long* a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int own_last(long long n, int cap) {
  return (int)(min(max(n, 1LL), (long long)cap) - 1);
}

__device__ __forceinline__ long long valid_records(const Params& p, int s) {
  return min(max(p.hdr[8LL * s + 3], 0LL), (long long)p.cap_rec);
}

// kernel 1, block s < C: runs, blocks, slots and the area prefix of stream s
__device__ void stream_pass(const Params& p, int s) {
  __shared__ long long sh_l[32];
  __shared__ unsigned long long sh_u[32];
  const int t = threadIdx.x;
  const long long* hv = p.hdr + 8LL * s;
  const long long n_sxy = hv[1], n_mv = hv[2], n_data = hv[7];
  const long long xx1 = hv[5], lenr = hv[6] - hv[5] + 1;
  const int nb = p.nbx * p.nby;
  const int* bt = p.bt + 2LL * p.cap_bt * s;
  long long* bstart = p.bstart + (long long)p.cap_bt * s;
  int* nzc = p.nzc + (long long)p.cap_bt * s;
  int bits = 0;

  // 1. the runs' starts and the count of runs of nvals > 0 up to each
  long long carry_v = 0, carry_n = 0;
  for (int base = 0; base < p.cap_bt; base += CHUNK) {
    const int i0 = base + t * IPT;
    long long sv = 0, sn = 0;
    for (int k = 0; k < IPT; ++k) {
      const int i = i0 + k;
      if (i < p.cap_bt) {
        const int nv = bt[2LL * i + 1];
        sv += nv;
        sn += nv > 0;
      }
    }
    long long tv, tn;
    long long ev = block_excl(sv, sh_l, tv) + carry_v;
    long long en = block_excl(sn, sh_l, tn) + carry_n;
    for (int k = 0; k < IPT; ++k) {
      const int i = i0 + k;
      if (i < p.cap_bt) {
        const int nv = bt[2LL * i + 1];
        bstart[i] = ev;
        ev += nv;
        en += nv > 0;
        nzc[i] = (int)en;
      }
    }
    carry_v += tv;
    carry_n += tn;
  }
  if (carry_v != lenr) bits |= 1;
  __syncthreads();

  // 2. each block's type and class; its rect, motion and data slots
  const int own_bt = own_last(hv[0], p.cap_bt), own_sxy = own_last(n_sxy, p.cap_sxy);
  const int own_mv = own_last(n_mv, p.cap_mv);
  const long long mcap = p.mcap[s], bcap = p.bcap[s], moff = p.moff[s], boff = p.boff[s];
  const int* sxy = p.sxy + 4LL * p.cap_sxy * s;
  const int* mv = p.mv + 2LL * p.cap_mv * s;
  long long* area = p.astart + (long long)(p.b_max + 1) * s;
  unsigned long long carry = 0;
  bool bad16 = false, bad32 = false;
  for (int base = 0; base < nb; base += CHUNK) {
    const int p0 = base + t * IPT;
    unsigned cls = 0;  // 3 bits an item: partial, motion, data
    unsigned long long own = 0;
    int kb = -1;  // runs starting at or before the item's relative position
    for (int k = 0; k < IPT; ++k) {
      const int pos = p0 + k;
      const long long q = (long long)pos - xx1;
      int bts = 0;
      if (pos < nb && q >= 0 && q < lenr) {
        const long long qq = min(q, (long long)nb - 1);
        if (kb < 0) kb = keys_at_most(bstart, p.cap_bt, qq);
        else while (kb < p.cap_bt && bstart[kb] <= qq) ++kb;
        const int ridx = (kb ? nzc[kb - 1] : 0) - 1;
        if (ridx >= 0) bts = bt[2LL * min(ridx, own_bt)];
      }
      const unsigned part = bts == BT_PARTIAL_DATA || bts == BT_PARTIAL_MOTION;
      const unsigned mot = bts == BT_FULL_MOTION || bts == BT_PARTIAL_MOTION;
      const unsigned dat = bts == BT_FULL_DATA || bts == BT_PARTIAL_DATA;
      cls |= (part | mot << 1 | dat << 2) << (3 * k);
      own += part | (unsigned long long)mot << FIELD | (unsigned long long)dat << (2 * FIELD);
    }
    unsigned long long tot;
    unsigned long long run = block_excl(own, sh_u, tot) + carry;
    for (int k = 0; k < IPT; ++k) {
      const int pos = p0 + k;
      const unsigned c3 = (cls >> (3 * k)) & 7;
      const bool part = c3 & 1, mot = c3 & 2, dat = c3 & 4;
      run += part | (unsigned long long)mot << FIELD | (unsigned long long)dat << (2 * FIELD);
      if (!c3) continue;
      const long long x_lo = (long long)(pos % p.nbx) * BLK;
      const long long y_lo = (long long)(pos / p.nbx) * BLK;
      const long long x_hi = min(x_lo + BLK, (long long)p.w);
      const long long y_hi = min(y_lo + BLK, (long long)p.h);
      long long x1 = x_lo, y1 = y_lo, x2 = x_hi, y2 = y_hi;
      if (part) {
        const long long pi = (long long)(run & FMASK) - 1;
        const int* r = sxy + 4LL * min(max(pi, 0LL), (long long)own_sxy);
        x1 = x_lo + r[0];
        y1 = y_lo + r[1];
        x2 = x_lo + r[2] + 1;
        y2 = y_lo + r[3] + 1;
        if (!(x1 < x2 && x2 <= x_hi && y1 < y2 && y2 <= y_hi)) bad16 = true;
      }
      if (mot) {
        const long long mi = (long long)((run >> FIELD) & FMASK) - 1;
        const int* m = mv + 2LL * min(mi, (long long)own_mv);
        const int m0 = m[0], m1 = m[1];
        if (!(x1 + m0 >= 0 && y1 + m1 >= 0 && x2 + m0 <= p.w && y2 + m1 <= p.h)) bad32 = true;
        if (mi < mcap) {
          int* o = p.mo_rects + 4 * (moff + mi);
          o[0] = (int)x1; o[1] = (int)y1; o[2] = (int)x2; o[3] = (int)y2;
          p.mo_mvs[2 * (moff + mi)] = m0;
          p.mo_mvs[2 * (moff + mi) + 1] = m1;
        }
      }
      if (dat) {
        const long long di = (long long)(run >> (2 * FIELD)) - 1;
        if (di < bcap) {
          int* o = p.d_rects + 4 * (boff + di);
          o[0] = (int)x1; o[1] = (int)y1; o[2] = (int)x2; o[3] = (int)y2;
          area[di] = (int)(max(x2 - x1, 0LL) * max(y2 - y1, 0LL));
        }
      }
    }
    carry += tot;
  }
  const long long n_part = carry & FMASK, n_mot = (carry >> FIELD) & FMASK;
  const long long n_dat = carry >> (2 * FIELD);
  if (n_part != n_sxy) bits |= 2;
  if (n_mot != n_mv) bits |= 4;
  if (n_dat != n_data) bits |= 8;
  if (__syncthreads_or(bad16)) bits |= 16;
  if (__syncthreads_or(bad32)) bits |= 32;

  // 3. the stream's slots past its blocks hold 0
  for (long long j = min(n_mot, mcap) + t; j < mcap; j += NT) {
    int* o = p.mo_rects + 4 * (moff + j);
    o[0] = o[1] = o[2] = o[3] = 0;
    p.mo_mvs[2 * (moff + j)] = p.mo_mvs[2 * (moff + j) + 1] = 0;
  }
  for (long long j = min(n_dat, bcap) + t; j < bcap; j += NT) {
    int* o = p.d_rects + 4 * (boff + j);
    o[0] = o[1] = o[2] = o[3] = 0;
    area[j] = 0;
  }
  __syncthreads();

  // 4. the areas' exclusive prefix in place, the total after it
  long long carry_a = 0;
  for (long long base = 0; base < bcap; base += CHUNK) {
    const long long j0 = base + (long long)t * IPT;
    long long sa = 0;
    for (int k = 0; k < IPT; ++k)
      if (j0 + k < bcap) sa += area[j0 + k];
    long long ta;
    long long ea = block_excl(sa, sh_l, ta) + carry_a;
    for (int k = 0; k < IPT; ++k) {
      if (j0 + k < bcap) {
        const long long a = area[j0 + k];
        area[j0 + k] = ea;
        ea += a;
      }
    }
    carry_a += ta;
  }
  const long long n_valid = valid_records(p, s);
  for (long long j = t; j < bcap; j += NT) p.first_rec[(long long)p.b_max * s + j] = (int)n_valid;
  if (t == 0) {
    area[bcap] = carry_a;
    p.err[s] = bits;
  }
}

// kernel 1, the other blocks: a tile's run lengths and literal records
__device__ void tile_sums(const Params& p, int idx) {
  __shared__ long long sh_l[32];
  const int s = idx / p.n_tiles, tile = idx % p.n_tiles;
  const long long n_valid = valid_records(p, s);
  const int* rec = p.rec + 2LL * p.cap_rec * s;
  const long long i0 = (long long)tile * TILE + (long long)threadIdx.x * RIPT;
  long long sr = 0, sl = 0;
  for (int k = 0; k < RIPT; ++k) {
    const long long i = i0 + k;
    if (i < n_valid) {
      sr += rec[2 * i + 1];
      sl += rec[2 * i] == PT_LITERAL;
    }
  }
  long long tr, tl;
  block_excl(sr, sh_l, tr);
  block_excl(sl, sh_l, tl);
  if (threadIdx.x == 0) {
    p.tsum[2 * ((long long)s * p.n_tiles + tile)] = tr;
    p.tsum[2 * ((long long)s * p.n_tiles + tile) + 1] = tl;
  }
}

__global__ void __launch_bounds__(NT) resolve_blocks_kernel(Params p) {
  if (blockIdx.x < (unsigned)p.c) stream_pass(p, blockIdx.x);
  else tile_sums(p, blockIdx.x - p.c);
}

// kernel 2: each valid record's slot, literal row and first_rec; bits 64,
// 128 and 512
__global__ void __launch_bounds__(NT) resolve_records_kernel(Params p) {
  __shared__ long long sh_l[32];
  const int t = threadIdx.x;
  const int s = blockIdx.x / p.n_tiles, tile = blockIdx.x % p.n_tiles;
  const long long* hv = p.hdr + 8LL * s;
  const long long bcap = p.bcap[s], n_valid = valid_records(p, s);
  const long long* astart = p.astart + (long long)(p.b_max + 1) * s;
  const int nslot = (int)bcap;

  // the tiles before this one; tile 0 takes all of them for the totals
  const int lim = tile ? tile : p.n_tiles;
  long long pr = 0, pl = 0;
  for (int u = t; u < lim; u += NT) {
    pr += p.tsum[2 * ((long long)s * p.n_tiles + u)];
    pl += p.tsum[2 * ((long long)s * p.n_tiles + u) + 1];
  }
  long long rl_pre, lit_pre;
  block_excl(pr, sh_l, rl_pre);
  block_excl(pl, sh_l, lit_pre);
  if (tile == 0) {
    int bits = 0;
    if (rl_pre != astart[bcap]) bits |= 64;
    if (lit_pre > hv[4]) bits |= 512;
    if (t == 0 && bits) atomicOr(p.err + s, bits);
    rl_pre = lit_pre = 0;
  }
  const long long i0 = (long long)tile * TILE + (long long)t * RIPT;
  if ((long long)tile * TILE >= n_valid) return;  // the whole block

  const int* rec = p.rec + 2LL * p.cap_rec * s;
  int rl[RIPT];
  unsigned lit = 0;
  long long sr = 0, sl = 0;
  for (int k = 0; k < RIPT; ++k) {
    const long long i = i0 + k;
    rl[k] = 0;
    if (i < n_valid) {
      rl[k] = rec[2 * i + 1];
      const unsigned l = rec[2 * i] == PT_LITERAL;
      lit |= l << k;
      sr += rl[k];
      sl += l;
    }
  }
  long long tr, tl;
  long long rstart = block_excl(sr, sh_l, tr) + rl_pre;
  long long nlit = block_excl(sl, sh_l, tl) + lit_pre;
  const int own_col = own_last(hv[4], p.cap_col);
  int* first_rec = p.first_rec + (long long)p.b_max * s;
  bool bad = false;
  int ub = -1;  // own slots whose area starts at or before the cursor
  for (int k = 0; k < RIPT; ++k) {
    const long long i = i0 + k;
    if (i >= n_valid) break;
    if (ub < 0) ub = keys_at_most(astart, nslot, i ? rstart - rec[2 * i - 1] : -1);
    const int lo = ub;  // first slot whose area starts after record i - 1's start
    while (ub < nslot && astart[ub] <= rstart) ++ub;
    const int jb = min(max(ub - 1, 0), nslot - 1);
    if (rstart + rl[k] > astart[jb + 1]) bad = true;
    for (int j = lo; j < ub; ++j) first_rec[j] = (int)i;
    const long long at = (long long)p.cap_rec * s + i;
    p.jbs[at] = jb;
    if ((lit >> k) & 1) {
      ++nlit;
      p.litrow[at] = (int)min(max(nlit - 1, 0LL), (long long)own_col);
    } else {
      p.litrow[at] = -1;
    }
    rstart += rl[k];
  }
  if (__syncthreads_or(bad) && t == 0) atomicOr(p.err + s, 128);
}

// kernel 3: data-block slot b's 256 positions from its records; bit 256
__global__ void __launch_bounds__(GT) resolve_gather_kernel(Params p) {
  const long long b = blockIdx.x;
  const int k = threadIdx.x;
  const int s = (int)p.bsid[b];
  const long long bl = b - p.boff[s];
  const long long n_valid = valid_records(p, s);
  const long long f = p.first_rec[(long long)p.b_max * s + bl];
  const long long row = (long long)p.cap_rec * s;
  const long long i = f + k;
  int ptv = 0, rlv = 0, l0 = 0, l1 = 0, l2 = 0;
  if (i < n_valid && p.jbs[row + i] == bl) {
    ptv = p.rec[2 * (row + i)];
    rlv = p.rec[2 * (row + i) + 1];
    const int lr = p.litrow[row + i];
    if (lr >= 0) {
      const int* c = p.col + 3 * ((long long)p.cap_col * s + lr);
      l0 = c[0]; l1 = c[1]; l2 = c[2];
    }
  }
  const long long at = (long long)AREA * b + k;
  p.pt[at] = ptv;
  p.rlg[at] = rlv;
  p.lt[3 * at] = l0;
  p.lt[3 * at + 1] = l1;
  p.lt[3 * at + 2] = l2;
  if (k == 0 && f + AREA < n_valid && p.jbs[row + f + AREA] == bl) atomicOr(p.err + s, 256);
}

// d: the host descriptor, in Params' order: the 25 pointers, then c, the
// five caps, b_max, n_tiles, nbx, nby, h, w, n_blk (the data-block slots)
extern "C" int sptc_resolve_blocks(const long long* d, void* stream) {
  Params p;
  int n = 0;
  p.bt = (const int*)d[n++];
  p.sxy = (const int*)d[n++];
  p.mv = (const int*)d[n++];
  p.rec = (const int*)d[n++];
  p.col = (const int*)d[n++];
  p.hdr = (const long long*)d[n++];
  p.mcap = (const long long*)d[n++];
  p.bcap = (const long long*)d[n++];
  p.moff = (const long long*)d[n++];
  p.boff = (const long long*)d[n++];
  p.bsid = (const long long*)d[n++];
  p.mo_rects = (int*)d[n++];
  p.mo_mvs = (int*)d[n++];
  p.d_rects = (int*)d[n++];
  p.pt = (int*)d[n++];
  p.rlg = (int*)d[n++];
  p.lt = (int*)d[n++];
  p.err = (int*)d[n++];
  p.bstart = (long long*)d[n++];
  p.nzc = (int*)d[n++];
  p.astart = (long long*)d[n++];
  p.first_rec = (int*)d[n++];
  p.tsum = (long long*)d[n++];
  p.jbs = (int*)d[n++];
  p.litrow = (int*)d[n++];
  const long long* v = d + n;
  const long long c = v[0], b_max = v[6], n_tiles = v[7], n_blk = v[12];
  for (int j = 0; j < 12; ++j)
    if (v[j] < 1 || v[j] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (v[8] * v[9] >= (1LL << FIELD) || n_blk < c || c * (1 + n_tiles) > 0x7fffffffLL ||
      n_blk > 0x7fffffffLL || b_max + 1 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.c = (int)c;
  p.cap_bt = (int)v[1];
  p.cap_sxy = (int)v[2];
  p.cap_mv = (int)v[3];
  p.cap_rec = (int)v[4];
  p.cap_col = (int)v[5];
  p.b_max = (int)b_max;
  p.n_tiles = (int)n_tiles;
  p.nbx = (int)v[8];
  p.nby = (int)v[9];
  p.h = (int)v[10];
  p.w = (int)v[11];
  cudaStream_t st = (cudaStream_t)stream;
  resolve_blocks_kernel<<<(unsigned)(c * (1 + n_tiles)), NT, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  resolve_records_kernel<<<(unsigned)(c * n_tiles), NT, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  resolve_gather_kernel<<<(unsigned)n_blk, GT, 0, st>>>(p);
  return (int)cudaGetLastError();
}
