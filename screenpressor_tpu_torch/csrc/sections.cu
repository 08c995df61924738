// Fused SPTC section encode (K1) and decode (K2) for Hopper (sm_90a).
//
// Replaces the Pallas section kernels of screenpressor_tpu/jx/kernels.py:
//   K1  _emit_encode_section / _build_encode_multi / _encode_sections_pallas
//   K2  _emit_decode_section / _build_decode_multi / _decode_sections_pallas
// and computes exactly what jx/coder.py's model_scan + rans_pack and
// decode_section_scan compute (the plain versions in coder.py).
//
// Design. One thread block per (section, stream): blockIdx.x picks the
// section, blockIdx.y the launch slot, whose stream id comes from a device
// int32 index list (the grid over streams of _decode_call's custom-vmap
// rule, jx/kernels.py:685, and of the vmapped K1 of parallel/serving.py).
// The sections of one launch use disjoint table kinds and the streams of a
// launch are distinct (the wrapper checks), so every block owns the tables
// it updates. Tables are [S, rows, alpha] (one stream's set is the S = 1
// case) and are addressed as base + stream * stride, or base + slot *
// stride for a table gathered per slot (the compact colw color table).
// Records, lens, scratch and outputs are per-slot arrays [C, ...]; a
// section's T is the largest over the launched streams, and padding steps
// are masked by each lane's len, so every stream's bytes equal its own
// exact-T encode. The K lanes of a section step in lockstep over T steps x S
// substeps. Per substep:
//   (a) each active lane (one warp per lane, warps stride over lanes)
//       gathers its table row, builds the effective row (mixed kinds: the
//       row scaled to its fill target plus the scaled global row, two warp
//       reductions over the alphabet) and takes the exclusive cum at its
//       symbol (K1) or searches the slot that holds x & MASK (K2);
//   (b) __syncthreads;
//   (c) every active lane adds STEP to its (row, sym) count and row sum
//       (and to the global row of a mixed kind) with atomics;
//   (d) __syncthreads;
//   (e) every touched row rescales exactly once, by the lowest lane index
//       holding that row (inactive lanes are parked on row 0, as in
//       jx/tables.py:update_batch and jx/kernels.py:_row_masks); warp 0
//       rescales the global row when its sum crossed the threshold;
//   (f) __syncthreads before the next substep, which may hit the same kind.
// Tables are int32 in global memory (the color table is 3 x 4096 x 256
// counts, 12.6 MB per stream). The kernel updates them in place: the
// single-stream wrapper passes copies, the serving sessions their own
// [S, ...] tables.
//
// colw (C_COLW, jx/substeps.py ColW): the col section over a compact
// touched-row color table gathered by the wrapper (coder.py
// color_compact_streams). Records carry RGB plus the three compact rows;
// the coding distributions, and so the bytes, are those of C_COL over the
// full table. K1 stages (cum, freq, act) per
// [T, K, S] in a scratch tensor, then each lane packs its rANS bytes in
// reverse in its own thread; K2 reads each lane's payload bytes with the
// clamp of jx/coder.py:149, so a corrupt stream never reads out of bounds.
//
// What bounds it on this card: the serial chain of T x S substeps, three
// block barriers each, not bytes or arithmetic (a 1080p keyframe section
// has K = 32 lanes and a few thousand steps). The design keeps that chain
// short: one launch per frame, no host round trip between sections, and
// only the (row, sym, act) of each lane crosses the barriers.
//
// Integer widths (int32, as in jx/tables.py): at read time a row sum is
// <= PROB_SCALE - STEP, so (PROB_SCALE - 2A) * s < 2^28; every
// `count * scale` product is bounded by `target << 13` < 2^27 because a
// count never exceeds the sum it is scaled by. The rANS state is uint32:
// freq << 17 <= 2^31, and decode wraps like jx's uint32 arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROB_BITS 14
#define PROB_SCALE (1 << PROB_BITS)
#define PMASK (PROB_SCALE - 1)
#define RANS_L (1u << 23)
#define X_MAX_SHIFT (23 - PROB_BITS + 8)
#define RESCALE_SHIFT 13
#define MAX_LANES 512
#define MAX_SUB 4
#define MAX_CHUNK 16  // alphabet <= 512 symbols, 32 per warp pass
#define N_KINDS 8
#define MAX_SECTIONS 8
#define MV_OFFSET 256
#define FULL 0xffffffffu

// table kinds (order of config.TABLE_KINDS)
enum { K_PTYPE, K_NRUN, K_COLOR, K_BT, K_BTN, K_SXY, K_MVFLAG, K_MV };
// record codecs (substeps.py cid)
enum { C_REC, C_COL, C_BT, C_SXY, C_MV, C_COLW };

struct Table {
  int* cnt;     // [S, rows, alpha]
  int* cntsum;  // [S, rows]
  int* gcnt;    // [S, alpha] or null (non-mixed kind)
  int* gsum;    // [S] or null
  int rows, alpha;
  int by_slot;  // indexed by launch slot (gathered per launch), not stream
};

struct Section {
  int codec, k, t, width;   // width: K1 pack capacity / K2 payload length
  int* recs;                // K1: in [C, T, K, W]; K2: out [C, T, K, W]
  const int* lens;          // [C, K] records per lane
  unsigned* iv;             // K1 scratch [C, T, K, S]: cum | freq << 15 | act << 30
  unsigned char* buf;       // K1 out [C, K, cap]
  int* start;               // K1 out [C, K]
  const unsigned char* pay; // K2 in [C, K, L]
};

struct Params {
  Table tab[N_KINDS];
  Section sec[MAX_SECTIONS];
  const int* sidx;  // [C] stream id of each launch slot
  int step, gstep, esc, bits_a, bits_b;
};

// The table set of kind `kind` for launch slot `slot` / stream `stream`.
__device__ __forceinline__ Table table_of(const Params& p, int kind, int slot,
                                          int stream) {
  Table tb = p.tab[kind];
  const size_t s = tb.by_slot ? slot : stream;
  tb.cnt += s * tb.rows * tb.alpha;
  tb.cntsum += s * tb.rows;
  if (tb.gcnt != nullptr) {
    tb.gcnt += s * tb.alpha;
    tb.gsum += s;
  }
  return tb;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int codec_nsub(int c) {
  switch (c) {
    case C_REC: return 2;
    case C_COL: return 3;
    case C_BT: return 2;
    case C_SXY: return 4;
    default: return 3;  // C_MV, C_COLW
  }
}

__device__ __forceinline__ int codec_width(int c) {
  switch (c) {
    case C_REC: return 2;
    case C_COL: return 3;
    case C_BT: return 2;
    case C_SXY: return 4;
    case C_COLW: return 6;
    default: return 2;
  }
}

__device__ __forceinline__ int sub_kind(int c, int j) {
  switch (c) {
    case C_REC: return j == 0 ? K_PTYPE : K_NRUN;
    case C_COL:
    case C_COLW: return K_COLOR;
    case C_BT: return j == 0 ? K_BT : K_BTN;
    case C_SXY: return K_SXY;
    default: return j == 0 ? K_MVFLAG : K_MV;
  }
}

__device__ __forceinline__ int color_ctx(const Params& p, int a, int b) {
  return ((a >> (8 - p.bits_a)) << p.bits_b) | (b >> (8 - p.bits_b));
}

__device__ __forceinline__ int col_row(const Params& p, int j, int f0, int f1,
                                       int s0, int s1) {
  int plane = 1 << (p.bits_a + p.bits_b);
  if (j == 0) return color_ctx(p, s0, s1);
  if (j == 1) return plane + color_ctx(p, s1, f0);
  return 2 * plane + color_ctx(p, f0, f1);
}

// Encode schedule (substeps.py enc_syms): row, symbol and the extra gate of
// substep j from the record fields r[] and the lane state (s0, s1).
__device__ __forceinline__ void enc_sub(const Params& p, int c, int j,
                                        const int* r, int s0, int s1,
                                        int* row, int* sym, bool* extra) {
  *extra = true;
  switch (c) {
    case C_REC:
      *row = j == 0 ? s0 : r[0];
      *sym = j == 0 ? r[0] : r[1] - 1;
      break;
    case C_COL:
      *row = col_row(p, j, r[0], r[1], s0, s1);
      *sym = r[j];
      break;
    case C_COLW:  // compact row from the record (coder.py color_compact_streams)
      *row = r[3 + j];
      *sym = r[j];
      break;
    case C_BT:
      *row = 0;
      *sym = j == 0 ? r[0] : r[1] - 1;
      break;
    case C_SXY:
      *row = j;
      *sym = r[j];
      break;
    default: {
      bool same = r[0] == s0 && r[1] == s1;
      if (j == 0) {
        *row = 0;
        *sym = same;
      } else {
        *row = j - 1;
        *sym = r[j - 1] + MV_OFFSET;
        *extra = !same;
      }
    }
  }
}

// Decode schedule (substeps.py dec_row): row and extra gate of substep j
// from the symbols decoded so far in this record.
__device__ __forceinline__ void dec_sub(const Params& p, int c, int j,
                                        const int* part, int s0, int s1,
                                        int* row, bool* extra) {
  *extra = true;
  switch (c) {
    case C_REC: *row = j == 0 ? s0 : part[0]; break;
    case C_COL: *row = col_row(p, j, part[0], part[1], s0, s1); break;
    case C_BT: *row = 0; break;
    case C_SXY: *row = j; break;
    default:
      *row = j == 0 ? 0 : j - 1;
      if (j > 0) *extra = part[0] != 1;
  }
}

// Each warp thread holds a contiguous chunk of `chunk` symbols of the
// effective row of (tb, row) in v[].
__device__ __forceinline__ void eff_row(const Table& tb, int row, int esc,
                                        int lane, int chunk, int* v) {
  const int a_n = tb.alpha;
  const int* c = tb.cnt + (size_t)row * a_n;
  const int a0 = lane * chunk;
  if (tb.gcnt == nullptr) {
#pragma unroll
    for (int i = 0; i < MAX_CHUNK; ++i)
      v[i] = (i < chunk && a0 + i < a_n) ? c[a0 + i] : 0;
    return;
  }
  const int s = tb.cntsum[row];
  const int target = ((PROB_SCALE - 2 * a_n) * s) / (s + esc);
  const int sc_r = (target << RESCALE_SHIFT) / max(s, 1);
  int part = 0;
#pragma unroll
  for (int i = 0; i < MAX_CHUNK; ++i) {
    v[i] = (i < chunk && a0 + i < a_n) ? (c[a0 + i] * sc_r) >> RESCALE_SHIFT : 0;
    part += v[i];
  }
  const int spare = (PROB_SCALE - a_n) - warp_sum(part);
  const int sc = (spare << RESCALE_SHIFT) / max(*tb.gsum, 1);
#pragma unroll
  for (int i = 0; i < MAX_CHUNK; ++i)
    if (i < chunk && a0 + i < a_n)
      v[i] += max((tb.gcnt[a0 + i] * sc) >> RESCALE_SHIFT, 1);
}

// Adds of one substep: thread-per-lane atomics into the row counts, row
// sums and (mixed kinds) the global row.
__device__ __forceinline__ void table_adds(const Table& tb, int k, int step,
                                           int gstep, const int* srow,
                                           const int* ssym,
                                           const unsigned char* sact) {
  for (int l = threadIdx.x; l < k; l += blockDim.x) {
    if (!sact[l]) continue;
    atomicAdd(tb.cnt + (size_t)srow[l] * tb.alpha + ssym[l], step);
    atomicAdd(tb.cntsum + srow[l], step);
    if (tb.gcnt != nullptr) {
      atomicAdd(tb.gcnt + ssym[l], gstep);
      atomicAdd(tb.gsum, gstep);
    }
  }
}

// Scale-to-fill rescale of one count vector (warp-wide): when its sum is
// above PROB_SCALE - step, scale to PROB_SCALE - step - A, floor 1.
__device__ __forceinline__ void rescale_vec(int* c, int* sum, int a_n, int step,
                                            int lane) {
  const int s = *sum;
  if (s <= PROB_SCALE - step) return;
  const int sc = ((PROB_SCALE - step - a_n) << RESCALE_SHIFT) / s;
  int part = 0;
  for (int a = lane; a < a_n; a += 32) {
    int nv = max((c[a] * sc) >> RESCALE_SHIFT, 1);
    c[a] = nv;
    part += nv;
  }
  part = warp_sum(part);
  if (lane == 0) *sum = part;
}

// Rescale phase: lane l's warp rescales row srow[l] when no lower lane
// index holds the same row.
__device__ __forceinline__ void table_rescale(const Table& tb, int k, int step,
                                              int gstep, const int* srow,
                                              int warp, int nw, int lane) {
  for (int l = warp; l < k; l += nw) {
    const int r = srow[l];
    bool first = true;
    for (int base = 0; base < l; base += 32) {
      int j = base + lane;
      if (__any_sync(FULL, j < l && srow[j] == r)) {
        first = false;
        break;
      }
    }
    if (first) rescale_vec(tb.cnt + (size_t)r * tb.alpha, tb.cntsum + r,
                           tb.alpha, step, lane);
  }
  if (tb.gcnt != nullptr && warp == 0)
    rescale_vec(tb.gcnt, tb.gsum, tb.alpha, gstep, lane);
}

struct LaneShared {
  int s0[MAX_LANES], s1[MAX_LANES];
  int row[MAX_LANES], sym[MAX_LANES];
  unsigned char act[MAX_LANES];
};

__global__ void __launch_bounds__(1024)
encode_kernel(const Params p) {
  const Section& sec = p.sec[blockIdx.x];
  const int slot = blockIdx.y, stream = p.sidx[slot];
  const int k = sec.k, t_n = sec.t, c = sec.codec, cap = sec.width;
  const int s_n = codec_nsub(c), w_n = codec_width(c);
  const int* recs = sec.recs + (size_t)slot * t_n * k * w_n;
  const int* lens = sec.lens + (size_t)slot * k;
  unsigned* iv = sec.iv + (size_t)slot * t_n * k * s_n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __shared__ LaneShared sh;
  for (int l = threadIdx.x; l < k; l += blockDim.x) sh.s0[l] = sh.s1[l] = 0;
  __syncthreads();

  for (int t = 0; t < t_n; ++t) {
    for (int j = 0; j < s_n; ++j) {
      const Table tb = table_of(p, sub_kind(c, j), slot, stream);
      const int chunk = (tb.alpha + 31) >> 5;
      for (int l = warp; l < k; l += nw) {
        const int* r = recs + ((size_t)t * k + l) * w_n;
        const bool lane_active = t < lens[l];
        int row, sym;
        bool extra;
        enc_sub(p, c, j, r, sh.s0[l], sh.s1[l], &row, &sym, &extra);
        const bool act = lane_active && extra;
        row = min(max(row, 0), tb.rows - 1);
        sym = min(max(sym, 0), tb.alpha - 1);
        int v[MAX_CHUNK];
        eff_row(tb, row, p.esc, lane, chunk, v);
        const int a0 = lane * chunk;
        int part = 0, fl = 0;
#pragma unroll
        for (int i = 0; i < MAX_CHUNK; ++i) {
          if (a0 + i < sym) part += v[i];
          if (a0 + i == sym) fl = v[i];
        }
        const int cum = warp_sum(part);
        const int freq = __shfl_sync(FULL, fl, sym / chunk);
        __syncwarp();
        if (lane == 0) {
          iv[((size_t)t * k + l) * s_n + j] =
              (unsigned)cum | ((unsigned)freq << 15) | ((unsigned)act << 30);
          sh.row[l] = act ? row : 0;
          sh.sym[l] = act ? sym : 0;
          sh.act[l] = act;
          if (j == s_n - 1 && lane_active) {  // substeps.py enc_next_state
            if (c == C_REC) sh.s0[l] = r[0];
            else if (c == C_COL) { sh.s0[l] = r[1]; sh.s1[l] = r[2]; }
            else if (c == C_MV) { sh.s0[l] = r[0]; sh.s1[l] = r[1]; }
          }
        }
      }
      __syncthreads();
      table_adds(tb, k, p.step, p.gstep, sh.row, sh.sym, sh.act);
      __syncthreads();
      table_rescale(tb, k, p.step, p.gstep, sh.row, warp, nw, lane);
      __syncthreads();
    }
  }

  // reverse rANS pack, one lane per thread (jx/coder.py:rans_pack)
  unsigned char* buf = sec.buf + (size_t)slot * k * cap;
  int* start = sec.start + (size_t)slot * k;
  for (int l = threadIdx.x; l < k; l += blockDim.x) {
    unsigned x = RANS_L;
    int pos = cap;
    unsigned char* b = buf + (size_t)l * cap;
    for (int t = t_n - 1; t >= 0; --t) {
      for (int j = s_n - 1; j >= 0; --j) {
        const unsigned e = iv[((size_t)t * k + l) * s_n + j];
        const unsigned cm = e & 0x7fff, f = (e >> 15) & 0x7fff, a = e >> 30;
        const unsigned x_max = a ? (f << X_MAX_SHIFT) : 0xffffffffu;
#pragma unroll
        for (int rep = 0; rep < 2; ++rep) {
          if (x >= x_max) {
            b[--pos] = (unsigned char)(x & 0xff);
            x >>= 8;
          }
        }
        const unsigned fx = max(f, 1u);
        const unsigned nx = ((x / fx) << PROB_BITS) + (x % fx) + cm;
        if (a) x = nx;
      }
    }
    for (int i = 3; i >= 0; --i) b[--pos] = (unsigned char)((x >> (8 * i)) & 0xff);
    start[l] = pos;
  }
}

__global__ void __launch_bounds__(1024)
decode_kernel(const Params p) {
  const Section& sec = p.sec[blockIdx.x];
  const int slot = blockIdx.y, stream = p.sidx[slot];
  const int k = sec.k, t_n = sec.t, c = sec.codec, plen = sec.width;
  const int s_n = codec_nsub(c), w_n = codec_width(c);
  int* recs = sec.recs + (size_t)slot * t_n * k * w_n;
  const int* lens = sec.lens + (size_t)slot * k;
  const unsigned char* pay = sec.pay + (size_t)slot * k * plen;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __shared__ LaneShared sh;
  __shared__ unsigned sx[MAX_LANES];
  __shared__ int spos[MAX_LANES];
  __shared__ int spart[MAX_SUB][MAX_LANES];
  for (int l = threadIdx.x; l < k; l += blockDim.x) {
    const unsigned char* q = pay + (size_t)l * plen;
    sx[l] = q[0] | (q[1] << 8) | (q[2] << 16) | ((unsigned)q[3] << 24);
    spos[l] = 4;
    sh.s0[l] = sh.s1[l] = 0;
  }
  __syncthreads();

  for (int t = 0; t < t_n; ++t) {
    for (int j = 0; j < s_n; ++j) {
      const Table tb = table_of(p, sub_kind(c, j), slot, stream);
      const int chunk = (tb.alpha + 31) >> 5;
      for (int l = warp; l < k; l += nw) {
        const bool lane_active = t < lens[l];
        int part_l[MAX_SUB];
#pragma unroll
        for (int i = 0; i < MAX_SUB; ++i) part_l[i] = i < j ? spart[i][l] : 0;
        int row;
        bool extra;
        dec_sub(p, c, j, part_l, sh.s0[l], sh.s1[l], &row, &extra);
        const bool act = lane_active && extra;
        row = min(max(row, 0), tb.rows - 1);
        int v[MAX_CHUNK];
        eff_row(tb, row, p.esc, lane, chunk, v);
        const unsigned x = sx[l];
        const int sf = (int)(x & PMASK);
        // exclusive prefix over the alphabet: chunk sums, warp scan
        int csum = 0;
#pragma unroll
        for (int i = 0; i < MAX_CHUNK; ++i) csum += v[i];
        int incl = csum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        const int excl = incl - csum;
        // sym = #{a in [1, A): cum[a] <= sf} (jx/coder.py:_lookup)
        const int a0 = lane * chunk;
        int pre = excl, cnt = 0;
#pragma unroll
        for (int i = 0; i < MAX_CHUNK; ++i) {
          const int a = a0 + i;
          if (i < chunk && a >= 1 && a < tb.alpha && pre <= sf) ++cnt;
          pre += v[i];
        }
        const int sym = warp_sum(cnt);
        int cum_o = excl, f_o = 0;
#pragma unroll
        for (int i = 0; i < MAX_CHUNK; ++i) {
          if (a0 + i < sym) cum_o += v[i];
          if (a0 + i == sym) f_o = v[i];
        }
        const int owner = sym / chunk;
        const unsigned cum = (unsigned)__shfl_sync(FULL, cum_o, owner);
        const unsigned freq = (unsigned)__shfl_sync(FULL, f_o, owner);
        __syncwarp();
        if (lane == 0) {
          unsigned xx = freq * (x >> PROB_BITS) + (x & PMASK) - cum;
          int pos = spos[l];
          const unsigned char* q = pay + (size_t)l * plen;
#pragma unroll
          for (int rep = 0; rep < 2; ++rep) {
            if (act && xx < RANS_L) {
              xx = (xx << 8) | q[min(pos, plen - 1)];
              ++pos;
            }
          }
          if (act) {
            sx[l] = xx;
            spos[l] = pos;
          }
          const int s = act ? sym : 0;
          spart[j][l] = s;
          sh.row[l] = act ? row : 0;
          sh.sym[l] = s;
          sh.act[l] = act;
          if (j == s_n - 1) {  // substeps.py dec_finish
            part_l[j] = s;
            int* o = recs + ((size_t)t * k + l) * w_n;
            switch (c) {
              case C_REC:
                o[0] = part_l[0];
                o[1] = part_l[1] + 1;
                if (lane_active) sh.s0[l] = part_l[0];
                break;
              case C_COL:
                o[0] = part_l[0];
                o[1] = part_l[1];
                o[2] = part_l[2];
                if (lane_active) { sh.s0[l] = part_l[1]; sh.s1[l] = part_l[2]; }
                break;
              case C_BT:
                o[0] = part_l[0];
                o[1] = part_l[1] + 1;
                break;
              case C_SXY:
                for (int i = 0; i < 4; ++i) o[i] = part_l[i];
                break;
              default: {
                const bool same = part_l[0] == 1;
                const int mx = same ? sh.s0[l] : part_l[1] - MV_OFFSET;
                const int my = same ? sh.s1[l] : part_l[2] - MV_OFFSET;
                o[0] = mx;
                o[1] = my;
                if (lane_active) { sh.s0[l] = mx; sh.s1[l] = my; }
              }
            }
          }
        }
      }
      __syncthreads();
      table_adds(tb, k, p.step, p.gstep, sh.row, sh.sym, sh.act);
      __syncthreads();
      table_rescale(tb, k, p.step, p.gstep, sh.row, warp, nw, lane);
      __syncthreads();
    }
  }
}

// desc layout (int64): [step, gstep, esc, bits_a, bits_b, sidx,
//   8 x (cnt, cntsum, gcnt, gsum, rows, alpha, by_slot),
//   n_sections x (codec, k, t, width, recs, lens, iv, buf, start, pay)]
static int unpack(const long long* d, int n_sec, bool decode, Params* p,
                  int* max_k) {
  if (n_sec < 1 || n_sec > MAX_SECTIONS) return (int)cudaErrorInvalidValue;
  p->step = (int)d[0];
  p->gstep = (int)d[1];
  p->esc = (int)d[2];
  p->bits_a = (int)d[3];
  p->bits_b = (int)d[4];
  p->sidx = (const int*)d[5];
  const long long* q = d + 6;
  for (int i = 0; i < N_KINDS; ++i, q += 7) {
    Table& tb = p->tab[i];
    tb.cnt = (int*)q[0];
    tb.cntsum = (int*)q[1];
    tb.gcnt = (int*)q[2];
    tb.gsum = (int*)q[3];
    tb.rows = (int)q[4];
    tb.alpha = (int)q[5];
    tb.by_slot = (int)q[6];
    if (tb.alpha > 32 * MAX_CHUNK) return (int)cudaErrorInvalidValue;
  }
  *max_k = 1;
  for (int i = 0; i < n_sec; ++i, q += 10) {
    Section& s = p->sec[i];
    s.codec = (int)q[0];
    s.k = (int)q[1];
    s.t = (int)q[2];
    s.width = (int)q[3];
    s.recs = (int*)q[4];
    s.lens = (const int*)q[5];
    s.iv = (unsigned*)q[6];
    s.buf = (unsigned char*)q[7];
    s.start = (int*)q[8];
    s.pay = (const unsigned char*)q[9];
    if (s.k < 1 || s.k > MAX_LANES || s.codec < C_REC || s.codec > C_COLW ||
        (decode && s.codec == C_COLW))
      return (int)cudaErrorInvalidValue;
    *max_k = s.k > *max_k ? s.k : *max_k;
  }
  return 0;
}

static int launch(const long long* desc, int n_sec, int n_streams, void* stream,
                  bool decode) {
  Params p;
  int max_k;
  int err = unpack(desc, n_sec, decode, &p, &max_k);
  if (err) return err;
  if (n_streams < 1 || n_streams > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 32 * (max_k < 32 ? max_k : 32);
  const dim3 grid(n_sec, n_streams);
  if (decode)
    decode_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(p);
  else
    encode_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int sptc_sections_encode(const long long* desc, int n_sec,
                                    int n_streams, void* stream) {
  return launch(desc, n_sec, n_streams, stream, false);
}

extern "C" int sptc_sections_decode(const long long* desc, int n_sec,
                                    int n_streams, void* stream) {
  return launch(desc, n_sec, n_streams, stream, true);
}
