// Fused SPTC section encode (K1) and decode (K2) for Hopper (sm_90a).
//
// Replaces the Pallas section kernels of screenpressor_tpu/jx/kernels.py:
//   K1  _emit_encode_section / _build_encode_multi / _encode_sections_pallas
//   K2  _emit_decode_section / _build_decode_multi / _decode_sections_pallas
// and computes exactly what jx/coder.py's model_scan + rans_pack and
// decode_section_scan compute (the plain versions in coder.py).
//
// Both kernels. One thread block per (section, stream): blockIdx.x picks
// the section, blockIdx.y the launch slot, whose stream id comes from a
// device int32 index list (the grid over streams of _decode_call's
// custom-vmap rule, jx/kernels.py:685, and of the vmapped K1 of
// parallel/serving.py). The sections of one launch use disjoint table kinds
// and the streams of a launch are distinct (the wrapper checks), so every
// block owns the tables it updates. Tables are [S, rows, alpha] (one
// stream's set is the S = 1 case) and are addressed as base + stream *
// stride, or base + slot * stride for a table gathered per slot (the
// compact colw color table). Records, lens, scratch and outputs are
// per-slot arrays [C, ...]; a section's T is the largest over the launched
// streams, and padding steps are masked by each lane's len, so every
// stream's bytes equal its own exact-T encode. The K lanes of a section
// step in lockstep over T steps x S substeps, one warp per lane (warps
// stride over lanes when K > 32). Each substep reads the tables, then
// applies one batched update: all adds of the substep land, then each
// touched row rescales once from its post-add counts, by the lowest lane
// index holding that row (inactive lanes are parked on row 0, as in
// jx/tables.py:update_batch and jx/kernels.py:_row_masks), and the global
// row of a mixed kind rescales when its sum crossed the threshold.
//
// K1 (encode_kernel), per substep: (a) each active lane gathers its row
// from global memory, builds the effective row (mixed kinds: the row
// scaled to its fill target plus the scaled global row, two warp
// reductions over the alphabet) and takes the exclusive cum at its symbol;
// (b) __syncthreads; (c) global atomics add STEP to each (row, sym), row
// sum and global row; (d) __syncthreads; (e) the rescales; (f)
// __syncthreads. It stages (cum, freq, act) per [T, K, S] in a scratch
// tensor, then each lane packs its rANS bytes in reverse in its own thread.
// colw (C_COLW, jx/substeps.py ColW): the col section over a compact
// touched-row color table gathered by the wrapper (coder.py
// color_compact_streams); records carry RGB plus the three compact rows,
// and the bytes are those of C_COL over the full table.
//
// K2 (decode_kernel) replaces _decode_sections_pallas (jx/kernels.py:577),
// _decode_call (:662) and its stream-grid rule (:685). What bounds it: the
// serial chain of T x S substeps, not bytes (a 1080p keyframe rec section
// reads ~3 KB of payload and ~6 KB of tables and writes 0.7 MB of records
// over 2,824 x 2 substeps, a fraction of a microsecond of memory time). So
// each substep's critical path is kept on chip:
//   - at block start the block copies its section's tables into dynamic
//     shared memory (k2_kind_ints): every kind but color whole (ptype 6x6
//     + nrun 6x256 with its global row: 7.4 KB; bt/btn 1.0 KB; sxy 0.3 KB;
//     mvflag/mv 4.1 KB), and of color the 12,288 row sums and the global
//     row (50.2 KB) plus one 256-count scratch row per warp (32 KB); the
//     color count rows stay in global memory / L2. Every array starts on
//     16 bytes, so a row of 256 or 512 counts moves as 16-byte vectors. It
//     writes them back at block end. Above 48 KB the launcher opts in once
//     per instantiation;
//   - the payload is staged in shared memory too: whole when the
//     section's K x L bytes fit 48 KB (a 1080p keyframe's are ~4.5 KB),
//     else as a per-lane window that slides forward in phase (b), so the
//     rANS renormalisation never reads global memory. Reads clamp to the
//     lane's payload (jx/coder.py:149): a corrupt stream never reads out of
//     bounds and never hangs;
//   - (a) each lane's warp builds the effective row and finds the symbol
//     whose slot holds x & MASK (a warp scan, one ballot for the owning
//     thread), advances the state, and lane 0 publishes (row, key = row <<
//     10 | sym or -1); with a warp per lane (K <= 32) the warp leaves a
//     color row's raw counts in its scratch row for phase (b).
//     __syncthreads;
//   - (b) the warp of the lowest lane on each row applies every add on
//     that row with shared-memory atomics (into the shared row, or for
//     color into its scratch row, filled by phase (a) or one L2 read),
//     rescales the row once if its sum crossed PROB_SCALE - STEP and stores
//     it once (one L2 row store for color); the last warp applies the
//     active lanes' adds to the shared global row and rescales it; windows
//     that ran low slide forward. __syncthreads.
// Two barriers per substep, no global atomics, and for color one L2 row
// read and one row store. Each substep works with 1, 8 or 16 symbols a
// thread (alphabets up to 32, 256, 512); a launch that holds the 512-symbol
// mv kind takes the instantiation that can hold 16. Registers (nvcc
// -Xptxas -v, sm_90a, under __launch_bounds__(1024), so at most 64 a
// thread): decode_kernel<8> 64 registers, no spills; decode_kernel<16> 64
// registers, 216 B of spill stores and 384 B of spill loads (the P-frame
// launches); both 24,768 B of static shared memory. What remains of a
// substep is a latency chain (shared loads, three integer divisions and
// the warp scan of a mixed kind, the owner's atomics and rescale) plus, at
// 32 lanes, 32 warps' effective-row work contending for the SM's four
// schedulers; PERF.md gives the time per substep at 1, 8 and 32 lanes.
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

// ---------------------------------------------------------------------------
// K2: fused section decode, tables in shared memory (source note above)
// ---------------------------------------------------------------------------

#define PAY_STAGE_BYTES (48 * 1024)  // payload bytes staged whole per block

// Table kind of substep j of a decode codec, -1 past its substeps (the
// host sizes the launch's shared memory from it).
__host__ __device__ __forceinline__ int k2_kind(int c, int j) {
  switch (c) {
    case C_REC: return j == 0 ? K_PTYPE : j == 1 ? K_NRUN : -1;
    case C_COL: return j < 3 ? K_COLOR : -1;
    case C_BT: return j == 0 ? K_BT : j == 1 ? K_BTN : -1;
    case C_SXY: return j < 4 ? K_SXY : -1;
    default: return j == 0 ? K_MVFLAG : j < 3 ? K_MV : -1;
  }
}

__host__ __device__ __forceinline__ int k2_round4(int n) { return (n + 3) & ~3; }

// Shared-memory ints of one kind's tables: the counts (except color's,
// which stay in global memory / L2), the row sums and a mixed kind's
// global row and its sum, each array 16-byte aligned.
__host__ __device__ __forceinline__ int k2_kind_ints(int kind, int rows, int alpha,
                                                     bool mixed) {
  return (kind == K_COLOR ? 0 : k2_round4(rows * alpha)) + k2_round4(rows) +
         (mixed ? k2_round4(alpha + 1) : 0);
}

// Bytes of payload each lane keeps in shared memory: all of it when the
// section's K x L bytes fit PAY_STAGE_BYTES, else a window that slides
// (at least 96 bytes, as K <= MAX_LANES; a substep reads at most 2).
__host__ __device__ __forceinline__ int k2_window(int k, int plen) {
  return (long long)k * plen <= PAY_STAGE_BYTES ? plen : (PAY_STAGE_BYTES / k) & ~3;
}

// Shared-memory ints of a section's tables, kinds in substep order.
__host__ __device__ __forceinline__ int k2_layout_ints(const Table* tab, int c) {
  int n = 0, done = 0;
  for (int j = 0; j < MAX_SUB; ++j) {
    const int kind = k2_kind(c, j);
    if (kind < 0 || ((done >> kind) & 1)) continue;
    done |= 1 << kind;
    n += k2_kind_ints(kind, tab[kind].rows, tab[kind].alpha, tab[kind].gcnt != nullptr);
  }
  return n;
}

// Ints of the warps' scratch rows (color: a row of adds per warp).
__host__ __device__ __forceinline__ int k2_scratch_ints(const Table* tab, int c, int nw) {
  return c == C_COL ? nw * tab[K_COLOR].alpha : 0;
}

// Dynamic shared memory of a section's block of nw warps: its tables, the
// scratch rows, then K x window payload bytes.
__host__ __device__ __forceinline__ int k2_smem_bytes(const Table* tab, const Section& s,
                                                      int nw) {
  const int ints = k2_layout_ints(tab, s.codec) + k2_scratch_ints(tab, s.codec, nw);
  return 4 * ((ints + 3) & ~3) + s.k * k2_window(s.k, s.width);
}

struct DTable {
  int* cnt;     // [rows, alpha]: shared, or global for color
  int* cntsum;  // [rows] shared
  int* gcnt;    // [alpha] shared, or null (non-mixed kind)
  int* gsum;    // shared
  int kind, rows, alpha;
};

struct K2Lanes {
  int s0[MAX_LANES], s1[MAX_LANES];  // record state (dec_finish)
  unsigned x[MAX_LANES];             // rANS state
  int pos[MAX_LANES], wbase[MAX_LANES], len[MAX_LANES];
  int part[MAX_SUB][MAX_LANES];      // symbols of the current record
  int row[MAX_LANES];                // row, inactive lanes parked on 0
  int key[MAX_LANES];                // row << 10 | sym of an active lane, else -1
  DTable tab[MAX_SUB];               // the substeps' tables
};

// A thread's C symbols of a row: symbols a0 .. a0 + C - 1 of the n in
// the row, C <= chunk (WHOLE: n == 32 * C and src 16-byte aligned, so the
// accesses are unpredicated 16-byte vectors).
template <int C, bool WHOLE>
__device__ __forceinline__ void k2_load(const int* src, int a0, int chunk, int n, int* v) {
  if (WHOLE) {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const int4 q = *reinterpret_cast<const int4*>(src + a0 + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = (i < chunk && a0 + i < n) ? src[a0 + i] : 0;
  }
}

template <int C, bool WHOLE>
__device__ __forceinline__ void k2_store(int* dst, int a0, int chunk, int n, const int* v) {
  if (WHOLE) {
#pragma unroll
    for (int i = 0; i < C; i += 4)
      *reinterpret_cast<int4*>(dst + a0 + i) = make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (i < chunk && a0 + i < n) dst[a0 + i] = v[i];
  }
}

// Phase (a) of one lane, warp-wide (C symbols a thread, C >= the row's
// chunk): the symbol whose slot of the effective row of (tb, row) holds
// x & PMASK, with its cum and freq; the row's raw counts go to stash
// unless it is null. Every
// effective frequency is >= 1 (counts floor at 1, a mixed row's global
// part at 1), so cum rises strictly and the symbol is the largest a with
// cum[a] <= x & PMASK, as jx/coder.py:_lookup counts it.
template <int C, bool WHOLE>
__device__ __forceinline__ void k2_lookup(const DTable& tb, int row, int esc, int lane,
                                          unsigned x, int* stash, int* sym_out,
                                          unsigned* cum_out, unsigned* freq_out) {
  const int a_n = tb.alpha, chunk = WHOLE ? C : C == 1 ? 1 : (a_n + 31) >> 5;
  const int a0 = lane * chunk;
  int raw[C];
  k2_load<C, WHOLE>(tb.cnt + (size_t)row * a_n, a0, chunk, a_n, raw);
  if (stash != nullptr) k2_store<C, WHOLE>(stash, a0, chunk, a_n, raw);
  const int s = tb.cntsum[row];
  int v[C];
  if (tb.gcnt == nullptr) {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = raw[i];
  } else {  // row scaled to its fill target plus the scaled global row
    const int target = ((PROB_SCALE - 2 * a_n) * s) / (s + esc);
    const int sc_r = (target << RESCALE_SHIFT) / max(s, 1);
    int rs = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      v[i] = (raw[i] * sc_r) >> RESCALE_SHIFT;
      rs += v[i];
    }
    const int spare = (PROB_SCALE - a_n) - warp_sum(rs);
    const int sc = (spare << RESCALE_SHIFT) / max(*tb.gsum, 1);
    if (WHOLE) {
#pragma unroll
      for (int i = 0; i < C; i += 4) {
        const int4 q = *reinterpret_cast<const int4*>(tb.gcnt + a0 + i);
        v[i] += max((q.x * sc) >> RESCALE_SHIFT, 1);
        v[i + 1] += max((q.y * sc) >> RESCALE_SHIFT, 1);
        v[i + 2] += max((q.z * sc) >> RESCALE_SHIFT, 1);
        v[i + 3] += max((q.w * sc) >> RESCALE_SHIFT, 1);
      }
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (i < chunk && a0 + i < a_n) v[i] += max((tb.gcnt[a0 + i] * sc) >> RESCALE_SHIFT, 1);
    }
  }
  int csum = 0;
#pragma unroll
  for (int i = 0; i < C; ++i) csum += v[i];
  int incl = csum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  const int excl = incl - csum, sf = (int)(x & PMASK);
  const int owner = 31 - __clz(__ballot_sync(FULL, a0 < a_n && excl <= sf));
  int c_i = excl, sy = a0, cm = excl, fq = v[0];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if ((WHOLE || (i < chunk && a0 + i < a_n)) && c_i <= sf) {
      sy = a0 + i;
      cm = c_i;
      fq = v[i];
    }
    c_i += v[i];
  }
  *sym_out = __shfl_sync(FULL, sy, owner);
  *cum_out = (unsigned)__shfl_sync(FULL, cm, owner);
  *freq_out = (unsigned)__shfl_sync(FULL, fq, owner);
}

// Phase (b) for the owner of row r, warp-wide: every active lane on the
// row adds STEP to its symbol with a shared-memory atomic, into the row
// itself when it lives in shared memory, else into the warp's scratch row,
// which holds the row's counts (color); then the row rescales once if its
// sum crossed PROB_SCALE - STEP (scale to fill PROB_SCALE - STEP - A,
// floor 1) and is stored. s is the row's sum before the adds.
template <int C, bool WHOLE>
__device__ __forceinline__ void k2_row_update(const DTable& tb, int r, int s, int* scratch,
                                              const int* key, int k, int step, int lane) {
  const int a_n = tb.alpha, chunk = WHOLE ? C : C == 1 ? 1 : (a_n + 31) >> 5;
  const int a0 = lane * chunk;
  int* row = tb.cnt + (size_t)r * a_n;
  int* acc = scratch != nullptr ? scratch : row;
  if (scratch != nullptr) __syncwarp();
  int cv[C];
  int n_add = 0;
  for (int base = 0; base < k; base += 32) {
    const int w = base + lane < k ? key[base + lane] : -1;
    const bool m = (w >> 10) == r;
    if (m) atomicAdd(acc + (w & 1023), step);
    n_add += __popc(__ballot_sync(FULL, m));
  }
  s += step * n_add;
  const bool resc = s > PROB_SCALE - step;
  if (n_add == 0 && !resc) return;
  __syncwarp();
  k2_load<C, WHOLE>(acc, a0, chunk, a_n, cv);
  if (resc) {
    const int sc = ((PROB_SCALE - step - a_n) << RESCALE_SHIFT) / s;
    int part = 0;
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (WHOLE || (i < chunk && a0 + i < a_n)) {
        cv[i] = max((cv[i] * sc) >> RESCALE_SHIFT, 1);
        part += cv[i];
      }
    s = warp_sum(part);
  }
  if (resc || scratch != nullptr) k2_store<C, WHOLE>(row, a0, chunk, a_n, cv);
  if (lane == 0) tb.cntsum[r] = s;
}

template <int CH>
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
  const int win_n = k2_window(k, plen);
  __shared__ K2Lanes sh;
  extern __shared__ int4 k2_dyn[];
  int* dyn = reinterpret_cast<int*>(k2_dyn);

  // lay the section's kinds out in shared memory and copy them in
  if (threadIdx.x == 0) {
    int off = 0, done = 0;
    for (int j = 0; j < s_n; ++j) {
      const int kind = k2_kind(c, j);
      const Table g = table_of(p, kind, slot, stream);
      DTable& d = sh.tab[j];
      d.kind = kind;
      d.rows = g.rows;
      d.alpha = g.alpha;
      if (done & (1 << kind)) {  // a kind of an earlier substep
        for (int i = 0; i < j; ++i)
          if (sh.tab[i].kind == kind) d = sh.tab[i];
        continue;
      }
      done |= 1 << kind;
      d.cnt = kind == K_COLOR ? g.cnt : dyn + off;
      off += kind == K_COLOR ? 0 : k2_round4(g.rows * g.alpha);
      d.cntsum = dyn + off;
      off += k2_round4(g.rows);
      d.gcnt = g.gcnt == nullptr ? nullptr : dyn + off;
      d.gsum = g.gcnt == nullptr ? nullptr : dyn + off + g.alpha;
      off += g.gcnt == nullptr ? 0 : k2_round4(g.alpha + 1);
    }
  }
  const int scratch_off = k2_layout_ints(p.tab, c);
  unsigned char* win = reinterpret_cast<unsigned char*>(k2_dyn) +
                       4 * ((scratch_off + k2_scratch_ints(p.tab, c, nw) + 3) & ~3);
  __syncthreads();
  for (int j = 0; j < s_n; ++j) {
    const DTable& d = sh.tab[j];
    if (j > 0 && d.cntsum == sh.tab[j - 1].cntsum) continue;
    const Table g = table_of(p, d.kind, slot, stream);
    if (d.kind != K_COLOR)
      for (int i = threadIdx.x; i < d.rows * d.alpha; i += blockDim.x) d.cnt[i] = g.cnt[i];
    for (int i = threadIdx.x; i < d.rows; i += blockDim.x) d.cntsum[i] = g.cntsum[i];
    if (d.gcnt != nullptr) {
      for (int i = threadIdx.x; i < d.alpha; i += blockDim.x) d.gcnt[i] = g.gcnt[i];
      if (threadIdx.x == 0) *d.gsum = *g.gsum;
    }
  }
  // lane state and the payload (whole, or each lane's first window)
  for (int l = threadIdx.x; l < k; l += blockDim.x) {
    const unsigned char* q = pay + (size_t)l * plen;
    sh.x[l] = q[0] | (q[1] << 8) | (q[2] << 16) | ((unsigned)q[3] << 24);
    sh.pos[l] = 4;
    sh.wbase[l] = 0;
    sh.len[l] = lens[l];
    sh.s0[l] = sh.s1[l] = 0;
  }
  for (int i = threadIdx.x; i < k * win_n; i += blockDim.x) {
    const int l = i / win_n, o = i - l * win_n;
    win[i] = pay[(size_t)l * plen + min(o, plen - 1)];
  }
  __syncthreads();

  // with a warp per lane, phase (a) leaves its color row's raw counts in
  // the warp's scratch row for phase (b)
  const bool own_warp = k <= nw;
  int* scratch = dyn + scratch_off + warp * p.tab[K_COLOR].alpha;
  int kept_row = -1;

  for (int t = 0; t < t_n; ++t) {
    for (int j = 0; j < s_n; ++j) {
      const DTable tb = sh.tab[j];
      // symbols a thread: 1 for alphabets up to 32, 8 up to 256, else CH;
      // whole: the alphabet fills the warp's symbols and the rows are
      // 16-byte aligned (shared arrays are laid out so; color's base is
      // checked), so rows move as 16-byte vectors without predicates
      const int width = tb.alpha <= 32 ? 1 : tb.alpha <= 256 ? 8 : CH;
      const bool whole = tb.alpha == 32 * width && (reinterpret_cast<size_t>(tb.cnt) & 15) == 0;
      // (a) effective row, symbol search, rANS advance from shared bytes
      for (int l = warp; l < k; l += nw) {
        const bool lane_active = t < sh.len[l];
        int part_l[MAX_SUB];
#pragma unroll
        for (int i = 0; i < MAX_SUB; ++i) part_l[i] = i < j ? sh.part[i][l] : 0;
        int row;
        bool extra;
        dec_sub(p, c, j, part_l, sh.s0[l], sh.s1[l], &row, &extra);
        const bool act = lane_active && extra;
        row = min(max(row, 0), tb.rows - 1);
        const unsigned x = sh.x[l];
        int sym;
        unsigned cum, freq;
        int* stash = tb.kind == K_COLOR && own_warp ? scratch : nullptr;
        if (width == 1) {
          k2_lookup<1, false>(tb, row, p.esc, lane, x, nullptr, &sym, &cum, &freq);
        } else if (width == 8) {
          if (whole)
            k2_lookup<8, true>(tb, row, p.esc, lane, x, stash, &sym, &cum, &freq);
          else
            k2_lookup<8, false>(tb, row, p.esc, lane, x, stash, &sym, &cum, &freq);
        } else if (whole) {
          k2_lookup<CH, true>(tb, row, p.esc, lane, x, nullptr, &sym, &cum, &freq);
        } else {
          k2_lookup<CH, false>(tb, row, p.esc, lane, x, nullptr, &sym, &cum, &freq);
        }
        kept_row = row;
        // every thread of the warp advances the state; the bytes come from
        // the lane's shared window, clamped to the payload (jx/coder.py:149)
        unsigned xx = freq * (x >> PROB_BITS) + (x & PMASK) - cum;
        int pos = sh.pos[l];
        const int wb = sh.wbase[l];
        const unsigned char* wq = win + (size_t)l * win_n;
#pragma unroll
        for (int rep = 0; rep < 2; ++rep) {
          if (act && xx < RANS_L) {
            xx = (xx << 8) | wq[min(pos, plen - 1) - wb];
            ++pos;
          }
        }
        __syncwarp();
        if (lane == 0) {
          if (act) {
            sh.x[l] = xx;
            sh.pos[l] = pos;
          }
          const int sv = act ? sym : 0;
          sh.part[j][l] = sv;
          sh.row[l] = act ? row : 0;
          sh.key[l] = act ? (row << 10) | sym : -1;
          if (j == s_n - 1) {  // substeps.py dec_finish
            part_l[j] = sv;
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
      // (b) the warp of the lowest lane on each row sums the row's adds,
      // rescales it once and stores it; one warp updates the global row;
      // windows that ran low slide forward
      for (int l = warp; l < k; l += nw) {
        const int r = sh.row[l];
        bool first = true;
        for (int base = 0; base < l; base += 32) {
          const int jj = base + lane;
          if (__any_sync(FULL, jj < l && sh.row[jj] == r)) {
            first = false;
            break;
          }
        }
        if (first) {
          int* scr = nullptr;
          if (tb.kind == K_COLOR) {  // 256 symbols, the counts in the scratch row
            scr = scratch;
            if (!own_warp || kept_row != r) {
              int cv[8];
              k2_load<8, false>(tb.cnt + (size_t)r * tb.alpha, lane * 8, 8, tb.alpha, cv);
              k2_store<8, false>(scr, lane * 8, 8, tb.alpha, cv);
            }
          }
          const int s = tb.cntsum[r];
          if (width == 1) {
            k2_row_update<1, false>(tb, r, s, scr, sh.key, k, p.step, lane);
          } else if (width == 8) {
            if (whole)
              k2_row_update<8, true>(tb, r, s, scr, sh.key, k, p.step, lane);
            else
              k2_row_update<8, false>(tb, r, s, scr, sh.key, k, p.step, lane);
          } else if (whole) {
            k2_row_update<CH, true>(tb, r, s, nullptr, sh.key, k, p.step, lane);
          } else {
            k2_row_update<CH, false>(tb, r, s, nullptr, sh.key, k, p.step, lane);
          }
        }
        if (win_n < plen) {
          const int pos = sh.pos[l], wb = sh.wbase[l];
          if (pos + 2 > wb + win_n && wb + win_n < plen) {
            unsigned char* wq = win + (size_t)l * win_n;
            const unsigned char* q = pay + (size_t)l * plen;
            for (int i = lane; i < win_n; i += 32) wq[i] = q[min(pos + i, plen - 1)];
            if (lane == 0) sh.wbase[l] = pos;
          }
        }
      }
      if (tb.gcnt != nullptr && warp == nw - 1) {
        int n_act = 0;
        for (int base = 0; base < k; base += 32) {
          const int w = base + lane < k ? sh.key[base + lane] : -1;
          if (w >= 0) atomicAdd(tb.gcnt + (w & 1023), p.gstep);
          n_act += __popc(__ballot_sync(FULL, w >= 0));
        }
        __syncwarp();
        int gs = *tb.gsum + p.gstep * n_act;
        if (gs > PROB_SCALE - p.gstep) {
          const int sc = ((PROB_SCALE - p.gstep - tb.alpha) << RESCALE_SHIFT) / gs;
          int part = 0;
          for (int a = lane; a < tb.alpha; a += 32) {
            const int nv = max((tb.gcnt[a] * sc) >> RESCALE_SHIFT, 1);
            tb.gcnt[a] = nv;
            part += nv;
          }
          gs = warp_sum(part);
        }
        __syncwarp();
        if (lane == 0) *tb.gsum = gs;
      }
      __syncthreads();
    }
  }

  // write the shared tables back
  for (int j = 0; j < s_n; ++j) {
    const DTable& d = sh.tab[j];
    if (j > 0 && d.cntsum == sh.tab[j - 1].cntsum) continue;
    const Table g = table_of(p, d.kind, slot, stream);
    if (d.kind != K_COLOR)
      for (int i = threadIdx.x; i < d.rows * d.alpha; i += blockDim.x) g.cnt[i] = d.cnt[i];
    for (int i = threadIdx.x; i < d.rows; i += blockDim.x) g.cntsum[i] = d.cntsum[i];
    if (d.gcnt != nullptr) {
      for (int i = threadIdx.x; i < d.alpha; i += blockDim.x) g.gcnt[i] = d.gcnt[i];
      if (threadIdx.x == 0) *g.gsum = *d.gsum;
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

// K2's dynamic shared memory: the largest need of the launch's sections;
// the opt-in above 48 KB is set once per instantiation, to the most a
// block can take beside the kernel's static shared memory.
template <int CH>
static int launch_decode(const Params& p, int n_sec, dim3 grid, int threads,
                         cudaStream_t stream) {
  static int max_dyn = -1;
  if (max_dyn < 0) {
    cudaFuncAttributes fa;
    int err = (int)cudaFuncGetAttributes(&fa, decode_kernel<CH>);
    if (err) return err;
    int dev, optin;
    err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!err) err = (int)cudaFuncSetAttribute(decode_kernel<CH>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              optin - (int)fa.sharedSizeBytes);
    if (err) return err;
    max_dyn = optin - (int)fa.sharedSizeBytes;
  }
  int smem = 0;
  for (int i = 0; i < n_sec; ++i) {
    const int b = k2_smem_bytes(p.tab, p.sec[i], threads / 32);
    smem = b > smem ? b : smem;
  }
  if (smem > max_dyn) return (int)cudaErrorInvalidValue;
  decode_kernel<CH><<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
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
  if (decode) {
    bool wide = false;  // an alphabet above 256 needs 16 symbols a thread
    for (int i = 0; i < n_sec; ++i)
      for (int j = 0; j < MAX_SUB; ++j) {
        const int kind = k2_kind(p.sec[i].codec, j);
        wide |= kind >= 0 && p.tab[kind].alpha > 256;
      }
    return wide ? launch_decode<16>(p, n_sec, grid, threads, (cudaStream_t)stream)
                : launch_decode<8>(p, n_sec, grid, threads, (cudaStream_t)stream);
  }
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
