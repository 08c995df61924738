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
// stride over lanes when K > 32). One substep's batched update
// (jx/tables.py:update_batch): all adds of the substep land, then each
// touched row rescales once from its post-add counts, and the global row of
// a mixed kind rescales when its sum crossed the threshold.
//
// What bounds both: the serial chain of T x S substeps, not bytes (a 1080p
// keyframe rec section moves ~0.7 MB of records, ~3 KB of payload and ~6 KB
// of tables over 2,824 x 2 substeps, a fraction of a microsecond of memory
// time). So each substep's critical path is kept on chip.
//
// Tables on chip (tables_layout): at block start the block copies its
// section's tables into dynamic shared memory: every kind but color whole
// (ptype 6x6 + nrun 6x256 with its global row: 7.4 KB; bt/btn 1.0 KB; sxy
// 0.3 KB; mvflag/mv 4.1 KB); of color the row sums and the global row
// (12,288 sums: 50.2 KB) while its count rows stay in global memory / L2;
// and a compact colw color table of at most 256 rows (K1 only) whole, as
// 16-bit counts (128 KB: a stored count never exceeds PROB_SCALE), with the
// adds and the rescale done in an int32 scratch row. Every array starts on
// 16 bytes, so a row of 256 or 512 counts moves as 16-byte vectors. The
// block writes the tables back at its end. Above 48 KB the launcher opts in
// once per instantiation; a launch that needs more than the card allows is
// refused.
//
// The update, phase (b) of a barrier interval: the warp of one active lane
// on each touched row (row_owner: the first in lane order, rotated per
// substep so the owners of merged substeps spread over the warps) applies
// every add on that row with shared-memory atomics (into the shared row, or
// for color into a scratch row that holds the row's counts), rescales the
// row once if its sum crossed PROB_SCALE - STEP and stores it once; the
// last warp applies the active lanes' adds to the shared global row and
// rescales it. A row that only parked (inactive) lanes touch needs nothing:
// a stored row sum never exceeds the threshold. No global atomics.
//
// K1 (encode_kernel). Encode knows what decode does not: the (row, symbol)
// of every substep of a step comes from the record and the lane state,
// never from coded data. So
//   - rec, bt, sxy, mv: the substeps of one step touch disjoint kinds or
//     rows, and the whole step is ONE interval: (a) each lane's warp looks
//     up all its substeps (the partial sum of the effective row below the
//     symbol and the frequency at it: one packed warp reduction, two for a
//     mixed kind), (b) the owners update the rows of all substeps. Two
//     barriers a step, not 3 x S;
//   - col / colw: the three substeps read three disjoint planes of count
//     rows, so at the step start each warp brings its three rows on chip at
//     once (cp.async from L2 into its three scratch rows, which phase (b)
//     then uses as they are; or 16-byte reads of the 16-bit shared table)
//     and computes their scaled row parts. Only the global row chains the
//     substeps: per substep (a) the global part of the lookup, barrier, (b)
//     the row owners and the global row update, barrier: two barriers a
//     substep;
//   - a lane's record for the next step is loaded a step ahead (one warp
//     per lane), lens are staged in shared memory, an inactive lane skips
//     its lookups.
// Each lane's intervals (cum | freq << 15 | act << 30) go to a scratch
// tensor [K, T * S], a lane's entries contiguous. Then the reverse rANS
// pack, a warp per lane: 32 entries a pass with one coalesced read; each
// thread prepares its entry's renormalisation bound and the exact
// reciprocal of its frequency (Alverson's division by an invariant, as
// rans_byte.h's RansEncSymbol: q = umulhi(x, rcp) >> shift is x / freq for
// x < 2^31, which holds below x_max = freq << 17 <= 2^31); thread 0 walks
// the 32 entries from shared memory without a division and stages the
// bytes, which the warp stores together.
// colw (C_COLW, jx/substeps.py ColW): the col section over a compact
// touched-row color table gathered by the wrapper (coder.py
// color_compact_streams); records carry RGB plus the three compact rows,
// and the bytes are those of C_COL over the full table. colw256 lives in
// shared memory; colw1024 (512 KB even at 16 bits) stays in L2 like col.
// Shared memory of a K1 block of 32 warps: static 30,944 B (lane state,
// keys, the col row parts); dynamic col 50.2 KB + 96 KB of scratch rows,
// colw1024 5.1 KB + 96 KB, colw256 130.1 KB + 32 KB (one scratch row a
// warp), others their tables (or the pack's 18 KB). A block has at least 8
// warps, so that a section of few lanes still copies its tables quickly and
// its global row has a warp of its own. Registers (nvcc -Xptxas -v, sm_90a,
// __launch_bounds__(1024), so at most 64 a thread): encode_kernel<8> and
// encode_kernel<16> (the launches that hold mv) 64 registers, no spills
// (the 16-bit store is a template flag of row_update). What remains of
// a step at 32 lanes: phase (a) is bound by the SM's integer issue rate (32
// warps' effective-row arithmetic on four schedulers), phase (b) by the
// owner's latency chain; PERF.md has the times per substep at 1, 8 and 32
// lanes.
//
// K2 (decode_kernel) replaces _decode_sections_pallas (jx/kernels.py:577),
// _decode_call (:662) and its stream-grid rule (:685). A decoder's rows
// depend on the symbols it decodes, so every substep is an interval:
//   - the payload is staged in shared memory: whole when the section's
//     K x L bytes fit 48 KB (a 1080p keyframe's are ~4.5 KB), else as a
//     per-lane window that slides forward in phase (b), so the rANS
//     renormalisation never reads global memory. Reads clamp to the lane's
//     payload (jx/coder.py:149): a corrupt stream never reads out of bounds
//     and never hangs;
//   - (a) each lane's warp builds the effective row and finds the symbol
//     whose slot holds x & MASK (a warp scan, one ballot for the owning
//     thread), advances the state, and lane 0 publishes (row, key = row <<
//     10 | sym or -1); with a warp per lane (K <= 32) the warp leaves a
//     color row's raw counts in its scratch row for phase (b).
//     __syncthreads;
//   - (b) the update above, by the warp of the lowest lane on each row
//     (inactive lanes parked on row 0, as jx/kernels.py:_row_masks); windows
//     that ran low slide forward. __syncthreads.
// Two barriers per substep, and for color one L2 row read and one row
// store. Each substep works with 1, 8 or 16 symbols a thread (alphabets up
// to 32, 256, 512); a launch that holds the 512-symbol mv kind takes the
// instantiation that can hold 16. Registers (as above): decode_kernel<8> 64
// registers, 8 B of spill stores and 12 B of spill loads; decode_kernel<16>
// 64 registers, 216 B and 384 B; both 24,800 B of static shared memory. What
// remains of a substep is a latency chain (shared loads, three integer
// divisions and the warp scan of a mixed kind, the owner's atomics and
// rescale) plus, at 32 lanes, 32 warps' effective-row work contending for
// the SM's four schedulers; PERF.md gives the time per substep at 1, 8 and
// 32 lanes for both kernels.
//
// Integer widths (int32, as in jx/tables.py): at read time a row sum is
// <= PROB_SCALE - STEP, so (PROB_SCALE - 2A) * s < 2^28; every
// `count * scale` product is bounded by `target << 13` < 2^27 because a
// count never exceeds the sum it is scaled by. Two such sums travel in one
// warp reduction as lo | hi << 16: each is at most PROB_SCALE. The rANS
// state is uint32: freq << 17 <= 2^31, and decode wraps like jx's uint32
// arithmetic.

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
#define COLOR_ALPHA 256        // the color alphabet: 8 symbols a thread
#define CHIP_COLOR_ROWS 256    // a compact color table up to this lives on chip
#define PAY_STAGE_BYTES (48 * 1024)  // K2: payload bytes staged whole per block
#define PACK_WARP_BYTES (32 * 16 + 64)  // K1 pack: 32 entries' constants, 64 bytes

// table kinds (order of config.TABLE_KINDS)
enum { K_PTYPE, K_NRUN, K_COLOR, K_BT, K_BTN, K_SXY, K_MVFLAG, K_MV };
// record codecs (substeps.py cid)
enum { C_REC, C_COL, C_BT, C_SXY, C_MV, C_COLW };
// where a kind's counts live during a launch: global memory / L2, shared
// memory as int32, shared memory as 16-bit counts
enum { HOME_L2, HOME_SMEM, HOME_SMEM16 };

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
  unsigned* iv;             // K1 scratch [C, K, T * S]: cum | freq << 15 | act << 30
  unsigned char* buf;       // K1 out [C, K, cap]
  int* start;               // K1 out [C, K]
  const unsigned char* pay; // K2 in [C, K, L]
  unsigned long long* clk;  // K1, or null: [C, 3] ns at the block's start,
                            // after its forward phase and at its end
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

// a / b of two non-negative ints (the unsigned division is the shorter
// instruction sequence)
__device__ __forceinline__ int udiv(int a, int b) {
  return (int)((unsigned)a / (unsigned)b);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// 16 bytes from global memory (through L2) into shared memory, no registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__host__ __device__ __forceinline__ int codec_nsub(int c) {
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

// Table kind of substep j of a codec, -1 past its substeps.
__host__ __device__ __forceinline__ int tab_kind(int c, int j) {
  switch (c) {
    case C_REC: return j == 0 ? K_PTYPE : j == 1 ? K_NRUN : -1;
    case C_COL:
    case C_COLW: return j < 3 ? K_COLOR : -1;
    case C_BT: return j == 0 ? K_BT : j == 1 ? K_BTN : -1;
    case C_SXY: return j < 4 ? K_SXY : -1;
    default: return j == 0 ? K_MVFLAG : j < 3 ? K_MV : -1;
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

// ---------------------------------------------------------------------------
// Tables in shared memory (both kernels; source note above)
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ int cnt_home(const Table& tb, int kind) {
  if (kind != K_COLOR) return HOME_SMEM;
  return tb.by_slot && tb.rows <= CHIP_COLOR_ROWS ? HOME_SMEM16 : HOME_L2;
}

// Shared-memory ints of the counts of one kind (0 when they stay in L2).
__host__ __device__ __forceinline__ int cnt_ints(const Table& tb, int kind) {
  const int home = cnt_home(tb, kind), n = tb.rows * tb.alpha;
  return home == HOME_SMEM ? round4(n) : home == HOME_SMEM16 ? round4((n + 1) / 2) : 0;
}

// Shared-memory ints of a section's tables, kinds in substep order: per
// kind the counts, the row sums and a mixed kind's global row and its sum,
// each array 16-byte aligned.
__host__ __device__ __forceinline__ int layout_ints(const Table* tab, int c) {
  int n = 0;
  for (int j = 0; j < MAX_SUB; ++j) {
    const int kind = tab_kind(c, j);
    if (kind < 0 || (j > 0 && kind == tab_kind(c, j - 1))) continue;
    const Table& tb = tab[kind];
    n += cnt_ints(tb, kind) + round4(tb.rows) + (tb.gcnt != nullptr ? round4(tb.alpha + 1) : 0);
  }
  return n;
}

// Ints of the warps' scratch rows (color: rows of counts a warp adds into;
// K1 over a table in L2 keeps the rows of all three substeps).
__host__ __device__ __forceinline__ int scratch_ints(const Table* tab, int c, int nw,
                                                     bool encode) {
  if (c != C_COL && c != C_COLW) return 0;
  const int rows = encode && cnt_home(tab[K_COLOR], K_COLOR) == HOME_L2 ? 3 : 1;
  return nw * rows * tab[K_COLOR].alpha;
}

// Bytes of payload each K2 lane keeps in shared memory: all of it when the
// section's K x L bytes fit PAY_STAGE_BYTES, else a window that slides
// (at least 96 bytes, as K <= MAX_LANES; a substep reads at most 2).
__host__ __device__ __forceinline__ int pay_window(int k, int plen) {
  return (long long)k * plen <= PAY_STAGE_BYTES ? plen : (PAY_STAGE_BYTES / k) & ~3;
}

// Dynamic shared memory of a section's block of nw warps. K2: its tables,
// the scratch rows, then K x window payload bytes. K1: its tables and the
// scratch rows, reused by the pack.
__host__ __device__ __forceinline__ int smem_bytes(const Table* tab, const Section& s,
                                                   int nw, bool encode) {
  const int ints = layout_ints(tab, s.codec) + scratch_ints(tab, s.codec, nw, encode);
  const int b = 4 * round4(ints);
  if (!encode) return b + s.k * pay_window(s.k, s.width);
  return b > nw * PACK_WARP_BYTES ? b : nw * PACK_WARP_BYTES;
}

struct DTable {
  int* cnt;               // [rows, alpha]: shared, or global for color in L2
  unsigned short* cnt16;  // [rows, alpha] shared 16-bit counts, else null
  int* cntsum;            // [rows] shared
  int* gcnt;              // [alpha] shared, or null (non-mixed kind)
  int* gsum;              // shared
  int kind, rows, alpha;
};

// Lay the kinds of codec c out in dyn (one thread).
__device__ __forceinline__ void tables_layout(const Params& p, int c, int slot, int stream,
                                              int* dyn, DTable* tab) {
  int off = 0;
  const int s_n = codec_nsub(c);
  for (int j = 0; j < s_n; ++j) {
    const int kind = tab_kind(c, j);
    if (j > 0 && kind == tab[j - 1].kind) {  // the kind of the substep before
      tab[j] = tab[j - 1];
      continue;
    }
    const Table g = table_of(p, kind, slot, stream);
    const int home = cnt_home(g, kind);
    DTable& d = tab[j];
    d.kind = kind;
    d.rows = g.rows;
    d.alpha = g.alpha;
    d.cnt = home == HOME_L2 ? g.cnt : home == HOME_SMEM ? dyn + off : nullptr;
    d.cnt16 = home == HOME_SMEM16 ? reinterpret_cast<unsigned short*>(dyn + off) : nullptr;
    off += cnt_ints(g, kind);
    d.cntsum = dyn + off;
    off += round4(g.rows);
    d.gcnt = g.gcnt == nullptr ? nullptr : dyn + off;
    d.gsum = g.gcnt == nullptr ? nullptr : dyn + off + g.alpha;
    off += g.gcnt == nullptr ? 0 : round4(g.alpha + 1);
  }
}

// Copy the section's tables between global and shared memory (block-wide):
// in at block start, out (write back) at block end.
template <bool IN>
__device__ __forceinline__ void tables_copy(const Params& p, int c, int slot, int stream,
                                            const DTable* tab) {
  const int s_n = codec_nsub(c);
  for (int j = 0; j < s_n; ++j) {
    const DTable& d = tab[j];
    if (j > 0 && d.kind == tab[j - 1].kind) continue;
    const Table g = table_of(p, d.kind, slot, stream);
    const int n = d.rows * d.alpha;
    if (d.cnt16 != nullptr) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        if (IN) d.cnt16[i] = (unsigned short)g.cnt[i];
        else g.cnt[i] = d.cnt16[i];
      }
    } else if (d.cnt != g.cnt) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        if (IN) d.cnt[i] = g.cnt[i];
        else g.cnt[i] = d.cnt[i];
      }
    }
    for (int i = threadIdx.x; i < d.rows; i += blockDim.x) {
      if (IN) d.cntsum[i] = g.cntsum[i];
      else g.cntsum[i] = d.cntsum[i];
    }
    if (d.gcnt != nullptr) {
      for (int i = threadIdx.x; i < d.alpha; i += blockDim.x) {
        if (IN) d.gcnt[i] = g.gcnt[i];
        else g.gcnt[i] = d.gcnt[i];
      }
      if (threadIdx.x == 0) {
        if (IN) *d.gsum = *g.gsum;
        else *g.gsum = *d.gsum;
      }
    }
  }
}

// A thread's C symbols of a row: symbols a0 .. a0 + C - 1 of the n in
// the row, C <= chunk (WHOLE: n == 32 * C and src 16-byte aligned, so the
// accesses are unpredicated 16-byte vectors).
template <int C, bool WHOLE>
__device__ __forceinline__ void row_load(const int* src, int a0, int chunk, int n, int* v) {
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
__device__ __forceinline__ void row_store(int* dst, int a0, int chunk, int n, const int* v) {
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

// A thread's 8 symbols of a row of 16-bit counts (16 bytes, aligned).
__device__ __forceinline__ void row_load16(const unsigned short* src, int* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  v[0] = q.x & 0xffff;
  v[1] = q.x >> 16;
  v[2] = q.y & 0xffff;
  v[3] = q.y >> 16;
  v[4] = q.z & 0xffff;
  v[5] = q.z >> 16;
  v[6] = q.w & 0xffff;
  v[7] = q.w >> 16;
}

__device__ __forceinline__ void row_store16(unsigned short* dst, const int* v) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4((unsigned)v[0] | ((unsigned)v[1] << 16), (unsigned)v[2] | ((unsigned)v[3] << 16),
                 (unsigned)v[4] | ((unsigned)v[5] << 16), (unsigned)v[6] | ((unsigned)v[7] << 16));
}

// Phase (b) for the owner of row r, warp-wide: every active lane on the
// row adds STEP to its symbol with a shared-memory atomic, into the row
// itself when it lives in shared memory as int32, else into the warp's
// scratch row, which holds the row's counts (color); then the row rescales
// once if its sum crossed PROB_SCALE - STEP (scale to fill PROB_SCALE -
// STEP - A, floor 1) and is stored (HALF: into the table of 16-bit
// counts). s is the row's sum before the adds.
template <int C, bool WHOLE, bool HALF = false>
__device__ __forceinline__ void row_update(const DTable& tb, int r, int s, int* scratch,
                                           const int* key, int k, int step, int lane) {
  const int a_n = tb.alpha, chunk = WHOLE ? C : C == 1 ? 1 : (a_n + 31) >> 5;
  const int a0 = lane * chunk;
  int* row = HALF ? nullptr : tb.cnt + (size_t)r * a_n;
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
  row_load<C, WHOLE>(acc, a0, chunk, a_n, cv);
  if (resc) {
    const int sc = udiv((PROB_SCALE - step - a_n) << RESCALE_SHIFT, s);
    int part = 0;
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (WHOLE || (i < chunk && a0 + i < a_n)) {
        cv[i] = max((cv[i] * sc) >> RESCALE_SHIFT, 1);
        part += cv[i];
      }
    s = warp_sum(part);
  }
  if constexpr (HALF)
    row_store16(tb.cnt16 + (size_t)r * a_n + a0, cv);
  else if (resc || scratch != nullptr)
    row_store<C, WHOLE>(row, a0, chunk, a_n, cv);
  if (lane == 0) tb.cntsum[r] = s;
}

// Phase (b) of a mixed kind's global row, warp-wide: the active lanes'
// adds, then the rescale when its sum crossed PROB_SCALE - GSTEP.
__device__ __forceinline__ void global_row_update(const DTable& tb, const int* key, int k,
                                                  int gstep, int lane) {
  int n_act = 0;
  for (int base = 0; base < k; base += 32) {
    const int w = base + lane < k ? key[base + lane] : -1;
    if (w >= 0) atomicAdd(tb.gcnt + (w & 1023), gstep);
    n_act += __popc(__ballot_sync(FULL, w >= 0));
  }
  __syncwarp();
  int gs = *tb.gsum + gstep * n_act;
  if (gs > PROB_SCALE - gstep) {
    const int sc = udiv((PROB_SCALE - gstep - tb.alpha) << RESCALE_SHIFT, gs);
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

// ---------------------------------------------------------------------------
// K1: fused section encode (source note above)
// ---------------------------------------------------------------------------

struct K1Lanes {
  int s0[MAX_LANES], s1[MAX_LANES], len[MAX_LANES];  // record state, lens
  int key[MAX_SUB][MAX_LANES];    // row << 10 | sym of an active lane, else -1
  int part[MAX_SUB][MAX_LANES];   // col: row part below the symbol | at it << 16
  int spare[MAX_SUB][MAX_LANES];  // col: what the row part leaves the global row
  DTable tab[MAX_SUB];            // the substeps' tables
};

// Row part of a mixed kind's lookup, warp-wide: the thread's C raw counts
// of the row scaled to its fill target; returns the part's sum below sym,
// its entry at sym, and the space it leaves the global row.
template <int C>
__device__ __forceinline__ void mixed_row_part(const int* raw, int s, int a_n, int esc, int a0,
                                               int chunk, int sym, int* below, int* at,
                                               int* spare) {
  const int target = udiv((PROB_SCALE - 2 * a_n) * s, s + esc);
  const int sc_r = udiv(target << RESCALE_SHIFT, max(s, 1));
  int rs = 0, b = 0, f = 0;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int v = (raw[i] * sc_r) >> RESCALE_SHIFT;
    rs += v;
    if (a0 + i < sym) b += v;
    if (a0 + i == sym) f = v;
  }
  const int both = warp_sum(rs | (b << 16));
  *spare = (PROB_SCALE - a_n) - (both & 0xffff);
  *below = both >> 16;
  *at = __shfl_sync(FULL, f, sym / chunk);
}

// Global part of a mixed kind's lookup, warp-wide: the global row scaled
// into `spare`, floor 1; returns its sum below sym and its entry at sym.
template <int C, bool WHOLE>
__device__ __forceinline__ void mixed_global_part(const DTable& tb, int spare, int lane, int sym,
                                                  int* below, int* at) {
  const int a_n = tb.alpha, chunk = WHOLE ? C : C == 1 ? 1 : (a_n + 31) >> 5;
  const int a0 = lane * chunk;
  const int sc = udiv(spare << RESCALE_SHIFT, max(*tb.gsum, 1));
  int g[C];
  row_load<C, WHOLE>(tb.gcnt, a0, chunk, a_n, g);
  int b = 0, f = 0;
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (WHOLE || (i < chunk && a0 + i < a_n)) {
      const int v = max((g[i] * sc) >> RESCALE_SHIFT, 1);
      if (a0 + i < sym) b += v;
      if (a0 + i == sym) f = v;
    }
  const int both = warp_sum(b | (f << 16));
  *below = both & 0xffff;
  *at = both >> 16;
}

// One lane's lookup in a table in shared memory, warp-wide (C symbols a
// thread): the exclusive cum of the effective row of (tb, row) at sym and
// its frequency there, as model_scan gathers them.
template <int C, bool WHOLE>
__device__ __forceinline__ void k1_lookup(const DTable& tb, int row, int sym, int esc, int lane,
                                          int* cum, int* freq) {
  const int a_n = tb.alpha, chunk = WHOLE ? C : C == 1 ? 1 : (a_n + 31) >> 5;
  const int a0 = lane * chunk;
  int raw[C];
  row_load<C, WHOLE>(tb.cnt + (size_t)row * a_n, a0, chunk, a_n, raw);
  if (tb.gcnt == nullptr) {
    int b = 0, f = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (a0 + i < sym) b += raw[i];
      if (a0 + i == sym) f = raw[i];
    }
    const int both = warp_sum(b | (f << 16));
    *cum = both & 0xffff;
    *freq = both >> 16;
    return;
  }
  int rb, rf, spare, gb, gf;
  mixed_row_part<C>(raw, tb.cntsum[row], a_n, esc, a0, chunk, sym, &rb, &rf, &spare);
  mixed_global_part<C, WHOLE>(tb, spare, lane, sym, &gb, &gf);
  *cum = rb + gb;
  *freq = rf + gf;
}

// Whether lane l's warp updates lane l's row in phase (b): l is active and
// is the first active lane on its row in lane order rotated by off.
__device__ __forceinline__ bool row_owner(const int* key, int k, int l, int off, int lane) {
  const int w = key[l];
  if (w < 0) return false;
  const int r = w >> 10, pl = l >= off ? l - off : l + k - off;
  for (int base = 0; base < k; base += 32) {
    const int m = base + lane;
    bool before = false;
    if (m < k) {
      const int wm = key[m];
      before = wm >= 0 && (wm >> 10) == r && (m >= off ? m - off : m + k - off) < pl;
    }
    if (__any_sync(FULL, before)) return false;
  }
  return true;
}

// Renormalisation bound and division constants of one interval (freq,
// cum), as rans_byte.h's RansEncSymbolInit: x_max, rcp_freq, bias,
// cmpl_freq | rcp_shift << 16, with x' = x + bias + (umulhi(x, rcp_freq) >>
// rcp_shift) * cmpl_freq == ((x / freq) << PROB_BITS) + x % freq + cum.
__device__ __forceinline__ uint4 pack_consts(unsigned f, unsigned cm) {
  const unsigned fx = max(f, 1u);
  uint4 q;
  q.x = f << X_MAX_SHIFT;
  if (fx < 2) {
    q.y = 0xffffffffu;
    q.z = cm + PROB_SCALE - 1;
    q.w = PROB_SCALE - fx;
  } else {
    const unsigned shift = 32 - __clz(fx - 1);  // smallest with 2^shift >= fx
    q.y = (unsigned)(((1ull << (shift + 31)) + fx - 1) / fx);
    q.z = cm;
    q.w = (PROB_SCALE - fx) | ((shift - 1) << 16);
  }
  return q;
}

template <int CH>
__global__ void __launch_bounds__(1024)
encode_kernel(const Params p) {
  const Section& sec = p.sec[blockIdx.x];
  const int slot = blockIdx.y, stream = p.sidx[slot];
  const int k = sec.k, t_n = sec.t, c = sec.codec, cap = sec.width;
  const int s_n = codec_nsub(c), w_n = codec_width(c);
  const int e_n = t_n * s_n;
  const int* recs = sec.recs + (size_t)slot * t_n * k * w_n;
  const int* lens = sec.lens + (size_t)slot * k;
  unsigned* iv = sec.iv + (size_t)slot * k * e_n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __shared__ K1Lanes sh;
  extern __shared__ int4 smem_dyn[];
  int* dyn = reinterpret_cast<int*>(smem_dyn);

  if (sec.clk != nullptr && threadIdx.x == 0) sec.clk[slot * 3] = global_ns();
  if (threadIdx.x == 0) tables_layout(p, c, slot, stream, dyn, sh.tab);
  for (int l = threadIdx.x; l < k; l += blockDim.x) {
    sh.s0[l] = sh.s1[l] = 0;
    sh.len[l] = lens[l];
  }
  __syncthreads();
  tables_copy<true>(p, c, slot, stream, sh.tab);
  __syncthreads();

  const bool color = c == C_COL || c == C_COLW;
  // with a warp per lane the next step's record is loaded a step ahead,
  // and a color row fetched in phase (a) is still in the warp's scratch
  // row in phase (b)
  const bool own_warp = k <= nw;
  const int scr_rows = color && sh.tab[0].cnt16 == nullptr ? 3 : 1;
  int* scratch = dyn + layout_ints(p.tab, c) + warp * scr_rows * COLOR_ALPHA;
  const int own_step = k / s_n;  // row_owner's rotation from substep to substep
  int rn[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    rn[i] = own_warp && warp < k && i < w_n ? __ldg(recs + (size_t)warp * w_n + i) : 0;

  for (int t = 0; t < t_n; ++t) {
    // (a) every lane's rows, symbols and lookups of the whole step
    for (int l = warp; l < k; l += nw) {
      int r[6];
      if (own_warp) {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          r[i] = rn[i];
          if (t + 1 < t_n && i < w_n)
            rn[i] = __ldg(recs + ((size_t)(t + 1) * k + l) * w_n + i);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i)
          r[i] = i < w_n ? __ldg(recs + ((size_t)t * k + l) * w_n + i) : 0;
      }
      const bool lane_active = t < sh.len[l];
      const int s0 = sh.s0[l], s1 = sh.s1[l];
      if (color) {
        const DTable tb = sh.tab[0];
        const int a0 = lane * 8;
        int rw[3], sy[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          bool extra;
          enc_sub(p, c, j, r, s0, s1, &rw[j], &sy[j], &extra);
          rw[j] = min(max(rw[j], 0), tb.rows - 1);
          sy[j] = min(max(sy[j], 0), tb.alpha - 1);
        }
        __syncwarp();
        if (lane_active && tb.cnt16 == nullptr) {  // the three rows, L2 -> scratch rows
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int* src = tb.cnt + (size_t)rw[j] * COLOR_ALPHA + a0;
            int* dst = scratch + j * COLOR_ALPHA + a0;
            cp_async16(dst, src);
            cp_async16(dst + 4, src + 4);
          }
          cp_async_wait();
          __syncwarp();
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          int below = 0, at = 0, spare = 0;
          if (lane_active) {
            int raw[8];
            if (tb.cnt16 != nullptr)
              row_load16(tb.cnt16 + (size_t)rw[j] * COLOR_ALPHA + a0, raw);
            else
              row_load<8, true>(scratch + j * COLOR_ALPHA, a0, 8, COLOR_ALPHA, raw);
            mixed_row_part<8>(raw, tb.cntsum[rw[j]], COLOR_ALPHA, p.esc, a0, 8, sy[j], &below,
                              &at, &spare);
          }
          if (lane == 0) {
            sh.key[j][l] = lane_active ? (rw[j] << 10) | sy[j] : -1;
            sh.part[j][l] = below | (at << 16);
            sh.spare[j][l] = spare;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < MAX_SUB; ++j) {
          if (j >= s_n) break;
          const DTable tb = sh.tab[j];
          int row, sym;
          bool extra;
          enc_sub(p, c, j, r, s0, s1, &row, &sym, &extra);
          const bool act = lane_active && extra;
          row = min(max(row, 0), tb.rows - 1);
          sym = min(max(sym, 0), tb.alpha - 1);
          int cum = 0, freq = 0;
          if (act) {
            if (tb.alpha <= 32)  // the launcher admits alphabets <= 32, 256 and 512
              k1_lookup<1, false>(tb, row, sym, p.esc, lane, &cum, &freq);
            else if (CH == 8 || tb.alpha == 256)
              k1_lookup<8, true>(tb, row, sym, p.esc, lane, &cum, &freq);
            else
              k1_lookup<16, true>(tb, row, sym, p.esc, lane, &cum, &freq);
          }
          if (lane == 0) {
            iv[(size_t)l * e_n + t * s_n + j] =
                (unsigned)cum | ((unsigned)freq << 15) | ((unsigned)act << 30);
            sh.key[j][l] = act ? (row << 10) | sym : -1;
          }
        }
      }
      if (lane == 0 && lane_active) {  // substeps.py enc_next_state
        if (c == C_REC) sh.s0[l] = r[0];
        else if (c == C_COL) { sh.s0[l] = r[1]; sh.s1[l] = r[2]; }
        else if (c == C_MV) { sh.s0[l] = r[0]; sh.s1[l] = r[1]; }
      }
    }

    if (color) {
      // the global row chains the three substeps: (a) its part of each
      // lane's lookup, (b) the owners' row updates and its own update
      const DTable tb = sh.tab[0];
      __syncwarp();
      for (int j = 0; j < 3; ++j) {
        for (int l = warp; l < k; l += nw) {
          const int w = sh.key[j][l];
          unsigned e = 0;
          if (w >= 0) {
            int gb, gf;
            mixed_global_part<8, true>(tb, sh.spare[j][l], lane, w & 1023, &gb, &gf);
            const int rp = sh.part[j][l];
            e = (unsigned)((rp & 0xffff) + gb) | ((unsigned)((rp >> 16) + gf) << 15) | (1u << 30);
          }
          if (lane == 0) iv[(size_t)l * e_n + t * 3 + j] = e;
        }
        __syncthreads();
        if (warp == nw - 1) global_row_update(tb, sh.key[j], k, p.gstep, lane);
        for (int l = warp; l < k; l += nw) {
          if (!row_owner(sh.key[j], k, l, 0, lane)) continue;
          const int r = sh.key[j][l] >> 10, a0 = lane * 8;
          int* scr = scratch + (tb.cnt16 == nullptr ? j * COLOR_ALPHA : 0);
          if (tb.cnt16 != nullptr || !own_warp) {  // else phase (a) left the row there
            int cv[8];
            __syncwarp();
            if (tb.cnt16 != nullptr)
              row_load16(tb.cnt16 + (size_t)r * COLOR_ALPHA + a0, cv);
            else
              row_load<8, true>(tb.cnt + (size_t)r * COLOR_ALPHA, a0, 8, COLOR_ALPHA, cv);
            row_store<8, true>(scr, a0, 8, COLOR_ALPHA, cv);
          }
          if (tb.cnt16 != nullptr)
            row_update<8, true, true>(tb, r, tb.cntsum[r], scr, sh.key[j], k, p.step, lane);
          else
            row_update<8, true>(tb, r, tb.cntsum[r], scr, sh.key[j], k, p.step, lane);
        }
        __syncthreads();
      }
    } else {
      // (b) the rows of all substeps, each by its owner; the global rows
      __syncthreads();
      for (int j = 0; j < s_n; ++j) {
        const DTable tb = sh.tab[j];
        if (tb.gcnt != nullptr && warp == nw - 1)
          global_row_update(tb, sh.key[j], k, p.gstep, lane);
        const int off = j * own_step;
        for (int l = warp; l < k; l += nw) {
          if (!row_owner(sh.key[j], k, l, off, lane)) continue;
          const int r = sh.key[j][l] >> 10, s = tb.cntsum[r];
          if (tb.alpha <= 32)
            row_update<1, false>(tb, r, s, nullptr, sh.key[j], k, p.step, lane);
          else if (CH == 8 || tb.alpha == 256)
            row_update<8, true>(tb, r, s, nullptr, sh.key[j], k, p.step, lane);
          else
            row_update<16, true>(tb, r, s, nullptr, sh.key[j], k, p.step, lane);
        }
      }
      __syncthreads();
    }
  }

  tables_copy<false>(p, c, slot, stream, sh.tab);
  __syncthreads();
  if (sec.clk != nullptr && threadIdx.x == 0) sec.clk[slot * 3 + 1] = global_ns();

  // reverse rANS pack (jx/coder.py:rans_pack), a warp per lane, 32 entries
  // a pass: constants by all threads, the walk by thread 0, the bytes by all
  unsigned char* pk = reinterpret_cast<unsigned char*>(smem_dyn) + warp * PACK_WARP_BYTES;
  uint4* cst = reinterpret_cast<uint4*>(pk);
  unsigned char* stage = pk + 32 * 16;
  unsigned char* buf = sec.buf + (size_t)slot * k * cap;
  int* start = sec.start + (size_t)slot * k;
  for (int l = warp; l < k; l += nw) {
    const unsigned* e = iv + (size_t)l * e_n;
    unsigned char* b = buf + (size_t)l * cap;
    unsigned x = RANS_L;
    int pos = cap;
    for (int hi = e_n; hi > 0; hi -= 32) {
      const int idx = hi - 1 - lane;  // thread i holds the pass's i-th entry
      uint4 q = make_uint4(0xffffffffu, 0u, 0u, 0u);  // inactive: x stays
      if (idx >= 0) {
        const unsigned w = e[idx];
        if (w >> 30) q = pack_consts((w >> 15) & 0x7fff, w & 0x7fff);
      }
      cst[lane] = q;
      __syncwarp();
      int n = 0;
      if (lane == 0) {
#pragma unroll 8
        for (int i = 0; i < 32; ++i) {
          const uint4 s = cst[i];
#pragma unroll
          for (int rep = 0; rep < 2; ++rep) {
            if (x >= s.x) {
              stage[n++] = (unsigned char)(x & 0xff);
              x >>= 8;
            }
          }
          x += s.z + (__umulhi(x, s.y) >> (s.w >> 16)) * (s.w & 0xffff);
        }
      }
      n = __shfl_sync(FULL, n, 0);
      __syncwarp();
      for (int i = lane; i < n; i += 32) b[pos - 1 - i] = stage[i];
      pos -= n;
      __syncwarp();
    }
    if (lane == 0) {
      for (int i = 3; i >= 0; --i) b[--pos] = (unsigned char)((x >> (8 * i)) & 0xff);
      start[l] = pos;
    }
  }
  if (sec.clk != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) sec.clk[slot * 3 + 2] = global_ns();
  }
}

// ---------------------------------------------------------------------------
// K2: fused section decode (source note above)
// ---------------------------------------------------------------------------

struct K2Lanes {
  int s0[MAX_LANES], s1[MAX_LANES];  // record state (dec_finish)
  unsigned x[MAX_LANES];             // rANS state
  int pos[MAX_LANES], wbase[MAX_LANES], len[MAX_LANES];
  int part[MAX_SUB][MAX_LANES];      // symbols of the current record
  int row[MAX_LANES];                // row, inactive lanes parked on 0
  int key[MAX_LANES];                // row << 10 | sym of an active lane, else -1
  DTable tab[MAX_SUB];               // the substeps' tables
};

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
  row_load<C, WHOLE>(tb.cnt + (size_t)row * a_n, a0, chunk, a_n, raw);
  if (stash != nullptr) row_store<C, WHOLE>(stash, a0, chunk, a_n, raw);
  const int s = tb.cntsum[row];
  int v[C];
  if (tb.gcnt == nullptr) {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = raw[i];
  } else {  // row scaled to its fill target plus the scaled global row
    const int target = udiv((PROB_SCALE - 2 * a_n) * s, s + esc);
    const int sc_r = udiv(target << RESCALE_SHIFT, max(s, 1));
    int rs = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      v[i] = (raw[i] * sc_r) >> RESCALE_SHIFT;
      rs += v[i];
    }
    const int spare = (PROB_SCALE - a_n) - warp_sum(rs);
    const int sc = udiv(spare << RESCALE_SHIFT, max(*tb.gsum, 1));
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
  const int win_n = pay_window(k, plen);
  __shared__ K2Lanes sh;
  extern __shared__ int4 smem_dyn[];
  int* dyn = reinterpret_cast<int*>(smem_dyn);

  // lay the section's kinds out in shared memory and copy them in
  if (threadIdx.x == 0) tables_layout(p, c, slot, stream, dyn, sh.tab);
  const int scratch_off = layout_ints(p.tab, c);
  unsigned char* win = reinterpret_cast<unsigned char*>(smem_dyn) +
                       4 * round4(scratch_off + scratch_ints(p.tab, c, nw, false));
  __syncthreads();
  tables_copy<true>(p, c, slot, stream, sh.tab);
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
              row_load<8, false>(tb.cnt + (size_t)r * tb.alpha, lane * 8, 8, tb.alpha, cv);
              row_store<8, false>(scr, lane * 8, 8, tb.alpha, cv);
            }
          }
          const int s = tb.cntsum[r];
          if (width == 1) {
            row_update<1, false>(tb, r, s, scr, sh.key, k, p.step, lane);
          } else if (width == 8) {
            if (whole)
              row_update<8, true>(tb, r, s, scr, sh.key, k, p.step, lane);
            else
              row_update<8, false>(tb, r, s, scr, sh.key, k, p.step, lane);
          } else if (whole) {
            row_update<CH, true>(tb, r, s, nullptr, sh.key, k, p.step, lane);
          } else {
            row_update<CH, false>(tb, r, s, nullptr, sh.key, k, p.step, lane);
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
      if (tb.gcnt != nullptr && warp == nw - 1)
        global_row_update(tb, sh.key, k, p.gstep, lane);
      __syncthreads();
    }
  }

  tables_copy<false>(p, c, slot, stream, sh.tab);
}

// desc layout (int64): [step, gstep, esc, bits_a, bits_b, sidx,
//   8 x (cnt, cntsum, gcnt, gsum, rows, alpha, by_slot),
//   n_sections x (codec, k, t, width, recs, lens, iv, buf, start, pay, clk)]
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
  for (int i = 0; i < n_sec; ++i, q += 11) {
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
    s.clk = (unsigned long long*)q[10];
    if (s.k < 1 || s.k > MAX_LANES || s.codec < C_REC || s.codec > C_COLW ||
        (decode && s.codec == C_COLW))
      return (int)cudaErrorInvalidValue;
    if (!decode) {
      // K1 moves whole rows as 16-byte vectors: alphabets up to 32 (a symbol
      // a thread), of 256 or of 512; color rows also from global memory
      for (int j = 0; j < codec_nsub(s.codec); ++j) {
        const int a_n = p->tab[tab_kind(s.codec, j)].alpha;
        if (a_n > 32 && a_n != 256 && a_n != 512) return (int)cudaErrorInvalidValue;
      }
      const Table& tb = p->tab[K_COLOR];
      if ((s.codec == C_COL || s.codec == C_COLW) &&
          (tb.alpha != COLOR_ALPHA || tb.gcnt == nullptr || ((size_t)tb.cnt & 15) != 0))
        return (int)cudaErrorInvalidValue;
    }
    *max_k = s.k > *max_k ? s.k : *max_k;
  }
  return 0;
}

constexpr int MAX_DEVICES = 64;

// The most dynamic shared memory a block of `kernel` can take beside the
// kernel's static shared memory on the current device; the opt-in above
// 48 KB is a per-device attribute, set once per kernel and device
// (limits[dev] 0: not asked yet).
template <typename Kernel>
static int dyn_limit(Kernel kernel, int* limits, int* limit) {
  int dev;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (limits[dev] > 0) {
    *limit = limits[dev];
    return 0;
  }
  cudaFuncAttributes fa;
  int optin;
  err = (int)cudaFuncGetAttributes(&fa, kernel);
  if (!err) err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err) err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            optin - (int)fa.sharedSizeBytes);
  if (err) return err;
  *limit = limits[dev] = optin - (int)fa.sharedSizeBytes;
  return 0;
}

// Launch with the largest dynamic shared memory need of the launch's
// sections; a need above the card's limit is refused.
template <int CH, bool ENCODE>
static int launch_sections(const Params& p, int n_sec, dim3 grid, int threads,
                           cudaStream_t stream) {
  static int limits[MAX_DEVICES] = {};
  int max_dyn;
  const int err = ENCODE ? dyn_limit(encode_kernel<CH>, limits, &max_dyn)
                         : dyn_limit(decode_kernel<CH>, limits, &max_dyn);
  if (err) return err;
  int smem = 0;
  for (int i = 0; i < n_sec; ++i) {
    const int b = smem_bytes(p.tab, p.sec[i], threads / 32, ENCODE);
    smem = b > smem ? b : smem;
  }
  if (smem > max_dyn) return (int)cudaErrorInvalidValue;
  if (ENCODE)
    encode_kernel<CH><<<grid, threads, smem, stream>>>(p);
  else
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
  // a warp per lane, at most 32; at least 8, so that a block of few lanes
  // still copies its tables in and out quickly and its global row has a
  // warp of its own
  const int threads = 32 * (max_k < 8 ? 8 : max_k < 32 ? max_k : 32);
  const dim3 grid(n_sec, n_streams);
  bool wide = false;  // an alphabet above 256 needs 16 symbols a thread
  for (int i = 0; i < n_sec; ++i)
    for (int j = 0; j < MAX_SUB; ++j) {
      const int kind = tab_kind(p.sec[i].codec, j);
      wide |= kind >= 0 && p.tab[kind].alpha > 256;
    }
  cudaStream_t st = (cudaStream_t)stream;
  if (decode)
    return wide ? launch_sections<16, false>(p, n_sec, grid, threads, st)
                : launch_sections<8, false>(p, n_sec, grid, threads, st);
  return wide ? launch_sections<16, true>(p, n_sec, grid, threads, st)
              : launch_sections<8, true>(p, n_sec, grid, threads, st);
}

extern "C" int sptc_sections_encode(const long long* desc, int n_sec,
                                    int n_streams, void* stream) {
  return launch(desc, n_sec, n_streams, stream, false);
}

extern "C" int sptc_sections_decode(const long long* desc, int n_sec,
                                    int n_streams, void* stream) {
  return launch(desc, n_sec, n_streams, stream, true);
}
