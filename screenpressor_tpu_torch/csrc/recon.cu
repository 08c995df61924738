// I-frame row reconstruction (K4) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of screenpressor_tpu/jx/recon.py
// (_recon_kernel / reconstruct_i). Each row obeys v[x] = a[x] * v[x-1] + b[x]
// with a in {0, 1}: literal, above and aboveleft reset (a = 0, b = the
// known value), gradient adds above - aboveleft (a = 1), every other type
// carries (a = 1, b = 0). Rows are sequential through the above row.
// Padding columns are left-runs, so the last slot of row y-1 carries into
// column 0 of row y, and column 0's aboveleft is that slot too
// (jx/recon.py:96).
//
// What bounds it: not bytes (a 1080p frame is 8.8 MB of packed words in and
// 6.2 MB out) but the row chain, 1,080 rows one after the other on the one
// SM that holds the frame, and the instructions each row issues there. The
// design keeps everything but one exchange of warp totals off that chain:
// - Exact per-channel mod-256 arithmetic in one 32-bit word. The output is
//   the low byte of each channel and the recurrence only copies, adds and
//   subtracts, so low bytes depend only on low bytes. Each channel has a
//   10-bit field (R bits 0-7, G 10-17, B 20-27): a field sum stays below
//   2^10, so one integer add and one mask add all three channels mod 256.
//   The affine map (a, b) is one word, a in bit 31; composing two is an
//   add, a mask and a select, and a scan step is one shuffle.
// - The input is one packed word per position (recon.py:pack_rows: the
//   fields, and a type code whose bits select the map, so that a position's
//   map is three selects with no branch). Each thread streams its own chunk
//   of the rows ahead into a shared-memory ring with cp.async, kRing rows
//   deep, so the row loop reads only shared memory and needs no barrier for
//   it.
// - The previous row stays in registers. A thread owns PER consecutive
//   positions; it keeps their values of the row before, the value entering
//   its chunk then (its aboveleft at the first position) and the carry into
//   the row. Every warp composes all warp totals itself after the row's one
//   barrier, so it knows the carry of the next row (the whole row's map
//   applied to this row's carry) without a second exchange. Warp totals are
//   double-buffered by row parity.
// - The output leaves off the chain: each row is assembled in shared memory
//   and written during the next row with 16-byte stores where the row pitch
//   allows.
// One barrier a row, one block per frame, a batch of frames per launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFields = 0x0FF3FCFFu;  // R bits 0-7, G 10-17, B 20-27
constexpr unsigned kBorrow = 0x10040100u;  // bit 8 above each field
constexpr unsigned kA = 0x80000000u;       // a = 1 (carries v[x-1])
constexpr unsigned kFieldsA = kFields | kA;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRing = 4;      // rows staged ahead
constexpr int kMaxWarps = 8;  // at most 256 threads a block

// f1 then f2 (f1's a-bit kept when f2 carries)
__device__ __forceinline__ unsigned compose(unsigned f1, unsigned f2) {
  return (f2 & kA) ? ((f1 + (f2 & kFields)) & kFieldsA) : f2;
}

// the map g applied to a value v (a-bit clear)
__device__ __forceinline__ unsigned apply(unsigned g, unsigned v) {
  return (g & kA) ? ((v + g) & kFields) : g;
}

// the map of one position from its packed word and the row before. The
// type code (recon.py:pack_rows) is three selector bits: bit 30 a = 1
// (gradient or carry), bit 29 the row before (above, aboveleft, gradient),
// bit 28 aboveleft; a literal's code is 0, so its word is its value. Every
// candidate is computed and selected: lanes of mixed types never diverge.
__device__ __forceinline__ unsigned affine(unsigned word, unsigned above, unsigned aboveleft) {
  const unsigned grad = (((above | kBorrow) - aboveleft) & kFields) | kA;
  const bool from_row = word & (1u << 29);
  const unsigned known = from_row ? ((word & (1u << 28)) ? aboveleft : above) : word;
  const unsigned adds = from_row ? grad : kA;
  return (word & (1u << 30)) ? adds : known;
}

// R, G, B fields -> bytes 0, 1, 2
__device__ __forceinline__ unsigned to_rgb(unsigned v) {
  return (v & 0xffu) | ((v >> 2) & 0xff00u) | ((v >> 4) & 0xff0000u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the 3 * w bytes of a staged row -> out (16-, 4- or 1-byte stores)
__device__ __forceinline__ void flush_row(const unsigned char* stage, unsigned char* out,
                                          int nbytes) {
  if ((nbytes & 15) == 0) {
    for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(stage)[i];
  } else if ((nbytes & 3) == 0) {
    for (int i = threadIdx.x; i < nbytes / 4; i += blockDim.x)
      reinterpret_cast<unsigned*>(out)[i] = reinterpret_cast<const unsigned*>(stage)[i];
  } else {
    for (int i = threadIdx.x; i < nbytes; i += blockDim.x) out[i] = stage[i];
  }
}

// rows [n, h, wp] packed words -> out [n, h, w, 3]; blockDim.x = wp / PER
template <int PER>
__global__ void __launch_bounds__(256)
recon_kernel(const unsigned* __restrict__ rows, unsigned char* __restrict__ out, int h,
             int w, int wp) {
  static_assert(PER % 4 == 0, "a thread's chunk is whole 16-byte copies");
  rows += (size_t)blockIdx.x * h * wp;
  out += (size_t)blockIdx.x * h * w * 3;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* ring = reinterpret_cast<unsigned*>(smem);   // [kRing][wp]
  unsigned char* stage = smem + (size_t)kRing * wp * 4;  // [2][3 * wp]
  unsigned* wtot = reinterpret_cast<unsigned*>(stage + 6 * (size_t)wp);  // [2][8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = tid * PER;
  const int row_bytes = 3 * w;

  auto stage_in = [&](int y) {  // this thread's chunk of row y, into the ring
    if (y < h) {
      unsigned* dst = ring + (y % kRing) * wp + x0;
      const unsigned* src = rows + (size_t)y * wp + x0;
#pragma unroll
      for (int q = 0; q < PER; q += 4) cp_async16(dst + q, src + q);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int y = 0; y < kRing - 1; ++y) stage_in(y);
  if (tid < 2 * kMaxWarps) wtot[tid] = kA;  // the totals of absent warps: identity
  __syncthreads();

  unsigned prev[PER];  // the row before at this thread's positions
#pragma unroll
  for (int i = 0; i < PER; ++i) prev[i] = 0;
  unsigned al0 = 0;    // the row before at x0 - 1 (thread 0: at wp - 1)
  unsigned carry = 0;  // the row before at wp - 1

  for (int y = 0; y < h; ++y) {
    stage_in(y + kRing - 1);
    cp_async_wait<kRing - 1>();  // this thread's copies of row y have landed
    unsigned word[PER];
    const uint4* src = reinterpret_cast<const uint4*>(ring + (y % kRing) * wp + x0);
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const uint4 v = src[q];
      word[4 * q] = v.x;
      word[4 * q + 1] = v.y;
      word[4 * q + 2] = v.z;
      word[4 * q + 3] = v.w;
    }
    // inclusive prefix maps of the chunk
    unsigned g[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const unsigned f = affine(word[i], prev[i], i ? prev[i - 1] : al0);
      g[i] = i ? compose(g[i - 1], f) : f;
    }
    unsigned incl = g[PER - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = compose(up, incl);
    }
    unsigned excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kA;
    unsigned* tot = wtot + (y & 1) * kMaxWarps;
    if (lane == 31) tot[warp] = incl;
    __syncthreads();  // the row's one barrier: every warp total is in

    // the warp totals in two chains of four: the map of warps [0, warp) and
    // of all of them
    const uint4 lo = reinterpret_cast<const uint4*>(tot)[0];
    const uint4 hi = reinterpret_cast<const uint4*>(tot)[1];
    const unsigned a1 = lo.x, a2 = compose(a1, lo.y), a3 = compose(a2, lo.z),
                   a4 = compose(a3, lo.w);
    const unsigned b5 = hi.x, b6 = compose(b5, hi.y), b7 = compose(b6, hi.z),
                   b8 = compose(b7, hi.w);
    const unsigned all = compose(a4, b8);
    unsigned pre = warp == 1 ? a1 : warp == 2 ? a2 : warp == 3 ? a3 : kA;
    pre = warp == 4 ? a4 : pre;
    pre = warp >= 5 ? compose(a4, warp == 5 ? b5 : warp == 6 ? b6 : b7) : pre;
    const unsigned v_in = apply(excl, apply(pre, carry));
    carry = apply(all, carry);
    al0 = tid == 0 ? carry : v_in;
#pragma unroll
    for (int i = 0; i < PER; ++i) prev[i] = apply(g[i], v_in);

    // the row's bytes, 12 per 4 positions
    unsigned b[3 * PER / 4];
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const unsigned c0 = to_rgb(prev[4 * q]), c1 = to_rgb(prev[4 * q + 1]);
      const unsigned c2 = to_rgb(prev[4 * q + 2]), c3 = to_rgb(prev[4 * q + 3]);
      b[3 * q] = __byte_perm(c0, c1, 0x4210);
      b[3 * q + 1] = __byte_perm(c1, c2, 0x5421);
      b[3 * q + 2] = __byte_perm(c2, c3, 0x6542);
    }
    unsigned* st = reinterpret_cast<unsigned*>(stage + (y & 1) * 3 * wp + 3 * x0);
#pragma unroll
    for (int k = 0; k < 3 * PER / 4; ++k) st[k] = b[k];
    // the row before leaves (its stage was filled before this row's barrier)
    if (y > 0)
      flush_row(stage + ((y - 1) & 1) * 3 * wp, out + (size_t)(y - 1) * row_bytes, row_bytes);
  }
  cp_async_wait<0>();
  __syncthreads();
  flush_row(stage + ((h - 1) & 1) * 3 * wp, out + (size_t)(h - 1) * row_bytes, row_bytes);
}

template <int PER>
int launch(const unsigned* rows, unsigned char* out, int n, int h, int w, int wp,
           cudaStream_t stream) {
  const size_t smem = (size_t)kRing * wp * 4 + 6 * (size_t)wp + 2 * kMaxWarps * 4;
  cudaError_t err = cudaFuncSetAttribute(
      recon_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  recon_kernel<PER><<<n, wp / PER, smem, stream>>>(rows, out, h, w, wp);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [n, h, wp] packed int32 (recon.py:pack_rows) -> out [n, h, w, 3]
extern "C" int sptc_recon_rows(const unsigned* rows, unsigned char* out, int n, int h, int w,
                               int wp, void* stream) {
  if (wp < 128 || wp > 8192 || (wp & (wp - 1)) || w < 1 || w > wp || n < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // 32 to 256 threads: 8 positions a thread, 4 below Wp 256, more above 2048
  if (wp < 256) return launch<4>(rows, out, n, h, w, wp, s);
  if (wp <= 2048) return launch<8>(rows, out, n, h, w, wp, s);
  if (wp == 4096) return launch<16>(rows, out, n, h, w, wp, s);
  return launch<32>(rows, out, n, h, w, wp, s);
}
