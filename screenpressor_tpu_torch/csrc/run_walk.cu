// Greedy RLE run walk (K3) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of screenpressor_tpu/jx/classify.py
// (_make_walk_kernel / _run_walk). Per seg tile: position 0 starts a run;
// a run extends while the fits bit of its ptype holds and it is shorter
// than MAX_RUN; a start takes the start type of its pixel. Output is the
// record-start mask (0/1 bytes).
//
// Design: a jump walk. At a record start the walk state is (cur, run) =
// (st[p], 1) whatever came before, so the next start is a function of the
// position alone:
//   next(p) = min(p + MAX_RUN, first q > p with bit st[p] of fits[q] clear,
//                 tile end)
// and the start mask is the orbit of the tile's position 0 under next. One
// thread block per tile (64 threads for the 256-position tiles of P-frame
// data blocks, 1,024 for a 1080p keyframe's 135 tiles, 256 where a launch
// has more than two tiles per SM, as the 64 serving keyframes have), in
// chunks of at most WALK_CHUNK positions plus a halo of 256, so that shared
// memory stays under 48 KB for any tile:
//   1. the chunk's fits are loaded coalesced and turned into one "bit
//      clear" bit mask per ptype with __ballot_sync (6 x chunk / 32 words);
//   2. every position finds its next, as if it were a start, with __ffs
//      over at most nine words of its start type's mask;
//   3. one thread hops from start to start (one dependent shared-memory
//      load a record) and sets the start bits; a hop that leaves the chunk
//      enters the next chunk at the position where it lands;
//   4. the start mask is stored coalesced.
//
// What bounds it on this card: the bytes are 9 per position (0.0056 ms at
// 1080p); the time is step 3's chain, one shared-memory load per record of
// the tile, and step 2's word scans. The TPU kernel carried (cur, run)
// through VMEM across grid steps; nothing is carried here but the entry
// position of a chunk.

#include <cuda_runtime.h>

#define MAX_RUN 255
#define NUM_PTYPES 6
#define WALK_CHUNK 8192
#define WALK_HALO 256  // > MAX_RUN: a chunk's next() never looks further
#define FULL 0xffffffffu

// Words of one ptype's mask over a chunk and its halo.
__host__ __device__ __forceinline__ int mask_words(int chunk) {
  return (chunk + WALK_HALO + 31) >> 5;
}

// Dynamic shared memory: six masks, the start mask, next[] (16 bits each).
__host__ __device__ __forceinline__ int walk_smem_bytes(int chunk) {
  return 4 * (NUM_PTYPES * mask_words(chunk) + ((chunk + 31) >> 5)) + 2 * chunk;
}

__global__ void __launch_bounds__(1024)
run_walk_kernel(const int* __restrict__ fits, const int* __restrict__ st,
                unsigned char* __restrict__ out, long long n, int tile, int chunk) {
  extern __shared__ int4 walk_dyn[];
  __shared__ int entry;  // the next start, relative to the tile
  const long long base = (long long)blockIdx.x * tile;
  const int len = (int)(n - base < tile ? n - base : tile);
  const int w_n = mask_words(chunk);
  unsigned* clr = reinterpret_cast<unsigned*>(walk_dyn);  // [6][w_n]: bit of ptype clear
  unsigned* smask = clr + NUM_PTYPES * w_n;               // [chunk / 32] start bits
  unsigned short* nxt = reinterpret_cast<unsigned short*>(smask + ((chunk + 31) >> 5));
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) entry = 0;

  for (int c0 = 0; c0 < len; c0 += chunk) {
    const int rest = len - c0;  // positions from the chunk's start to the tile's end
    const int m = min(chunk, rest), mh = min(m + WALK_HALO, rest);
    // 1. the six clear masks of the chunk and its halo
    for (int q0 = 0; q0 < mh; q0 += blockDim.x) {
      const int q = q0 + threadIdx.x;
      const int f = q < mh ? fits[base + c0 + q] : 0;
#pragma unroll
      for (int b = 0; b < NUM_PTYPES; ++b) {
        const unsigned word = __ballot_sync(FULL, !((f >> b) & 1));
        if (lane == 0 && q < mh) clr[b * w_n + (q >> 5)] = word;
      }
    }
    for (int i = threadIdx.x; i < ((m + 31) >> 5); i += blockDim.x) smask[i] = 0;
    __syncthreads();
    // 2. next(p) of every position of the chunk
    for (int pp = threadIdx.x; pp < m; pp += blockDim.x) {
      const int c = st[base + c0 + pp];
      const int limit = min(pp + MAX_RUN, rest);
      int nx = limit;
      if ((unsigned)c >= NUM_PTYPES) {
        nx = pp + 1;  // no such fits bit: the run ends at once
      } else {
        const unsigned* cw = clr + c * w_n;
        unsigned keep = FULL << ((pp + 1) & 31);
        for (int w = (pp + 1) >> 5; w <= (limit - 1) >> 5; ++w) {
          const unsigned word = cw[w] & keep;
          if (word != 0) {
            nx = min(w * 32 + __ffs(word) - 1, limit);
            break;
          }
          keep = FULL;
        }
      }
      nxt[pp] = (unsigned short)nx;
    }
    __syncthreads();
    // 3. the orbit of the entry position
    if (threadIdx.x == 0) {
      int pp = entry - c0;
      while (pp < m) {
        smask[pp >> 5] |= 1u << (pp & 31);
        pp = nxt[pp];
      }
      entry = c0 + pp;
    }
    __syncthreads();
    // 4. the start mask of the chunk
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      out[base + c0 + i] = (unsigned char)((smask[i >> 5] >> (i & 31)) & 1);
    __syncthreads();
  }
}

extern "C" int sptc_run_walk(const int* fits, const int* st, unsigned char* out,
                             long long n, int tile, void* stream) {
  if (tile < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + tile - 1) / tile;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int chunk = tile < WALK_CHUNK ? tile : WALK_CHUNK;
  // one tile on an SM wants many threads for steps 1 and 2; many tiles per
  // SM want many resident blocks, so that their serial step 3s overlap
  const int threads = tile <= 256 ? 64 : tile <= 2048 || n_tiles > 264 ? 256 : 1024;
  run_walk_kernel<<<(unsigned)n_tiles, threads, walk_smem_bytes(chunk), (cudaStream_t)stream>>>(
      fits, st, out, n, tile, chunk);
  return (int)cudaGetLastError();
}
