// The session API's RGB32 <-> RGB24 conversion (K7) for Hopper (sm_90a):
// every frame of a batch, one direction, in one launch.
//
// Stands for the JAX package's colorspace.rgb32_to_rgb24_device and
// rgb24_to_rgb32_device (screenpressor_tpu/colorspace.py), which have no
// Pallas site: XLA fuses the slice / concatenate into its program. The
// port's plain versions are colorspace.rgb32_to_rgb24_batch and
// rgb24_to_rgb32_batch on CPU tensors (a slice and a copy).
//
//   sptc_rgb32_to_rgb24: src [N, P, 4] (one buffer, the batch's uploaded
//     RGB32 frames) -> dsts[f] [P, 3] (N frames, each in storage of its own:
//     a session keeps one as its previous frame); alpha dropped.
//   sptc_rgb24_to_rgb32: srcs[f] [P, 3] (N frames; a slot may repeat
//     another's pointer: an idle P frame is its previous frame) -> dst
//     [N, P, 4] (one buffer, copied to the host in one piece); alpha 255.
//
// P = H * W pixels: a frame is contiguous, so its rows need no care and the
// only ragged edge is the frame's last tile.
//
// What bounds it on this card: bytes, 7 a pixel (4 RGB32 + 3 RGB24), one
// read and one write each: a 64-frame 1080p batch moves 929 MB, 0.277 ms
// at 3.35 TB/s. The design:
//   - a thread block of 128 threads takes a tile of 512 pixels of one frame
//     (grid: tiles x frames): 2,048 B of RGB32, 1,536 B of RGB24;
//   - RGB32 side: a thread moves one 16-byte group, 4 pixels, with one
//     128-bit load or store;
//   - RGB24 side: the tile's 1,536 B go through shared memory as 96
//     128-bit words, so that both sides move 16 B a thread, neighbouring
//     threads on neighbouring addresses; the 4 pixels' 12 B are packed
//     or unpacked in registers (__byte_perm) as 3 words, which a thread
//     writes to or reads from shared memory at word 3t (stride 3: no
//     bank conflict);
//   - a tile that is not whole (the frame's last) or a frame whose base is
//     not 16-byte aligned goes pixel by pixel (the branch is the whole
//     block's, so the barrier is uniform).
// Offsets are int64: N * P * 4 passes 2^31 at 4K beyond 64 frames.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define TILE (THREADS * 4)          // pixels a block
#define TILE_WORDS (TILE * 3 / 16)  // 128-bit words of RGB24 a tile (96)
#define MAX_FRAMES 65535            // gridDim.y

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

__global__ void __launch_bounds__(THREADS)
rgb32_to_rgb24_kernel(const unsigned char* __restrict__ src,
                      const unsigned long long* __restrict__ dsts, long long npix) {
  __shared__ uint4 s_rgb[TILE_WORDS];
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * TILE;
  const unsigned char* s = src + ((long long)blockIdx.y * npix + p0) * 4;
  unsigned char* d = reinterpret_cast<unsigned char*>(dsts[blockIdx.y]) + p0 * 3;
  if (p0 + TILE <= npix && aligned16(s) && aligned16(d)) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(s) + t);
    // pixels v.x .. v.w, bytes r g b a each: 12 bytes r g b r g b ...
    unsigned* w = reinterpret_cast<unsigned*>(s_rgb) + 3 * t;
    w[0] = __byte_perm(v.x, v.y, 0x4210);
    w[1] = __byte_perm(v.y, v.z, 0x5421);
    w[2] = __byte_perm(v.z, v.w, 0x6542);
    __syncthreads();
    if (t < TILE_WORDS) reinterpret_cast<uint4*>(d)[t] = s_rgb[t];
    return;
  }
  const long long n = min((long long)TILE, npix - p0);
  for (long long p = t; p < n; p += THREADS) {
    d[3 * p] = s[4 * p];
    d[3 * p + 1] = s[4 * p + 1];
    d[3 * p + 2] = s[4 * p + 2];
  }
}

__global__ void __launch_bounds__(THREADS)
rgb24_to_rgb32_kernel(const unsigned long long* __restrict__ srcs,
                      unsigned char* __restrict__ dst, long long npix) {
  __shared__ uint4 s_rgb[TILE_WORDS];
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * TILE;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(srcs[blockIdx.y]) + p0 * 3;
  unsigned char* d = dst + ((long long)blockIdx.y * npix + p0) * 4;
  if (p0 + TILE <= npix && aligned16(s) && aligned16(d)) {
    if (t < TILE_WORDS) s_rgb[t] = __ldg(reinterpret_cast<const uint4*>(s) + t);
    __syncthreads();
    const unsigned* w = reinterpret_cast<const unsigned*>(s_rgb) + 3 * t;
    const unsigned w0 = w[0], w1 = w[1], w2 = w[2];
    uint4 v;
    v.x = w0 | 0xff000000u;
    v.y = __byte_perm(w0, w1, 0x7543) | 0xff000000u;
    v.z = __byte_perm(w1, w2, 0x7432) | 0xff000000u;
    v.w = (w2 >> 8) | 0xff000000u;
    reinterpret_cast<uint4*>(d)[t] = v;
    return;
  }
  const long long n = min((long long)TILE, npix - p0);
  for (long long p = t; p < n; p += THREADS) {
    d[4 * p] = s[3 * p];
    d[4 * p + 1] = s[3 * p + 1];
    d[4 * p + 2] = s[3 * p + 2];
    d[4 * p + 3] = 255;
  }
}

static int grid_of(long long npix, int n, dim3* grid) {
  if (npix < 1 || n < 1 || n > MAX_FRAMES) return (int)cudaErrorInvalidValue;
  const long long tiles = (npix + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)tiles, (unsigned)n);
  return 0;
}

extern "C" int sptc_rgb32_to_rgb24(const unsigned char* src, const unsigned long long* dsts,
                                   long long npix, int n, void* stream) {
  dim3 grid;
  const int err = grid_of(npix, n, &grid);
  if (err) return err;
  rgb32_to_rgb24_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(src, dsts, npix);
  return (int)cudaGetLastError();
}

extern "C" int sptc_rgb24_to_rgb32(const unsigned long long* srcs, unsigned char* dst,
                                   long long npix, int n, void* stream) {
  dim3 grid;
  const int err = grid_of(npix, n, &grid);
  if (err) return err;
  rgb24_to_rgb32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(srcs, dst, npix);
  return (int)cudaGetLastError();
}
