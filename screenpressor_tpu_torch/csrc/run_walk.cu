// Greedy RLE run walk (K3) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of screenpressor_tpu/jx/classify.py
// (_make_walk_kernel / _run_walk). Per seg tile: position 0 starts a run;
// a run extends while the fits bit of its ptype holds and it is shorter
// than MAX_RUN; a start takes the start type of its pixel. Output is the
// record-start mask (0/1 bytes).
//
// Design: one thread walks one whole tile, so no walk state crosses a
// chunk boundary (the TPU kernel carried it in VMEM across grid steps).
// The loads of a tile position do not depend on the walk state, so the
// unrolled loop keeps several of them in flight.
//
// What bounds it on this card: latency. At 1080p (n = 2,073,600,
// tile = 15360) only 135 threads are busy, each walking 15360 positions
// serially; the card is nearly idle. Accepted for bring-up. P-frame data
// blocks use the same walk with one 256-position tile per block.

#include <cuda_runtime.h>

#define MAX_RUN 255

__global__ void run_walk_kernel(const int* __restrict__ fits,
                                const int* __restrict__ st,
                                unsigned char* __restrict__ out, long long n,
                                int tile, long long n_tiles) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tiles) return;
  const long long base = i * tile;
  const long long end = base + tile < n ? base + tile : n;
  int cur = 0, run = 0;
#pragma unroll 8
  for (long long p = base; p < end; ++p) {
    const int f = fits[p];
    const int s = st[p];
    const bool ext = p != base && ((f >> cur) & 1) && run < MAX_RUN;
    out[p] = ext ? 0 : 1;
    cur = ext ? cur : s;
    run = ext ? run + 1 : 1;
  }
}

extern "C" int sptc_run_walk(const int* fits, const int* st, unsigned char* out,
                             long long n, int tile, void* stream) {
  if (tile < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + tile - 1) / tile;
  const int threads = 128;
  const long long blocks = (n_tiles + threads - 1) / threads;
  run_walk_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      fits, st, out, n, tile, n_tiles);
  return (int)cudaGetLastError();
}
