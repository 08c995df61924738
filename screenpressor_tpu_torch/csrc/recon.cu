// I-frame row reconstruction (K4) for Hopper (sm_90a).
//
// Replaces the Pallas kernel of screenpressor_tpu/jx/recon.py
// (_recon_kernel / reconstruct_i). Each row obeys v[x] = a[x] * v[x-1] + b[x]
// with a in {0, 1}: literal, above and aboveleft reset (a = 0, b = the
// known value), left carries (a = 1, b = 0), gradient adds above -
// aboveleft (a = 1). Rows are sequential through the above row. Padding
// columns are left-runs, so the last pixel of row y-1 carries into column 0
// of row y, and column 0's aboveleft is the last slot of the previous
// padded row (jx/recon.py:96).
//
// Design: one thread block walks all rows of one frame; a launch takes a
// batch of frames [N, H, Wp] (the keyframing streams of a serving step, or
// one frame), one block each (blockIdx.x = frame). Per row each thread
// loads its contiguous chunk of pt/lit, builds its (a, b) pairs against the
// previous row held in shared memory (a 2048 x 3 int32 row is 24 KB at
// 1080p), composes them, and a block-wide scan of the affine compositions
// (warp shuffles, then one warp over the warp totals) gives the value
// entering each chunk; the thread then writes its pixels and the new row.
//
// What bounds it on this card: the serial row chain (1080 rows, four block
// barriers each) on one SM per frame; bytes are 2 x 24 KB per row. A batch
// of frames fills more SMs. Accepted for bring-up. Arithmetic is uint32 so
// it wraps exactly like jx's int32.

#include <cuda_runtime.h>

#define PT_LITERAL 0
#define PT_ABOVE 2
#define PT_GRADIENT 4
#define PT_ABOVELEFT 5
#define MAX_PER 8
#define FULL 0xffffffffu

struct Aff {
  unsigned a, b0, b1, b2;
};

// f1 then f2: v -> a2 * (a1 * v + b1) + b2
__device__ __forceinline__ Aff compose(const Aff& f1, const Aff& f2) {
  return {f1.a * f2.a, f2.a * f1.b0 + f2.b0, f2.a * f1.b1 + f2.b1,
          f2.a * f1.b2 + f2.b2};
}

__device__ __forceinline__ Aff shfl_up(const Aff& f, int o) {
  return {__shfl_up_sync(FULL, f.a, o), __shfl_up_sync(FULL, f.b0, o),
          __shfl_up_sync(FULL, f.b1, o), __shfl_up_sync(FULL, f.b2, o)};
}

__global__ void __launch_bounds__(1024)
recon_kernel(const int* __restrict__ pt, const int* __restrict__ lit,
             unsigned char* __restrict__ out, int h, int w, int wp) {
  pt += (size_t)blockIdx.x * h * wp;
  lit += (size_t)blockIdx.x * h * wp * 3;
  out += (size_t)blockIdx.x * h * w * 3;
  extern __shared__ unsigned smem[];
  unsigned* prev = smem;              // [wp * 3] previous row
  Aff* wtot = (Aff*)(smem + wp * 3);  // [32] warp totals, then prefixes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int per = wp / blockDim.x;
  const int x0 = tid * per;
  const Aff ident = {1u, 0u, 0u, 0u};
  for (int i = tid; i < wp * 3; i += blockDim.x) prev[i] = 0;
  __syncthreads();

  for (int y = 0; y < h; ++y) {
    const unsigned c0 = prev[(wp - 1) * 3], c1 = prev[(wp - 1) * 3 + 1],
                   c2 = prev[(wp - 1) * 3 + 2];
    Aff f[MAX_PER];
    Aff acc = ident;
#pragma unroll
    for (int i = 0; i < MAX_PER; ++i) {
      if (i >= per) break;
      const int x = x0 + i;
      const int p = pt[(size_t)y * wp + x];
      const unsigned* ab = prev + x * 3;
      const unsigned* al = prev + (x == 0 ? wp - 1 : x - 1) * 3;
      const int* lt = lit + ((size_t)y * wp + x) * 3;
      Aff g;
      if (p == PT_LITERAL) {
        g = {0u, (unsigned)lt[0], (unsigned)lt[1], (unsigned)lt[2]};
      } else if (p == PT_ABOVE) {
        g = {0u, ab[0], ab[1], ab[2]};
      } else if (p == PT_ABOVELEFT) {
        g = {0u, al[0], al[1], al[2]};
      } else if (p == PT_GRADIENT) {
        g = {1u, ab[0] - al[0], ab[1] - al[1], ab[2] - al[2]};
      } else {
        g = ident;
      }
      f[i] = g;
      acc = compose(acc, g);
    }
    // inclusive scan of the thread aggregates within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      Aff up = shfl_up(acc, o);
      if (lane >= o) acc = compose(up, acc);
    }
    Aff excl = shfl_up(acc, 1);
    if (lane == 0) excl = ident;
    __syncthreads();  // every read of prev is done
    if (lane == 31) wtot[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      Aff t = lane < nw ? wtot[lane] : ident;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        Aff up = shfl_up(t, o);
        if (lane >= o) t = compose(up, t);
      }
      Aff e = shfl_up(t, 1);
      if (lane == 0) e = ident;
      if (lane < nw) wtot[lane] = e;  // exclusive warp prefix
    }
    __syncthreads();
    const Aff pre = compose(wtot[warp], excl);
    unsigned v0 = pre.a * c0 + pre.b0, v1 = pre.a * c1 + pre.b1,
             v2 = pre.a * c2 + pre.b2;
#pragma unroll
    for (int i = 0; i < MAX_PER; ++i) {
      if (i >= per) break;
      const int x = x0 + i;
      v0 = f[i].a * v0 + f[i].b0;
      v1 = f[i].a * v1 + f[i].b1;
      v2 = f[i].a * v2 + f[i].b2;
      prev[x * 3] = v0;
      prev[x * 3 + 1] = v1;
      prev[x * 3 + 2] = v2;
      if (x < w) {
        unsigned char* o = out + ((size_t)y * w + x) * 3;
        o[0] = (unsigned char)(v0 & 0xff);
        o[1] = (unsigned char)(v1 & 0xff);
        o[2] = (unsigned char)(v2 & 0xff);
      }
    }
    __syncthreads();  // the new row is complete before the next row reads it
  }
}

// pt [n, h, wp], lit [n, h, wp, 3] -> out [n, h, w, 3]
extern "C" int sptc_recon_rows(const int* pt, const int* lit, unsigned char* out,
                               int n, int h, int w, int wp, void* stream) {
  if (wp < 128 || wp > 8192 || (wp & (wp - 1)) || w > wp || n < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = wp < 1024 ? wp : 1024;
  const size_t smem = (size_t)wp * 3 * sizeof(unsigned) + 32 * sizeof(Aff);
  cudaError_t err = cudaFuncSetAttribute(
      recon_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  recon_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(pt, lit, out, h, w, wp);
  return (int)cudaGetLastError();
}
