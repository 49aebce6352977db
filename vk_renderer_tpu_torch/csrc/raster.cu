// Hand-written Hopper (sm_90a) kernels for the two Pallas raster kernels of
// vk_renderer_tpu/ops/raster_pallas.py, bound to PyTorch through a plain C
// interface (ctypes; vk_renderer_tpu_torch/ops/raster_kernels.py).
//
// Both kernels walk a tile's OCCUPANCY-PACKED record stream (built by
// raster_kernels.build_records): record chunk r is 64 records x 16 f32
// fields, 4 KB:
//   0-8   a,b,k of the three inside-positive edges, tile-folded
//   9-11  a,b,k of the screen-linear depth plane, tile-folded
//   12    tri*8 + top-left bits (bit i: edge i is a top or left edge)
//   13    r0*256 + r1, the triangle's covered tile-row range [r0, r1)
//   14-15 pad
// Tile t owns chunks rec_start[t] .. rec_start[t] + ceil(counts[t]/64) - 1.
// Pixel centers are tile-local ((x + 0.5, y + 0.5)); tiles are 128 wide.
//
// Design (both kernels): one thread block per 128x8 band of a tile, one
// thread per pixel (1024 threads), the pixel's depth/id state in
// registers for the whole stream.  The block stages one record chunk at a
// time in shared memory (each thread loads one float) and every thread
// walks the 64 records in stream order — the per-pixel sequential
// semantics of the Pallas kernels (LEQUAL later-wins z-test, k-buffer
// insertion) need that order.  A record whose row range misses the band
// is skipped by the whole block (a uniform branch), mirroring the Pallas
// kernels' 8-row sub-block guards (raster_pallas.py:113-116).
//
// What bounds it on this card: per record each thread does ~14 broadcast
// shared-memory reads and ~25 f32 ops, and the records are re-read by the
// tile's 4 bands, so the kernel is bound by issue rate on the densest
// tiles (on the bench frame the densest 1080p tile streams ~1.5k
// triangles in the opaque pass and ~3k in the masked one): the heavy
// tiles' blocks run long after the rest of the grid has drained.  Device-memory traffic is small (4 KB per chunk
// per band, read once into shared memory).  Balancing the heavy tiles
// (splitting a tile's stream across blocks and merging) is later work.
//
// Exactness: coverage uses the explicit top-left rule
// (e > 0) | (e == 0 & top_left) and the near clip z >= 0 — the Pallas
// kernels fold both into `> -FLT_MIN` compares, which equal these only
// under the TPU's flush-to-zero.  Plane evaluation is written with
// __fmul_rn/__fadd_rn in the Pallas kernel's order (a*px + b*py) + k so
// no FMA contraction changes a rounding (the build also passes
// --fmad=false); the plain PyTorch versions evaluate the same expression.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 16;
constexpr int kChunk = 64;
constexpr int kTileW = 128;
constexpr int kBand = 8;
constexpr int kChunkFloats = kChunk * kFields;   // 1024 == threads per block

__device__ __forceinline__ float plane(float a, float b, float k, float px,
                                       float py) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), k);
}

__device__ __forceinline__ bool inside(float e, int top_left) {
    return (e > 0.0f) | ((e == 0.0f) & (top_left != 0));
}

struct Frag {
    bool cov;
    float z;
    int tri;
};

// Evaluates record c of the staged chunk at pixel (px, py).  Returns
// cov=false also when the record's row range misses the band (the caller
// has already skipped such records block-uniformly).
__device__ __forceinline__ Frag eval_record(const float* f, float px,
                                            float py) {
    Frag out;
    int tb = static_cast<int>(f[12]);
    out.tri = tb >> 3;
    float e0 = plane(f[0], f[1], f[2], px, py);
    float e1 = plane(f[3], f[4], f[5], px, py);
    float e2 = plane(f[6], f[7], f[8], px, py);
    out.z = plane(f[9], f[10], f[11], px, py);
    out.cov = inside(e0, tb & 1) & inside(e1, tb & 2) & inside(e2, tb & 4)
              & (__fadd_rn(__fadd_rn(e0, e1), e2) > 0.0f)
              & (out.z >= 0.0f);
    return out;
}

__device__ __forceinline__ bool band_hit(const float* f, int band_lo) {
    int rr = static_cast<int>(f[13]);
    int r0 = rr >> 8;
    int r1 = rr & 255;
    return (r1 > band_lo) & (r0 < band_lo + kBand);
}

// Replaces raster_pallas.py::_kernel (rasterize_depth_packed): nearest
// covered fragment per pixel, LEQUAL later-wins, seeded by init depth/id,
// optional strict peel floor (z > floor).
__global__ void __launch_bounds__(1024)
raster_depth_kernel(const float* __restrict__ records,
                    const int* __restrict__ rec_start,
                    const int* __restrict__ counts,
                    const float* __restrict__ init_d,
                    const int* __restrict__ init_i,
                    const float* __restrict__ floor_t,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    int tile_h) {
    __shared__ float srec[kChunkFloats];
    const int t = blockIdx.x;
    const int band_lo = blockIdx.y * kBand;
    const int x = threadIdx.x;
    const int row = band_lo + threadIdx.y;
    const int lin = threadIdx.y * kTileW + x;
    const size_t pix = (static_cast<size_t>(t) * tile_h + row) * kTileW + x;
    const float px = static_cast<float>(x) + 0.5f;
    const float py = static_cast<float>(row) + 0.5f;

    float zbuf = init_d[pix];
    int ibuf = init_i[pix];
    const bool has_floor = floor_t != nullptr;
    const float flo = has_floor ? floor_t[pix] : 0.0f;

    const int nk = (counts[t] + kChunk - 1) / kChunk;
    const float* chunk0 = records + static_cast<size_t>(rec_start[t]) * kChunkFloats;
    for (int k = 0; k < nk; ++k) {
        __syncthreads();
        srec[lin] = chunk0[static_cast<size_t>(k) * kChunkFloats + lin];
        __syncthreads();
        for (int c = 0; c < kChunk; ++c) {
            const float* f = srec + c * kFields;
            if (!band_hit(f, band_lo)) continue;
            Frag g = eval_record(f, px, py);
            bool cov = g.cov & (!has_floor | (g.z > flo));
            float zc = cov ? g.z : 2.0f;
            if (zc <= zbuf) {        // LEQUAL: the later record wins ties
                zbuf = zc;
                ibuf = g.tri;
            }
        }
    }
    out_d[pix] = zbuf;
    out_i[pix] = ibuf;
}

// Replaces raster_pallas.py::_kernel_k (rasterize_layers_grid): the K
// nearest covered fragments per pixel with strictly increasing depths,
// z <= bound and (optionally) z > floor; a fragment tying a layer's depth
// replaces it, a strictly nearer one shifts the deeper layers down.
// Empty layers are (2.0, sentinel).  K is a template parameter so the
// layer stack stays in registers (the insertion loop fully unrolls).
template <int K>
__global__ void __launch_bounds__(1024)
raster_layers_kernel(const float* __restrict__ records,
                     const int* __restrict__ rec_start,
                     const int* __restrict__ counts,
                     const float* __restrict__ bound_t,
                     const float* __restrict__ floor_t,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int n_tiles, int tile_h, int sentinel) {
    __shared__ float srec[kChunkFloats];
    const int t = blockIdx.x;
    const int band_lo = blockIdx.y * kBand;
    const int x = threadIdx.x;
    const int row = band_lo + threadIdx.y;
    const int lin = threadIdx.y * kTileW + x;
    const size_t plane_px = static_cast<size_t>(n_tiles) * tile_h * kTileW;
    const size_t pix = (static_cast<size_t>(t) * tile_h + row) * kTileW + x;
    const float px = static_cast<float>(x) + 0.5f;
    const float py = static_cast<float>(row) + 0.5f;

    float d[K];
    int id[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
        d[j] = 2.0f;
        id[j] = sentinel;
    }
    const float bound = bound_t[pix];
    const bool has_floor = floor_t != nullptr;
    const float flo = has_floor ? floor_t[pix] : 0.0f;

    const int nk = (counts[t] + kChunk - 1) / kChunk;
    const float* chunk0 = records + static_cast<size_t>(rec_start[t]) * kChunkFloats;
    for (int k = 0; k < nk; ++k) {
        __syncthreads();
        srec[lin] = chunk0[static_cast<size_t>(k) * kChunkFloats + lin];
        __syncthreads();
        for (int c = 0; c < kChunk; ++c) {
            const float* f = srec + c * kFields;
            if (!band_hit(f, band_lo)) continue;
            Frag g = eval_record(f, px, py);
            bool cov = g.cov & (g.z <= bound) & (!has_floor | (g.z > flo));
            if (!cov) continue;
            // insertion at the first layer with z <= d[j]: a tie replaces
            // it, a strict insert shifts the deeper layers down one slot
            bool taken = false;
            bool pushed = false;
            float prev_d = 0.0f;
            int prev_i = 0;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const float dj = d[j];
                const int ij = id[j];
                const bool rep = !taken & (g.z <= dj);
                const bool strict = rep & (g.z < dj);
                taken |= rep;
                if (pushed) {
                    d[j] = prev_d;
                    id[j] = prev_i;
                } else if (rep) {
                    d[j] = g.z;
                    id[j] = g.tri;
                }
                pushed |= strict;
                prev_d = dj;
                prev_i = ij;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
        out_d[j * plane_px + pix] = d[j];
        out_i[j * plane_px + pix] = id[j];
    }
}

template <int K>
cudaError_t launch_layers(const float* records, const int* rec_start,
                          const int* counts, const float* bound_t,
                          const float* floor_t, float* out_d, int* out_i,
                          int n_tiles, int tile_h, int sentinel,
                          cudaStream_t stream) {
    dim3 grid(n_tiles, tile_h / kBand);
    dim3 block(kTileW, kBand);
    raster_layers_kernel<K><<<grid, block, 0, stream>>>(
        records, rec_start, counts, bound_t, floor_t, out_d, out_i, n_tiles,
        tile_h, sentinel);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int vkr_max_layers() { return 16; }

int vkr_raster_depth(const float* records, const int* rec_start,
                     const int* counts, const float* init_d,
                     const int* init_i, const float* floor_t, float* out_d,
                     int* out_i, int n_tiles, int tile_h, void* stream) {
    if (n_tiles <= 0) return 0;
    dim3 grid(n_tiles, tile_h / kBand);
    dim3 block(kTileW, kBand);
    raster_depth_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        records, rec_start, counts, init_d, init_i, floor_t, out_d, out_i,
        tile_h);
    return static_cast<int>(cudaGetLastError());
}

int vkr_raster_layers(const float* records, const int* rec_start,
                      const int* counts, const float* bound_t,
                      const float* floor_t, float* out_d, int* out_i,
                      int n_tiles, int tile_h, int k_layers, int sentinel,
                      void* stream) {
    if (n_tiles <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (k_layers) {
#define VKR_CASE(K)                                                          \
    case K:                                                                  \
        err = launch_layers<K>(records, rec_start, counts, bound_t, floor_t, \
                               out_d, out_i, n_tiles, tile_h, sentinel, s); \
        break;
        VKR_CASE(1) VKR_CASE(2) VKR_CASE(3) VKR_CASE(4)
        VKR_CASE(5) VKR_CASE(6) VKR_CASE(7) VKR_CASE(8)
        VKR_CASE(9) VKR_CASE(10) VKR_CASE(11) VKR_CASE(12)
        VKR_CASE(13) VKR_CASE(14) VKR_CASE(15) VKR_CASE(16)
#undef VKR_CASE
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}

}  // extern "C"
