// Hand-written Hopper (sm_90a) kernel for the masked pass's resolve,
// bound to PyTorch through a plain C interface (ctypes;
// vk_renderer_tpu_torch/ops/masked.py):
//
//   masked_resolve_kernel  one k-buffer round's layers walked front to
//                          back per tile pixel: each winner's trilinear
//                          albedo alpha at the pixel centre, accepted at
//                          alpha >= 0.5 (mesh_pbr.frag:192-193), else the
//                          walk goes on behind it while the pixel stays
//                          pending.
//
// It replaces no pl.pallas_call: the JAX package resolves the layers with
// XLA gathers over 32-pixel cell ladders (vk_renderer_tpu/graph/frame.py:
// 579-777), and the plain PyTorch version (masked_resolve_plain) does it
// layer by layer, each a nonzero (a host sync) and some 380 small
// launches.  Here a round is one launch with no sync.
//
// What bounds it on this card: bytes of random gathers.  A tested pixel
// reads its triangle's two 32-byte rows, three vertex rows, its material
// and texture descriptors and 8 texels of two mip levels: some 14 sectors
// of 32 bytes each, scattered over the heap, against ~60 f32 operations.
// The design keeps every step but those gathers in registers: one thread
// per tile pixel (its layer reads coalesced across the warp for each k,
// the layers being [K, G, th, tw]), the walk stopping at the first
// accepted or empty layer, the triangle rows read as float4 pairs, the
// tested-pixel and probe counts summed in the block and added with one
// atomic per block.
//
// Exactness: the build passes --fmad=false and the arithmetic is spelled
// with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the order of
// ops/interp.py (interpolation_weights_rows, gather_corners,
// derivs_from_corners) and ops/texture.py (_meta_take, _lod_from_meta,
// _desc_from_meta, _bilinear_at on channel 3, or _sample_general for
// scenes with custom samplers); sqrtf and log2f are CUDA's, as
// torch.sqrt and torch.log2 are on the card; torch.maximum,
// torch.minimum and clamp propagate NaN and so do their mirrors here;
// float-to-int casts truncate (saturating, NaN to 0) as PyTorch's do;
// torch.remainder's floor-mod is spelled out.  So the kernel agrees with
// the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// f32(1 / 255) as _unpack_rgba8's Python scalar meets an f32 tensor
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
// clamp(rho, min=1e-12) in _lod_from_meta, the scalar rounded to f32
constexpr float kRhoMin = static_cast<float>(1e-12);
constexpr int kWrapClamp = 1, kWrapMirror = 2;   // texture.WRAP_*

struct Args {
    const float* layer_d;        // [K, G, th, tw]
    const int* layer_i;          // [K, G, th, tw], -1 where empty
    const float* depth_in;       // [G, th, tw]
    const int* tid_in;
    const unsigned char* pend_in;   // null: the frame extent
    const float* deep_in;           // null: 0
    float* depth_out;
    int* tid_out;
    unsigned char* pend_out;
    float* deep_out;
    const float4* row1;          // [T+1, 8] as float4 pairs
    const float4* row2;
    const float* vattr;          // [V, 8]
    const int* mat_tex;          // [M, 3], column 0 the albedo texture
    const int* texels;
    const int* mip_offsets;      // [n_tex, max_mips]
    const int* mip_sizes;        // [n_tex, max_mips, 2]
    const int* n_mips;
    const int* modes;
    int* probe_count;            // null: no probe
    unsigned long long* tested;  // null: not counted
    int n_px;                    // G * th * tw
    int n_layers, n_walk, probe;
    int tile_h, tile_w, cols, width, height;
    int u_col, v_col, max_mips;
};

__device__ __forceinline__ float fmul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
    return __fsub_rn(a, b);
}

__device__ __forceinline__ bool isnan_(float a) { return a != a; }

// torch.maximum / torch.minimum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
    return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
    return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return isnan_(v) ? v : fmaxf(v, lo);
}

// f32 -> i32 as PyTorch's .to(torch.int32): truncate, saturate, NaN -> 0
__device__ __forceinline__ int f2i(float x) { return static_cast<int>(x); }

// torch.remainder on ints: the sign of the divisor (n > 0 here)
__device__ __forceinline__ int floor_mod(int a, int n) {
    const int r = a % n;
    return (r != 0 && ((r < 0) != (n < 0))) ? r + n : r;
}

// i + 1 with the two's-complement wrap of an i32 tensor add
__device__ __forceinline__ int inc(int i) {
    return static_cast<int>(static_cast<unsigned>(i) + 1u);
}

__device__ __forceinline__ float alpha8(int word) {
    return fmul(static_cast<float>((word >> 24) & 0xFF), kInv255);
}

// _desc_from_meta: the heap lays a texture's mips contiguously with
// sizes max(x >> m, 1)
struct Desc {
    int off, w, h;
};

__device__ __forceinline__ Desc mip_desc(int base, int w0, int h0,
                                         int level, int max_mips) {
    int acc = 0;
    for (int m = 0; m < max_mips - 1; ++m) {
        if (level > m) acc += max(w0 >> m, 1) * max(h0 >> m, 1);
    }
    return {base + acc, max(w0 >> level, 1), max(h0 >> level, 1)};
}

// the four corner texels' alphas and the lerp (_bilinear_at's tail)
__device__ __forceinline__ float lerp2(const int* texels, long long row0,
                                       long long row1, int i0, int i1,
                                       float fx, float fy) {
    const float t00 = alpha8(__ldg(texels + row0 + i0));
    const float t10 = alpha8(__ldg(texels + row0 + i1));
    const float t01 = alpha8(__ldg(texels + row1 + i0));
    const float t11 = alpha8(__ldg(texels + row1 + i1));
    const float top = fadd(t00, fmul(fsub(t10, t00), fx));
    const float bot = fadd(t01, fmul(fsub(t11, t01), fx));
    return fadd(top, fmul(fsub(bot, top), fy));
}

// _bilinear_at: REPEAT-wrapped corners of the base texel
__device__ float bilinear(const int* texels, Desc d, float u, float v) {
    const float x = fsub(fmul(u, static_cast<float>(d.w)), 0.5f);
    const float y = fsub(fmul(v, static_cast<float>(d.h)), 0.5f);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float fx = fsub(x, x0);
    const float fy = fsub(y, y0);
    const int x0i = floor_mod(f2i(x0), d.w);
    const int y0i = floor_mod(f2i(y0), d.h);
    const int x1i = floor_mod(x0i + 1, d.w);
    const int y1i = floor_mod(y0i + 1, d.h);
    const long long row0 = static_cast<long long>(d.off) + y0i * d.w;
    const long long row1 = static_cast<long long>(d.off) + y1i * d.w;
    return lerp2(texels, row0, row1, x0i, x1i, fx, fy);
}

// _wrap_index: 0 REPEAT, 1 CLAMP_TO_EDGE, 2 MIRRORED_REPEAT
__device__ __forceinline__ int wrap_index(int i, int n, int mode) {
    if (mode == kWrapClamp) return min(max(i, 0), n - 1);
    if (mode == kWrapMirror) {
        const int m = floor_mod(i, 2 * n);
        return m >= n ? 2 * n - 1 - m : m;
    }
    return floor_mod(i, n);
}

// _sample_general's level(): NEAREST folds to fx = fy = 0
__device__ float general_level(const int* texels, Desc d, float u, float v,
                               bool nearest, int wrap_s, int wrap_t) {
    const float wf = static_cast<float>(d.w);
    const float hf = static_cast<float>(d.h);
    const float xb = fsub(fmul(u, wf), 0.5f);
    const float yb = fsub(fmul(v, hf), 0.5f);
    const float xn = floorf(fmul(u, wf));
    const float yn = floorf(fmul(v, hf));
    const int x0 = f2i(nearest ? xn : floorf(xb));
    const int y0 = f2i(nearest ? yn : floorf(yb));
    const float fx = nearest ? 0.0f : fsub(xb, floorf(xb));
    const float fy = nearest ? 0.0f : fsub(yb, floorf(yb));
    const int i0 = wrap_index(x0, d.w, wrap_s);
    const int i1 = wrap_index(inc(x0), d.w, wrap_s);
    const int j0 = wrap_index(y0, d.h, wrap_t);
    const int j1 = wrap_index(inc(y0), d.h, wrap_t);
    const long long row0 = static_cast<long long>(d.off) + j0 * d.w;
    const long long row1 = static_cast<long long>(d.off) + j1 * d.w;
    return lerp2(texels, row0, row1, i0, i1, fx, fy);
}

// winner_alpha: the albedo alpha of triangle t at pixel centre (px, py)
template <bool kGeneral>
__device__ float winner_alpha(const Args& a, int t, float px, float py) {
    // interpolation_weights_rows
    const float4 r1a = __ldg(a.row1 + 2 * t);
    const float4 r1b = __ldg(a.row1 + 2 * t + 1);
    const float4 r2a = __ldg(a.row2 + 2 * t);
    const float4 r2b = __ldg(a.row2 + 2 * t + 1);
    const float pxa = fsub(px, r2a.y);
    const float pya = fsub(py, r2a.z);
    const float ea[3] = {r1a.x, r1a.w, r1b.z};
    const float eb[3] = {r1a.y, r1b.x, r1b.w};
    const float ec[3] = {r1a.z, r1b.y, r2a.x};
    float e[3];
    for (int k = 0; k < 3; ++k) {
        e[k] = fadd(fadd(fmul(ea[k], pxa), fmul(eb[k], pya)), ec[k]);
    }
    const float esum = fadd(fadd(e[0], e[1]), e[2]);
    const float esafe = esum != 0.0f ? esum : 1.0f;
    const float inv = __fdiv_rn(1.0f, esafe);
    const float lam[3] = {fmul(e[0], inv), fmul(e[1], inv),
                          fmul(e[2], inv)};
    const int mat = f2i(r2a.w);
    const long long vidx[3] = {static_cast<long long>(r2b.x),
                               static_cast<long long>(r2b.y),
                               static_cast<long long>(r2b.z)};
    // gather_corners + derivs_from_corners on the UV channels
    const float dax = fadd(fadd(ea[0], ea[1]), ea[2]);
    const float day = fadd(fadd(eb[0], eb[1]), eb[2]);
    float val[2], ddx[2], ddy[2];
    const int ch[2] = {a.u_col, a.v_col};
    for (int c = 0; c < 2; ++c) {
        const float v0 = __ldg(a.vattr + vidx[0] * 8 + ch[c]);
        const float v1 = __ldg(a.vattr + vidx[1] * 8 + ch[c]);
        const float v2 = __ldg(a.vattr + vidx[2] * 8 + ch[c]);
        val[c] = fadd(fadd(fmul(v0, lam[0]), fmul(v1, lam[1])),
                      fmul(v2, lam[2]));
        const float nx = fadd(fadd(fmul(v0, ea[0]), fmul(v1, ea[1])),
                              fmul(v2, ea[2]));
        const float ny = fadd(fadd(fmul(v0, eb[0]), fmul(v1, eb[1])),
                              fmul(v2, eb[2]));
        ddx[c] = fmul(fsub(nx, fmul(val[c], dax)), inv);
        ddy[c] = fmul(fsub(ny, fmul(val[c], day)), inv);
    }
    const float u = val[0], v = val[1];
    // _meta_take
    const int tex = __ldg(a.mat_tex + static_cast<long long>(mat) * 3);
    const int w0i = __ldg(a.mip_sizes + tex * a.max_mips * 2);
    const int h0i = __ldg(a.mip_sizes + tex * a.max_mips * 2 + 1);
    const int max_l = __ldg(a.n_mips + tex) - 1;
    const int base = __ldg(a.mip_offsets + tex * a.max_mips);
    const float w0 = static_cast<float>(w0i);
    const float h0 = static_cast<float>(h0i);
    const float max_level = static_cast<float>(max_l);
    // _lod_from_meta: (dudx, dvdx) against (dudy, dvdy)
    const float sx = fmul(ddx[0], w0), tx = fmul(ddx[1], h0);
    const float sy = fmul(ddy[0], w0), ty = fmul(ddy[1], h0);
    const float rho = nan_max(sqrtf(fadd(fmul(sx, sx), fmul(tx, tx))),
                              sqrtf(fadd(fmul(sy, sy), fmul(ty, ty))));
    const float lam_l = nan_min(
        clamp_min(log2f(clamp_min(rho, kRhoMin)), 0.0f), max_level);
    const int max_li = f2i(max_level);
    if (!kGeneral) {
        // sample_trilinear's default path
        const int l0 = f2i(floorf(lam_l));
        const int l1 = min(l0 + 1, max_li);
        const float frac = fsub(lam_l, static_cast<float>(l0));
        const Desc d0 = mip_desc(base, w0i, h0i, l0, a.max_mips);
        const float c0 = bilinear(a.texels, d0, u, v);
        const bool deeper = l1 > l0;
        const Desc d1 = deeper ? Desc{d0.off + d0.w * d0.h,
                                      max(d0.w >> 1, 1), max(d0.h >> 1, 1)}
                               : d0;
        const float c1 = bilinear(a.texels, d1, u, v);
        return fadd(c0, fmul(fsub(c1, c0), frac));
    }
    // _sample_general: the per-sampler mode bits
    const int mode = __ldg(a.modes + tex);
    const bool mag_n = (mode & 1) > 0;
    const bool min_n = (mode & 2) > 0;
    const bool mip_n = (mode & 4) > 0;
    const int wrap_s = (mode >> 3) & 3;
    const int wrap_t = (mode >> 5) & 3;
    const bool nearest = lam_l <= 0.0f ? mag_n : min_n;
    const int d_near = min(max(f2i(ceilf(fadd(lam_l, 0.5f))) - 1, 0),
                           max_li);
    const int l0 = mip_n ? d_near : f2i(floorf(lam_l));
    const int l1 = mip_n ? d_near : min(l0 + 1, max_li);
    const float frac = mip_n ? 0.0f : fsub(lam_l, floorf(lam_l));
    const float c0 = general_level(
        a.texels, mip_desc(base, w0i, h0i, l0, a.max_mips), u, v, nearest,
        wrap_s, wrap_t);
    const float c1 = general_level(
        a.texels, mip_desc(base, w0i, h0i, l1, a.max_mips), u, v, nearest,
        wrap_s, wrap_t);
    return fadd(c0, fmul(fsub(c1, c0), frac));
}

template <bool kGeneral>
__global__ void __launch_bounds__(kThreads)
masked_resolve_kernel(const Args a) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    int tested = 0, probed = 0;
    if (p < a.n_px) {
        const int tile_px = a.tile_h * a.tile_w;
        const int g = p / tile_px;
        const int r = p - g * tile_px;
        const int y = r / a.tile_w;
        const int x = r - y * a.tile_w;
        const int fx = (g % a.cols) * a.tile_w + x;
        const int fy = (g / a.cols) * a.tile_h + y;
        float depth = a.depth_in[p];
        int tid = a.tid_in[p];
        bool pending = a.pend_in ? a.pend_in[p] != 0
                                 : (fx < a.width && fy < a.height);
        float deepest = a.deep_in ? a.deep_in[p] : 0.0f;
        const float px = fadd(static_cast<float>(fx), 0.5f);
        const float py = fadd(static_cast<float>(fy), 0.5f);
        for (int k = 0; k < a.n_walk && pending; ++k) {
            const int lt = a.layer_i[k * a.n_px + p];
            if (lt < 0) {             // nothing behind: the pixel resolves
                pending = false;
                break;
            }
            const float ld = a.layer_d[k * a.n_px + p];
            ++tested;
            const bool acc = winner_alpha<kGeneral>(a, lt, px, py) >= 0.5f;
            if (acc) {
                depth = ld;
                tid = lt;
            }
            pending = !acc;
            deepest = ld;
        }
        if (a.probe && pending
            && a.layer_i[(a.n_layers - 1) * a.n_px + p] >= 0) {
            probed = 1;
        }
        a.depth_out[p] = depth;
        a.tid_out[p] = tid;
        a.pend_out[p] = pending ? 1 : 0;
        a.deep_out[p] = deepest;
    }
    if (a.tested == nullptr && a.probe_count == nullptr) return;
    __shared__ int block_sum[2];
    if (threadIdx.x < 2) block_sum[threadIdx.x] = 0;
    __syncthreads();
    const int warp_t = __reduce_add_sync(0xffffffffu, tested);
    const int warp_p = __reduce_add_sync(0xffffffffu, probed);
    if ((threadIdx.x & 31) == 0) {
        if (warp_t) atomicAdd(&block_sum[0], warp_t);
        if (warp_p) atomicAdd(&block_sum[1], warp_p);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        if (a.tested && block_sum[0]) {
            atomicAdd(a.tested,
                      static_cast<unsigned long long>(block_sum[0]));
        }
        if (a.probe_count && block_sum[1]) {
            atomicAdd(a.probe_count, block_sum[1]);
        }
    }
}

}  // namespace

extern "C" {

// The caller checks shapes, types and contiguity (ops/masked.py) and keeps
// K * G * th * tw below 2^31.  Returns cudaGetLastError() after the launch.
int vkr_masked_resolve(
    const float* layer_d, const int* layer_i, int n_layers, int n_walk,
    int probe, const float* depth_in, const int* tid_in,
    const unsigned char* pend_in, const float* deep_in, float* depth_out,
    int* tid_out, unsigned char* pend_out, float* deep_out, int n_tiles,
    int tile_h, int tile_w, int cols, int width, int height,
    const float* row1, const float* row2, const float* vattr, int u_col,
    int v_col, const int* mat_tex, const int* texels,
    const int* mip_offsets, const int* mip_sizes, const int* n_mips,
    const int* modes, int max_mips, int general, int* probe_count,
    long long* tested, void* stream) {
    Args a;
    a.layer_d = layer_d;
    a.layer_i = layer_i;
    a.depth_in = depth_in;
    a.tid_in = tid_in;
    a.pend_in = pend_in;
    a.deep_in = deep_in;
    a.depth_out = depth_out;
    a.tid_out = tid_out;
    a.pend_out = pend_out;
    a.deep_out = deep_out;
    a.row1 = reinterpret_cast<const float4*>(row1);
    a.row2 = reinterpret_cast<const float4*>(row2);
    a.vattr = vattr;
    a.mat_tex = mat_tex;
    a.texels = texels;
    a.mip_offsets = mip_offsets;
    a.mip_sizes = mip_sizes;
    a.n_mips = n_mips;
    a.modes = modes;
    a.probe_count = probe ? probe_count : nullptr;
    a.tested = reinterpret_cast<unsigned long long*>(tested);
    a.n_px = n_tiles * tile_h * tile_w;
    a.n_layers = n_layers;
    a.n_walk = n_walk;
    a.probe = probe;
    a.tile_h = tile_h;
    a.tile_w = tile_w;
    a.cols = cols;
    a.width = width;
    a.height = height;
    a.u_col = u_col;
    a.v_col = v_col;
    a.max_mips = max_mips;
    if (a.n_px <= 0) return 0;
    const int blocks = (a.n_px + kThreads - 1) / kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (general) {
        masked_resolve_kernel<true><<<blocks, kThreads, 0, s>>>(a);
    } else {
        masked_resolve_kernel<false><<<blocks, kThreads, 0, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
