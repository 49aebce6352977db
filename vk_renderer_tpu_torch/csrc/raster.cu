// Hand-written Hopper (sm_90a) kernels for the two Pallas raster kernels of
// vk_renderer_tpu/ops/raster_pallas.py, bound to PyTorch through a plain C
// interface (ctypes; vk_renderer_tpu_torch/ops/raster_kernels.py):
//   raster_depth_kernel        replaces _kernel   (raster_pallas.py:50)
//   raster_layers_kernel<K>    replaces _kernel_k (raster_pallas.py:147)
//   plan_segments              splits the heavy tiles' streams (below)
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
// A record touches a pixel only if its row range meets the pixel's 8-row
// band (the Pallas kernels' sub-block guards, raster_pallas.py:113-116).
//
// What bounds them on this card.  Device-memory traffic is small (a tile's
// records are 4 KB a chunk; the k-buffer writes K layers), so the work is
// the per-(record, pixel) evaluation: three edge planes, the depth plane
// and the edge sum, ~25 f32 operations.  Evaluating every record of a
// band at every pixel of it wastes most of that on triangles that lie
// elsewhere (a 1080p Sponza triangle covers tens of pixels), and a tile
// whose stream is long (8,716 records in the far shadow cascade) keeps one
// block busy long after the rest of the grid has drained.
//
// Design.
// - A block of 256 threads owns one region of an 8-row band of a tile;
//   each of its 8 warps owns a footprint inside the band, the lanes' pixel
//   state (depth/id, or K layers) in registers for the whole stream.  The
//   depth raster gives a lane two pixels (8x8 footprints, 64x8 regions):
//   half the blocks for the same work; the k-buffer one (8x4, 32x8), as a
//   second K-layer stack costs it more registers than the blocks it
//   saves.  Small blocks let several fit on one SM.
// - Chunks are staged into a ring of 4 buffers in shared memory with
//   cp.async.bulk, each completed on its own mbarrier: three chunks are in
//   flight while the block works on one.  Once per chunk the block decodes
//   it into a field-major copy (plane coefficients, tri*8+bits and row
//   range as ints), so that lane l can read record l without bank
//   conflicts; one __syncthreads a chunk.
// - Exact footprint culling: after the decode each warp tests its
//   footprint against the chunk's 64 records (two a lane) and ballots a
//   64-bit mask of the records that hit its band and may cover one of its
//   pixels; it then walks only the set bits, in stream order.  The test
//   is exact.  Each step of e = fl(fl(fl(a*px) + fl(b*py)) + k) is a
//   correctly rounded, hence monotone, function of one changing operand:
//   fl(a*px) is monotone in px (non-decreasing for a >= 0, non-increasing
//   for a < 0), and fl(u + c) is non-decreasing in u.  So for a fixed py,
//   e is monotone in px, and for a fixed px, in py, and its maximum over a
//   rectangle of pixel centres is taken at the corner chosen by the signs
//   of a and b (its minimum at the opposite corner).  That corner value is
//   computed with the very expression the pixel test uses, so "maximum
//   < 0" proves that no pixel of the footprint passes that edge (or the
//   near clip z >= 0).  The k-buffer also culls a record whose depth
//   minimum exceeds the footprint's largest bound, or whose maximum is at
//   most its smallest floor (NaN bounds and floors reject every fragment,
//   and fmaxf/fminf skip them; a NaN plane value never culls).  Nothing
//   inexact is culled on: no bounding box, no margin.
// - Balanced heavy tiles: plan_segments (one block, from the device's
//   counts, no host sync) cuts the stream of every tile longer than
//   kSegChunks chunks into segments of kSegChunks chunks, as far as the
//   partial-result workspace holds them (if it does not, only the longest
//   streams are cut: the length threshold doubles until they fit).  One
//   block takes one (segment, region); the extra segments come first in
//   the grid, so the long work starts first.  A cut tile's blocks write
//   partial results; the last block of a (tile, region) to finish merges
//   them in segment order and writes the output.
// - Exact merges.  The depth raster's sequential result is the
//   lexicographic minimum of (zc, -stream index) over the init value
//   (index -1) and every band-hitting record, zc = z where covered and 2.0
//   where not: segment 0 starts from the init value, the others from
//   none, and a later segment's result wins a tie.  A culled record that
//   hits the band is (2.0, index) at every pixel of the footprint, so the
//   warp keeps only the latest such index (uniform across the warp) and
//   folds it into its segment's minimum at the end; each pixel tracks its
//   winner's index for that.  A k-buffer holds the K smallest distinct
//   covered depths, each with the latest fragment at that depth, so the
//   segments' stacks merge by inserting their real entries (id !=
//   sentinel; a real entry may lie at depth 2.0) in segment order with
//   the k-buffer's own rule.  raster_kernels.merge_depth_segments and
//   merge_layer_segments are the plain mirrors of both rules.
//
// Exactness of the pixel test: coverage uses the explicit top-left rule
// (e > 0) | (e == 0 & top_left) and the near clip z >= 0 — the Pallas
// kernels fold both into `> -FLT_MIN` compares, which equal these only
// under the TPU's flush-to-zero.  Plane evaluation is written with
// __fmul_rn/__fadd_rn in the Pallas kernel's order (a*px + b*py) + k so
// no FMA contraction changes a rounding (the build also passes
// --fmad=false); the plain PyTorch versions evaluate the same expression.
//
// block_ns (optional, null on the frame's path): per block, the
// %globaltimer at its start and end, for measuring the spread of block
// times over a launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 16;
constexpr int kChunk = 64;
constexpr int kTileW = 128;
constexpr int kBand = 8;
constexpr int kChunkFloats = kChunk * kFields;
constexpr unsigned kChunkBytes = kChunkFloats * 4;
constexpr int kStages = 4;                // the chunk ring
constexpr int kThreads = 256;
constexpr int kPlaneFields = 12;
constexpr int kSoaStride = kChunk + 2;    // conflict-free decode stores
constexpr int kSegChunks = 8;             // chunks of one stream segment
constexpr long long kPartialBytes = 32LL << 20;   // partial-result budget
constexpr int kPlanThreads = 1024;
// pixels a lane (see the design note at the top)
constexpr int kDepthPx = 2;
constexpr int kLayersPx = 1;

static_assert(kThreads * 4 == kChunkFloats, "one float4 per thread");

// A warp's footprint is 8 x 4 pixels with one pixel a lane (PX = 1) or
// 8 x 8 with two (PX = 2: rows y and y + 4); it never leaves its 8-row
// band.  A block's 8 warps cover one region of a band: 32 x 8 or 64 x 8.
template <int PX>
struct Shape {
    static_assert(PX == 1 || PX == 2, "1 or 2 pixels a lane");
    static constexpr int kFootW = 8;
    static constexpr int kFootH = 4 * PX;
    static constexpr int kWarpsPerRow = (kThreads / 32) / (kBand / kFootH);
    static constexpr int kRegionW = kWarpsPerRow * kFootW;
    static constexpr int kRegionsPerBand = kTileW / kRegionW;
};

struct __align__(16) Stage {
    float4 aos[kStages][kChunkFloats / 4];        // the chunk ring
    float soa[2][kPlaneFields * kSoaStride];      // field-major planes
    int tb[2][kChunk];                            // tri*8 + top-left bits
    int rr[2][kChunk];                            // r0*256 + r1
    unsigned long long bar[kStages];              // one mbarrier a buffer
    int flag;                                     // last-arrival broadcast
};

// The segment plan in the workspace (ints): [0] the number of extra
// segments E, then per tile the first extra item, the number of segments
// and the first partial-result slot (-1: not cut), then one arrival
// counter per (tile, region).
struct Plan {
    const int* n_extra;
    const int* extra_start;
    const int* nseg;
    const int* slot;
    int* arrivals;
};

__device__ __forceinline__ Plan read_plan(int* plan, int n_tiles) {
    Plan p;
    p.n_extra = plan;
    p.extra_start = plan + 1;
    p.nseg = plan + 1 + n_tiles;
    p.slot = plan + 1 + 2 * n_tiles;
    p.arrivals = plan + 1 + 3 * n_tiles;
    return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// One thread: arm the buffer's barrier for 4 KB and start the bulk copy.
// The proxy fence orders the block's earlier reads of the buffer (ended
// by the __syncthreads before this call) before the async-proxy write.
__device__ __forceinline__ void stage_chunk(float4* dst, const float* src,
                                            unsigned long long* bar) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(kChunkBytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
           "r"(kChunkBytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ long long global_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ float plane(float a, float b, float k, float px,
                                       float py) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), k);
}

__device__ __forceinline__ bool inside(float e, int top_left) {
    return (e > 0.0f) | ((e == 0.0f) & (top_left != 0));
}

// Where a block's threads are: one region (blockIdx.y) of a tile, one
// footprint a warp, PX pixels a lane.
template <int PX>
struct Geometry {
    int band_lo;                 // first row of the region's 8-row band
    int x[PX], row[PX];          // this lane's pixels, tile-local
    float px[PX], py[PX];        // their centres
    float xlo, xhi, ylo, yhi;    // the footprint's extreme pixel centres
};

template <int PX>
__device__ __forceinline__ Geometry<PX> geometry() {
    using S = Shape<PX>;
    Geometry<PX> g;
    const int band = blockIdx.y / S::kRegionsPerBand;
    const int region = blockIdx.y % S::kRegionsPerBand;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int x0 = region * S::kRegionW + (warp % S::kWarpsPerRow) * S::kFootW;
    const int y0 = band * kBand + (warp / S::kWarpsPerRow) * S::kFootH;
    g.band_lo = band * kBand;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
        g.x[p] = x0 + lane % 8;
        g.row[p] = y0 + lane / 8 + 4 * p;
        g.px[p] = static_cast<float>(g.x[p]) + 0.5f;
        g.py[p] = static_cast<float>(g.row[p]) + 0.5f;
    }
    g.xlo = static_cast<float>(x0) + 0.5f;
    g.xhi = static_cast<float>(x0 + S::kFootW - 1) + 0.5f;
    g.ylo = static_cast<float>(y0) + 0.5f;
    g.yhi = static_cast<float>(y0 + S::kFootH - 1) + 0.5f;
    return g;
}

// One work item of a launch: segment seg (of nseg) of tile t, chunks
// [k0, k1) of its stream.
struct Item {
    int t, seg, nseg, k0, k1;
};

__device__ __forceinline__ Item make_item(const Plan& p, int t, int seg,
                                          const int* counts) {
    Item it;
    it.t = t;
    it.seg = seg;
    it.nseg = p.nseg[t];
    const int nk = (counts[t] + kChunk - 1) / kChunk;
    it.k0 = seg * kSegChunks;
    it.k1 = it.nseg == 1 ? nk : min(nk, it.k0 + kSegChunks);
    return it;
}

// Runs ``process(item)`` for this block's items: the items are the extra
// segments (1 .. nseg - 1 of the cut tiles) first, so the long streams
// start first, then segment 0 of every tile; block x of a grid row takes
// items x, x + gridDim.x, ...
template <class Process>
__device__ __forceinline__ void for_items(const Plan& p, int n_tiles,
                                          const int* counts,
                                          Process&& process) {
    const int n_extra = *p.n_extra;
    for (int item = blockIdx.x; item < n_extra + n_tiles;
         item += gridDim.x) {
        if (item >= n_extra) {
            process(make_item(p, item - n_extra, 0, counts));
            continue;
        }
        // the tile whose extra segments hold the item: the last one whose
        // first extra item is <= item
        int lo = 0, hi = n_tiles - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (p.extra_start[mid] <= item) lo = mid; else hi = mid - 1;
        }
        process(make_item(p, lo, item - p.extra_start[lo] + 1, counts));
    }
}

// The staged chunk, field-major: thread i holds float4 i (fields 4q..4q+3
// of record i/4).  With a row stride of 66 floats the stores of one warp
// fall on 32 distinct banks.
__device__ __forceinline__ void decode_chunk(Stage& s, int st, int b) {
    const int i = threadIdx.x;
    const int r = i >> 2;
    const int q = i & 3;
    const float4 v = s.aos[st][i];
    if (q < 3) {
        float* col = s.soa[b] + (4 * q) * kSoaStride + r;
        col[0] = v.x;
        col[kSoaStride] = v.y;
        col[2 * kSoaStride] = v.z;
        col[3 * kSoaStride] = v.w;
    } else {
        s.tb[b][r] = static_cast<int>(v.x);
        s.rr[b][r] = static_cast<int>(v.y);
    }
}

// Plane maximum / minimum over the footprint's pixel centres: the corner
// chosen by the signs of a and b (see the note at the top).
template <class G>
__device__ __forceinline__ float plane_max(float a, float b, float k,
                                           const G& g) {
    return plane(a, b, k, a >= 0.0f ? g.xhi : g.xlo,
                 b >= 0.0f ? g.yhi : g.ylo);
}

template <class G>
__device__ __forceinline__ float plane_min(float a, float b, float k,
                                           const G& g) {
    return plane(a, b, k, a >= 0.0f ? g.xlo : g.xhi,
                 b >= 0.0f ? g.ylo : g.yhi);
}

struct Test {
    bool hit;      // the record's row range meets the footprint's band
    bool may;      // no edge and no near clip excludes the whole footprint
    float zmin, zmax;
};

template <class G>
__device__ __forceinline__ Test footprint_test(const Stage& s, int b, int r,
                                               const G& g) {
    const float* f = s.soa[b] + r;
    const auto at = [&](int i) { return f[i * kSoaStride]; };
    const int rr = s.rr[b][r];
    Test t;
    t.hit = ((rr & 255) > g.band_lo) & ((rr >> 8) < g.band_lo + kBand);
    const float e0 = plane_max(at(0), at(1), at(2), g);
    const float e1 = plane_max(at(3), at(4), at(5), g);
    const float e2 = plane_max(at(6), at(7), at(8), g);
    t.zmax = plane_max(at(9), at(10), at(11), g);
    t.zmin = plane_min(at(9), at(10), at(11), g);
    // written as !(x < 0) so that a NaN corner keeps the record
    t.may = !(e0 < 0.0f) & !(e1 < 0.0f) & !(e2 < 0.0f) & !(t.zmax < 0.0f);
    return t;
}

__device__ __forceinline__ uint64_t ballot64(bool lo, bool hi) {
    return (static_cast<uint64_t>(__ballot_sync(0xffffffffu, hi)) << 32)
           | __ballot_sync(0xffffffffu, lo);
}

struct Frag {
    bool cov;
    float z;
    int tri;
};

// Evaluates staged record c at the lane's PX pixels: fields 0-11 as three
// broadcast float4 loads, tri*8 + bits from the decoded copy.
template <int PX>
__device__ __forceinline__ void eval_record(const Stage& s, int st, int b,
                                            int c, const Geometry<PX>& g,
                                            Frag (&out)[PX]) {
    const float4* f = s.aos[st] + 4 * c;
    const float4 q0 = f[0], q1 = f[1], q2 = f[2];
    const int tb = s.tb[b][c];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
        const float px = g.px[p], py = g.py[p];
        out[p].tri = tb >> 3;
        const float e0 = plane(q0.x, q0.y, q0.z, px, py);
        const float e1 = plane(q0.w, q1.x, q1.y, px, py);
        const float e2 = plane(q1.z, q1.w, q2.x, px, py);
        out[p].z = plane(q2.y, q2.z, q2.w, px, py);
        out[p].cov = inside(e0, tb & 1) & inside(e1, tb & 2)
                     & inside(e2, tb & 4)
                     & (__fadd_rn(__fadd_rn(e0, e1), e2) > 0.0f)
                     & (out[p].z >= 0.0f);
    }
}

__device__ __forceinline__ void init_ring(Stage& s) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < kStages; ++i) bar_init(&s.bar[i]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
}

// The chunk pipeline shared by both kernels: chunks [k0, k1) of the stream
// at chunk0.  ``used`` counts the chunks this block has staged before
// (block-uniform); chunk u of the block goes to ring buffer u % kStages,
// whose barrier then completes its (u / kStages)-th phase.  ``visit(st, b,
// k)`` runs once per chunk k, staged in buffer st and decoded into copy b,
// after a barrier that also guarantees that every warp has finished the
// previous chunk — so its buffer can take the chunk kStages - 1 ahead.
template <class Visit>
__device__ __forceinline__ void stream_chunks(Stage& s, uint32_t& used,
                                              const float* chunk0, int k0,
                                              int k1, Visit&& visit) {
    const int n = k1 - k0;
    __syncthreads();   // the previous item is done with every buffer
    if (threadIdx.x == 0) {
        for (int i = 0; i < min(n, kStages - 1); ++i) {
            const uint32_t u = used + i;
            stage_chunk(s.aos[u % kStages],
                        chunk0 + static_cast<size_t>(k0 + i) * kChunkFloats,
                        &s.bar[u % kStages]);
        }
    }
    for (int i = 0; i < n; ++i) {
        const uint32_t u = used + i;
        const int st = u % kStages;
        const int b = u & 1;
        bar_wait(&s.bar[st], (u / kStages) & 1);
        decode_chunk(s, st, b);
        __syncthreads();
        if (threadIdx.x == 0 && i + kStages - 1 < n) {
            const uint32_t v = u + kStages - 1;
            stage_chunk(s.aos[v % kStages],
                        chunk0 + static_cast<size_t>(k0 + i + kStages - 1)
                                     * kChunkFloats,
                        &s.bar[v % kStages]);
        }
        visit(st, b, k0 + i);
    }
    used += n;
}

// Publishes this block's partial results and tells whether it is the last
// of the tile's nseg blocks for its region to do so.
__device__ __forceinline__ bool last_arrival(Stage& s, int* counter,
                                             int nseg) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s.flag = atomicAdd(counter, 1) == nseg - 1;
    __syncthreads();
    const bool last = s.flag != 0;
    if (last) __threadfence();
    return last;
}

__device__ __forceinline__ void block_time(long long* block_ns,
                                           long long start) {
    if (block_ns == nullptr) return;
    __syncthreads();
    if (threadIdx.x == 0) {
        const size_t b = static_cast<size_t>(blockIdx.y) * gridDim.x
                         + blockIdx.x;
        block_ns[2 * b] = start;
        block_ns[2 * b + 1] = global_ns();
    }
}

// ---------------------------------------------------------------------------
// the segment plan
// ---------------------------------------------------------------------------

__device__ __forceinline__ int warp_inclusive_scan(int v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += n;
    }
    return v;
}

// Exclusive prefix sum over a block of kPlanThreads; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* ws, int* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int inc = warp_inclusive_scan(v);
    if (lane == 31) ws[warp] = inc;
    __syncthreads();
    if (warp == 0) ws[lane] = warp_inclusive_scan(ws[lane]);
    __syncthreads();
    const int base = warp ? ws[warp - 1] : 0;
    *total = ws[kPlanThreads / 32 - 1];
    __syncthreads();   // ws is reused by the next call
    return base + inc - v;
}

__device__ __forceinline__ int stream_chunks_of(const int* counts, int t) {
    return (counts[t] + kChunk - 1) / kChunk;
}

// One block: cut every stream longer than thr chunks into segments of
// kSegChunks, thr = kSegChunks doubled until the cut tiles' segments fit
// in cap_slots partial-result slots; lay out the work items (the extra
// segments first, then segment 0 of every tile) and zero the arrival
// counters.
__global__ void __launch_bounds__(kPlanThreads)
plan_segments(const int* __restrict__ counts, int n_tiles, int regions,
              int cap_slots, int* __restrict__ plan) {
    __shared__ int ws[kPlanThreads / 32];
    int thr = kSegChunks;
    for (;; thr *= 2) {
        int want = 0;
        for (int t = threadIdx.x; t < n_tiles; t += kPlanThreads) {
            const int nk = stream_chunks_of(counts, t);
            if (nk > thr) want += (nk + kSegChunks - 1) / kSegChunks;
        }
        int total;
        block_exclusive_scan(want, ws, &total);
        if (total <= cap_slots) break;
    }
    int* extra_start = plan + 1;
    int* nseg = plan + 1 + n_tiles;
    int* slot = plan + 1 + 2 * n_tiles;
    int extra_base = 0;
    int slot_base = 0;
    for (int base = 0; base < n_tiles; base += kPlanThreads) {
        const int t = base + threadIdx.x;
        const int nk = t < n_tiles ? stream_chunks_of(counts, t) : 0;
        const int s = nk > thr ? (nk + kSegChunks - 1) / kSegChunks : 1;
        int extra_total, slot_total;
        const int ex = block_exclusive_scan(s - 1, ws, &extra_total);
        const int sl = block_exclusive_scan(s > 1 ? s : 0, ws, &slot_total);
        if (t < n_tiles) {
            extra_start[t] = extra_base + ex;
            nseg[t] = s;
            slot[t] = s > 1 ? slot_base + sl : -1;
        }
        extra_base += extra_total;
        slot_base += slot_total;
    }
    int* arrivals = plan + 1 + 3 * n_tiles;
    for (int i = threadIdx.x; i < n_tiles * regions; i += kPlanThreads) {
        arrivals[i] = 0;
    }
    if (threadIdx.x == 0) plan[0] = extra_base;
}

// ---------------------------------------------------------------------------
// kernel 1: depth + id
// ---------------------------------------------------------------------------

// Replaces raster_pallas.py::_kernel (rasterize_depth_packed): nearest
// covered fragment per pixel, LEQUAL later-wins, seeded by init depth/id,
// optional strict peel floor (z > floor).
template <int PX>
__global__ void __launch_bounds__(kThreads)
raster_depth_kernel(const float* __restrict__ records,
                    const int* __restrict__ rec_start,
                    const int* __restrict__ counts,
                    const float* __restrict__ init_d,
                    const int* __restrict__ init_i,
                    const float* __restrict__ floor_t,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    int n_tiles, int tile_h, int* __restrict__ plan_ws,
                    float* __restrict__ part_z, int* __restrict__ part_i,
                    int* __restrict__ part_w,
                    long long* __restrict__ block_ns) {
    __shared__ Stage s;
    const long long start = block_ns != nullptr ? global_ns() : 0;
    const Plan plan = read_plan(plan_ws, n_tiles);
    const Geometry<PX> g = geometry<PX>();
    const int lane = threadIdx.x & 31;
    const bool has_floor = floor_t != nullptr;
    init_ring(s);
    uint32_t used = 0;
    for_items(plan, n_tiles, counts, [&](const Item& it) {
        size_t pix[PX];
        float zbuf[PX], flo[PX];
        int ibuf[PX];
        int widx[PX];     // stream index of the winner (-1: none so far)
#pragma unroll
        for (int p = 0; p < PX; ++p) {
            pix[p] = (static_cast<size_t>(it.t) * tile_h + g.row[p]) * kTileW
                     + g.x[p];
            // segment 0 starts from the init value, the others from none
            zbuf[p] = it.seg == 0 ? init_d[pix[p]]
                                  : __int_as_float(0x7f800000);
            ibuf[p] = it.seg == 0 ? init_i[pix[p]] : 0;
            widx[p] = -1;
            flo[p] = has_floor ? floor_t[pix[p]] : 0.0f;
        }
        int jcull = -1;     // latest culled band-hitting record (warp-wide)
        int jtri = 0;
        const float* chunk0 = records + static_cast<size_t>(rec_start[it.t])
                                            * kChunkFloats;
        stream_chunks(s, used, chunk0, it.k0, it.k1, [&](int st, int b,
                                                          int k) {
            const Test lo = footprint_test(s, b, lane, g);
            const Test hi = footprint_test(s, b, lane + 32, g);
            uint64_t walk = ballot64(lo.hit & lo.may, hi.hit & hi.may);
            const uint64_t culled = ballot64(lo.hit & !lo.may,
                                             hi.hit & !hi.may);
            if (culled) {
                const int c = 63 - __clzll(static_cast<long long>(culled));
                jcull = k * kChunk + c;
                jtri = s.tb[b][c] >> 3;
            }
            while (walk) {
                const int c = __ffsll(static_cast<long long>(walk)) - 1;
                walk &= walk - 1;
                Frag f[PX];
                eval_record(s, st, b, c, g, f);
#pragma unroll
                for (int p = 0; p < PX; ++p) {
                    const bool cov = f[p].cov
                                     & (!has_floor | (f[p].z > flo[p]));
                    const float zc = cov ? f[p].z : 2.0f;
                    if (zc <= zbuf[p]) {     // LEQUAL: the later record wins
                        zbuf[p] = zc;
                        ibuf[p] = f[p].tri;
                        widx[p] = k * kChunk + c;
                    }
                }
            }
        });
        // fold the culled records' (2.0, jcull) into the minimum
#pragma unroll
        for (int p = 0; p < PX; ++p) {
            if ((jcull >= 0) & ((2.0f < zbuf[p])
                                | ((2.0f == zbuf[p]) & (jcull > widx[p])))) {
                zbuf[p] = 2.0f;
                ibuf[p] = jtri;
                widx[p] = jcull;
            }
        }
        if (it.nseg == 1) {
#pragma unroll
            for (int p = 0; p < PX; ++p) {
                out_d[pix[p]] = zbuf[p];
                out_i[pix[p]] = ibuf[p];
            }
            return;
        }
        // a cut tile: publish the partial, the last block merges
        const size_t per_slot = static_cast<size_t>(gridDim.y) * PX * kThreads;
        const size_t own = static_cast<size_t>(blockIdx.y) * PX * kThreads
                           + threadIdx.x;
        const int slot0 = plan.slot[it.t];
#pragma unroll
        for (int p = 0; p < PX; ++p) {
            const size_t q = (slot0 + it.seg) * per_slot + own + p * kThreads;
            part_z[q] = zbuf[p];
            part_i[q] = ibuf[p];
            part_w[q] = widx[p];
        }
        if (!last_arrival(s, plan.arrivals + it.t * gridDim.y + blockIdx.y,
                          it.nseg)) {
            return;
        }
#pragma unroll
        for (int p = 0; p < PX; ++p) {
            const size_t o = own + p * kThreads;
            float z = __ldcg(part_z + slot0 * per_slot + o);
            int id = __ldcg(part_i + slot0 * per_slot + o);
            for (int j = 1; j < it.nseg; ++j) {
                const size_t r = (slot0 + j) * per_slot + o;
                const float zj = __ldcg(part_z + r);
                if ((__ldcg(part_w + r) >= 0) & (zj <= z)) {  // later wins
                    z = zj;
                    id = __ldcg(part_i + r);
                }
            }
            out_d[pix[p]] = z;
            out_i[pix[p]] = id;
        }
    });
    block_time(block_ns, start);
}

// ---------------------------------------------------------------------------
// kernel 2: the k-buffer
// ---------------------------------------------------------------------------

// Insertion at the first layer with z <= d[j]: a tie replaces it, a strict
// insert shifts the deeper layers down one slot.
template <int K>
__device__ __forceinline__ void insert_layer(float (&d)[K], int (&id)[K],
                                             float z, int tri) {
    bool taken = false;
    bool pushed = false;
    float prev_d = 0.0f;
    int prev_i = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const float dj = d[j];
        const int ij = id[j];
        const bool rep = !taken & (z <= dj);
        const bool strict = rep & (z < dj);
        taken |= rep;
        if (pushed) {
            d[j] = prev_d;
            id[j] = prev_i;
        } else if (rep) {
            d[j] = z;
            id[j] = tri;
        }
        pushed |= strict;
        prev_d = dj;
        prev_i = ij;
    }
}

// Replaces raster_pallas.py::_kernel_k (rasterize_layers_grid): the K
// nearest covered fragments per pixel with strictly increasing depths,
// z <= bound and (optionally) z > floor; a fragment tying a layer's depth
// replaces it, a strictly nearer one shifts the deeper layers down.
// Empty layers are (2.0, sentinel).  K is a template parameter so the
// layer stacks stay in registers (the insertion loop fully unrolls).
// A culled record covers no pixel of the footprint, so it is skipped.
template <int K, int PX>
__global__ void __launch_bounds__(kThreads)
raster_layers_kernel(const float* __restrict__ records,
                     const int* __restrict__ rec_start,
                     const int* __restrict__ counts,
                     const float* __restrict__ bound_t,
                     const float* __restrict__ floor_t,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int n_tiles, int tile_h, int sentinel,
                     int* __restrict__ plan_ws, float* __restrict__ part_d,
                     int* __restrict__ part_i,
                     long long* __restrict__ block_ns) {
    __shared__ Stage s;
    const long long start = block_ns != nullptr ? global_ns() : 0;
    const Plan plan = read_plan(plan_ws, n_tiles);
    const Geometry<PX> g = geometry<PX>();
    const size_t plane_px = static_cast<size_t>(n_tiles) * tile_h * kTileW;
    const int lane = threadIdx.x & 31;
    const bool has_floor = floor_t != nullptr;
    init_ring(s);
    uint32_t used = 0;
    for_items(plan, n_tiles, counts, [&](const Item& it) {
        size_t pix[PX];
        float bound[PX], flo[PX];
        float d[PX][K];
        int id[PX][K];
        // the footprint's largest bound and smallest floor (NaNs skipped)
        float bmax = __int_as_float(0x7fc00000);
        float fmin = __int_as_float(0x7fc00000);
#pragma unroll
        for (int p = 0; p < PX; ++p) {
            pix[p] = (static_cast<size_t>(it.t) * tile_h + g.row[p]) * kTileW
                     + g.x[p];
            bound[p] = bound_t[pix[p]];
            flo[p] = has_floor ? floor_t[pix[p]] : 0.0f;
            bmax = fmaxf(bmax, bound[p]);
            fmin = fminf(fmin, flo[p]);
#pragma unroll
            for (int j = 0; j < K; ++j) {
                d[p][j] = 2.0f;
                id[p][j] = sentinel;
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
            fmin = fminf(fmin, __shfl_xor_sync(0xffffffffu, fmin, o));
        }
        const float* chunk0 = records + static_cast<size_t>(rec_start[it.t])
                                            * kChunkFloats;
        stream_chunks(s, used, chunk0, it.k0, it.k1, [&](int st, int b,
                                                          int) {
            const Test lo = footprint_test(s, b, lane, g);
            const Test hi = footprint_test(s, b, lane + 32, g);
            const bool keep_lo = lo.hit & lo.may & !(lo.zmin > bmax)
                                 & !(has_floor & (lo.zmax <= fmin));
            const bool keep_hi = hi.hit & hi.may & !(hi.zmin > bmax)
                                 & !(has_floor & (hi.zmax <= fmin));
            uint64_t walk = ballot64(keep_lo, keep_hi);
            while (walk) {
                const int c = __ffsll(static_cast<long long>(walk)) - 1;
                walk &= walk - 1;
                Frag f[PX];
                eval_record(s, st, b, c, g, f);
#pragma unroll
                for (int p = 0; p < PX; ++p) {
                    if (f[p].cov & (f[p].z <= bound[p])
                        & (!has_floor | (f[p].z > flo[p]))) {
                        insert_layer<K>(d[p], id[p], f[p].z, f[p].tri);
                    }
                }
            }
        });
        if (it.nseg == 1) {
#pragma unroll
            for (int p = 0; p < PX; ++p) {
#pragma unroll
                for (int j = 0; j < K; ++j) {
                    out_d[j * plane_px + pix[p]] = d[p][j];
                    out_i[j * plane_px + pix[p]] = id[p][j];
                }
            }
            return;
        }
        // a cut tile: publish the partial stacks, the last block merges
        const size_t per_slot = static_cast<size_t>(gridDim.y) * PX * K
                                * kThreads;
        const size_t own = static_cast<size_t>(blockIdx.y) * PX * K
                           * kThreads + threadIdx.x;
        const int slot0 = plan.slot[it.t];
#pragma unroll
        for (int p = 0; p < PX; ++p) {
            const size_t q = (slot0 + it.seg) * per_slot + own
                             + p * K * kThreads;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                part_d[q + j * kThreads] = d[p][j];
                part_i[q + j * kThreads] = id[p][j];
            }
        }
        if (!last_arrival(s, plan.arrivals + it.t * gridDim.y + blockIdx.y,
                          it.nseg)) {
            return;
        }
        // segment 0's stacks, then every later segment's real entries
        // inserted in order (an empty slot is (2.0, sentinel); a real
        // entry at 2.0 has a real id)
#pragma unroll
        for (int p = 0; p < PX; ++p) {
            const size_t o = own + p * K * kThreads;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                d[p][j] = __ldcg(part_d + slot0 * per_slot + o + j * kThreads);
                id[p][j] = __ldcg(part_i + slot0 * per_slot + o + j * kThreads);
            }
            for (int sg = 1; sg < it.nseg; ++sg) {
                const size_t r = (slot0 + sg) * per_slot + o;
                for (int j = 0; j < K; ++j) {
                    const int ij = __ldcg(part_i + r + j * kThreads);
                    if (ij != sentinel) {
                        insert_layer<K>(d[p], id[p],
                                        __ldcg(part_d + r + j * kThreads), ij);
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < K; ++j) {
                out_d[j * plane_px + pix[p]] = d[p][j];
                out_i[j * plane_px + pix[p]] = id[p][j];
            }
        }
    });
    block_time(block_ns, start);
}

// ---------------------------------------------------------------------------
// launch geometry and workspace
// ---------------------------------------------------------------------------

int px_of(int k_layers) { return k_layers == 0 ? kDepthPx : kLayersPx; }

int regions_of(int tile_h, int px) {
    return (tile_h / kBand) * (px == 2 ? Shape<2>::kRegionsPerBand
                                       : Shape<1>::kRegionsPerBand);
}

// blocks a row of the grid: one per tile plus room for extra segments
// (a block that finds more items than blocks loops over them)
int grid_x(int n_tiles) { return n_tiles + n_tiles / 8 + 8; }

// the plan's ints, with arrival counters for the most regions a tile has
int plan_ints(int n_tiles, int tile_h) {
    return 1 + 3 * n_tiles + n_tiles * regions_of(tile_h, 1);
}

// partial-result bytes of one slot (one segment of one tile, all regions)
long long slot_bytes(int tile_h, int k_layers) {
    const long long px = static_cast<long long>(tile_h) * kTileW;
    return k_layers == 0 ? px * 12 : px * 8 * k_layers;
}

int cap_slots(int tile_h, int k_layers) {
    const long long cap = kPartialBytes / slot_bytes(tile_h, k_layers);
    return static_cast<int>(cap > 1 ? cap : 1);
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

size_t partial_values(int tile_h, int k_layers) {
    return static_cast<size_t>(cap_slots(tile_h, k_layers)) * tile_h * kTileW
           * (k_layers == 0 ? 1 : k_layers);
}

struct Workspace {
    int* plan;
    float* part_f;
    int* part_i;
    int* part_w;
};

Workspace carve(void* ws, int n_tiles, int tile_h, int k_layers) {
    char* p = static_cast<char*>(ws);
    Workspace w;
    w.plan = reinterpret_cast<int*>(p);
    p += align16(sizeof(int) * plan_ints(n_tiles, tile_h));
    const size_t vals = partial_values(tile_h, k_layers);
    w.part_f = reinterpret_cast<float*>(p);
    p += align16(4 * vals);
    w.part_i = reinterpret_cast<int*>(p);
    p += align16(4 * vals);
    w.part_w = k_layers == 0 ? reinterpret_cast<int*>(p) : nullptr;
    return w;
}

cudaError_t launch_plan(const int* counts, int n_tiles, int tile_h,
                        int k_layers, int* plan, cudaStream_t stream) {
    plan_segments<<<1, kPlanThreads, 0, stream>>>(
        counts, n_tiles, regions_of(tile_h, px_of(k_layers)),
        cap_slots(tile_h, k_layers), plan);
    return cudaGetLastError();
}

template <int K>
cudaError_t launch_layers(const float* records, const int* rec_start,
                          const int* counts, const float* bound_t,
                          const float* floor_t, float* out_d, int* out_i,
                          int n_tiles, int tile_h, int sentinel, void* ws,
                          long long* block_ns, cudaStream_t stream) {
    constexpr int PX = kLayersPx;
    const Workspace w = carve(ws, n_tiles, tile_h, K);
    cudaError_t err = launch_plan(counts, n_tiles, tile_h, K, w.plan, stream);
    if (err != cudaSuccess) return err;
    raster_layers_kernel<K, PX><<<dim3(grid_x(n_tiles),
                                       regions_of(tile_h, PX)),
                                  kThreads, 0, stream>>>(
        records, rec_start, counts, bound_t, floor_t, out_d, out_i, n_tiles,
        tile_h, sentinel, w.plan, w.part_f, w.part_i, block_ns);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int vkr_max_layers() { return 16; }

// blocks of one launch (the length of block_ns is 2 * this)
int vkr_raster_blocks(int n_tiles, int tile_h, int k_layers) {
    return grid_x(n_tiles) * regions_of(tile_h, px_of(k_layers));
}

// bytes of the workspace one launch needs (k_layers = 0: the depth raster)
long long vkr_raster_workspace(int n_tiles, int tile_h, int k_layers) {
    return static_cast<long long>(
               align16(sizeof(int) * plan_ints(n_tiles, tile_h)))
           + static_cast<long long>(align16(4 * partial_values(tile_h,
                                                                k_layers)))
             * (k_layers == 0 ? 3 : 2);
}

int vkr_raster_depth(const float* records, const int* rec_start,
                     const int* counts, const float* init_d,
                     const int* init_i, const float* floor_t, float* out_d,
                     int* out_i, int n_tiles, int tile_h, void* ws,
                     long long* block_ns, void* stream) {
    if (n_tiles <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Workspace w = carve(ws, n_tiles, tile_h, 0);
    cudaError_t err = launch_plan(counts, n_tiles, tile_h, 0, w.plan, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    raster_depth_kernel<kDepthPx><<<dim3(grid_x(n_tiles),
                                         regions_of(tile_h, kDepthPx)),
                                    kThreads, 0, s>>>(
        records, rec_start, counts, init_d, init_i, floor_t, out_d, out_i,
        n_tiles, tile_h, w.plan, w.part_f, w.part_i, w.part_w, block_ns);
    return static_cast<int>(cudaGetLastError());
}

int vkr_raster_layers(const float* records, const int* rec_start,
                      const int* counts, const float* bound_t,
                      const float* floor_t, float* out_d, int* out_i,
                      int n_tiles, int tile_h, int k_layers, int sentinel,
                      void* ws, long long* block_ns, void* stream) {
    if (n_tiles <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (k_layers) {
#define VKR_CASE(K)                                                          \
    case K:                                                                  \
        err = launch_layers<K>(records, rec_start, counts, bound_t, floor_t, \
                               out_d, out_i, n_tiles, tile_h, sentinel, ws,  \
                               block_ns, s);                                 \
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
