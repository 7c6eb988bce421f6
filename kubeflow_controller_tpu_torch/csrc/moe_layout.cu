// The MoE layer's grouped row layout on Hopper (sm_90a): each routing
// slot's rank inside its expert, and the maps built from that rank.
//
// Replaces no Pallas kernel: the JAX package builds this layout with
// jnp.cumsum over the one-hot [slots, groups] assignment
// (kubeflow_controller_tpu/models/moe.py, _grouped_ffn), which XLA lowers.
// On the port it replaces the same cumsum in PyTorch (ops/moe_layout.py,
// moe_layout_plain): torch's scan along the outer dimension gives each of
// the G columns one thread, so a handful of threads walk every slot one
// after another (~102 ms for 262,144 slots and 65 groups), and the one-hot
// and its cumsum are two [N, G] int64 buffers.
//
// What it computes, equal to the plain version bit for bit.  Slot s
// (s < N, N = B * T * k) goes to group g(s): its expert, or with a shard's
// expert range [first, first + E) its expert less `first` when the expert
// lies in the range and the sentinel group E when it does not (G = E, or
// E + 1 with a range).  Its rank is the number of earlier slots, in slot
// order, that went to the same group.  Group g's rows start at
// off[g] = sum over h < g of round_up(count[h], bm) and end at ends[g]:
//   dest[s]            = off[g(s)] + rank(s)
//   inv_src[dest[s]]   = s / k, or n_tok (= N / k) for a sentinel slot
//   inv_pos[dest[s]]   = s
//   inv_src[r], inv_pos[r] = n_tok, N on every other row r < M
//                        (pad rows and the tail past the last group)
//   tile_experts[t]    = min(#{g : ends[g] <= t * bm}, E - 1)
//   valid_tiles[0]     = ends[E - 1] / bm   (with a range only)
// where M = N + G * bm.  Ranks are counted, never handed out by atomics:
// no atomics at all, so every launch gives the same bits.
//
// What bounds it on this card: bytes, and below ~1M slots the launches.
// The indices are read twice (8 B a slot each time), dest written once
// (8 B a slot), inv_src and inv_pos once each (8 B a row): ~4 MB at
// 262,144 slots, ~1.2 us at 3.35 TB/s.
//
// The design: three launches on the caller's stream.
//   count   Each warp owns a run of RUN consecutive slots (a "unit"), reads
//           its indices once into registers, and counts its groups in a
//           shared histogram of its own: __match_any_sync finds the lanes
//           of one group in a 32-slot chunk and its lowest lane adds their
//           number, so no two lanes touch one counter.  Writes
//           counts[unit, G] (int32).
//   offsets One block a group: the exclusive scan of that group's counts
//           over the units (in place: each unit's base rank in the group)
//           and the group's total.
//   place   Each block scans the G totals' padded sizes into off[] and
//           ends[] in shared memory; each warp walks its unit again in
//           slot order from its bases, the rank within a chunk being the
//           popcount of its group's lanes below it; then every thread
//           writes the sentinels on its share of the pad and tail rows
//           and the tile owners (a binary search over ends[]).
// The grid follows from N alone (and M for the last launch): no knob.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 256;                // slots a warp owns
constexpr int CHUNKS = RUN / 32;
constexpr int MAX_GROUPS = 1024;        // = THREADS * GROUP_ITEMS
constexpr int GROUP_ITEMS = MAX_GROUPS / THREADS;
constexpr int SCAN_ITEMS = 4;           // units a thread scans a pass
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_GROUP = 0xffffffffu;   // a lane past the last slot

// Where a routing index goes (see the top of the file).  Without a range
// an index outside [0, E) stops the kernel, as an index out of range does
// in torch's own kernels.
struct Groups {
  int n_experts;       // E
  int groups;          // G: E, or E + 1 with a range
  long long first;     // the range's first expert
  int sharded;         // a range was given
};

__device__ __forceinline__ unsigned group_of(int64_t e, const Groups& gs) {
  if (gs.sharded)
    return (e >= gs.first && e < gs.first + gs.n_experts)
               ? static_cast<unsigned>(e - gs.first)
               : static_cast<unsigned>(gs.n_experts);
  if (e < 0 || e >= gs.n_experts) __trap();
  return static_cast<unsigned>(e);
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The exclusive scan of v over the block (every thread calls it);
// *total gets the sum.  warp_sums holds WARPS ints of shared memory.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      const int y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    if (lane < WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[WARPS - 1];
  __syncthreads();   // warp_sums is free for the next call
  return before + x - v;
}

// The number of ends[] at or below x (searchsorted, side "right").
__device__ __forceinline__ int count_le(const int* ends, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A unit's indices, one chunk of 32 a register (-1 past the last slot).
__device__ __forceinline__ void load_unit(const int64_t* idx, int n,
                                          int start, int lane,
                                          int64_t (&e)[CHUNKS]) {
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int s = start + c * 32 + lane;
    e[c] = s < n ? idx[s] : -1;
  }
}

__global__ void __launch_bounds__(THREADS)
moe_layout_scan_count_kernel(const int64_t* __restrict__ idx, int n,
                             Groups gs, int* __restrict__ counts) {
  __shared__ int hist[WARPS][MAX_GROUPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * WARPS + warp;
  const int start = unit * RUN;
  if (start >= n) return;
  int* h = hist[warp];
  for (int g = lane; g < gs.groups; g += 32) h[g] = 0;
  int64_t e[CHUNKS];
  load_unit(idx, n, start, lane, e);
  __syncwarp();
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int s = start + c * 32 + lane;
    const unsigned g = s < n ? group_of(e[c], gs) : NO_GROUP;
    const unsigned peers = __match_any_sync(FULL, g);
    if (g != NO_GROUP && (peers & lanes_below(lane)) == 0)
      h[g] += __popc(peers);
    __syncwarp();
  }
  int* row = counts + static_cast<size_t>(unit) * gs.groups;
  for (int g = lane; g < gs.groups; g += 32) row[g] = h[g];
}

__global__ void __launch_bounds__(THREADS)
moe_layout_scan_offsets_kernel(int* __restrict__ counts, int units,
                               int groups, int* __restrict__ totals) {
  __shared__ int warp_sums[WARPS];
  const int g = blockIdx.x;
  int carry = 0;
  for (int base = 0; base < units; base += THREADS * SCAN_ITEMS) {
    int v[SCAN_ITEMS], sum = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int u = base + threadIdx.x * SCAN_ITEMS + j;
      v[j] = u < units ? counts[static_cast<size_t>(u) * groups + g] : 0;
      sum += v[j];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, warp_sums, &total);
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int u = base + threadIdx.x * SCAN_ITEMS + j;
      if (u < units) counts[static_cast<size_t>(u) * groups + g] = run;
      run += v[j];
    }
    carry += total;
  }
  if (threadIdx.x == 0) totals[g] = carry;
}

__global__ void __launch_bounds__(THREADS)
moe_layout_scan_place_kernel(const int64_t* __restrict__ idx, int n, int k,
                             Groups gs, int bm, int m,
                             const int* __restrict__ bases,
                             const int* __restrict__ totals,
                             int64_t* __restrict__ dest,
                             int64_t* __restrict__ inv_src,
                             int64_t* __restrict__ inv_pos,
                             int* __restrict__ tile_experts,
                             int* __restrict__ valid_tiles) {
  __shared__ int run[WARPS][MAX_GROUPS];
  __shared__ int cnt[MAX_GROUPS], off[MAX_GROUPS], ends[MAX_GROUPS];
  __shared__ int warp_sums[WARPS];
  const int G = gs.groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tok = n / k;

  // Each group's count, padded offset and end.
  {
    int c[GROUP_ITEMS], p[GROUP_ITEMS], sum = 0;
#pragma unroll
    for (int j = 0; j < GROUP_ITEMS; ++j) {
      const int g = threadIdx.x * GROUP_ITEMS + j;
      c[j] = g < G ? totals[g] : 0;
      p[j] = (c[j] + bm - 1) / bm * bm;
      sum += p[j];
    }
    int total;
    int o = block_exclusive_scan(sum, warp_sums, &total);
#pragma unroll
    for (int j = 0; j < GROUP_ITEMS; ++j) {
      const int g = threadIdx.x * GROUP_ITEMS + j;
      if (g < G) {
        cnt[g] = c[j];
        off[g] = o;
        ends[g] = o + p[j];
      }
      o += p[j];
    }
  }
  __syncthreads();
  if (valid_tiles != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    valid_tiles[0] = ends[gs.n_experts - 1] / bm;

  // Place this warp's unit, in slot order.
  const int unit = blockIdx.x * WARPS + warp;
  const int start = unit * RUN;
  if (start < n) {
    int* rc = run[warp];
    const int* b = bases + static_cast<size_t>(unit) * G;
    for (int g = lane; g < G; g += 32) rc[g] = b[g];
    int64_t e[CHUNKS];
    load_unit(idx, n, start, lane, e);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int s = start + c * 32 + lane;
      const unsigned g = s < n ? group_of(e[c], gs) : NO_GROUP;
      const unsigned peers = __match_any_sync(FULL, g);
      const unsigned below = peers & lanes_below(lane);
      if (g != NO_GROUP) {
        const int d = off[g] + rc[g] + __popc(below);
        dest[s] = d;
        inv_src[d] = static_cast<int>(g) < gs.n_experts ? s / k : n_tok;
        inv_pos[d] = s;
      }
      __syncwarp();
      if (g != NO_GROUP && below == 0) rc[g] += __popc(peers);
      __syncwarp();
    }
  }

  // The sentinels on pad and tail rows, and each tile's owner.
  const int stride = gridDim.x * THREADS;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  for (int r = first; r < m; r += stride) {
    const int g = count_le(ends, G, r / bm * bm);
    if (g >= G || r - off[g] >= cnt[g]) {
      inv_src[r] = n_tok;
      inv_pos[r] = n;
    }
  }
  for (int t = first; t < m / bm; t += stride) {
    const int g = count_le(ends, G, t * bm);
    tile_experts[t] = g < gs.n_experts - 1 ? g : gs.n_experts - 1;
  }
}

}  // namespace

extern "C" {

// The grouped layout of n routing slots (idx: int64 [n], k slots a token)
// over n_experts experts in tiles of bm rows; with valid_tiles not null,
// one shard's layout over experts first_expert .. first_expert +
// n_experts - 1, the others' slots in a sentinel group.  workspace holds
// ceil(n / 256) * G + G int32 (G = n_experts, + 1 with a shard); dest
// (int64 [n]), inv_src and inv_pos (int64 [M], M = n + G * bm),
// tile_experts (int32 [M / bm]) and valid_tiles (int32 [1]) are written.
// Returns a cudaError_t code.
int kctpu_moe_layout(const void* idx, void* workspace, void* dest,
                     void* tile_experts, void* inv_src, void* inv_pos,
                     void* valid_tiles, int n, int k, int n_experts,
                     long long first_expert, int bm, void* stream) {
  Groups gs;
  gs.n_experts = n_experts;
  gs.sharded = valid_tiles != nullptr;
  gs.groups = n_experts + gs.sharded;
  gs.first = first_expert;
  const long long m = static_cast<long long>(n) +
                      static_cast<long long>(gs.groups) * bm;
  if (idx == nullptr || workspace == nullptr || dest == nullptr ||
      tile_experts == nullptr || inv_src == nullptr || inv_pos == nullptr ||
      n < 1 || k < 1 || n % k || n_experts < 1 ||
      gs.groups > MAX_GROUPS || bm < 1 || (bm & (bm - 1)) || n % bm ||
      m > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = (n + RUN - 1) / RUN;
  int* counts = static_cast<int*>(workspace);
  int* totals = counts + static_cast<size_t>(units) * gs.groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  moe_layout_scan_count_kernel<<<(units + WARPS - 1) / WARPS, THREADS, 0,
                                 s>>>(ix, n, gs, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_layout_scan_offsets_kernel<<<gs.groups, THREADS, 0, s>>>(
      counts, units, gs.groups, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((m + WARPS * RUN - 1) / (WARPS * RUN));
  moe_layout_scan_place_kernel<<<blocks, THREADS, 0, s>>>(
      ix, n, k, gs, bm, static_cast<int>(m), counts, totals,
      static_cast<int64_t*>(dest), static_cast<int64_t*>(inv_src),
      static_cast<int64_t*>(inv_pos), static_cast<int*>(tile_experts),
      static_cast<int*>(valid_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
