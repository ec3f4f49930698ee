// A coupling subnet's whole conv chain as one Hopper (sm_90a) kernel, bound
// with ctypes.
//
// Replaces the Pallas TPU kernel of
// arl_conditional_normalizing_flows_tpu/ops/pallas/fused_subnet.py:
// _build_pallas_fn (body subnet_math), reached by subnet_apply_pallas. For x
// (B, h, w, cin) float32, NHWC:
//
//   y = conv_k(x->dt, entry_w) + entry_b                       f32 trunk
//   repeat res_blocks:
//     t = lrelu(conv_1x1(lrelu(y)->dt, pre_w) + pre_b) -> dt
//     u = sum_d conv_1x1(lrelu(gconv_k,dil_d(t[..., :w_d], bw_d) + bb_d) -> dt,
//                        post_w[rows of branch d])
//     y = y + u + post_b
//   out = conv_k(lrelu(y)->dt, head_w) + head_b                f32
//
// lrelu has slope 0.3; dt (float32 or bfloat16) is the type of every product's
// operands, every sum is float32, biases are float32. SAME padding is
// dil*(k-1) in total, total/2 low and the rest high (asymmetric for even k).
// Branch d (width w_d = K/dil_d) reads the first w_d trunk channels in
// `card` groups of g_d = w_d/card: output j reads inputs [j/g_d*g_d, +g_d).
//
// Every kernel gives one block to one sample: the chain is sequential within
// a sample and independent across samples, so block barriers are all the
// ordering it needs. Grouped convs are never expanded block-diagonally over
// the whole trunk as the TPU kernel does (3.4x the work at the flagship).
//
// Bound: operations. At the flagship a pass needs 50.4 GFLOP of grouped
// products (51 us on the tensor cores at 989 TFLOP/s) against ~1.3 MB of
// inputs and outputs per launch.
//
// bfloat16 (the main path): every product runs on the tensor cores, as
// mma.sync.m16n8k16 bf16 x bf16 -> f32. Each stage is an implicit GEMM: M is a
// tile of 16 pixels of the sample, N the output channels in n8 tiles, and K
// the taps x input channels in k16 chunks of two "slices" (one tap, 8
// consecutive channels). A warp owns the same pixel tiles in every stage:
//  - the pre 1x1 takes its A operand straight from the trunk's accumulators
//    (two n8 accumulator tiles are one k16 A fragment), as the post 1x1 takes
//    its A from two branch-output tiles: no branch output is concatenated or
//    leaves registers;
//  - the k x k convs (entry, branches, head) gather their A fragments from
//    the stage input in shared memory with ldmatrix.x4, rows padded so that
//    8 consecutive pixels fall on distinct banks, a padding pixel pointed at
//    a row of zeros; a branch's walk over its taps takes its addresses from
//    a table built once a block (put_taps: no division in the walk), holds
//    them in registers for all the branch's n8 tiles, so that a product is
//    an ldmatrix, half a B load and an mma;
//  - the weights come packed by the wrapper in fragment order, K and N
//    zero-padded, each lane's B fragment one 8-byte load; nothing is
//    reshuffled per call;
//  - the biases sit in shared memory, read before any store.
// A branch's n8 output tile reads the input window of the groups it covers,
// so the block-diagonal expansion stays inside one n8 tile (exact where
// g_d = 8); with the zero padding of K and N the tensor cores are given 1.31x
// the grouped work at the flagship's largest spec (fused_subnet.mma_flops).
// Two plans, picked by the spec (narrow_plan here, from which the entry
// launches, mirrored by fused_subnet.py::narrow_plan; the table carries
// on_chip, which the entry checks against its own):
//  - on chip (the flagship's three small specs): a warp a 16-pixel tile, its
//    f32 trunk in registers for the whole chain, every weight brought by one
//    bulk copy (cp.async.bulk, the TMA) while x is converted, the stage input
//    in two buffers by turns, so one barrier a stage; no scratch. Trunks of
//    up to kChipSmallTiles n8 tiles take a build sized to them that two
//    blocks an SM can hold.
//  - scratch (28 x 28): 16 warps over the 49 tiles, the f32 trunk (196 KB a
//    sample) in the caller's scratch tensor in the accumulator layout, each
//    lane reading and writing only its own float4s (it fits neither beside
//    the 113 KB stage input in shared memory nor in 16 warps' registers);
//    each stage's weights brought by a bulk copy into the other of two
//    buffers while the stage before computes; a residual block one phase, the
//    next block's pre 1x1 run on each tile's trunk while it is in registers,
//    into a scratch copy of the stage input that one bulk copy brings in
//    after the block's barrier; the 49th tile split across warps a post 1x1
//    chunk each. Each waits on an mbarrier that traps after kWaitLimitNs.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's [kernel]
// lines, a call of 128 from a CUDA graph, inputs warm in L2): 186.5 us at
// the flagship's (28, 28, 1) K 64, 0.058 of its bound (mma.sync with the
// trunk in scratch and synchronous weight copies: 239-243 us), 14.7-27.7
// us at its three small specs (24.4-45.1). What bounds it now: a product is
// an ldmatrix, an 8-byte B load and an mma.sync, and shared memory gives an
// SM 128 B a cycle against 768 B a product; the kernel takes ~2x that rate,
// each warp's walk over taps, biases, packing and trunk traffic between
// its products. Two pixel tiles a warp in the residual blocks would share
// each B load, but spill at 128 registers (the entry and the head take two).
// The trunk-wide products on wgmma instead (a warpgroup's four tiles one
// product, their B in core matrices, read once for the four) were measured
// against this kernel with every tile whole: no faster at 128 (194 us
// both), 2% faster at 2,048, and ptxas serializes them (C7515); each
// product taking four warps rules out the split of the 49th tile, which
// gains 9 us at 128 and 2% at 2,048 (chain_ablation.py --against).
//
// float32 (cnf-conv's default dtype; the same TPU kernel at compute_dtype
// float32, subnet_math with float32 operands): the same narrow kernel, its
// skeleton templated over the product (Bf16, Tf32: the chunk depth, the
// element size, the A and B fragments, the trunk hand-off), on the tensor
// cores as three TF32 products a k8 chunk. TF32 keeps 10 bits of mantissa,
// so one product would miss the 1e-4 agreement with the CPU that float32 is
// held to (the CPU test's emulation: 9.1e-4 to 5.9e-3 off); split operands,
// a = hi + lo (Tf32::split), and lo*hi + hi*lo + hi*hi keep ~20 bits of
// each, an error of order 2^-19 a product at worst (the same emulation: at
// most 3.8e-6 from JAX, whose plain float32 chain the port's is 2.5e-6 from).
// Bound: operations, the products' rate, 165 TFLOP/s (495 TF32 / 3): at the
// flagship's (128, 28, 28, 1) K 64, 10.77 GFLOP, 65.3 us (160.8 at the 67
// TFLOP/s of float32 FMAs that the retired CUDA-core kernel was held to). The
// design keeps the bf16 kernel's: A by ldmatrix.x4 from the stage input in
// shared memory (rows of K + 4 floats, an odd number of 16-byte units), split
// once a gather and used for every n8 tile it feeds; B packed by the wrapper
// in m16n8k8 fragment order (one float32 plane, split once a load; a hi and
// a lo plane, 16 bytes a lane and no split, measured against it with
// chain_ablation.py); the trunk handed to the pre 1x1 as it stands in the
// accumulators (one n8 tile is one k8 A fragment once the wrapper permutes
// each chunk's rows: fused_subnet.py::HANDOFF_ROWS), each branch tile to the
// post 1x1 so. Plans, sized for float32 (narrow_plan<Tf32>):
//  - on chip: the flagship's three small specs, one block of 4-13 warps, the
//    whole packing and two stage inputs in 51,712-159,616 bytes;
//  - scratch (its 28 x 28, and the preset's two K 64 specs, whose packing
//    does not fit on chip): the stage input in shared memory (213,520 B at
//    28 x 28), the weights streamed through a ring of kSlots bulk copies as
//    the wide kernel's are (fused_subnet_tf32_ring_kernel), 230,640 B;
// past the tiles or shared memory the wide variant's tf32 build (below).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's [kernel]
// lines, a call of 128 from a CUDA graph, inputs warm in L2): 620.5 us at
// the flagship's (28, 28, 1) K 64, 0.105 of its bound at 165 TFLOP/s (0.259
// at 67; the CUDA-core kernel it replaced: 2,487-2,502 us in chain_ablation.py
// --against), 22.4-53.6 us at its three small specs (67-252 us); at 2,048
// 9,228 us at 28 x 28. What bounds it now: at 28 x 28 the products (three
// mma and the split a chunk) take about half the launch, and the rest is
// the skeleton: the ring walked by every warp once a round in four rounds
// (49 tiles over 16 warps), the trunk and stage-input copies through L2,
// the entry's and head's fourth round of one tile. What
// could not be shared with the bf16 scratch plan: its stage buffers of
// weights (a float32 residual block's 80 KB twice do not fit beside a
// 213 KB stage input), x's own buffer (so block 0's pre 1x1 goes through
// the scratch copy), the entry's and head's pairs of tiles and the split of
// the 49th tile (each warp walks every piece of the ring, so a tile's share
// would not shorten the walk).
//
// The wide variant (entry point fused_subnet_forward_wide; the wrapper picks
// it by the spec, fused_subnet.py::wide): what the kernels above do not take,
// as JAX's kernel does (its grid runs over batch tiles of 8 with up to 100 MB
// of VMEM; it takes any trunk and head width and any number of branches).
// The narrow kernel holds the stage input in shared memory and all K/8
// trunk tiles of a pixel tile in registers, so it stops at K 64, out_total
// 32 and a plan of ~227 KB (narrow_plan), and at kNarrowBranches branches,
// so that what it takes by value stays small. One kernel templated over its
// product, as the narrow one is (fused_subnet_mma_wide_kernel<Bf16 | Tf32>):
//  - bfloat16, written for Hopper. Bound: operations (the capacity preset's
//    (28, 28, 1) K 128: 42.4 GFLOP a call of 128, 42.9 us at 989 TFLOP/s,
//    against 1.6 MB of inputs and outputs). One block a sample, kWideGroups
//    warpgroups, each a 64-pixel tile a round (its warps the 16-pixel tiles
//    4M..4M+3, so that the f32 trunk keeps the accumulator layout above).
//    What held a first version of it (mma.sync, no shared memory) to 0.019
//    of that bound, and what this one does about each:
//    * no operand came from shared memory: the stage input now lives there
//      wherever it fits beside the ring (213,520 B at the preset's 28 x 28 x
//      128; the layout's act_in_shared, checked here) and its A fragments
//      come through the narrow kernel's ldmatrix gather; where it does not
//      fit (28 x 28 x 256, ~414 KB) it stays in the sample's scratch and
//      each lane loads its A words (kShared false), the same code otherwise;
//    * every B fragment was an 8-byte __ldg from L2 for each mma of each
//      warp: the weights now stream through a ring of kSlots slots of
//      kSlotBytes (Ring): each piece (one k16 chunk of a 128-wide stage,
//      several chunks of a narrower one, chunks of a branch group) is one
//      cp.async.bulk (TMA) completing on its slot's mbarrier, read from L2
//      once for the block's four 64-pixel tiles of a round; the warp that
//      frees a slot last copies the next piece into it, from the schedule
//      the wrapper computes (fused_subnet.py::wide_schedule) and the entry
//      checks against walk_pieces. The wrapper packs each k16 x n8 B tile as
//      two 8 x 8 core matrices, and each branch group chunk by chunk
//      (fused_subnet.py::_wide_order), so that a piece is one copy and is
//      what wgmma and ldmatrix read;
//    * A was gathered again for each chunk of 8 output tiles, on mma.sync
//      with nothing in flight: the entry, pre 1x1, post 1x1 and head are
//      wgmma.mma_async m64nNk16, A from registers (mma.sync's A layout: the
//      ldmatrix gather and the trunk's accumulator tiles as they are), B
//      from the ring, N up to 128 (kPassTiles tiles) a pass, so that A is
//      gathered once for the whole trunk. The branch tiles (n8 each, with
//      their own input windows) stay on mma.sync, kGroupTiles of them
//      sharing a walk over the chunks and B from the ring through ldmatrix;
//    * the branch outputs went to scratch as the post 1x1's A fragments
//      (351,232 B a sample at the preset): two finished tiles are one k16
//      chunk of the post 1x1's A operand and go straight into its wgmma. The
//      scratch is the f32 trunk alone where the stage input fits (401,408 B
//      a sample at the preset's 28 x 28 x 128).
//    No warp only feeds the ring: registers are split among the SM's four
//    sub-partitions, and a 17th (or 13th) warp would leave the sub-partition
//    that holds it too few for the others. 16 warps get 128 registers a
//    thread (ptxas spills ~300 bytes); 12 warps 168, but 5 rounds of
//    64-pixel tiles at 28 x 28 instead of 4, and 2 instead of 1 at 14 x 14.
//    Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's [kernel]
//    lines, a call of 128 from a CUDA graph, inputs warm in L2): 820.0 us at
//    the preset's (28, 28, 1) K 128, 0.052 of its bound (the first version:
//    2,218-2,222 us), 182.9 us at (14, 14, 2) K 128, 0.055; 12.3 and 2.8 ms
//    at 2,048. What bounds it now is latency: each warp is a chain of waits
//    (the ring, ldmatrix, the branch tiles' mma.sync, the post 1x1's wgmma
//    a tile pair), 4 warps to a sub-partition to hide them, and at 28 x 28
//    a 4th round for 16 pixels (784 = 3 x 256 + 16). Forced at the
//    flagship's K 64 it was 1.5x the narrow kernel of its time (354 against
//    241 us), and is 1.9x the narrow kernel of the on-chip and scratch plans.
//  - float32 (the capacity preset's two K 128 chains at cnf-conv's default
//    dtype, and any spec past the narrow kernel): the same skeleton, three
//    TF32 products a k8 chunk on split operands as in the narrow Tf32
//    build. Bound: operations at 165 TFLOP/s (495 TF32 / 3): 256.9 us for
//    the 42.39 GFLOP of (128, 28, 28, 1) K 128, 60.5 us at (128, 14, 14, 2).
//    What differs from bf16, and why:
//    * the trunk-wide stages run wgmma.m64nNk8 tf32, three a chunk (lo*hi,
//      hi*lo, hi*hi), A from registers split once a gather or a hand-off
//      (Tf32::tile_a: the wrapper permutes each chunk's rows, HANDOFF_ROWS).
//      wgmma reads B from shared memory, so B's lo cannot be made in
//      registers: B lands in the ring as the float32 packing holds it (the
//      tensor cores read its top 19 bits, which is hi) and each warpgroup
//      writes the piece's lo plane into one of its own two planes by turns
//      (LoPlane: a warpgroup barrier and a proxy fence a piece). The ring
//      carrying a hi and a lo plane instead would double its bytes and the
//      packing; the planes cost 23-202 us a launch at 128 (chain_ablation.py);
//    * tf32 wgmma takes B K-major only: each k8 x n8 tile is two core
//      matrices of 8 n rows of 4 floats (fused_subnet.py::TF32_CORE_ORDER),
//      the descriptor bf16's, ldmatrix giving the branch tiles' B registers;
//    * a slot is kTf32SlotBytes, two k8 chunks of a 128-wide pass, so that a
//      piece is as much work as bf16's; the post 1x1 takes a pair of branch
//      tiles' two k8 chunks a piece where a pass takes every tile;
//    * the stage input is twice bf16's: at 14 x 14 x 128 (104,016 B) it
//      still lives in shared memory (202,384 B a block with the ring and the
//      planes); at 28 x 28 x 128 (414,480 B) it does not and stays in the
//      sample's scratch, each lane reading its A values of a chunk as two
//      8-byte loads, channels 2t, 2t+1 of rows g and g+8 (the wrapper
//      permutes the k x k stages' rows there as the 1x1s',
//      fused_subnet.py::scratch_pairs).
//    Measured on an NVIDIA H100 80GB HBM3 at 700 W (chain_ablation.py
//    --against, a call of 128 from a CUDA graph, inputs warm in L2):
//    2,643-2,647 us at (128, 28, 28, 1) K 128, 0.097 of its bound (the
//    CUDA-core kernel it replaced: 7,712-7,775 us), 391-393 us at (128, 14,
//    14, 2), 0.155 (1,612-1,624 us); 40.9-41.0 and 6.0 ms at 2,048 (95.2-96.0
//    and 21.4-21.6 ms). What bounds it now: at 28 x 28 the stage input's
//    loads from L1 or L2 (a third of the launch), the two lo products
//    (~18%) and the lo planes (~8%); past those the same chain of waits as
//    bf16 (each piece waited for, split, multiplied and released by every
//    warp) and its fourth round of one tile.
// A two-block cluster per sample sharing the stage input through distributed
// shared memory was the alternative for a stage input past shared memory;
// it still fails at ~450 KB and halves the blocks a batch has, where
// scratch takes any size.
//
// Barriers: every __syncthreads() is at the top level of a kernel or inside
// loops whose trip counts (res_blocks, pixel tiles of the float32 path) are
// the same for every thread of the block. In the wide kernel every warp
// takes every piece of the ring and releases it, a warpgroup that has no
// pixels in a round included; a wait for a piece traps after kWaitLimitNs.
// Its tf32 build's warpgroup barriers (1 + the warpgroup; 0 is the block's)
// are taken by a warpgroup's four warps together: whether it has pixels in
// a round is the same for all four.
// The entry points return cudaGetLastError(), and cudaErrorInvalidValue for
// sizes they do not take or packed buffers of another size than its
// layout's, without launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Mirrored in ops/kernels/fused_subnet.py (a CPU test compares them).
constexpr int kThreads = 512;
// the most dilations a block has: ConvFlowConfig's schedule (models/arch.py::
// _dilation_schedule, as JAX's) stops at its guard of 10 levels. The wide
// variant takes that many; the narrow kernels 4, so that the parameters they
// take by value (Dims, Layout, MmaLayout, sized by their branches) stay small
constexpr int kMaxBranches = 10;
constexpr int kNarrowBranches = 4;
constexpr int kMaxShared = 232448;  // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;
constexpr int kMaxTrunkTiles = 8;  // bfloat16: n8 tiles of the trunk (K <= 64)
constexpr int kMaxHeadTiles = 4;   // bfloat16: n8 tiles of the head (out_total <= 32)
constexpr int kFrag = 128;         // bfloat16: elements of one k16 x n8 B fragment
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTableValue = 1073741824;  // bfloat16: 2**30, the layout's largest int
constexpr int kTableScalars = 29;  // bfloat16: the layout table's scalars (TABLE_FIELDS)
// narrow bfloat16: its mbarriers (32 bytes) and the branch walks' tap table, before its buffers
constexpr int kPlanHead = 672;
// narrow bfloat16, scratch plan: pixel tiles a warp has in flight in the entry and in the head
constexpr int kEntryPairTiles = 2;
constexpr int kHeadPairTiles = 2;
constexpr int kBranchTiles = 2;  // narrow bfloat16: branch tiles a walk over the taps feeds
// narrow bfloat16, on chip: trunks of at most this many n8 tiles (K <= 32)
// take an instantiation of the kernel sized to them, two blocks an SM
constexpr int kChipSmallTiles = 4;
// narrow: slices of a branch walk held as addresses (the tap table's)
constexpr int kWalkSlices = 10;
constexpr int kTapTable = 16 * kNarrowBranches * kWalkSlices;  // narrow: its bytes
static_assert(kPlanHead == 32 + kTapTable, "the mbarriers, then the tap table");
constexpr int kWideGroups = 4;     // wide: warpgroups a block
constexpr int kWideThreads = 512;  // wide: threads a block
constexpr int kSlotBytes = 4096;   // wide bfloat16 and the tf32 scratch plan: a slot of a ring
constexpr int kTf32SlotBytes = 8192;  // wide tf32: a slot of its ring
constexpr int kSlots = 4;          // wide: slots of the ring
constexpr int kBarrierBytes = 64;  // wide: a full mbarrier and a counter a slot
constexpr int kSlack = 2048;       // wide: bytes past the ring wgmma may over-read
constexpr int kGroupTiles = 8;     // wide: branch tiles that share a walk over the chunks
constexpr int kPassTiles = 16;     // wide: n8 tiles of one wgmma (N <= 128)
constexpr float kSlope = 0.3f;

// B: the branches the struct has room for (kNarrowBranches in the narrow
// kernels, kMaxBranches in the wide variant)
template <int B>
struct Dims {
  int h, w, cin, K, res_blocks, card, ksize, nd, out_total;
  int dil[B];
};

template <bool kWide>
using DimsOf = Dims<kWide ? kMaxBranches : kNarrowBranches>;

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : kSlope * v; }

template <int B>
bool dims_ok(const Dims<B>& d) {
  if (d.h < 1 || d.w < 1 || d.cin < 1 || d.K < 1 || d.res_blocks < 0 || d.card < 2 ||
      d.ksize < 1 || d.nd < 1 || d.nd > B || d.out_total < 1)
    return false;
  for (int i = 0; i < d.nd; ++i)
    if (d.dil[i] < 1 || d.K % d.dil[i] != 0 || (d.K / d.dil[i]) % d.card != 0) return false;
  return true;
}

// Sets the kernel's dynamic shared memory limit to the card's most, once per
// device, before its first launch (so never during stream capture).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// tensor cores: the products
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// c += a (16x8, row) * b (8x8, col), tf32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}


// the A fragment at this lane's address `at` (+ 2 bytes a channel of offset)
__device__ __forceinline__ void fragment_a(uint32_t at, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(at));
}

// The narrow kernels' product, one of two. A chunk of K is 8 consecutive
// channels of one tap (a "slice") times kSlices; an A fragment comes from
// the stage input in shared memory by ldmatrix.x4 (rows padded to an odd
// number of 16-byte units), a B fragment is one 8-byte load a lane from the
// wrapper's packing (kFrag elements, 256 bytes, a fragment).
//  - Bf16: mma.sync m16n8k16, bf16 operands; two slices a chunk, lanes 16-31
//    of ldmatrix on the second.
//  - Tf32: the float32 chain on the tensor cores. mma.sync m16n8k8 takes tf32
//    (10 bits of mantissa; it reads the top 19 bits of each 32-bit operand):
//    one product would miss the 1e-4 agreement that float32 is held to. Each
//    operand is split, a = hi + lo with hi = a's top 19 bits (a mask) and lo
//    = a - hi (exact, and read as tf32: its top 11 significant bits), and a
//    product is lo*hi + hi*lo + hi*hi, the cross terms summed apart where a
//    walk has few output tiles (lo*lo, ~2^-20 relative, left out): ~20 bits
//    of each operand kept, an error of order 2^-19 a product at worst, two
//    instructions a value. One slice a chunk: ldmatrix's four 8 x 16-byte
//    matrices are pixels 0-7 and 8-15 of floats 0-3, then of floats 4-7,
//    which is the m16n8k8 A layout as it stands (lanes 16-31 16 bytes on).
//    A is split once a gather, B (one float32 plane) once a load.
struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kSlices = 2;
  static constexpr int kFrag = 128;
  static constexpr int kItem = 2;  // bytes an element
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint2 v;
  };
  static __device__ __forceinline__ A load_a(uint32_t at) {
    A a;
    fragment_a(at, a.r);
    return a;
  }
  // lane's B fragment `frag` of the stage whose fragments start at w (shared)
  static __device__ __forceinline__ B load_b(const T* w, int frag) {
    return B{reinterpret_cast<const uint2*>(w + frag * kFrag)[threadIdx.x & 31]};
  }
  static __device__ __forceinline__ void product(float (&c)[4], const A& a, const B& b) {
    mma(c, a.r, b.v);
  }
  // product with a second sum for what Tf32 sums apart (none here)
  static __device__ __forceinline__ void product(float (&c)[4], float (&)[4], const A& a,
                                                 const B& b) {
    mma(c, a.r, b.v);
  }
  // from a lane's ldmatrix address in its slice to where it reads
  static __device__ __forceinline__ uint32_t lane_bytes() { return 0; }
  static __device__ __forceinline__ void store2(T* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  }
  static __device__ __forceinline__ T zero() { return __float2bfloat16(0.f); }
};

struct Tf32 {
  using T = float;
  static constexpr int kSlices = 1;
  static constexpr int kFrag = 64;
  static constexpr int kItem = 4;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  static __device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
  // the A fragment of the m16n8k8 values (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  static __device__ __forceinline__ A split_a(float a0, float a1, float a2, float a3) {
    A a;
    split(a0, a.hi[0], a.lo[0]);
    split(a1, a.hi[1], a.lo[1]);
    split(a2, a.hi[2], a.lo[2]);
    split(a3, a.hi[3], a.lo[3]);
    return a;
  }
  // An accumulator tile c of lrelu-ed values as the A fragment of a k8
  // chunk: a lane holds columns 2t, 2t + 1 of rows g, g + 8, which are A's
  // columns t and t + 4 once the wrapper has permuted the chunk's rows
  // (fused_subnet.py::HANDOFF_ROWS)
  static __device__ __forceinline__ A tile_a(float c0, float c1, float c2, float c3) {
    return split_a(c0, c2, c1, c3);
  }
  static __device__ __forceinline__ A load_a(uint32_t at) {
    uint32_t r[4];
    fragment_a(at, r);
    return split_a(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                   __uint_as_float(r[3]));
  }
  // a lane's B fragment from its two 32-bit words (as ldmatrix gives them)
  static __device__ __forceinline__ B split_b(uint32_t v0, uint32_t v1) {
    B b;
    split(__uint_as_float(v0), b.hi[0], b.lo[0]);
    split(__uint_as_float(v1), b.hi[1], b.lo[1]);
    return b;
  }
  static __device__ __forceinline__ B load_b(const T* w, int frag) {
    const float2 v = reinterpret_cast<const float2*>(w + frag * kFrag)[threadIdx.x & 31];
    B b;
    split(v.x, b.hi[0], b.lo[0]);
    split(v.y, b.hi[1], b.lo[1]);
    return b;
  }
  static __device__ __forceinline__ void product(float (&c)[4], const A& a, const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
  // the cross terms into x, hi*hi into c: two chains of products
  static __device__ __forceinline__ void product(float (&c)[4], float (&x)[4], const A& a,
                                                 const B& b) {
    mma_tf32(x, a.lo, b.hi);
    mma_tf32(x, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
  static __device__ __forceinline__ uint32_t lane_bytes() {
    return 16 * ((threadIdx.x & 31) >> 4);
  }
  static __device__ __forceinline__ void store2(T* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ T zero() { return 0.f; }
};

// ---------------------------------------------------------------------------
// tensor cores: the layout
// ---------------------------------------------------------------------------

// One n8 output tile of a branch: the first channel of its input window (a
// multiple of 8), the window's 8-channel slices per tap and its k chunks
// (both the same for every tile of a branch), and its weights' and biases'
// offsets within a block.
struct BranchTile {
  int lo8, q, chunks, w_off, b_off;
};

// The tensor-core packing, derived only in
// ops/kernels/fused_subnet.py::mma_layout and handed to every launch as a
// table of ints: weights in one buffer, every stage as [k chunk][n8 tile]
// [lane][values] B fragments (the product's kFrag elements each): the entry,
// then per residual block the pre 1x1, each branch tile in order (branch by
// branch), the post 1x1; then the head. Biases in one f32 buffer, each
// stage's padded to its n8 tiles. Offsets count elements of the dtype.
template <int B>
struct MmaLayout {
  int Kp, NT, NO;           // trunk width padded to 8, its n8 tiles, the head's
  int xs, ts;               // row strides (elements) of x and t in shared memory
  int qx, n_mt;             // x's 8-channel slices per tap; 16-pixel tiles
  int ch_entry, ch_pre, ch_post, ch_head, n_tiles;
  int w_block0, w_block, w_post, w_head, w_total;
  int b_block0, b_block, b_post, b_head, b_total;
  int trunk_per_sample;     // f32 scratch elements a sample
  int act_bytes, w_stage;   // the stage input's bytes; the weights of the largest stage
  int br_tile0[B], br_tiles[B];  // each branch's first tile, its tiles
  BranchTile tile[B * kMaxTrunkTiles];
  int on_chip;  // 1 where narrow_plan puts the narrow kernel on chip (no scratch)
};

// The table's scalars that the narrow bf16 kernel does not read (kept out of
// MmaLayout, so that its parameters stay as they were).
struct WidePlan {
  int act_in_shared;  // wide: 1 if the stage input lives in shared memory
  int wide_shared;    // wide: dynamic shared memory a block
  int n_pieces;       // pieces of one round of every stage of a ring (the table's schedule)
};
static_assert(sizeof(Dims<kMaxBranches>) + sizeof(MmaLayout<kMaxBranches>) + sizeof(WidePlan) +
                      8 * sizeof(void*) <=
                  4096,
              "a kernel's parameters fit the 4 KB every toolkit takes");

// The table's tiles start after its scalars and each branch's first tile and
// tile count.
constexpr int kTableTiles = kTableScalars + 2 * kMaxBranches;

// The wrapper's table (fused_subnet.py::layout_table) into L and W: the
// scalars in this order (TABLE_FIELDS there), each of kMaxBranches branches' first tile
// and tile count (the first B into L), then lo8, q, chunks, w_off, b_off a
// tile (the first B * kMaxTrunkTiles into L.tile, the narrow kernel's copy),
// then the wide kernel's schedule (schedule_matches checks it). False if
// the table is too short for them or has a value outside [0,
// kMaxTableValue].
template <int B>
bool read_mma_layout(const int* t, int n, MmaLayout<B>& L, WidePlan& W) {
  int* head[] = {&L.Kp,       &L.NT,       &L.NO,      &L.xs,       &L.ts,
                 &L.qx,       &L.n_mt,     &L.ch_entry, &L.ch_pre,  &L.ch_post,
                 &L.ch_head,  &L.n_tiles,  &L.w_block0, &L.w_block, &L.w_post,
                 &L.w_head,   &L.w_total,  &L.b_block0, &L.b_block, &L.b_post,
                 &L.b_head,   &L.b_total,  &L.trunk_per_sample, &L.act_bytes, &L.w_stage,
                 &W.act_in_shared, &W.wide_shared, &W.n_pieces, &L.on_chip};
  static_assert(sizeof(head) / sizeof(head[0]) == kTableScalars, "the table's scalars");
  if (t == nullptr || n < kTableTiles) return false;
  for (int i = 0; i < kTableScalars; ++i) *head[i] = t[i];
  if (L.n_tiles < 1 || W.n_pieces < 1 ||
      n - kTableTiles < 5 * static_cast<int64_t>(L.n_tiles) + 2 * static_cast<int64_t>(W.n_pieces))
    return false;
  for (int i = 0; i < n; ++i)  // so that no sum of two overflows
    if (t[i] < 0 || t[i] > kMaxTableValue) return false;
  for (int i = 0; i < B; ++i) {
    L.br_tile0[i] = t[kTableScalars + 2 * i];
    L.br_tiles[i] = t[kTableScalars + 2 * i + 1];
  }
  for (int i = 0; i < L.n_tiles && i < B * kMaxTrunkTiles; ++i) {
    const int* v = t + kTableTiles + 5 * i;
    L.tile[i] = BranchTile{v[0], v[1], v[2], v[3], v[4]};
  }
  return true;
}

// float32 scratch elements a sample of the wide kernel: the trunk, then
// the stage input (act_bytes, a multiple of 16) where it does not fit shared
// memory
template <int B>
int64_t wide_scratch(const MmaLayout<B>& L, const WidePlan& W) {
  return L.trunk_per_sample + (W.act_in_shared ? 0 : L.act_bytes / 4);
}

// the wide kernel's slot of its ring: in tf32 twice bf16's, so that a piece
// of a 128-wide stage is two k8 chunks, as much work as bf16's k16 one
template <class Prod>
constexpr int kWideSlot = Prod::kSlices == 1 ? kTf32SlotBytes : kSlotBytes;

// wide tf32: the lo planes after the ring, two a warpgroup, each a slot's
// bytes (the lo half of the piece it multiplies, split in shared memory)
template <class Prod>
constexpr int kLoPlanes = Prod::kSlices == 1 ? 2 * kWideGroups * kWideSlot<Prod> : 0;

// The wide kernel's shared memory: the ring's barriers, the ring of
// weights, in tf32 the lo planes, then the stage input if it fits beside
// them (else kSlack bytes, what wgmma may read past the ring or a plane).
// Whether it fits is the layout's (fused_subnet.py::_wide_plan); this
// checks it.
template <class Prod, int B>
bool wide_plan_ok(const MmaLayout<B>& L, const WidePlan& W) {
  const int64_t ring =
      static_cast<int64_t>(kSlots) * kWideSlot<Prod> + kBarrierBytes + kLoPlanes<Prod>;
  const int64_t with_act = ring + (L.act_bytes > kSlack ? L.act_bytes : kSlack);
  const bool fits = with_act <= kMaxShared;
  return W.act_in_shared == (fits ? 1 : 0) && W.wide_shared == (fits ? with_act : ring + kSlack);
}

// The narrow kernel's plan (fused_subnet.py::narrow_plan): on chip where a
// warp a 16-pixel tile fits a block and the whole packing and two stage
// inputs fit shared memory beside the barriers, the tap table and the
// biases; else the scratch plan of kThreads threads: in bf16 x, the stage
// input and two stage buffers of weights in shared memory; in tf32 the
// stage input and a ring of kSlots slots of weights.
struct NarrowPlan {
  bool on_chip;
  int threads;
  int64_t shared;
};

// bytes of the scratch plan's x in shared memory: hw rows of xs, a multiple
// of 16
template <int B>
__host__ __device__ __forceinline__ int64_t x_bytes(const Dims<B>& d, const MmaLayout<B>& L) {
  return (static_cast<int64_t>(d.h) * d.w * L.xs * 2 + 15) / 16 * 16;
}

// bytes of the narrow kernel's copy of the biases in shared memory (b_total,
// a multiple of 8 floats)
template <int B>
__host__ __device__ __forceinline__ int bias_bytes(const MmaLayout<B>& L) {
  return 4 * L.b_total;
}


// The scratch plan's split tiles: its last round of 16-pixel tiles over the
// warps, where that is one or two tiles and their chunks of the post 1x1
// are at most kWarps, each tile's residual blocks split across warps a chunk
// each (bf16: post_share, two branch tiles a k16 chunk; tf32: a branch tile
// a k8 chunk); else 0, and every tile is whole.
template <int B>
__host__ __device__ __forceinline__ int split_tiles(const MmaLayout<B>& L) {
  const int tail = L.n_mt % kWarps;
  return tail <= 2 && tail * L.ch_post <= kWarps ? tail : 0;
}

// the scratch plan's room after the biases: x, and from the first residual
// block on the split tiles' shares of the post 1x1 (NT n8 tiles of f32 a lane)
template <int B>
__host__ __device__ __forceinline__ int64_t x_room(const Dims<B>& d, const MmaLayout<B>& L) {
  const int64_t shares = static_cast<int64_t>(split_tiles(L)) * L.ch_post * L.NT * 512;
  const int64_t x = x_bytes(d, L);
  return x > shares ? x : shares;
}

// float32 scratch elements a sample of the narrow kernel: none on chip;
// else the trunk, then a copy of the stage input's hw rows of ts in the
// dtype, then in tf32 the split tiles' shares of the post 1x1
template <class Prod, int B>
__host__ __device__ __forceinline__ int64_t narrow_scratch(const Dims<B>& d,
                                                           const MmaLayout<B>& L) {
  if (L.on_chip) return 0;
  const int64_t shares = Prod::kSlices == 1 ? 128LL * split_tiles(L) * L.ch_post * L.NT : 0;
  return L.trunk_per_sample + static_cast<int64_t>(d.h) * d.w * L.ts * Prod::kItem / 4 + shares;
}

template <class Prod, int B>
NarrowPlan narrow_plan(const Dims<B>& d, const MmaLayout<B>& L) {
  const int64_t head = kPlanHead + bias_bytes(L);
  const int64_t chip = head + static_cast<int64_t>(Prod::kItem) * L.w_total + 2LL * L.act_bytes;
  if (L.n_mt <= kWarps && chip <= kMaxShared) return {true, 32 * L.n_mt, chip};
  if (Prod::kSlices == 1)  // tf32: the ring's barriers, the plan head, the stage input, the ring
    return {false, kThreads, kBarrierBytes + kPlanHead + L.act_bytes + kSlots * kSlotBytes};
  return {false, kThreads, head + x_room(d, L) + L.act_bytes + 4LL * L.w_stage};
}

// Whether the kernel of product Prod (wide: the wide bf16 kernel), run with
// L and the table's tiles on buffers of n_weights and n_biases elements,
// stays inside them, its shared memory, its tiles and its scratch, and covers
// every tap, channel and n8 tile of each stage. Checks only: what L computes
// is held to the chain on the CPU (tests/test_torch_fused_subnet.py) and on
// the card.
template <class Prod, int B>
bool mma_layout_ok(const Dims<B>& d, const MmaLayout<B>& L, const WidePlan& W, const int* tiles,
                   bool wide,
                   int64_t n_weights, int64_t n_biases) {
  const int64_t hw = static_cast<int64_t>(d.h) * d.w, kk = static_cast<int64_t>(d.ksize) * d.ksize;
  const int64_t f = Prod::kFrag, Kp = L.Kp, S = Prod::kSlices, item = Prod::kItem;
  const int64_t row = L.xs > L.ts ? L.xs : L.ts;
  const bool sizes =
      dims_ok(d) && L.NT >= 1 && Kp == 8LL * L.NT && Kp >= d.K && L.NO >= 1 &&
      8LL * L.NO >= d.out_total && L.qx >= 1 && 8LL * L.qx >= d.cin && L.xs >= 8LL * L.qx &&
      L.ts >= Kp && L.xs * item % 16 == 0 && L.ts * item % 16 == 0 && hw <= INT32_MAX / 16 &&
      hw * d.out_total <= INT32_MAX && L.n_mt == (hw + 15) / 16 &&
      L.trunk_per_sample == 16 * static_cast<int64_t>(L.n_mt) * Kp &&
      L.act_bytes % 16 == 0 && L.act_bytes >= (hw + 1) * row * item &&
      wide_plan_ok<Prod>(L, W);
  const bool stages =
      S * L.ch_entry >= kk * L.qx && L.ch_pre == (L.NT + S - 1) / S &&
      L.ch_post == (L.n_tiles + S - 1) / S && S * L.ch_head >= kk * L.NT &&
      L.w_block0 == f * L.ch_entry * L.NT && L.w_post % f == 0 &&
      L.w_post + f * L.ch_post * L.NT == L.w_block &&
      L.w_head == L.w_block0 + d.res_blocks * static_cast<int64_t>(L.w_block) &&
      L.w_total == n_weights && L.w_total - L.w_head == f * L.ch_head * L.NO &&
      L.w_block0 <= L.w_stage && L.w_block <= L.w_stage && L.w_total - L.w_head <= L.w_stage &&
      L.b_block0 == Kp && L.b_post + Kp == L.b_block &&
      L.b_head == L.b_block0 + d.res_blocks * static_cast<int64_t>(L.b_block) &&
      L.b_total == n_biases && L.b_total == L.b_head + 8LL * L.NO;
  // the narrow kernel's plan, shared memory, registers and by-value tiles
  const NarrowPlan P = narrow_plan<Prod>(d, L);
  const bool narrow = L.NT <= kMaxTrunkTiles && L.NO <= kMaxHeadTiles &&
                      L.n_tiles <= B * kMaxTrunkTiles && P.shared <= kMaxShared &&
                      L.on_chip == (P.on_chip ? 1 : 0);
  if (!sizes || !stages || !(wide ? wide_scratch(L, W) <= INT32_MAX : narrow)) return false;
  // branch tiles: in order, branch by branch, one window size a branch, each
  // window inside the trunk's channels, weights and biases between the pre
  // and the post 1x1's
  int64_t next = 0;
  for (int br = 0; br < d.nd; ++br) {
    const int64_t t0 = L.br_tile0[br], nt = L.br_tiles[br];
    if (t0 != next || nt < 1 || (!wide && nt > kMaxTrunkTiles) || t0 + nt > L.n_tiles ||
        8 * nt < d.K / d.dil[br])
      return false;
    const int* first = tiles + 5 * t0;
    for (int64_t j = t0; j < t0 + nt; ++j) {
      const int* v = tiles + 5 * j;  // lo8, q, chunks, w_off, b_off
      const int64_t lo8 = v[0], q = v[1], chunks = v[2], w_off = v[3], b_off = v[4];
      if (q != first[1] || chunks != first[2] || q < 1 || S * chunks < kk * q ||
          lo8 % 8 != 0 || lo8 + 8 * q > Kp || w_off < f * L.ch_pre * L.NT || w_off % f != 0 ||
          w_off + chunks * f > L.w_post || b_off < Kp || b_off + 8 > L.b_post)
        return false;
    }
    next = t0 + nt;
  }
  return next == L.n_tiles;
}

// The two pixel rows (g and g + 8) a lane holds of a 16-pixel tile.
struct Rows {
  int py[2], px[2];
  bool ok[2];
};

template <class D>
__device__ __forceinline__ Rows tile_rows(const D& d, int mt) {
  Rows r;
  const int lane_row = (threadIdx.x & 31) >> 2, hw = d.h * d.w;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = mt * 16 + lane_row + 8 * i;
    r.ok[i] = p < hw;
    r.py[i] = p / d.w;
    r.px[i] = p - r.py[i] * d.w;
  }
  return r;
}

// A SAME k x k conv's A operand, gathered from a stage input in shared memory
// with ldmatrix.x4: K runs over slices (a tap, 8 channels = 16 bytes), two
// slices a k16 chunk. Lane l gives the address of pixel row l % 8 + 8 (l / 8
// % 2) of the tile in the chunk's slice l / 16, located once a tap; a pixel
// outside the image, or past the last tap, reads a zero row.
struct Gather {
  uint32_t act, zero;  // shared addresses of the stage input and of the zero row
  int stride;          // bytes per pixel
  int py, px;
  bool ok;
  int q, dil, pad;
  int ty, tx, c8;  // this lane's slice
  uint32_t base;   // shared address of this lane's pixel at the slice's tap
};

template <class D>
__device__ __forceinline__ void locate(const D& d, Gather& G) {
  const int iy = G.py + G.ty * G.dil - G.pad, ix = G.px + G.tx * G.dil - G.pad;
  const bool in = G.ok && G.ty < d.ksize && iy >= 0 && iy < d.h && ix >= 0 && ix < d.w;
  G.base = in ? G.act + (iy * d.w + ix) * G.stride : G.zero;
}

template <class D>
__device__ __forceinline__ void advance(const D& d, Gather& G) {
  if (++G.c8 == G.q) {
    G.c8 = 0;
    if (++G.tx == d.ksize) {
      G.tx = 0;
      ++G.ty;
    }
    locate(d, G);
  }
}

template <class D>
__device__ __forceinline__ Gather gather_at(const D& d, int mt, uint32_t act, uint32_t zero,
                                            int stride, int q, int dil) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int p = mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  Gather G;
  G.act = act;
  G.zero = zero;
  G.stride = 2 * stride;
  G.ok = p < d.h * d.w;
  G.py = p / d.w;
  G.px = p - G.py * d.w;
  G.q = q;
  G.dil = dil;
  G.pad = dil * (d.ksize - 1) / 2;
  G.ty = G.tx = G.c8 = 0;
  locate(d, G);
  if (lane >> 4) advance(d, G);  // the chunk's second slice
  return G;
}

// this lane's ldmatrix address for the next chunk (channel 0 of the slice),
// and G moved on by a chunk
template <class D>
__device__ __forceinline__ uint32_t take_chunk(const D& d, Gather& G) {
  const uint32_t at = G.base + 16 * G.c8;
  advance(d, G);
  advance(d, G);
  return at;
}

// bias (f32 buffer at b) of this lane's two columns of n8 tile j
__device__ __forceinline__ float2 bias2(const float* __restrict__ b, int j) {
  return __ldg(reinterpret_cast<const float2*>(b + 8 * j + 2 * (threadIdx.x & 3)));
}

// bias2 from the narrow kernel's copy of the biases in shared memory
__device__ __forceinline__ float2 bias_pair(const float* b, int j) {
  return *reinterpret_cast<const float2*>(b + 8 * j + 2 * (threadIdx.x & 3));
}

// ---------------------------------------------------------------------------
// asynchronous copies into shared memory (both bf16 kernels)
// ---------------------------------------------------------------------------

constexpr unsigned long long kWaitLimitNs = 4000000000ull;  // a barrier wait past it traps

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival on bar that also makes it wait for `bytes` of asynchronous copies
__device__ __forceinline__ void barrier_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of bar with this parity has completed. Past
// kWaitLimitNs it traps, so that a copy that never lands (a schedule the
// warps disagree on) fails the launch instead of hanging the card.
__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity) {
  unsigned long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > kWaitLimitNs)
      __trap();
  }
}

// `bytes` (a multiple of 16) from global src to shared dst with the tensor
// memory accelerator's bulk copy, completing on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// narrow: the flagship's kernel, bf16 and tf32 (Bf16, Tf32)
// ---------------------------------------------------------------------------

// The narrow kernel's tap walk (Gather's) for kP pixel tiles at once: the
// slice a lane reads is the same for all of them, so the walk over taps and
// channels is taken once a chunk and only the kP addresses are located.
template <int kP>
struct TileTaps {
  uint32_t act, zero;  // shared addresses of the stage input and of the zero row
  int stride;          // bytes a pixel
  int q, dil, pad;
  int ty, tx, c8;  // this lane's slice
  int py[kP], px[kP];
  bool ok[kP];
  uint32_t base[kP];  // this lane's pixel of each tile at the slice's tap
};

template <int kP, class D>
__device__ __forceinline__ void taps_locate(const D& d, TileTaps<kP>& G) {
  const int oy = G.ty * G.dil - G.pad, ox = G.tx * G.dil - G.pad;
  const bool tap = G.ty < d.ksize;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int iy = G.py[i] + oy, ix = G.px[i] + ox;
    const bool in = G.ok[i] && tap && iy >= 0 && iy < d.h && ix >= 0 && ix < d.w;
    G.base[i] = in ? G.act + (iy * d.w + ix) * G.stride : G.zero;
  }
}

template <int kP, class D>
__device__ __forceinline__ void taps_advance(const D& d, TileTaps<kP>& G) {
  if (++G.c8 == G.q) {
    G.c8 = 0;
    if (++G.tx == d.ksize) {
      G.tx = 0;
      ++G.ty;
    }
    taps_locate(d, G);
  }
}

// The pixel whose row address this lane gives ldmatrix, in each of the
// 16-pixel tiles mt (row l % 8 + 8 (l / 8 % 2) of the tile): located once a
// tile, for every walk over it.
template <int kP>
struct TilePix {
  int py[kP], px[kP];
  bool ok[kP];
};

template <int kP, class D>
__device__ __forceinline__ TilePix<kP> tile_pix(const D& d, const int (&mt)[kP]) {
  const int lane = static_cast<int>(threadIdx.x & 31), hw = d.h * d.w;
  const int row = (lane & 7) + 8 * ((lane >> 3) & 1);
  TilePix<kP> P;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int p = mt[i] * 16 + row;
    P.ok[i] = p < hw;
    P.py[i] = p / d.w;
    P.px[i] = p - P.py[i] * d.w;
  }
  return P;
}

// the walk of a SAME k x k conv (q slices a tap, dilation dil) over the
// stage input at shared address act (`stride` elements a pixel) for the
// tiles of P; a tile past the sample reads zeros
template <class Prod, int kP, class D>
__device__ __forceinline__ TileTaps<kP> taps_at(const D& d, const TilePix<kP>& P, uint32_t act,
                                                uint32_t zero, int stride, int q, int dil) {
  TileTaps<kP> G;
  G.act = act;
  G.zero = zero;
  G.stride = Prod::kItem * stride;
  G.q = q;
  G.dil = dil;
  G.pad = dil * (d.ksize - 1) / 2;
  G.ty = G.tx = G.c8 = 0;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    G.ok[i] = P.ok[i];
    G.py[i] = P.py[i];
    G.px[i] = P.px[i];
  }
  taps_locate(d, G);
  // bf16: lanes 16-31 take the chunk's second slice
  if (Prod::kSlices == 2 && (threadIdx.x & 31) >> 4) taps_advance(d, G);
  return G;
}

template <class Prod, int kP, class D>
__device__ __forceinline__ TileTaps<kP> taps_at(const D& d, const int (&mt)[kP], uint32_t act,
                                                uint32_t zero, int stride, int q, int dil) {
  return taps_at<Prod>(d, tile_pix(d, mt), act, zero, stride, q, dil);
}

// this lane's ldmatrix address of the next chunk in each tile, and G moved
// on by a chunk
template <class Prod, int kP, class D>
__device__ __forceinline__ void taps_take(const D& d, TileTaps<kP>& G, uint32_t (&at)[kP]) {
#pragma unroll
  for (int i = 0; i < kP; ++i) at[i] = G.base[i] + 8 * Prod::kItem * G.c8 + Prod::lane_bytes();
#pragma unroll
  for (int s = 0; s < Prod::kSlices; ++s) taps_advance(d, G);
}

// a[i] <- the A fragment of G's next chunk in tile i, and G moved on by a
// chunk
template <class Prod, int kP, class D>
__device__ __forceinline__ void next_a(const D& d, TileTaps<kP>& G, typename Prod::A (&a)[kP]) {
  uint32_t at[kP];
  taps_take<Prod>(d, G, at);
#pragma unroll
  for (int i = 0; i < kP; ++i) a[i] = Prod::load_a(at[i]);
}

// acc[i] += the k x k conv of G's tile i over `chunks` chunks, n8 tiles
// [0, nt) of the stage at w (shared): each B fragment feeds all kP tiles
template <class Prod, int kT, int kP, class D>
__device__ __forceinline__ void conv_k(const D& d, TileTaps<kP> G, int chunks,
                                       const typename Prod::T* w, int nt,
                                       float (&acc)[kP][kT][4]) {
  for (int c = 0; c < chunks; ++c) {
    typename Prod::A a[kP];
    next_a<Prod>(d, G, a);
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j >= nt) break;
      const typename Prod::B b = Prod::load_b(w, c * nt + j);
#pragma unroll
      for (int i = 0; i < kP; ++i) Prod::product(acc[i][j], a[i], b);
    }
  }
}

// conv_k for the head (n8 tiles [0, no), no <= kMaxHeadTiles): its few
// output tiles and many chunks make one chain of mma a tile, so even and odd
// chunks sum apart, two chains a tile
template <class Prod, int kP, class D>
__device__ __forceinline__ void head_conv(const D& d, TileTaps<kP> G, int chunks,
                                          const typename Prod::T* w, int no,
                                          float (&acc)[kP][kMaxHeadTiles][4]) {
  float odd[kP][kMaxHeadTiles][4] = {};
  for (int c = 0; c < chunks; c += 2) {
    typename Prod::A a0[kP], a1[kP];
    next_a<Prod>(d, G, a0);
    next_a<Prod>(d, G, a1);  // past the last chunk: zero rows, not used
#pragma unroll
    for (int j = 0; j < kMaxHeadTiles; ++j) {
      if (j >= no) break;
      const typename Prod::B b = Prod::load_b(w, c * no + j);
#pragma unroll
      for (int i = 0; i < kP; ++i) Prod::product(acc[i][j], a0[i], b);
    }
    if (c + 1 < chunks) {
#pragma unroll
      for (int j = 0; j < kMaxHeadTiles; ++j) {
        if (j >= no) break;
        const typename Prod::B b = Prod::load_b(w, (c + 1) * no + j);
#pragma unroll
        for (int i = 0; i < kP; ++i) Prod::product(odd[i][j], a1[i], b);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int j = 0; j < kMaxHeadTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += odd[i][j][e];
}

// acc[i] += dt(lrelu(y[i])) @ the pre 1x1 at w. bf16: accumulator tiles 2c
// and 2c + 1 of y[i] are chunk c's A fragment, all packed before the first
// mma so that y's registers are free for acc. tf32: tile c is chunk c's
// (Tf32::tile_a), split as the chunk comes (the split fragments are twice
// y's registers)
template <class Prod, int kT, int kP>
__device__ __forceinline__ void pre_1x1(const float (&y)[kP][kT][4], int NT,
                                        const typename Prod::T* w,
                                        float (&acc)[kP][kT][4]) {
  if constexpr (Prod::kSlices == 1) {
#pragma unroll
    for (int c = 0; c < kT; ++c) {
      if (c >= NT) break;
      typename Prod::A a[kP];
#pragma unroll
      for (int i = 0; i < kP; ++i)
        a[i] = Prod::tile_a(lrelu(y[i][c][0]), lrelu(y[i][c][1]), lrelu(y[i][c][2]),
                            lrelu(y[i][c][3]));
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        if (j >= NT) break;
        const typename Prod::B b = Prod::load_b(w, c * NT + j);
#pragma unroll
        for (int i = 0; i < kP; ++i) Prod::product(acc[i][j], a[i], b);
      }
    }
  } else {
    uint32_t a[kT / 2][kP][4];
#pragma unroll
    for (int c = 0; c < kT / 2; ++c) {
      const bool hi = 2 * c + 1 < NT;
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        a[c][i][0] = pack_bf16(lrelu(y[i][2 * c][0]), lrelu(y[i][2 * c][1]));
        a[c][i][1] = pack_bf16(lrelu(y[i][2 * c][2]), lrelu(y[i][2 * c][3]));
        a[c][i][2] = hi ? pack_bf16(lrelu(y[i][2 * c + 1][0]), lrelu(y[i][2 * c + 1][1])) : 0u;
        a[c][i][3] = hi ? pack_bf16(lrelu(y[i][2 * c + 1][2]), lrelu(y[i][2 * c + 1][3])) : 0u;
      }
    }
#pragma unroll
    for (int c = 0; c < kT / 2; ++c) {
      if (2 * c >= NT) break;
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        if (j >= NT) break;
        const uint2 b = Bf16::load_b(w, c * NT + j).v;
#pragma unroll
        for (int i = 0; i < kP; ++i) mma(acc[i][j], a[c][i], b);
      }
    }
  }
}

// v[i] += the bias (shared f32 copy at b) of each of its n8 tiles [0, nt)
template <int kT, int kP>
__device__ __forceinline__ void add_bias(const float* b, int nt,
                                         float (&v)[kP][kT][4]) {
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    if (j >= nt) break;
    const float2 bj = bias_pair(b, j);
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      v[i][j][0] += bj.x;
      v[i][j][1] += bj.y;
      v[i][j][2] += bj.x;
      v[i][j][3] += bj.y;
    }
  }
}

// the stage input's rows of tiles mt (stride ts) <- dt(lrelu(v + b)), b
// the f32 biases of its n8 tiles (none where null), all read before the
// first row is written
template <class Prod, int kT, int kP, class D>
__device__ __forceinline__ void put_rows(const D& d, const int (&mt)[kP], int nt, const float* b,
                                         const float (&v)[kP][kT][4],
                                         typename Prod::T* act, int ts) {
  const int lane = threadIdx.x & 31;
  float2 bs[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j)
    bs[j] = b != nullptr && j < nt ? bias_pair(b, j) : make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const Rows r = tile_rows(d, mt[i]);
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j >= nt) break;
      const float2 bj = bs[j];
      const int ch = 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r.ok[h])
          Prod::store2(act + (r.py[h] * d.w + r.px[h]) * ts + ch,
                       lrelu(v[i][j][2 * h] + bj.x), lrelu(v[i][j][2 * h + 1] + bj.y));
    }
  }
}

// The branch walks' tap table, one int4 for each branch br and slice s <
// kWalkSlices of its walk: the slice's byte offset in the stage input (rows
// of ts) from the pixel, its tap's offset (dy, dx) and, in .w, the slice's
// bytes from its tap (8 channels a slice) and (bit 16) whether the tap
// exists. Built once a block, so that a walk's addresses take no division.
template <class Prod, class D>
__device__ __forceinline__ void put_taps(const D& d, const MmaLayout<kNarrowBranches>& L,
                                         int4* tab) {
  for (int e = threadIdx.x; e < d.nd * kWalkSlices; e += blockDim.x) {
    const int br = e / kWalkSlices, s = e - br * kWalkSlices;
    const int q = L.tile[L.br_tile0[br]].q, dil = d.dil[br], pad = dil * (d.ksize - 1) / 2;
    const int tap = s / q, c8 = s - tap * q, ty = tap / d.ksize, tx = tap - ty * d.ksize;
    const int dy = ty * dil - pad, dx = tx * dil - pad;
    tab[e] = make_int4(Prod::kItem * ((dy * d.w + dx) * L.ts + 8 * c8), dy, dx,
                       8 * Prod::kItem * c8 | (tap < d.ksize * d.ksize ? 1 << 16 : 0));
  }
}

// u[i] += the post 1x1's chunk c, whose A fragment is a[i], from the
// residual block's weights at wb
template <class Prod, int kT, int kP>
__device__ __forceinline__ void post_chunk(const MmaLayout<kNarrowBranches>& L,
                                           const typename Prod::T* wb, int c,
                                           const typename Prod::A (&a)[kP],
                                           float (&u)[kP][kT][4]) {
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    if (j >= L.NT) break;
    const typename Prod::B b = Prod::load_b(wb + L.w_post, c * L.NT + j);
#pragma unroll
    for (int i = 0; i < kP; ++i) Prod::product(u[i][j], a[i], b);
  }
}

// chunks of a branch walk whose addresses a warp holds: the tap table's
// kWalkSlices slices (5 k16 chunks in bf16, 10 k8 chunks in tf32)
template <class Prod>
constexpr int kWalk = kWalkSlices / Prod::kSlices;

// at[c][i]: this lane's ldmatrix address in chunk c < chunks (at most
// kWalk<Prod>) of branch br's walk over tile i of P, from the tap table
template <class Prod, int kP, class D>
__device__ __forceinline__ void walk_at(const D& d, const MmaLayout<kNarrowBranches>& L,
                                        const int4* tab, const TilePix<kP>& P, uint32_t act,
                                        uint32_t zero, int br, int chunks,
                                        uint32_t (&at)[kWalk<Prod>][kP]) {
  // bf16: lanes 16-31 read the chunk's second slice
  const int4* tb =
      tab + br * kWalkSlices + (Prod::kSlices == 2 ? (threadIdx.x & 31) >> 4 : 0);
  uint32_t base[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) base[i] = act + (P.py[i] * d.w + P.px[i]) * Prod::kItem * L.ts;
#pragma unroll
  for (int c = 0; c < kWalk<Prod>; ++c) {
    if (c >= chunks) break;
    const int4 e = tb[Prod::kSlices * c];
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const unsigned iy = P.py[i] + e.y, ix = P.px[i] + e.z;
      const bool in = P.ok[i] && (e.w >> 16) && iy < static_cast<unsigned>(d.h) &&
                      ix < static_cast<unsigned>(d.w);
      at[c][i] = (in ? base[i] + e.x : zero + (e.w & 0xffff)) + Prod::lane_bytes();
    }
  }
}

// s[k][i] += the grouped conv of branch br over tile i of P into its branch
// tiles g + k (k < ng <= kG), weights at wb: from the held addresses at
// (chunks <= kWalk: nothing but ldmatrix, the B fragment and the product),
// else from a walk taken chunk by chunk
template <class Prod, int kP, int kG, class D>
__device__ __forceinline__ void branch_group(const D& d, const MmaLayout<kNarrowBranches>& L,
                                             const TilePix<kP>& P, uint32_t act, uint32_t zero,
                                             const typename Prod::T* wb, int br, int g, int ng,
                                             int chunks, const uint32_t (&at)[kWalk<Prod>][kP],
                                             float (&s)[kG][kP][4]) {
  uint32_t lo[kG];
  const typename Prod::T* w[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    const int gk = g + min(k, ng - 1);
    lo[k] = Prod::kItem * L.tile[gk].lo8;
    w[k] = wb + L.tile[gk].w_off;
  }
  float x[kG][kP][4] = {};  // tf32: the cross terms, summed apart
  // s[k] += chunk c's products with the A fragment at ac + each tile's window
  auto chunk = [&](int c, const uint32_t (&ac)[kP]) {
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      if (k >= ng) break;
      const typename Prod::B b = Prod::load_b(w[k], c);
#pragma unroll
      for (int i = 0; i < kP; ++i)
        Prod::product(s[k][i], x[k][i], Prod::load_a(ac[i] + lo[k]), b);
    }
  };
  if (chunks <= kWalk<Prod>) {
#pragma unroll
    for (int c = 0; c < kWalk<Prod>; ++c) {
      if (c >= chunks) break;
      chunk(c, at[c]);
    }
  } else {
    TileTaps<kP> G = taps_at<Prod>(d, P, act, zero, L.ts, L.tile[g].q, d.dil[br]);
    for (int c = 0; c < chunks; ++c) {
      uint32_t a_at[kP];
      taps_take<Prod>(d, G, a_at);
      chunk(c, a_at);
    }
  }
  if constexpr (Prod::kSlices == 1) {
#pragma unroll
    for (int k = 0; k < kG; ++k)
#pragma unroll
      for (int i = 0; i < kP; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[k][i][e] += x[k][i][e];
  }
}

// bf16(lrelu(s + branch tile gt's biases, at bb)): its rows g and g + 8, the
// halves of a k16 chunk's A fragment in the post 1x1
__device__ __forceinline__ uint2 branch_out(const MmaLayout<kNarrowBranches>& L, const float* bb,
                                            int gt, const float (&s)[4]) {
  const float2 b = bias_pair(bb + L.tile[gt].b_off, 0);
  return make_uint2(pack_bf16(lrelu(s[0] + b.x), lrelu(s[1] + b.y)),
                    pack_bf16(lrelu(s[2] + b.x), lrelu(s[3] + b.y)));
}

// tf32: lrelu(s + branch tile gt's biases, at bb) as the A fragment of the
// post 1x1's chunk gt (Tf32::tile_a)
__device__ __forceinline__ Tf32::A branch_a(const MmaLayout<kNarrowBranches>& L, const float* bb,
                                            int gt, const float (&s)[4]) {
  const float2 b = bias_pair(bb + L.tile[gt].b_off, 0);
  return Tf32::tile_a(lrelu(s[0] + b.x), lrelu(s[1] + b.y), lrelu(s[2] + b.x),
                      lrelu(s[3] + b.y));
}

// u[i] += the residual block's branches and post 1x1 at tiles mt, weights
// at wb (shared) and biases at bb: s = dt(lrelu(gconv(t) + bb)) of the
// branch tiles kG at a time (one walk over the chunks feeds them, and each
// B fragment all kP pixel tiles) multiplied into u straight away, no branch
// output leaving registers: in bf16 two finished tiles a k16 chunk of the
// post 1x1's A operand, in tf32 each tile a k8 chunk
template <class Prod, int kT, int kP, int kG, class D>
__device__ __forceinline__ void branches_post(const D& d, const MmaLayout<kNarrowBranches>& L,
                                              const int4* tab, const int (&mt)[kP],
                                              uint32_t act, uint32_t zero,
                                              const typename Prod::T* wb, const float* bb,
                                              float (&u)[kP][kT][4]) {
  uint32_t pend[kP][2] = {};  // bf16: an even tile's fragment half, waiting for its pair
  const TilePix<kP> P = tile_pix(d, mt);
  for (int br = 0; br < d.nd; ++br) {
    const int t0 = L.br_tile0[br], end = t0 + L.br_tiles[br];
    const int chunks = L.tile[t0].chunks;
    // a short walk's addresses, once for all the branch's tiles
    uint32_t at[kWalk<Prod>][kP];
    if (chunks <= kWalk<Prod>) walk_at<Prod>(d, L, tab, P, act, zero, br, chunks, at);
    for (int g = t0; g < end; g += kG) {
      const int ng = min(kG, end - g);
      float s[kG][kP][4] = {};
      branch_group<Prod>(d, L, P, act, zero, wb, br, g, ng, chunks, at, s);
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        if (k >= ng) break;
        const int gt = g + k;
        typename Prod::A a[kP];
        if constexpr (Prod::kSlices == 1) {
#pragma unroll
          for (int i = 0; i < kP; ++i) a[i] = branch_a(L, bb, gt, s[k][i]);
          post_chunk<Prod>(L, wb, gt, a, u);
        } else {
#pragma unroll
          for (int i = 0; i < kP; ++i) {
            const uint2 o = branch_out(L, bb, gt, s[k][i]);
            a[i].r[0] = pend[i][0];
            a[i].r[1] = pend[i][1];
            a[i].r[2] = pend[i][0] = o.x;
            a[i].r[3] = pend[i][1] = o.y;
          }
          if (gt % 2) post_chunk<Prod>(L, wb, gt / 2, a, u);
        }
      }
    }
  }
  if constexpr (Prod::kSlices == 2) {
    if (L.n_tiles % 2) {
      typename Prod::A a[kP];
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        a[i].r[0] = pend[i][0];
        a[i].r[1] = pend[i][1];
        a[i].r[2] = a[i].r[3] = 0u;
      }
      post_chunk<Prod>(L, wb, L.n_tiles / 2, a, u);
    }
  }
}

// part = tile mt's share of the post 1x1 from its k16 chunk c alone: the
// chunk's two branch tiles (2c, 2c + 1, each from its own branch), then
// their rows of the post 1x1. The bf16 scratch plan splits a tile of its
// last round so across warps; the shares add up to branches_post.
template <int kT, class D>
__device__ __forceinline__ void post_share(const D& d, const MmaLayout<kNarrowBranches>& L,
                                           const int4* tab, int mt, uint32_t act, uint32_t zero,
                                           const __nv_bfloat16* wb, const float* bb, int c,
                                           float (&part)[1][kT][4]) {
  const int mts[1] = {mt};
  const TilePix<1> P = tile_pix(d, mts);
  Bf16::A a[1] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gt = 2 * c + h;
    if (gt >= L.n_tiles) break;
    int br = 0;
    while (br + 1 < d.nd && gt >= L.br_tile0[br + 1]) ++br;
    const int chunks = L.tile[gt].chunks;
    uint32_t at[kWalk<Bf16>][1];
    if (chunks <= kWalk<Bf16>) walk_at<Bf16>(d, L, tab, P, act, zero, br, chunks, at);
    float s[1][1][4] = {};
    branch_group<Bf16>(d, L, P, act, zero, wb, br, gt, 1, chunks, at, s);
    const uint2 o = branch_out(L, bb, gt, s[0][0]);
    a[0].r[2 * h] = o.x;
    a[0].r[2 * h + 1] = o.y;
  }
  post_chunk<Bf16>(L, wb, c, a, part);
}

// the trunk of tiles mt, in accumulator layout in the sample's scratch y
// ([pixel tile][n8 tile][lane] float4, each float4 read and written by its
// own lane only), into v; zeros for a tile past the sample
template <int kT, int kP>
__device__ __forceinline__ void load_trunk(const float4* y, int NT, int n_mt, const int (&mt)[kP],
                                           float (&v)[kP][kT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j >= NT) break;
      const float4 t = mt[i] < n_mt ? y[(mt[i] * NT + j) * 32 + lane]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i][j][0] = t.x;
      v[i][j][1] = t.y;
      v[i][j][2] = t.z;
      v[i][j][3] = t.w;
    }
}

template <int kT, int kP>
__device__ __forceinline__ void store_trunk(float4* y, int NT, int n_mt, const int (&mt)[kP],
                                            const float (&v)[kP][kT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    if (mt[i] >= n_mt) continue;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j >= NT) break;
      y[(mt[i] * NT + j) * 32 + lane] = make_float4(v[i][j][0], v[i][j][1], v[i][j][2], v[i][j][3]);
    }
  }
}

// out of tiles mt <- acc + the head's biases at hb (shared), the real
// columns only
template <int kP, class D>
__device__ __forceinline__ void put_head(const D& d, const int (&mt)[kP], int no, const float* hb,
                                         const float (&acc)[kP][kMaxHeadTiles][4], float* o) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const Rows r = tile_rows(d, mt[i]);
#pragma unroll
    for (int j = 0; j < kMaxHeadTiles; ++j) {
      if (j >= no) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + (e & 1), h = e >> 1;
        if (r.ok[h] && col < d.out_total)
          o[(r.py[h] * d.w + r.px[h]) * d.out_total + col] = acc[i][j][e] + hb[col];
      }
    }
  }
}

// x of the sample (hw pixels of cin) -> rows of `stride` in the dtype in
// shared memory, channels zero-padded to 8 qx: a thread a pixel, its
// channels' loads started together
template <class Prod, class D>
__device__ __forceinline__ void put_x(const D& d, const float* __restrict__ xs, int qx,
                                      int stride, typename Prod::T* dst) {
  const int hw = d.h * d.w;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float* px = xs + p * d.cin;
    for (int c = 0; c < 8 * qx; c += 2)
      Prod::store2(dst + p * stride + c, c < d.cin ? __ldg(px + c) : 0.f,
                   c + 1 < d.cin ? __ldg(px + c + 1) : 0.f);
  }
}

// the packed biases (n floats, a multiple of 4) into shared memory at dst
__device__ __forceinline__ void put_biases(const float* __restrict__ bias, int n, float* dst) {
  for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
    reinterpret_cast<float4*>(dst)[e] = __ldg(reinterpret_cast<const float4*>(bias) + e);
}

// Weight stage s of the narrow kernel (0 the entry, 1 + r residual block r,
// res_blocks + 1 the head): (element offset, elements) in the packing.
template <int B>
__device__ __forceinline__ int2 weight_stage(const Dims<B>& d, const MmaLayout<B>& L, int s) {
  if (s == 0) return make_int2(0, L.w_block0);
  if (s <= d.res_blocks) return make_int2(L.w_block0 + (s - 1) * L.w_block, L.w_block);
  return make_int2(L.w_head, L.w_total - L.w_head);
}

// The on-chip plan (fused_subnet.py::narrow_plan): one block a sample, a
// warp a 16-pixel tile (blockDim 32 n_mt), its trunk in registers for the
// whole chain. Shared memory: an mbarrier, the whole packing (one bulk copy
// at the start, landing while x is converted), then the stage input in two
// buffers by turns: x in act[0], block r's t in act[(r + 1) % 2], the head's
// input in act[(res_blocks + 1) % 2]. A buffer is written only once every
// warp has passed the barrier after its last reading, so one barrier a
// stage is enough. Trunks of up to kChipSmallTiles n8 tiles take a build
// sized to them, which in bf16 two blocks an SM can hold (a float32 plan
// fits one).
template <class Prod, int kT>
__global__ void __launch_bounds__(kThreads, Prod::kSlices == 2 && kT <= kChipSmallTiles ? 2 : 1)
fused_subnet_mma_chip_kernel(const float* __restrict__ x,
                             const typename Prod::T* __restrict__ wts,
                             const float* __restrict__ bias, float* __restrict__ out,
                             const Dims<kNarrowBranches> d, const MmaLayout<kNarrowBranches> L) {
  using T = typename Prod::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bar = shared_addr(smem);
  const int nb = bias_bytes(L), w_bytes = Prod::kItem * L.w_total;
  int4* tab = reinterpret_cast<int4*>(smem + kPlanHead - kTapTable);
  float* sb = reinterpret_cast<float*>(smem + kPlanHead);
  const T* w = reinterpret_cast<const T*>(smem + kPlanHead + nb);
  T* acts[2];
  acts[0] = reinterpret_cast<T*>(smem + kPlanHead + nb + w_bytes);
  acts[1] = acts[0] + L.act_bytes / Prod::kItem;
  const int hw = d.h * d.w, NT = L.NT, row = L.xs > L.ts ? L.xs : L.ts;
  const int64_t n = blockIdx.x;
  if (threadIdx.x == 0) {
    barrier_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    barrier_expect(bar, w_bytes);
    bulk_copy(shared_addr(w), wts, w_bytes, bar);
  }
  // a row of zeros after x's rows: what a padding pixel reads, in any stage
  for (int e = threadIdx.x; e < row; e += blockDim.x) acts[0][hw * row + e] = Prod::zero();
  put_x<Prod>(d, x + n * hw * d.cin, L.qx, L.xs, acts[0]);
  put_biases(bias, L.b_total, sb);
  put_taps<Prod>(d, L, tab);
  __syncthreads();
  barrier_wait(bar, 0);

  const uint32_t zero = shared_addr(acts[0]) + Prod::kItem * hw * row;
  const int mt[1] = {static_cast<int>(threadIdx.x >> 5)};
  // entry conv: y = conv_k(x) + entry_b
  float y[1][kT][4] = {};
  conv_k<Prod>(d, taps_at<Prod>(d, mt, shared_addr(acts[0]), zero, L.xs, L.qx, 1), L.ch_entry,
               w, NT, y);
  add_bias(sb, NT, y);
  for (int blk = 0; blk < d.res_blocks; ++blk) {
    const T* wb = w + L.w_block0 + blk * L.w_block;
    const float* bb = sb + L.b_block0 + blk * L.b_block;
    T* t = acts[(blk + 1) & 1];
    // pre 1x1: t = dt(lrelu(dt(lrelu(y)) @ pre_w + pre_b))
    float acc[1][kT][4] = {};
    pre_1x1<Prod>(y, NT, wb, acc);
    put_rows<Prod>(d, mt, NT, bb, acc, t, L.ts);
    __syncthreads();
    // branches and post 1x1 into the trunk: y = y + u + post_b
    branches_post<Prod, kT, 1, kBranchTiles>(d, L, tab, mt, shared_addr(t), zero, wb, bb, y);
    add_bias(bb + L.b_post, NT, y);
  }
  // head: t = dt(lrelu(y)); out = conv_k(t) + head_b
  T* t = acts[(d.res_blocks + 1) & 1];
  put_rows<Prod>(d, mt, NT, nullptr, y, t, L.ts);
  __syncthreads();
  float acc[1][kMaxHeadTiles][4] = {};
  head_conv<Prod>(d, taps_at<Prod>(d, mt, shared_addr(t), zero, L.ts, NT, 1), L.ch_head,
                  w + L.w_head, L.NO, acc);
  put_head(d, mt, L.NO, sb + L.b_head, acc, out + n * hw * d.out_total);
}

// The scratch plan: one block a sample, kThreads threads, each warp
// kPairTiles pixel tiles in flight (units of kPairTiles tiles over the
// warps). The sample's scratch holds the f32 trunk and a copy of the next
// stage input in its shared-memory layout. Shared memory: three mbarriers,
// x, the stage input (a row of zeros after it), then two buffers of
// weights: stage s (weight_stage) in buffer s % 2, brought by a bulk copy
// that thread 0 starts once every warp is past the stage two before it, so
// that each copy lands while the stage before it computes. Each tile's
// pre 1x1 runs where its trunk is in registers: block 0's after the entry
// (x has its own buffer, so t goes straight into the stage input), block
// r + 1's after block r's post 1x1, with the head's lrelu(y) after the last
// block's; those go to the scratch copy, which one bulk copy brings into the
// stage input once every warp is past the block (the stage input is still
// being read until then). A residual block is thus one phase and one
// barrier, and the trunk is read once and written once a block.
__global__ void __launch_bounds__(kThreads, 1)
fused_subnet_mma_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ wts,
                        const float* __restrict__ bias, float4* trunk,
                        float* __restrict__ out, const Dims<kNarrowBranches> d,
                        const MmaLayout<kNarrowBranches> L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bars = shared_addr(smem), act_bar = bars + 16;
  const int64_t xb = x_room(d, L), nb = bias_bytes(L);
  int4* tab = reinterpret_cast<int4*>(smem + kPlanHead - kTapTable);
  int* shares_done = reinterpret_cast<int*>(smem + 24);  // a count for each split tile
  float* sb = reinterpret_cast<float*>(smem + kPlanHead);
  __nv_bfloat16* xsm = reinterpret_cast<__nv_bfloat16*>(smem + kPlanHead + nb);
  // the split tiles' post 1x1 shares, once x is no longer read
  float4* shares = reinterpret_cast<float4*>(smem + kPlanHead + nb);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + kPlanHead + nb + xb);
  unsigned char* wbuf = smem + kPlanHead + nb + xb + L.act_bytes;
  const int wbytes = 2 * L.w_stage, R = d.res_blocks;
  const int hw = d.h * d.w, NT = L.NT, row = L.xs > L.ts ? L.xs : L.ts;
  const int warp = threadIdx.x >> 5;
  const int64_t n = blockIdx.x;
  // one lane: weight stage s into its buffer
  auto fetch = [&](int s) {
    const int2 st = weight_stage(d, L, s);
    const uint32_t b = bars + 8 * (s & 1);
    barrier_expect(b, 2 * st.y);
    bulk_copy(shared_addr(wbuf + (s & 1) * wbytes), wts + st.x, 2 * st.y, b);
  };
  auto wait_stage = [&](int s) { barrier_wait(bars + 8 * (s & 1), (s >> 1) & 1); };
  auto stage_w = [&](int s) {
    return reinterpret_cast<const __nv_bfloat16*>(wbuf + (s & 1) * wbytes);
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < 3; ++b) barrier_init(bars + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fetch(0);
    fetch(1);
    shares_done[0] = shares_done[1] = 0;
  }
  for (int e = threadIdx.x; e < row; e += kThreads) act[hw * row + e] = __float2bfloat16(0.f);
  put_x<Bf16>(d, x + n * hw * d.cin, L.qx, L.xs, xsm);
  put_biases(bias, L.b_total, sb);
  put_taps<Bf16>(d, L, tab);
  float4* y = trunk + n * (narrow_scratch<Bf16>(d, L) / 4);
  // the next stage input, rows of ts as in shared memory
  __nv_bfloat16* t_next = reinterpret_cast<__nv_bfloat16*>(y + L.trunk_per_sample / 4);
  const int t_bytes = 2 * hw * L.ts;
  float* o = out + n * hw * d.out_total;
  const uint32_t act_s = shared_addr(act), zero = act_s + 2 * hw * row;
  const int lane = threadIdx.x & 31;
  // the residual blocks' whole tiles and the shares of the split tiles
  const int split = split_tiles(L), n_shares = split * L.ch_post, whole = L.n_mt - split;
  __syncthreads();

  // entry conv: y = conv_k(x) + entry_b; then block 0's pre 1x1 on it (the
  // head's input where there is no block) straight into the stage input
  wait_stage(0);
  if (R > 0) wait_stage(1);
  // (kEntryPairTiles tiles a warp's conv, then each tile's pre 1x1 alone)
  constexpr int kE = kEntryPairTiles;
  for (int u = warp; u < (L.n_mt + kE - 1) / kE; u += kWarps) {
    int mt[kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) mt[i] = u * kE + i;
    float v[kE][kMaxTrunkTiles][4] = {};
    conv_k<Bf16>(d, taps_at<Bf16>(d, mt, shared_addr(xsm), zero, L.xs, L.qx, 1), L.ch_entry,
                 stage_w(0), NT, v);
    add_bias(sb, NT, v);
    store_trunk(y, NT, L.n_mt, mt, v);
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int mi[1] = {mt[i]};
      float vi[1][kMaxTrunkTiles][4], acc[1][kMaxTrunkTiles][4] = {};
#pragma unroll
      for (int j = 0; j < kMaxTrunkTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) vi[0][j][e] = v[i][j][e];
      if (R > 0) {
        pre_1x1<Bf16>(vi, NT, stage_w(1), acc);
        put_rows<Bf16>(d, mi, NT, sb + L.b_block0, acc, act, L.ts);
      } else {
        put_rows<Bf16>(d, mi, NT, nullptr, vi, act, L.ts);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && 2 <= R + 1) fetch(2);

  for (int blk = 0; blk < R; ++blk) {
    const int s = 1 + blk;
    const bool last = blk + 1 == R;
    const float* bb = sb + L.b_block0 + blk * L.b_block;
    // each stage is waited for once: this block's in the phase before
    if (blk > 0) barrier_wait(act_bar, (blk - 1) & 1);
    if (!last) wait_stage(s + 1);
    // y = y + u + post_b, then block + 1's pre 1x1 on it, or the head's
    // lrelu(y), into the scratch copy of the next stage input
    auto finish = [&](const int (&mt)[1], float (&v)[1][kMaxTrunkTiles][4]) {
      add_bias(bb + L.b_post, NT, v);
      if (last) {
        put_rows<Bf16>(d, mt, NT, nullptr, v, t_next, L.ts);
      } else {
        store_trunk(y, NT, L.n_mt, mt, v);
        float acc[1][kMaxTrunkTiles][4] = {};
        pre_1x1<Bf16>(v, NT, stage_w(s + 1), acc);
        put_rows<Bf16>(d, mt, NT, bb + L.b_block, acc, t_next, L.ts);
      }
    };
    // branches and post 1x1, the products summed into the trunk's tiles as
    // loaded, a tile a warp (two spill): the whole tiles, kWarps a round ...
    for (int u = warp; u < whole; u += kWarps) {
      const int mt[1] = {u};
      float v[1][kMaxTrunkTiles][4];
      load_trunk(y, NT, L.n_mt, mt, v);
      branches_post<Bf16, kMaxTrunkTiles, 1, kBranchTiles>(d, L, tab, mt, act_s, zero,
                                                           stage_w(s), bb, v);
      finish(mt, v);
    }
    // ... then the last round's split tiles, a k16 chunk of the post 1x1 a
    // warp (the last warps, which the whole tiles left idlest): each share
    // to shared memory; the warp that writes a tile's last share adds them
    // up in chunk order (whatever the order they came in) and finishes it
    for (int su = kWarps - 1 - warp; su < n_shares; su += kWarps) {
      const int ti = su / L.ch_post, c = su - ti * L.ch_post;
      const int mt[1] = {whole + ti};
      float v[1][kMaxTrunkTiles][4] = {};
      post_share(d, L, tab, mt[0], act_s, zero, stage_w(s), bb, c, v);
#pragma unroll
      for (int j = 0; j < kMaxTrunkTiles; ++j)
        if (j < NT) shares[(su * NT + j) * 32 + lane] = make_float4(v[0][j][0], v[0][j][1],
                                                                      v[0][j][2], v[0][j][3]);
      __syncwarp();
      int before = 0;
      if (lane == 0) {
        __threadfence_block();
        before = atomicAdd(shares_done + ti, 1);
      }
      if (__shfl_sync(0xffffffffu, before, 0) == L.ch_post - 1) {
        __syncwarp();
        __threadfence_block();
        load_trunk(y, NT, L.n_mt, mt, v);
        for (int cc = 0; cc < L.ch_post; ++cc) {
#pragma unroll
          for (int j = 0; j < kMaxTrunkTiles; ++j) {
            if (j >= NT) break;
            const float4 p = shares[((ti * L.ch_post + cc) * NT + j) * 32 + lane];
            v[0][j][0] += p.x;
            v[0][j][1] += p.y;
            v[0][j][2] += p.z;
            v[0][j][3] += p.w;
          }
        }
        finish(mt, v);
        if (lane == 0) shares_done[ti] = 0;
      }
    }
    // the copy's writes, made by this thread, before the bulk copy reads them
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      if (s + 2 <= R + 1) fetch(s + 2);
      barrier_expect(act_bar, t_bytes);
      bulk_copy(act_s, t_next, t_bytes, act_bar);
    }
  }

  // head: out = conv_k(t) + head_b, t = bf16(lrelu(y)) in the stage input
  if (R > 0) barrier_wait(act_bar, (R - 1) & 1);
  wait_stage(R + 1);
  for (int u = warp; u < (L.n_mt + kHeadPairTiles - 1) / kHeadPairTiles; u += kWarps) {
    int mt[kHeadPairTiles];
#pragma unroll
    for (int i = 0; i < kHeadPairTiles; ++i) mt[i] = u * kHeadPairTiles + i;
    float acc[kHeadPairTiles][kMaxHeadTiles][4] = {};
    head_conv<Bf16>(d, taps_at<Bf16>(d, mt, act_s, zero, L.ts, NT, 1), L.ch_head, stage_w(R + 1),
                    L.NO, acc);
    put_head(d, mt, L.NO, sb + L.b_head, acc, o);
  }
}

// ---------------------------------------------------------------------------
// wide: any trunk and head width, any stage input size (bf16 and tf32)
// ---------------------------------------------------------------------------

constexpr int kWideWarps = 4 * kWideGroups;
template <class Prod>
constexpr int kRingBytes = kSlots * kWideSlot<Prod>;
constexpr int kLoadTiles = 4;  // the trunk's float4s a lane loads together
static_assert(kWideThreads == 32 * kWideWarps, "warpgroups of 128 threads");
static_assert(kBarrierBytes == 16 * kSlots, "a full mbarrier and a counter (padded) a slot");
static_assert(kSlotBytes == kPassTiles * 2 * kFrag, "a slot holds one chunk of a pass");
static_assert(kSlack >= (kPassTiles / 2 - 1) * 2 * kFrag + 64,
              "the slack covers wgmma's widest over-read (N a power of two at or above 8 nt)");
static_assert(kGroupTiles % 2 == 0 && kPassTiles % kGroupTiles == 0, "groups of tile pairs");
constexpr int kFragBytes = 2 * kFrag;  // a B fragment of either product (k16 bf16, k8 tf32)
static_assert(kFragBytes == Tf32::kFrag * Tf32::kItem, "a fragment is 256 bytes either way");
static_assert(kTf32SlotBytes == 2 * kPassTiles * kFragBytes && kTf32SlotBytes % (16 * 128) == 0,
              "a tf32 slot holds two k8 chunks of a pass, split by 128 threads in float4s");

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits for every wgmma of this warpgroup, then pins d after the wait
__device__ __forceinline__ void wgmma_wait_all(float (&d)[4 * kPassTiles]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 4 * kPassTiles; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a B operand at shared address addr: no swizzle, K-major
// core matrices of 8 n rows x 16 bytes, the k16 chunk's second half 128
// bytes on (leading byte offset), the next n8 tile 256 bytes on (stride byte
// offset): the wide packing (fused_subnet.py::CORE_ORDER).
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// d += a x B: wgmma.mma_async m64nNk16, N = 8 kTiles, bf16 x bf16 -> f32, A
// from registers (each warp its 16 rows of the warpgroup's 64, in
// mma.m16n8k16's A layout), B from shared memory at desc; d in the
// accumulator layout (n8 tile j is d[4j, 4j + 4), as an m16n8 tile of mma.sync)
template <int kTiles>
__device__ __forceinline__ void wgmma_tiles(float (&d)[4 * kPassTiles], const uint32_t (&a)[4],
                                            uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tiles<1>(float (&d)[4 * kPassTiles],
                                                const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tiles<2>(float (&d)[4 * kPassTiles],
                                                const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tiles<4>(float (&d)[4 * kPassTiles],
                                                const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tiles<8>(float (&d)[4 * kPassTiles],
                                                const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tiles<16>(float (&d)[4 * kPassTiles],
                                                const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a x B: wgmma.mma_async m64nNk8, N = 8 kTiles, tf32 x tf32 -> f32 (the
// tensor cores read each operand's top 19 bits), A from registers (each warp
// its 16 rows, in mma.m16n8k8's tf32 A layout), B from shared memory at desc
// (K-major, as bf16's: a k8 x n8 tile is two core matrices of 8 n rows x 4
// floats, fused_subnet.py::TF32_CORE_ORDER); d in the accumulator layout
template <int kTiles>
__device__ __forceinline__ void wgmma_tf32_tiles(float (&d)[4 * kPassTiles],
                                                 const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tf32_tiles<1>(float (&d)[4 * kPassTiles],
                                                     const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_tiles<2>(float (&d)[4 * kPassTiles],
                                                     const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_tiles<4>(float (&d)[4 * kPassTiles],
                                                     const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_tiles<8>(float (&d)[4 * kPassTiles],
                                                     const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_tiles<16>(float (&d)[4 * kPassTiles],
                                                     const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A SAME k x k conv's A operand in the wide kernel, read from the stage input
// in scratch: this lane's pixel rows g and g + 8 of a 16-pixel tile, the
// input's 8-channel slices per tap, the dilation and the row stride.
struct WideGather {
  Rows r;
  int q, dil, pad, stride;
};

template <class D>
__device__ __forceinline__ WideGather wide_gather(const D& d, int mt, int q, int dil,
                                                  int stride) {
  return WideGather{tile_rows(d, mt), q, dil, dil * (d.ksize - 1) / 2, stride};
}

// Element offsets, from the input window's first channel, of this lane's four
// A registers in chunk c, in the m16n8k16 order: (row g, slice 2c), (row g+8,
// slice 2c), (row g, slice 2c+1), (row g+8, slice 2c+1), each the channels
// 2t, 2t+1 of its slice (t = lane % 4); -1 where the register is zero (a
// padding pixel, a row past the sample, a slice past the last tap).
template <class D>
__device__ __forceinline__ void chunk_offsets(const D& d, const WideGather& G, int c,
                                              int (&off)[4]) {
  const int kk = d.ksize * d.ksize, t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int slice = 2 * c + s, tap = slice / G.q, c8 = slice - tap * G.q;
    const int ty = tap / d.ksize, tx = tap - ty * d.ksize;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int iy = G.r.py[i] + ty * G.dil - G.pad, ix = G.r.px[i] + tx * G.dil - G.pad;
      const bool in = G.r.ok[i] && tap < kk && iy >= 0 && iy < d.h && ix >= 0 && ix < d.w;
      off[2 * s + i] = in ? (iy * d.w + ix) * G.stride + 8 * c8 + t2 : -1;
    }
  }
}

// the A fragment at `off` (chunk_offsets) + lo8 of the stage input at act,
// which this kernel writes: plain loads, never the read-only path
__device__ __forceinline__ void fragment_a_scratch(const __nv_bfloat16* act, const int (&off)[4],
                                                   int lo8, uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a[e] = off[e] < 0 ? 0u : *reinterpret_cast<const uint32_t*>(act + off[e] + lo8);
}

// Element offsets, from the input window's first channel, of this lane's A
// values in tf32 chunk c (one slice) of rows g and g+8: channels 2t and 2t+1
// of the slice (t = lane % 4), which are A's columns t and t+4 in the
// scratch route's packing (its k x k stages' rows permuted as the pre and
// post 1x1s' are, fused_subnet.py::HANDOFF_ROWS), so that a row is one
// 8-byte load; -1 where the values are zero (chunk_offsets' cases).
template <class D>
__device__ __forceinline__ void tf32_offsets(const D& d, const WideGather& G, int c,
                                             int (&off)[2]) {
  const int t = threadIdx.x & 3, tap = c / G.q, c8 = c - tap * G.q;
  const int ty = tap / d.ksize, tx = tap - ty * d.ksize;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int iy = G.r.py[i] + ty * G.dil - G.pad, ix = G.r.px[i] + tx * G.dil - G.pad;
    const bool in = G.r.ok[i] && tap < d.ksize * d.ksize && iy >= 0 && iy < d.h && ix >= 0 &&
                    ix < d.w;
    off[i] = in ? (iy * d.w + ix) * G.stride + 8 * c8 + 2 * t : -1;
  }
}

// d += a x the B tiles at shared address b for n8 tiles [0, nt) of d: N is
// the power of two at or above 8 nt, so the columns past nt read what lies
// past the piece (inside kSlack) and are never used
__device__ __forceinline__ void wgmma_n(int nt, float (&d)[4 * kPassTiles],
                                        const uint32_t (&a)[4], uint32_t b) {
  const uint64_t desc = b_descriptor(b);
  if (nt > 8)
    wgmma_tiles<16>(d, a, desc);
  else if (nt > 4)
    wgmma_tiles<8>(d, a, desc);
  else if (nt > 2)
    wgmma_tiles<4>(d, a, desc);
  else if (nt > 1)
    wgmma_tiles<2>(d, a, desc);
  else
    wgmma_tiles<1>(d, a, desc);
}

// wgmma_n in tf32 (wgmma_tf32_tiles)
__device__ __forceinline__ void wgmma_tf32_n(int nt, float (&d)[4 * kPassTiles],
                                             const uint32_t (&a)[4], uint32_t b) {
  const uint64_t desc = b_descriptor(b);
  if (nt > 8)
    wgmma_tf32_tiles<16>(d, a, desc);
  else if (nt > 4)
    wgmma_tf32_tiles<8>(d, a, desc);
  else if (nt > 2)
    wgmma_tf32_tiles<4>(d, a, desc);
  else if (nt > 1)
    wgmma_tf32_tiles<2>(d, a, desc);
  else
    wgmma_tf32_tiles<1>(d, a, desc);
}

// d += a x B as Tf32::product's three TF32 products, lo*hi + hi*lo + hi*hi:
// B as it stands at b (the tensor cores read its top 19 bits, hi) and its lo
// plane at lo (LoPlane)
__device__ __forceinline__ void wgmma_split(int nt, float (&d)[4 * kPassTiles], const Tf32::A& a,
                                            uint32_t b, uint32_t lo) {
  wgmma_tf32_n(nt, d, a.lo, b);
  wgmma_tf32_n(nt, d, a.hi, lo);
  wgmma_tf32_n(nt, d, a.hi, b);
}

// the 128 threads of warpgroup barrier `bar` (1 + the warpgroup: 0 is the block's)
__device__ __forceinline__ void warpgroup_sync(int bar) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
}

// The wide tf32 kernel's lo planes. wgmma reads B from shared memory, so the
// lo half of a ring piece (B - hi, hi its top 19 bits: Tf32::split) cannot be
// made in registers as the branch tiles' is; each warpgroup writes the lo
// plane of the piece it multiplies into one of its own two planes of
// kWideSlot bytes after the ring, by turns, once a piece: the plane written, made
// visible to the async proxy (which wgmma reads through), and every warp of
// the warpgroup past it. That barrier is also what frees the other plane: a
// warp reaches it only after waiting for its products of the piece before,
// which read that plane.
struct LoPlane {
  unsigned char* smem;  // the block's shared memory, and its shared address
  uint32_t smem_s;
  uint32_t planes;  // shared address of this warpgroup's two planes
  int bar;          // its barrier
  int turn;         // the pieces it has split
  // the plane of the piece's first `bytes` at shared address slot; returns
  // its shared address
  __device__ __forceinline__ uint32_t split(uint32_t slot, int bytes) {
    const uint32_t plane = planes + (turn++ & 1) * kTf32SlotBytes;
    const float4* b = reinterpret_cast<const float4*>(smem + (slot - smem_s));
    float4* lo = reinterpret_cast<float4*>(smem + (plane - smem_s));
    for (int e = threadIdx.x & 127; e < bytes / 16; e += 128) {
      const float4 v = b[e];
      lo[e] = make_float4(lo_part(v.x), lo_part(v.y), lo_part(v.z), lo_part(v.w));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(bar);
    return plane;
  }
  static __device__ __forceinline__ float lo_part(float v) {
    return v - __uint_as_float(__float_as_uint(v) & 0xffffe000u);
  }
};

// rounds of the warpgroups over a sample's 64-pixel tiles
__host__ __device__ __forceinline__ int wide_rounds(const MmaLayout<kMaxBranches>& L) {
  return (L.n_mt + kWideWarps - 1) / kWideWarps;
}

// chunks (k16 in bf16, k8 in tf32) a piece of a pass over a stage of NTs n8
// tiles that takes its tiles [j0, j0 + nt): as many as a slot holds where
// the pass takes every tile (its chunks lie end to end), one otherwise
template <class Prod>
__host__ __device__ __forceinline__ int chunks_a_piece(int NTs, int nt) {
  return nt == NTs ? kWideSlot<Prod> / kFragBytes / nt : 1;
}

// element offset of chunk c, tile j0 of a stage of NTs tiles at w, of
// fragments of f elements
__host__ __device__ __forceinline__ int64_t pass_src(int64_t w, int c, int NTs, int j0, int f) {
  return w + (static_cast<int64_t>(c) * NTs + j0) * f;
}

// The schedule's entry of piece p of the chain: each stage (the entry, per
// residual block the pre 1x1 and the branches with the post 1x1, the head)
// takes the same pieces every round, lens[s] of them, one stage after
// another; the host's table lists one round of each.
inline int schedule_entry(const int* lens, int stages, int rounds, int p) {
  int start = 0;
  for (int s = 0; s < stages; ++s) {
    const int len = lens[s];
    if (p < rounds * len) return start + p % len;
    p -= rounds * len;
    start += len;
  }
  return start;  // past the chain: schedule_matches refuses such a table
}

// The ring of weights as the warps walk it: piece k sits in slot k % kSlots;
// its full barrier completes when its copy has landed. The warps count
// themselves out of a slot in shared memory (`freed`, one arrival a warp);
// the warp that frees it last copies the piece kSlots on into it, from the
// schedule in the device copy of the layout table: every piece of the chain
// in order (fused_subnet.py::wide_schedule, one round a stage in the host's
// table, which schedule_matches checks, and each stage's round repeated in
// the device's). So no warp is kept back to feed the ring (a
// 17th warp would put 5 on one of the SM's four sub-partitions, whose 16,384
// registers would then give each thread 96), and a slot is refilled the
// moment it is free. The tf32 scratch plan's kernel walks its own ring so,
// its weights float32 (T); the wide tf32 kernel's slots are kTf32SlotBytes.
template <class T, int kBytes = kSlotBytes>
struct Ring {
  uint32_t slots, full;
  int* freed;
  int k;  // the next piece to take
  int n;  // pieces of the whole chain
  const int* sched;  // (element offset, bytes) a piece
  const T* w;
  __device__ __forceinline__ uint32_t slot() const { return slots + (k % kSlots) * kBytes; }
  // one lane: piece p into its slot
  __device__ __forceinline__ void issue(int p) const {
    const int s = p % kSlots, bytes = __ldg(sched + 2 * p + 1);
    barrier_expect(full + 8 * s, bytes);
    bulk_copy(slots + s * kBytes, w + __ldg(sched + 2 * p), bytes, full + 8 * s);
  }
  __device__ __forceinline__ void wait() const {
    barrier_wait(full + 8 * (k % kSlots), (k / kSlots) & 1);
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const int s = k % kSlots;
      __threadfence_block();
      if (atomicAdd(freed + s, 1) == kWideWarps - 1) {  // every warp of the block
        freed[s] = 0;
        __threadfence_block();
        if (k + kSlots < n) issue(k + kSlots);
      }
    }
    ++k;
  }
};

using WideRing = Ring<__nv_bfloat16>;

// Where a k x k conv's A fragments come from: the stage input in dt (T), in
// shared memory (act_s, its row of zeros at zero_s) or in scratch (act).
template <class T>
struct StageIn {
  const T* act;
  uint32_t act_s, zero_s;
};

template <bool kShared>
struct Taps;

// the stage input in shared memory: ldmatrix.x4 at the narrow kernel's Gather
template <>
struct Taps<true> {
  Gather G;
  uint32_t at;
  template <class D>
  __device__ __forceinline__ void start(const D& d, const StageIn<__nv_bfloat16>& in, int mt,
                                        int stride, int q, int dil) {
    G = gather_at(d, mt, in.act_s, in.zero_s, stride, q, dil);
  }
  template <class D>
  __device__ __forceinline__ void next(const D& d) {
    at = take_chunk(d, G);
  }
  __device__ __forceinline__ void fetch(int lo8, uint32_t (&a)[4]) const {
    fragment_a(at + 2 * lo8, a);
  }
};

// the stage input in scratch: four plain loads a fragment (ldmatrix reads
// shared memory only)
template <>
struct Taps<false> {
  WideGather G;
  const __nv_bfloat16* act;
  int c, off[4];
  template <class D>
  __device__ __forceinline__ void start(const D& d, const StageIn<__nv_bfloat16>& in, int mt,
                                        int stride, int q, int dil) {
    G = wide_gather(d, mt, q, dil, stride);
    act = in.act;
    c = 0;
  }
  template <class D>
  __device__ __forceinline__ void next(const D& d) {
    chunk_offsets(d, G, c++, off);
  }
  __device__ __forceinline__ void fetch(int lo8, uint32_t (&a)[4]) const {
    fragment_a_scratch(act, off, lo8, a);
  }
};

// The tf32 counterpart of Taps: one slice a k8 chunk, each A fragment split
// as it is read (Tf32::load_a, Tf32::split_a). In shared memory the narrow
// kernel's walk (TileTaps, ldmatrix.x4); in scratch four plain loads.
template <bool kShared>
struct TfTaps;

template <>
struct TfTaps<true> {
  TileTaps<1> G;
  uint32_t at;
  template <class D>
  __device__ __forceinline__ void start(const D& d, const StageIn<float>& in, int mt, int stride,
                                        int q, int dil) {
    const int mts[1] = {mt};
    G = taps_at<Tf32>(d, mts, in.act_s, in.zero_s, stride, q, dil);
  }
  template <class D>
  __device__ __forceinline__ void next(const D& d) {
    uint32_t a[1];
    taps_take<Tf32>(d, G, a);
    at = a[0];
  }
  __device__ __forceinline__ void fetch(int lo8, Tf32::A& a) const {
    a = Tf32::load_a(at + Tf32::kItem * lo8);
  }
};

template <>
struct TfTaps<false> {
  WideGather G;
  const float* act;
  int c, off[2];
  template <class D>
  __device__ __forceinline__ void start(const D& d, const StageIn<float>& in, int mt, int stride,
                                        int q, int dil) {
    G = wide_gather(d, mt, q, dil, stride);
    act = in.act;
    c = 0;
  }
  template <class D>
  __device__ __forceinline__ void next(const D& d) {
    tf32_offsets(d, G, c++, off);
  }
  // plain loads of what this kernel writes, never the read-only path: rows
  // g and g+8, channels 2t and 2t+1 each, as an accumulator tile holds them
  __device__ __forceinline__ void fetch(int lo8, Tf32::A& a) const {
    float2 v[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      v[i] = off[i] < 0 ? make_float2(0.f, 0.f)
                        : *reinterpret_cast<const float2*>(act + off[i] + lo8);
    a = Tf32::tile_a(v[0].x, v[0].y, v[1].x, v[1].y);
  }
};

// the A walk of product Prod with the stage input in shared memory or not
template <class Prod, bool kShared>
struct TapsOf {
  using type = Taps<kShared>;
};
template <bool kShared>
struct TapsOf<Tf32, kShared> {
  using type = TfTaps<kShared>;
};

// acc = the SAME k x k conv (dilation 1) of this warp's 16-pixel tile mt of
// the stage input (`stride` elements a pixel, q slices a tap) over `ch` k16
// (bf16) or k8 (tf32) chunks, into n8 tiles [j0, j0 + nt) of a stage of NTs
// tiles whose B pieces come from the ring (in tf32 with the piece's lo
// plane, LoPlane). `active`: the warpgroup has pixels this round; an idle
// one only walks the ring.
template <class Prod, bool kShared, class D>
__device__ __forceinline__ void conv_pass(const D& d, const StageIn<typename Prod::T>& in, int mt,
                                          int stride, int q, int ch, int NTs, int j0, int nt,
                                          bool active,
                                          Ring<typename Prod::T, kWideSlot<Prod>>& ring,
                                          LoPlane& lo, float (&acc)[4 * kPassTiles]) {
#pragma unroll
  for (int i = 0; i < 4 * kPassTiles; ++i) acc[i] = 0.f;
  typename TapsOf<Prod, kShared>::type A;
  if (active) A.start(d, in, mt, stride, q, 1);
  const int per = chunks_a_piece<Prod>(NTs, nt);
  for (int c0 = 0; c0 < ch; c0 += per) {
    ring.wait();
    if (active) {
      if constexpr (Prod::kSlices == 2) {
        for (int i = 0; i < min(per, ch - c0); ++i) {
          uint32_t a[4];
          A.next(d);
          A.fetch(0, a);
          wgmma_fence();
          wgmma_n(nt, acc, a, ring.slot() + i * nt * 2 * kFrag);
          wgmma_commit();
        }
      } else {
        const int n = min(per, ch - c0);
        const uint32_t plane = lo.split(ring.slot(), n * nt * kFragBytes);
        for (int i = 0; i < n; ++i) {
          Tf32::A a;
          A.next(d);
          A.fetch(0, a);
          wgmma_fence();
          wgmma_split(nt, acc, a, ring.slot() + i * nt * kFragBytes, plane + i * nt * kFragBytes);
          wgmma_commit();
        }
      }
      wgmma_wait_all(acc);
    }
    ring.release();
  }
}

// u += the post 1x1's k16 chunk whose A fragment is a (two branch tiles'
// outputs), its B the ring's next piece
__device__ __forceinline__ void post_piece(WideRing& ring, bool active, int nt,
                                           const uint32_t (&a)[4], float (&u)[4 * kPassTiles]) {
  ring.wait();
  if (active) {
    wgmma_fence();
    wgmma_n(nt, u, a, ring.slot());
    wgmma_commit();
    wgmma_wait_all(u);
  }
  ring.release();
}

using Tf32Ring = Ring<float, kTf32SlotBytes>;

// tf32: u += the post 1x1's k8 chunks whose A fragments are a[0, n) (n one
// or two branch tiles' outputs, Tf32::tile_a), their B the ring's next piece
// (the chunks end to end) with its lo plane
__device__ __forceinline__ void post_piece(Tf32Ring& ring, LoPlane& lo, bool active, int nt,
                                           const Tf32::A (&a)[2], int n,
                                           float (&u)[4 * kPassTiles]) {
  ring.wait();
  if (active) {
    const uint32_t plane = lo.split(ring.slot(), n * nt * kFragBytes);
    wgmma_fence();
    wgmma_split(nt, u, a[0], ring.slot(), plane);
    if (n > 1) wgmma_split(nt, u, a[1], ring.slot() + nt * kFragBytes, plane + nt * kFragBytes);
    wgmma_commit();
    wgmma_wait_all(u);
  }
  ring.release();
}

// The chain of fused_subnet_mma_kernel for any trunk and head width, as the
// source note's wide variant: kWideGroups warpgroups, each a 64-pixel
// tile a round (its warps the 16-pixel tiles 4M..4M+3), that feed every
// stage's weights through a ring of kSlots shared slots themselves (Ring).
// Prod: Bf16 (one k16 product a chunk) or Tf32 (three TF32 products a k8
// chunk on split operands: A split once a gather or a hand-off, a branch
// tile's B in registers, a trunk-wide stage's B lo plane in shared memory,
// LoPlane). kShared: the stage input lives in shared memory after the ring
// (and in tf32 the lo planes), else in the sample's scratch after its
// trunk. `tiles`: the layout table's tiles, then every piece of the
// schedule, in device memory; per_sample: the scratch elements a sample
// (wide_scratch).
template <class Prod, bool kShared>
__global__ void __launch_bounds__(kWideThreads, 1)
fused_subnet_mma_wide_kernel(const float* __restrict__ x,
                             const typename Prod::T* __restrict__ wts,
                             const float* __restrict__ bias, float* scratch,
                             float* __restrict__ out, const Dims<kMaxBranches> d,
                             const MmaLayout<kMaxBranches> L, const WidePlan W,
                             const int* __restrict__ tiles, int64_t per_sample) {
  using T = typename Prod::T;
  constexpr bool kTf32 = Prod::kSlices == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // the barriers first, so that what wgmma reads past a slot is the next
  // slot, a lo plane, the stage input or the slack, never an mbarrier
  const uint32_t full = shared_addr(smem), slots = full + kBarrierBytes;
  int* freed = reinterpret_cast<int*>(smem + 8 * kSlots);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rounds = wide_rounds(L);
  Ring<T, kWideSlot<Prod>> ring{slots, full, freed, 0, rounds * W.n_pieces,
                                tiles + 5 * L.n_tiles, wts};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      barrier_init(full + 8 * s, 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int p = 0; p < kSlots && p < ring.n; ++p) ring.issue(p);
  }
  __syncthreads();

  // warpgroup and warp within it, uniform as the compiler sees them (so that
  // no wgmma sits on a path it takes for divergent)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), wq = __shfl_sync(0xffffffffu, warp & 3, 0);
  // tf32: this warpgroup's two lo planes, after the ring
  LoPlane plane{smem, full, slots + kRingBytes<Prod> + 2 * wg * kTf32SlotBytes, 1 + wg, 0};
  const int hw = d.h * d.w, NT = L.NT;
  const int64_t n = blockIdx.x;
  const float* xs = x + n * hw * d.cin;
  float* mine = scratch + n * per_sample;
  // the trunk in accumulator layout, [pixel tile][n8 tile][lane] float4: each
  // float4 is only ever read and written by its own lane
  float4* y = reinterpret_cast<float4*>(mine);
  // the stage input, rows as in the narrow kernel's shared memory, then (in
  // shared memory) a row of zeros: what a padding pixel reads
  const int row = L.xs > L.ts ? L.xs : L.ts;
  T* act = kShared ? reinterpret_cast<T*>(smem + kBarrierBytes + kRingBytes<Prod> +
                                          kLoPlanes<Prod>)
                   : reinterpret_cast<T*>(mine + L.trunk_per_sample);
  StageIn<T> in{act, 0u, 0u};
  if (kShared) {
    in.act_s = shared_addr(act);
    in.zero_s = in.act_s + Prod::kItem * hw * row;
    for (int e = threadIdx.x; e < row; e += kWideThreads) act[hw * row + e] = Prod::zero();
  }
  float* o = out + n * hw * d.out_total;
  auto y_at = [&](int mt, int j) -> float4& { return y[(mt * NT + j) * 32 + lane]; };

  // x -> dt, channels zero-padded to the slices
  const int cin_p = 8 * L.qx;
  for (int e = threadIdx.x; e < hw * cin_p; e += kWideThreads) {
    const int p = e / cin_p, c = e - p * cin_p;
    const float v = c < d.cin ? xs[p * d.cin + c] : 0.f;
    if constexpr (kTf32)
      act[p * L.xs + c] = v;
    else
      act[p * L.xs + c] = __float2bfloat16(v);
  }
  __syncthreads();

  // entry conv: y = conv_k(x) + entry_b
  for (int r = 0; r < rounds; ++r) {
    const int mt = 4 * (r * kWideGroups + wg) + wq;
    const bool active = 4 * (r * kWideGroups + wg) < L.n_mt;
    for (int j0 = 0; j0 < NT; j0 += kPassTiles) {
      const int nt = min(kPassTiles, NT - j0);
      float acc[4 * kPassTiles];
      conv_pass<Prod, kShared>(d, in, mt, L.xs, L.qx, L.ch_entry, NT, j0, nt, active, ring, plane,
                               acc);
      if (mt < L.n_mt) {
#pragma unroll
        for (int j = 0; j < kPassTiles; ++j) {
          if (j >= nt) break;
          const float2 b = bias2(bias, j0 + j);
          y_at(mt, j0 + j) = make_float4(acc[4 * j] + b.x, acc[4 * j + 1] + b.y,
                                         acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
        }
      }
    }
  }
  __syncthreads();

  for (int blk = 0; blk < d.res_blocks; ++blk) {
    const float* bb = bias + L.b_block0 + static_cast<int64_t>(blk) * L.b_block;

    // pre 1x1: t = dt(lrelu(dt(lrelu(y)) @ pre_w + pre_b)) into the stage
    // input. bf16: accumulator tiles 2c and 2c+1 of y are chunk c's A
    // fragment, up to kPassTiles / 2 chunks loaded together; tf32: tile c is
    // chunk c's (Tf32::tile_a), split as the chunk comes
    for (int r = 0; r < rounds; ++r) {
      const int mt = 4 * (r * kWideGroups + wg) + wq;
      const bool active = 4 * (r * kWideGroups + wg) < L.n_mt, mine_ok = mt < L.n_mt;
      for (int j0 = 0; j0 < NT; j0 += kPassTiles) {
        const int nt = min(kPassTiles, NT - j0), per = chunks_a_piece<Prod>(NT, nt);
        float acc[4 * kPassTiles];
#pragma unroll
        for (int i = 0; i < 4 * kPassTiles; ++i) acc[i] = 0.f;
        if constexpr (kTf32) {
          uint32_t lo = 0;  // the piece's lo plane
          for (int cc = 0; cc < L.ch_pre; ++cc) {
            const int cp = cc % per;  // cc's chunk within its piece
            if (cp == 0) {
              ring.wait();
              if (active) lo = plane.split(ring.slot(), min(per, L.ch_pre - cc) * nt * kFragBytes);
            }
            if (active) {
              const float4 v = mine_ok ? y_at(mt, cc) : make_float4(0.f, 0.f, 0.f, 0.f);
              const Tf32::A a = Tf32::tile_a(lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w));
              wgmma_fence();
              wgmma_split(nt, acc, a, ring.slot() + cp * nt * kFragBytes, lo + cp * nt * kFragBytes);
              wgmma_commit();
            }
            if (cp + 1 == per || cc + 1 == L.ch_pre) {
              if (active) wgmma_wait_all(acc);
              ring.release();
            }
          }
        } else {
          for (int cb = 0; cb < L.ch_pre; cb += kPassTiles / 2) {
            uint32_t a[kPassTiles / 2][4];
#pragma unroll
            for (int c = 0; c < kPassTiles / 2; ++c) {
              const int cc = cb + c;
              float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
              if (mine_ok && cc < L.ch_pre) {
                lo = y_at(mt, 2 * cc);
                if (2 * cc + 1 < NT) hi = y_at(mt, 2 * cc + 1);
              }
              a[c][0] = pack_bf16(lrelu(lo.x), lrelu(lo.y));
              a[c][1] = pack_bf16(lrelu(lo.z), lrelu(lo.w));
              a[c][2] = pack_bf16(lrelu(hi.x), lrelu(hi.y));
              a[c][3] = pack_bf16(lrelu(hi.z), lrelu(hi.w));
            }
#pragma unroll
            for (int c = 0; c < kPassTiles / 2; ++c) {
              const int cc = cb + c;
              if (cc >= L.ch_pre) break;
              if (cc % per == 0) ring.wait();
              if (active) {
                wgmma_fence();
                wgmma_n(nt, acc, a[c], ring.slot() + (cc % per) * nt * 2 * kFrag);
                wgmma_commit();
              }
              if ((cc + 1) % per == 0 || cc + 1 == L.ch_pre) {
                if (active) wgmma_wait_all(acc);
                ring.release();
              }
            }
          }
        }
        if (mine_ok) {
          const Rows rw = tile_rows(d, mt);
#pragma unroll
          for (int j = 0; j < kPassTiles; ++j) {
            if (j >= nt) break;
            const float2 b = bias2(bb, j0 + j);
            const int ch = 8 * (j0 + j) + 2 * (lane & 3);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (rw.ok[i])
                Prod::store2(act + (rw.py[i] * d.w + rw.px[i]) * L.ts + ch,
                             lrelu(acc[4 * j + 2 * i] + b.x), lrelu(acc[4 * j + 2 * i + 1] + b.y));
          }
        }
      }
    }
    __syncthreads();

    // branches and post 1x1: the branch tiles in groups of kGroupTiles, each
    // group's chunks located once for all its tiles (mma.sync, B from the
    // ring); s = dt(lrelu(gconv(t) + bb)) multiplied into the post 1x1 as
    // soon as it is done (wgmma): in bf16 two tiles a k16 chunk of its A
    // operand, in tf32 each tile a k8 chunk; y = y + u + post_b
    for (int r = 0; r < rounds; ++r) {
      const int mt = 4 * (r * kWideGroups + wg) + wq;
      const bool active = 4 * (r * kWideGroups + wg) < L.n_mt;
      for (int j0 = 0; j0 < NT; j0 += kPassTiles) {
        const int nt = min(kPassTiles, NT - j0);
        float u[4 * kPassTiles];
#pragma unroll
        for (int i = 0; i < 4 * kPassTiles; ++i) u[i] = 0.f;
        uint32_t pend[2] = {0u, 0u};  // bf16: an even tile's fragment half, waiting for its pair
        // tf32: an even tile's A fragment, waiting for its pair where the pass
        // takes every tile (two k8 chunks of the post 1x1 lie end to end)
        Tf32::A pair[2];
        const bool pairs = nt == NT;
        for (int br = 0; br < d.nd; ++br) {
          const int t0 = L.br_tile0[br], end = t0 + L.br_tiles[br];
          const int q = __ldg(tiles + 5 * t0 + 1), chunks = __ldg(tiles + 5 * t0 + 2);
          for (int g0 = t0; g0 < end; g0 += kGroupTiles) {
            const int ng = min(kGroupTiles, end - g0), per = kWideSlot<Prod> / kFragBytes / ng;
            int lo8[kGroupTiles];
#pragma unroll
            for (int j = 0; j < kGroupTiles; ++j) lo8[j] = __ldg(tiles + 5 * (g0 + min(j, ng - 1)));
            float s[kGroupTiles][4] = {};
            typename TapsOf<Prod, kShared>::type A;
            if (active) A.start(d, in, mt, L.ts, q, d.dil[br]);
            for (int c0 = 0; c0 < chunks; c0 += per) {
              ring.wait();
              if (active) {
#pragma unroll 2
                for (int i = 0; i < min(per, chunks - c0); ++i) {
                  A.next(d);
                  // lane l: row l % 8 of core matrix l / 8 of tiles j, j + 1
                  const uint32_t bq = ring.slot() + i * ng * 2 * kFrag + 16 * lane;
#pragma unroll
                  for (int j = 0; j < kGroupTiles; j += 2) {
                    if (j >= ng) break;
                    uint32_t b[4];
                    fragment_a(bq + j * 2 * kFrag, b);
                    if constexpr (kTf32) {
                      Tf32::A a;
                      A.fetch(lo8[j], a);
                      Tf32::product(s[j], a, Tf32::split_b(b[0], b[1]));
                      if (j + 1 < ng) {
                        // tiles of one group of a wide branch share their window
                        if (lo8[j + 1] != lo8[j]) A.fetch(lo8[j + 1], a);
                        Tf32::product(s[j + 1], a, Tf32::split_b(b[2], b[3]));
                      }
                    } else {
                      uint32_t a[4];
                      A.fetch(lo8[j], a);
                      mma(s[j], a, make_uint2(b[0], b[1]));
                      if (j + 1 < ng) {
                        // tiles of one group of a wide branch share their window
                        if (lo8[j + 1] != lo8[j]) A.fetch(lo8[j + 1], a);
                        mma(s[j + 1], a, make_uint2(b[2], b[3]));
                      }
                    }
                  }
                }
              }
              ring.release();
            }
#pragma unroll
            for (int j = 0; j < kGroupTiles; ++j) {
              if (j >= ng) break;
              const int gt = g0 + j;
              const float2 b = bias2(bb + __ldg(tiles + 5 * gt + 4), 0);
              if constexpr (kTf32) {
                const int h = pairs ? gt % 2 : 0;
                pair[h] = Tf32::tile_a(lrelu(s[j][0] + b.x), lrelu(s[j][1] + b.y),
                                       lrelu(s[j][2] + b.x), lrelu(s[j][3] + b.y));
                if (h == 1 || !pairs || gt + 1 == L.n_tiles)
                  post_piece(ring, plane, active, nt, pair, h + 1, u);
              } else {
                const uint32_t lo = pack_bf16(lrelu(s[j][0] + b.x), lrelu(s[j][1] + b.y));
                const uint32_t hi = pack_bf16(lrelu(s[j][2] + b.x), lrelu(s[j][3] + b.y));
                if (gt % 2 == 0) {
                  pend[0] = lo;
                  pend[1] = hi;
                } else {
                  const uint32_t a[4] = {pend[0], pend[1], lo, hi};
                  post_piece(ring, active, nt, a, u);
                }
              }
            }
          }
        }
        if constexpr (!kTf32) {
          if (L.n_tiles % 2) {
            const uint32_t a[4] = {pend[0], pend[1], 0u, 0u};
            post_piece(ring, active, nt, a, u);
          }
        }
        // kLoadTiles of y's float4s loaded together, then updated
        if (mt < L.n_mt) {
#pragma unroll
          for (int jb = 0; jb < kPassTiles; jb += kLoadTiles) {
            float4 old[kLoadTiles];
#pragma unroll
            for (int j = 0; j < kLoadTiles; ++j)
              if (jb + j < nt) old[j] = y_at(mt, j0 + jb + j);
#pragma unroll
            for (int j = 0; j < kLoadTiles; ++j) {
              const int jj = jb + j;
              if (jj >= nt) break;
              const float2 b = bias2(bb + L.b_post, j0 + jj);
              y_at(mt, j0 + jj) =
                  make_float4((old[j].x + u[4 * jj]) + b.x, (old[j].y + u[4 * jj + 1]) + b.y,
                              (old[j].z + u[4 * jj + 2]) + b.x, (old[j].w + u[4 * jj + 3]) + b.y);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // head: t = dt(lrelu(y)) into the stage input; out = conv_k(t) + head_b
  for (int r = 0; r < rounds; ++r) {
    const int mt = 4 * (r * kWideGroups + wg) + wq;
    if (mt >= L.n_mt) continue;
    const Rows rw = tile_rows(d, mt);
    for (int jb = 0; jb < NT; jb += kLoadTiles) {
      float4 v[kLoadTiles];
#pragma unroll
      for (int j = 0; j < kLoadTiles; ++j)
        if (jb + j < NT) v[j] = y_at(mt, jb + j);
#pragma unroll
      for (int j = 0; j < kLoadTiles; ++j) {
        if (jb + j >= NT) break;
        const int ch = 8 * (jb + j) + 2 * (lane & 3);
        if (rw.ok[0])
          Prod::store2(act + (rw.py[0] * d.w + rw.px[0]) * L.ts + ch, lrelu(v[j].x),
                       lrelu(v[j].y));
        if (rw.ok[1])
          Prod::store2(act + (rw.py[1] * d.w + rw.px[1]) * L.ts + ch, lrelu(v[j].z),
                       lrelu(v[j].w));
      }
    }
  }
  __syncthreads();
  const float* hb = bias + L.b_head;
  for (int r = 0; r < rounds; ++r) {
    const int mt = 4 * (r * kWideGroups + wg) + wq;
    const bool active = 4 * (r * kWideGroups + wg) < L.n_mt;
    for (int j0 = 0; j0 < L.NO; j0 += kPassTiles) {
      const int nt = min(kPassTiles, L.NO - j0);
      float acc[4 * kPassTiles];
      conv_pass<Prod, kShared>(d, in, mt, L.ts, NT, L.ch_head, L.NO, j0, nt, active, ring, plane,
                               acc);
      if (mt < L.n_mt) {
        const Rows rw = tile_rows(d, mt);
#pragma unroll
        for (int j = 0; j < kPassTiles; ++j) {
          if (j >= nt) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * (j0 + j) + 2 * (lane & 3) + (e & 1), i = e >> 1;
            if (rw.ok[i] && col < d.out_total)
              o[(rw.py[i] * d.w + rw.px[i]) * d.out_total + col] = acc[4 * j + e] + hb[col];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tf32, narrow: the scratch plan
// ---------------------------------------------------------------------------

constexpr int kSlotFrags = kSlotBytes / (4 * Tf32::kFrag);  // B fragments a slot holds
static_assert(kWarps == kWideWarps, "the ring counts every warp of the block out of a slot");
static_assert(kWalkSlices <= kSlotFrags, "a walk whose addresses a warp holds is one piece");

// the ring's slot of the piece being taken (slot0: its first slot, in shared memory)
__device__ __forceinline__ const float* ring_slot(const Ring<float>& ring, const float* slot0) {
  return slot0 + (ring.k % kSlots) * (kSlotBytes / 4);
}

// acc += the k x k conv of G's tile over ch k8 chunks into n8 tiles [0, nts)
// of a stage whose B fragments come through the ring, as many whole chunks a
// piece as a slot holds; a warp without a tile (mine false) only walks the ring
template <int kT, class D>
__device__ __forceinline__ void ring_conv(const D& d, Ring<float>& ring, const float* slot0,
                                          bool mine, TileTaps<1> G, int ch, int nts,
                                          float (&acc)[1][kT][4]) {
  const int per = kSlotFrags / nts;
  for (int c0 = 0; c0 < ch; c0 += per) {
    ring.wait();
    if (mine) {
      const float* w = ring_slot(ring, slot0);
      const int end = min(c0 + per, ch);
      for (int c = c0; c < end; ++c) {
        Tf32::A a[1];
        next_a<Tf32>(d, G, a);
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          if (j >= nts) break;
          Tf32::product(acc[0][j], a[0], Tf32::load_b(w, (c - c0) * nts + j));
        }
      }
    }
    ring.release();
  }
}

// acc = the head's k x k conv of G's tile over ch k8 chunks into its n8
// tiles [0, no), B through the ring as in ring_conv: its few output tiles
// make one chain of products a tile, so even and odd chunks and the cross
// terms sum apart, four chains a tile
template <class D>
__device__ __forceinline__ void ring_head(const D& d, Ring<float>& ring, const float* slot0,
                                          bool mine, TileTaps<1> G, int ch, int no,
                                          float (&acc)[1][kMaxHeadTiles][4]) {
  float odd[kMaxHeadTiles][4] = {}, x[2][kMaxHeadTiles][4] = {};
  const int per = kSlotFrags / no;
  for (int c0 = 0; c0 < ch; c0 += per) {
    ring.wait();
    if (mine) {
      const float* w = ring_slot(ring, slot0);
      const int end = min(c0 + per, ch);
      for (int c = c0; c < end; c += 2) {
        Tf32::A a0[1], a1[1];
        next_a<Tf32>(d, G, a0);
#pragma unroll
        for (int j = 0; j < kMaxHeadTiles; ++j) {
          if (j >= no) break;
          Tf32::product(acc[0][j], x[0][j], a0[0], Tf32::load_b(w, (c - c0) * no + j));
        }
        if (c + 1 < end) {  // the walk moves on by a chunk only where the piece has one
          next_a<Tf32>(d, G, a1);
#pragma unroll
          for (int j = 0; j < kMaxHeadTiles; ++j) {
            if (j >= no) break;
            Tf32::product(odd[j], x[1][j], a1[0], Tf32::load_b(w, (c + 1 - c0) * no + j));
          }
        }
      }
    }
    ring.release();
  }
#pragma unroll
  for (int j = 0; j < kMaxHeadTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] += odd[j][e] + (x[0][j][e] + x[1][j][e]);
}

// acc += lrelu(y) @ the pre 1x1, NT k8 chunks (Tf32::tile_a) whose B comes
// through the ring
template <int kT>
__device__ __forceinline__ void ring_pre(Ring<float>& ring, const float* slot0, bool mine,
                                         const float (&y)[1][kT][4], int NT,
                                         float (&acc)[1][kT][4]) {
  const int per = kSlotFrags / NT;
  int cp = 0;  // c's chunk within its piece
#pragma unroll
  for (int c = 0; c < kT; ++c, cp = cp + 1 == per ? 0 : cp + 1) {
    if (c >= NT) break;
    if (cp == 0) ring.wait();
    if (mine) {
      const float* w = ring_slot(ring, slot0);
      const Tf32::A a =
          Tf32::tile_a(lrelu(y[0][c][0]), lrelu(y[0][c][1]), lrelu(y[0][c][2]), lrelu(y[0][c][3]));
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        if (j >= NT) break;
        Tf32::product(acc[0][j], a, Tf32::load_b(w, cp * NT + j));
      }
    }
    if (cp == per - 1 || c + 1 == NT) ring.release();
  }
}

// s += branch tile gt's grouped conv over the tile of P, its k8 chunks
// through the ring (a slot of them a piece): where the walk is short, from
// the held addresses at, even and odd chunks into s[0] and s[1] and their
// cross terms into x[0] and x[1] (four chains of products); else from a walk
// taken chunk by chunk
template <class D>
__device__ __forceinline__ void ring_branch(const D& d, const MmaLayout<kNarrowBranches>& L,
                                            Ring<float>& ring, const float* slot0, bool mine,
                                            const TilePix<1>& P, uint32_t act, uint32_t zero,
                                            int br, int gt,
                                            const uint32_t (&at)[kWalk<Tf32>][1],
                                            float (&s)[2][4], float (&x)[2][4]) {
  const int chunks = L.tile[gt].chunks;
  const uint32_t lo = Tf32::kItem * L.tile[gt].lo8;
  if (chunks <= kWalk<Tf32>) {
    ring.wait();
    if (mine) {
      const float* w = ring_slot(ring, slot0);
#pragma unroll
      for (int c = 0; c < kWalk<Tf32>; ++c) {
        if (c >= chunks) break;
        Tf32::product(s[c & 1], x[c & 1], Tf32::load_a(at[c][0] + lo), Tf32::load_b(w, c));
      }
    }
    ring.release();
    return;
  }
  TileTaps<1> G = taps_at<Tf32>(d, P, act, zero, L.ts, L.tile[gt].q, d.dil[br]);
  for (int c0 = 0; c0 < chunks; c0 += kSlotFrags) {
    ring.wait();
    if (mine) {
      const float* w = ring_slot(ring, slot0);
      const int end = min(c0 + kSlotFrags, chunks);
      for (int c = c0; c < end; ++c) {
        uint32_t a_at[1];
        taps_take<Tf32>(d, G, a_at);
        Tf32::product(s[0], x[0], Tf32::load_a(a_at[0] + lo), Tf32::load_b(w, c - c0));
      }
    }
    ring.release();
  }
}

// The tf32 scratch plan (fused_subnet.py::narrow_plan, float32): one block a
// sample, kThreads threads, a 16-pixel tile a warp a round in every phase.
// Shared memory: the ring's barriers and counters (kBarrierBytes), the plan
// head (the stage input's mbarrier, then the tap table), the stage input and
// its row of zeros (x at first), then the ring's kSlots slots, through which
// every phase's weights stream once a round (Ring: refilled by the warp that
// frees a slot last, in the order of the wrapper's schedule,
// fused_subnet.py::wide_schedule, which the entry checks against ring_walk).
// The biases are read from device memory: at 28 x 28 they do not fit beside
// the ring. The f32 trunk lives in the sample's scratch in the accumulator
// layout, each lane reading and writing only its own float4s. Phases: the
// entry with block 0's pre 1x1; each residual block (its branches and post
// 1x1 on each tile's trunk, then the next block's pre 1x1, or the head's
// lrelu(y)); the head. Each phase but the head writes the next stage input
// to the sample's scratch copy, which one bulk copy brings into the stage
// input after the phase's barrier (x has no buffer of its own here, so block
// 0's pre 1x1 takes that way too).
__global__ void __launch_bounds__(kThreads, 1)
fused_subnet_tf32_ring_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                              const float* __restrict__ bias, float4* trunk,
                              float* __restrict__ out, const Dims<kNarrowBranches> d,
                              const MmaLayout<kNarrowBranches> L, const int* __restrict__ sched,
                              int n_pieces) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t full = shared_addr(smem), act_bar = full + kBarrierBytes;
  int* freed = reinterpret_cast<int*>(smem + 8 * kSlots);
  int* shares_done = reinterpret_cast<int*>(smem + kBarrierBytes + 8);  // a count a split tile
  int4* tab = reinterpret_cast<int4*>(smem + kBarrierBytes + kPlanHead - kTapTable);
  float* act = reinterpret_cast<float*>(smem + kBarrierBytes + kPlanHead);
  const float* slot0 =
      reinterpret_cast<const float*>(smem + kBarrierBytes + kPlanHead + L.act_bytes);
  const int R = d.res_blocks, hw = d.h * d.w, NT = L.NT, row = L.xs > L.ts ? L.xs : L.ts;
  const int warp = threadIdx.x >> 5, rounds = (L.n_mt + kWarps - 1) / kWarps;
  const int64_t n = blockIdx.x;
  Ring<float> ring{shared_addr(slot0), full, freed, 0, n_pieces, sched, wts};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      barrier_init(full + 8 * s, 1);
      freed[s] = 0;
    }
    barrier_init(act_bar, 1);
    shares_done[0] = shares_done[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int p = 0; p < kSlots && p < ring.n; ++p) ring.issue(p);
  }
  for (int e = threadIdx.x; e < row; e += kThreads) act[hw * row + e] = 0.f;
  put_x<Tf32>(d, x + n * hw * d.cin, L.qx, L.xs, act);
  put_taps<Tf32>(d, L, tab);
  float4* y = trunk + n * (narrow_scratch<Tf32>(d, L) / 4);
  // the next stage input, rows of ts as in shared memory; then the split
  // tiles' shares of the post 1x1 (NT n8 tiles of f32 a lane each)
  float* t_next = reinterpret_cast<float*>(y + L.trunk_per_sample / 4);
  float4* shares = reinterpret_cast<float4*>(t_next + hw * L.ts);
  const int t_bytes = 4 * hw * L.ts;
  float* o = out + n * hw * d.out_total;
  const uint32_t act_s = shared_addr(act), zero = act_s + 4 * hw * row;
  // once every warp is past the phase: the scratch copy into the stage input
  auto next_stage = [&]() {
    // the copy's writes, made by this thread, before the bulk copy reads them
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      barrier_expect(act_bar, t_bytes);
      bulk_copy(act_s, t_next, t_bytes, act_bar);
    }
  };
  __syncthreads();

  // entry conv: y = conv_k(x) + entry_b; then block 0's pre 1x1 on it (the
  // head's input where there is no block) into the scratch copy
  for (int r = 0; r < rounds; ++r) {
    const int mt[1] = {r * kWarps + warp};
    const bool mine = mt[0] < L.n_mt;
    float v[1][kMaxTrunkTiles][4] = {};
    ring_conv(d, ring, slot0, mine, taps_at<Tf32>(d, mt, act_s, zero, L.xs, L.qx, 1), L.ch_entry,
              NT, v);
    add_bias(bias, NT, v);
    if (R > 0) {
      if (mine) store_trunk(y, NT, L.n_mt, mt, v);
      float acc[1][kMaxTrunkTiles][4] = {};
      ring_pre(ring, slot0, mine, v, NT, acc);
      if (mine) put_rows<Tf32>(d, mt, NT, bias + L.b_block0, acc, t_next, L.ts);
    } else if (mine) {
      put_rows<Tf32>(d, mt, NT, nullptr, v, t_next, L.ts);
    }
  }
  next_stage();

  // the residual blocks' whole tiles, then (split) the last round's one or
  // two tiles split across warps, a branch tile and its post 1x1 chunk each
  const int split = split_tiles(L), whole = L.n_mt - split, n_shares = split * L.ch_post;
  for (int blk = 0; blk < R; ++blk) {
    const bool last = blk + 1 == R;
    const float* bb = bias + L.b_block0 + blk * L.b_block;
    barrier_wait(act_bar, blk & 1);
    for (int r = 0; r < rounds; ++r) {
      const bool split_round = split > 0 && r + 1 == rounds;
      // a warp's tile, or in the split round its share's tile and branch tile
      const int ti = warp / L.ch_post, share_gt = warp - ti * L.ch_post;
      const int mt[1] = {split_round ? whole + (warp < n_shares ? ti : 0) : r * kWarps + warp};
      const bool mine = split_round ? warp < n_shares : mt[0] < whole;
      // y = y + u + post_b: each branch tile's output, lrelu(gconv(t) + bb),
      // a k8 chunk of the post 1x1 multiplied into the trunk's tiles as soon
      // as its pair is done, two chunks a piece (in the split round into the
      // share, which starts at zero)
      float v[1][kMaxTrunkTiles][4] = {};
      if (!split_round) load_trunk(y, NT, L.n_mt, mt, v);
      const TilePix<1> P = tile_pix(d, mt);
      Tf32::A pend{};  // an even tile's output, waiting for its pair
      bool pend_on = false;
      for (int br = 0; br < d.nd; ++br) {
        const int t0 = L.br_tile0[br], end = t0 + L.br_tiles[br];
        uint32_t at[kWalk<Tf32>][1];
        if (L.tile[t0].chunks <= kWalk<Tf32>)
          walk_at<Tf32>(d, L, tab, P, act_s, zero, br, L.tile[t0].chunks, at);
        for (int gt = t0; gt < end; ++gt) {
          const bool on = mine && (!split_round || gt == share_gt);
          float s[2][4] = {}, x[2][4] = {};
          ring_branch(d, L, ring, slot0, on, P, act_s, zero, br, gt, at, s, x);
          Tf32::A a{};
          if (on) {
            float sum[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[e] = (s[0][e] + s[1][e]) + (x[0][e] + x[1][e]);
            a = branch_a(L, bb, gt, sum);
          }
          if (gt % 2 == 0 && gt + 1 < L.n_tiles) {
            pend = a;
            pend_on = on;
            continue;
          }
          ring.wait();  // post 1x1 chunks gt - gt % 2 .. gt
          const float* w = ring_slot(ring, slot0);
          if (gt % 2 && pend_on) {
#pragma unroll
            for (int j = 0; j < kMaxTrunkTiles; ++j) {
              if (j >= NT) break;
              Tf32::product(v[0][j], pend, Tf32::load_b(w, j));
            }
          }
          if (on) {
#pragma unroll
            for (int j = 0; j < kMaxTrunkTiles; ++j) {
              if (j >= NT) break;
              Tf32::product(v[0][j], a, Tf32::load_b(w, (gt % 2) * NT + j));
            }
          }
          ring.release();
        }
      }
      bool done = mine;  // this warp finishes its tile's block
      if (split_round) {
        // each share to the sample's scratch; the warp that writes a tile's
        // last share adds them up in branch-tile order (whatever the order
        // they came in) onto the trunk
        done = false;
        if (mine) {
          const int lane = threadIdx.x & 31;
#pragma unroll
          for (int j = 0; j < kMaxTrunkTiles; ++j)
            if (j < NT) shares[(warp * NT + j) * 32 + lane] =
                make_float4(v[0][j][0], v[0][j][1], v[0][j][2], v[0][j][3]);
          __syncwarp();
          int before = 0;
          if (lane == 0) {
            __threadfence_block();
            before = atomicAdd(shares_done + ti, 1);
          }
          done = __shfl_sync(0xffffffffu, before, 0) == L.ch_post - 1;
          if (done) {
            __syncwarp();
            __threadfence_block();
            load_trunk(y, NT, L.n_mt, mt, v);
            for (int g = 0; g < L.ch_post; ++g) {
#pragma unroll
              for (int j = 0; j < kMaxTrunkTiles; ++j) {
                if (j >= NT) break;
                const float4 p = shares[((ti * L.ch_post + g) * NT + j) * 32 + lane];
                v[0][j][0] += p.x;
                v[0][j][1] += p.y;
                v[0][j][2] += p.z;
                v[0][j][3] += p.w;
              }
            }
            if (lane == 0) shares_done[ti] = 0;
          }
        }
      }
      add_bias(bb + L.b_post, NT, v);
      if (last) {
        if (done) put_rows<Tf32>(d, mt, NT, nullptr, v, t_next, L.ts);
      } else {
        if (done) store_trunk(y, NT, L.n_mt, mt, v);
        float acc[1][kMaxTrunkTiles][4] = {};
        ring_pre(ring, slot0, done, v, NT, acc);
        if (done) put_rows<Tf32>(d, mt, NT, bb + L.b_block, acc, t_next, L.ts);
      }
    }
    next_stage();
  }

  // head: out = conv_k(t) + head_b, t = lrelu(y) in the stage input
  barrier_wait(act_bar, R & 1);
  for (int r = 0; r < rounds; ++r) {
    const int mt[1] = {r * kWarps + warp};
    const bool mine = mt[0] < L.n_mt;
    float acc[1][kMaxHeadTiles][4] = {};
    ring_head(d, ring, slot0, mine, taps_at<Tf32>(d, mt, act_s, zero, L.ts, NT, 1), L.ch_head,
              L.NO, acc);
    if (mine) put_head(d, mt, L.NO, bias + L.b_head, acc, o);
  }
}

// Every piece fused_subnet_tf32_ring_kernel's warps take from its ring, in
// their order, to piece(element offset, bytes): its phases, rounds, branch
// tiles, the post 1x1's chunks two branch tiles at a time and the pre 1x1's. On the host: the schedule the wrapper
// hands over is checked against it.
template <class Piece>
void ring_walk(const Dims<kNarrowBranches>& d, const MmaLayout<kNarrowBranches>& L, Piece piece) {
  const int rounds = (L.n_mt + kWarps - 1) / kWarps, R = d.res_blocks, F = Tf32::kFrag;
  auto chunks = [&](int64_t w, int ch, int nts) {
    const int per = kSlotFrags / nts;
    for (int c0 = 0; c0 < ch; c0 += per)
      piece(w + static_cast<int64_t>(c0) * nts * F, (ch - c0 < per ? ch - c0 : per) * nts * 4 * F);
  };
  for (int r = 0; r < rounds; ++r) {
    chunks(0, L.ch_entry, L.NT);
    if (R > 0) chunks(L.w_block0, L.ch_pre, L.NT);
  }
  for (int blk = 0; blk < R; ++blk) {
    const int64_t wb = L.w_block0 + static_cast<int64_t>(blk) * L.w_block;
    for (int r = 0; r < rounds; ++r) {
      for (int i = 0; i < L.n_tiles; ++i) {
        chunks(wb + L.tile[i].w_off, L.tile[i].chunks, 1);
        if (i % 2 || i + 1 == L.n_tiles)  // post 1x1 chunks i - i % 2 .. i
          chunks(wb + L.w_post + static_cast<int64_t>(i - i % 2) * L.NT * F, 1 + i % 2, L.NT);
      }
      if (blk + 1 < R) chunks(wb + L.w_block, L.ch_pre, L.NT);
    }
  }
  for (int r = 0; r < rounds; ++r) chunks(L.w_head, L.ch_head, L.NO);
}

// Every piece the kernel's warps take from the ring, in their order, to
// piece(element offset, bytes): each loop here is one of
// fused_subnet_mma_wide_kernel<Prod>'s (its stages, rounds, passes, branch
// groups and post chunks: in bf16 one k16 chunk a pair of branch tiles, in
// tf32 two k8 chunks a pair where the pass takes every tile, else one a
// tile). On the host: the schedule the wrapper hands over is checked
// against it.
template <class Prod, class Piece>
void walk_pieces(const Dims<kMaxBranches>& d, const MmaLayout<kMaxBranches>& L, const int* tiles,
                 Piece piece) {
  const int rounds = wide_rounds(L), NT = L.NT, F = Prod::kFrag, S = Prod::kSlices;
  auto imin = [](int a, int b) { return a < b ? a : b; };
  auto trunk_stage = [&](int64_t w, int ch, int NTs) {
    for (int r = 0; r < rounds; ++r)
      for (int j0 = 0; j0 < NTs; j0 += kPassTiles) {
        const int nt = imin(kPassTiles, NTs - j0), per = chunks_a_piece<Prod>(NTs, nt);
        for (int c0 = 0; c0 < ch; c0 += per)
          piece(pass_src(w, c0, NTs, j0, F), imin(per, ch - c0) * nt * kFragBytes);
      }
  };
  trunk_stage(0, L.ch_entry, NT);
  for (int blk = 0; blk < d.res_blocks; ++blk) {
    const int64_t wb = L.w_block0 + static_cast<int64_t>(blk) * L.w_block;
    trunk_stage(wb, L.ch_pre, NT);
    for (int r = 0; r < rounds; ++r)
      for (int j0 = 0; j0 < NT; j0 += kPassTiles) {
        const int nt = imin(kPassTiles, NT - j0);
        for (int br = 0; br < d.nd; ++br) {
          const int t0 = L.br_tile0[br], end = t0 + L.br_tiles[br], chunks = tiles[5 * t0 + 2];
          for (int g0 = t0; g0 < end; g0 += kGroupTiles) {
            const int ng = imin(kGroupTiles, end - g0), per = kWideSlot<Prod> / kFragBytes / ng;
            const int64_t wg = wb + tiles[5 * g0 + 3];
            for (int c0 = 0; c0 < chunks; c0 += per)
              piece(wg + static_cast<int64_t>(c0) * ng * F,
                    imin(per, chunks - c0) * ng * kFragBytes);
            for (int gt = g0; gt < g0 + ng; ++gt) {
              if (S == 2) {  // a k16 chunk of two tiles
                if (gt % 2) piece(pass_src(wb + L.w_post, gt / 2, NT, j0, F), nt * kFragBytes);
              } else if (nt < NT) {  // a k8 chunk of one tile
                piece(pass_src(wb + L.w_post, gt, NT, j0, F), nt * kFragBytes);
              } else if (gt % 2 || gt + 1 == L.n_tiles) {  // the k8 chunks of a pair of tiles
                piece(pass_src(wb + L.w_post, gt - gt % 2, NT, j0, F),
                      (1 + gt % 2) * nt * kFragBytes);
              }
            }
          }
        }
        if (S == 2 && L.n_tiles % 2)
          piece(pass_src(wb + L.w_post, L.n_tiles / 2, NT, j0, F), nt * kFragBytes);
      }
  }
  trunk_stage(L.w_head, L.ch_head, L.NO);
}

// Whether the table's schedule, the n_sched ints at lens (after its tiles),
// is the order in which walk(piece) visits a ring's pieces over `rounds`
// rounds: `stages` stage lengths adding up to n_pieces, then as many
// (element offset, bytes) pairs, every piece a multiple of 16 bytes, at most
// a slot (`slot` bytes), inside the weights (of `item` bytes an element).
template <int B, class Walk>
bool schedule_matches(const MmaLayout<B>& L, int stages, int rounds, int n_pieces,
                      const int* lens, int64_t n_sched, int item, int slot, Walk walk) {
  if (n_sched != stages + 2 * static_cast<int64_t>(n_pieces)) return false;
  int64_t sum = 0;
  for (int s = 0; s < stages; ++s) {
    if (lens[s] < 1) return false;
    sum += lens[s];
  }
  if (sum != n_pieces || static_cast<int64_t>(rounds) * n_pieces > INT32_MAX) return false;
  int64_t k = 0;
  bool ok = true;
  walk([&](int64_t src, int bytes) {
    const int* piece =
        lens + stages + 2 * schedule_entry(lens, stages, rounds, static_cast<int>(k));
    ok = ok && k < static_cast<int64_t>(rounds) * n_pieces && piece[0] == src &&
         piece[1] == bytes && bytes > 0 && bytes % 16 == 0 && bytes <= slot &&
         src * item % 16 == 0 && src + bytes / item <= L.w_total;
    ++k;
  });
  return ok && k == static_cast<int64_t>(rounds) * n_pieces;
}

// The narrow tensor-core kernel of product Prod on the plan narrow_plan
// picks: on chip (the build sized to the trunk), or the scratch plan (bf16:
// two stage buffers of weights; tf32: the ring, its schedule checked against
// ring_walk and read from device_table).
template <class Prod>
int launch_narrow(const void* x, const void* wts, const void* bias, void* trunk, void* out,
                  int batch, const Dims<kNarrowBranches>& d, int64_t n_weights, int64_t n_biases,
                  int64_t n_trunk, const int* table, int n_table, const int* device_table,
                  cudaStream_t stream) {
  MmaLayout<kNarrowBranches> L{};
  WidePlan W{};
  if (batch < 1 || !read_mma_layout(table, n_table, L, W) ||
      !mma_layout_ok<Prod>(d, L, W, table + kTableTiles, false, n_weights, n_biases) ||
      n_trunk < static_cast<int64_t>(batch) * narrow_scratch<Prod>(d, L))
    return static_cast<int>(cudaErrorInvalidValue);
  using T = typename Prod::T;
  const float* xf = static_cast<const float*>(x);
  const T* wt = static_cast<const T*>(wts);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  const NarrowPlan P = narrow_plan<Prod>(d, L);
  if (L.on_chip && L.NT <= kChipSmallTiles) {
    static bool limit_set[kMaxDevices] = {};
    cudaError_t err = allow_shared(fused_subnet_mma_chip_kernel<Prod, kChipSmallTiles>, limit_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_subnet_mma_chip_kernel<Prod, kChipSmallTiles>
        <<<batch, P.threads, P.shared, stream>>>(xf, wt, bf, of, d, L);
  } else if (L.on_chip) {
    static bool limit_set[kMaxDevices] = {};
    cudaError_t err = allow_shared(fused_subnet_mma_chip_kernel<Prod, kMaxTrunkTiles>, limit_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_subnet_mma_chip_kernel<Prod, kMaxTrunkTiles>
        <<<batch, P.threads, P.shared, stream>>>(xf, wt, bf, of, d, L);
  } else if constexpr (Prod::kSlices == 2) {
    static bool limit_set[kMaxDevices] = {};
    cudaError_t err = allow_shared(fused_subnet_mma_kernel, limit_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_subnet_mma_kernel<<<batch, P.threads, P.shared, stream>>>(
        xf, wt, bf, static_cast<float4*>(trunk), of, d, L);
  } else {
    const int rounds = (L.n_mt + kWarps - 1) / kWarps;
    const int* lens = table + kTableTiles + 5 * L.n_tiles;
    if (device_table == nullptr ||
        !schedule_matches(L, 2 + d.res_blocks, rounds, W.n_pieces, lens,
                          n_table - kTableTiles - 5 * L.n_tiles, Prod::kItem, kSlotBytes,
                          [&](auto piece) { ring_walk(d, L, piece); }))
      return static_cast<int>(cudaErrorInvalidValue);
    static bool limit_set[kMaxDevices] = {};
    cudaError_t err = allow_shared(fused_subnet_tf32_ring_kernel, limit_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_subnet_tf32_ring_kernel<<<batch, P.threads, P.shared, stream>>>(
        xf, wt, bf, static_cast<float4*>(trunk), of, d, L,
        device_table + kTableTiles + 5 * L.n_tiles, rounds * W.n_pieces);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wide kernel of product Prod (bf16, or tf32 for float32), the stage
// input in shared memory where it fits; its table checked against its own
// layout, plan and schedule (walk_pieces) before any launch.
template <class Prod>
int launch_wide(const void* x, const void* wts, const void* bias, void* trunk, void* out,
                int batch, const Dims<kMaxBranches>& d, int64_t n_weights, int64_t n_biases,
                int64_t n_trunk, const int* table, int n_table, const int* device_table,
                cudaStream_t stream) {
  MmaLayout<kMaxBranches> L{};
  WidePlan W{};
  if (batch < 1 || !read_mma_layout(table, n_table, L, W) ||
      !mma_layout_ok<Prod>(d, L, W, table + kTableTiles, true, n_weights, n_biases))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_sample = wide_scratch(L, W);
  const int* tiles = table + kTableTiles;
  if (n_trunk < static_cast<int64_t>(batch) * per_sample || device_table == nullptr ||
      !schedule_matches(L, 2 + 2 * d.res_blocks, wide_rounds(L), W.n_pieces,
                        tiles + 5 * L.n_tiles, n_table - kTableTiles - 5 * L.n_tiles,
                        Prod::kItem, kWideSlot<Prod>,
                        [&](auto piece) { walk_pieces<Prod>(d, L, tiles, piece); }))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const auto* wt = static_cast<const typename Prod::T*>(wts);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  static bool limit_set[2][kMaxDevices] = {};
  float* sf = static_cast<float*>(trunk);
  const int* on_card = device_table + kTableTiles;
  if (W.act_in_shared) {
    cudaError_t err = allow_shared(fused_subnet_mma_wide_kernel<Prod, true>, limit_set[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_subnet_mma_wide_kernel<Prod, true><<<batch, kWideThreads, W.wide_shared, stream>>>(
        xf, wt, bf, sf, of, d, L, W, on_card, per_sample);
  } else {
    cudaError_t err = allow_shared(fused_subnet_mma_wide_kernel<Prod, false>, limit_set[0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_subnet_mma_wide_kernel<Prod, false><<<batch, kWideThreads, W.wide_shared, stream>>>(
        xf, wt, bf, sf, of, d, L, W, on_card, per_sample);
  }
  return static_cast<int>(cudaGetLastError());
}

// d's fields and its dilations (the first B of them) into a Dims<B>
template <int B>
Dims<B> with_dilations(const Dims<B>& d, int n_dil, const int* dilations) {
  Dims<B> out = d;
  out.nd = n_dil;
  for (int i = 0; i < B; ++i) out.dil[i] = i < n_dil ? dilations[i] : 1;
  return out;
}

template <bool kWide>
int launch(const void* x, const void* weights, const void* biases, void* trunk, void* out,
           int batch, const DimsOf<kWide>& d, int dtype, long long n_weights,
           long long n_biases, long long n_trunk, const int* table, int n_table,
           const int* device_table, cudaStream_t stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kWide) {
    if (dtype == 0)
      return launch_wide<Tf32>(x, weights, biases, trunk, out, batch, d, n_weights, n_biases,
                               n_trunk, table, n_table, device_table, stream);
    return launch_wide<Bf16>(x, weights, biases, trunk, out, batch, d, n_weights, n_biases,
                             n_trunk, table, n_table, device_table, stream);
  } else {
    if (dtype == 0)
      return launch_narrow<Tf32>(x, weights, biases, trunk, out, batch, d, n_weights, n_biases,
                                 n_trunk, table, n_table, device_table, stream);
    return launch_narrow<Bf16>(x, weights, biases, trunk, out, batch, d, n_weights, n_biases,
                               n_trunk, table, n_table, device_table, stream);
  }
}

// The entry points' common part: the dilations checked and copied into the
// variant's Dims (the narrow kernels take at most kNarrowBranches), then the
// launch of dtype's kernel.
template <bool kWide>
int forward(const void* x, const void* weights, const void* biases, void* trunk, void* out,
            int batch, const DimsOf<kWide>& d, int n_dil, const int* dilations, int dtype,
            long long n_weights, long long n_biases, long long n_trunk, const int* table,
            int n_table, const int* device_table, void* stream) {
  if (dilations == nullptr || n_dil < 1 || n_dil > (kWide ? kMaxBranches : kNarrowBranches))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kWide>(x, weights, biases, trunk, out, batch, with_dilations(d, n_dil, dilations),
                       dtype, n_weights, n_biases, n_trunk, table, n_table, device_table,
                       static_cast<cudaStream_t>(stream));
}

}  // namespace

// x (batch, h, w, cin) f32; weights: the packed dt kernels (n_weights
// elements); biases: the packed f32 biases (n_biases); trunk: f32 scratch of
// n_trunk elements; out (batch, h, w, out_total) f32. dtype: 0 = float32
// (tf32 products), 1 = bfloat16 (the type of weights and of the products'
// operands; each has its own packing). dilations: the n_dil branches'
// dilations (at most kNarrowBranches; the wide entry takes kMaxBranches).
// table, n_table: the tensor-core layout (fused_subnet.py::layout_table);
// device_table: a copy of it in device memory with its ring's schedule
// written out (fused_subnet.py::_layout_table_on), which the float32 scratch
// plan reads (null elsewhere).
extern "C" int fused_subnet_forward(const void* x, const void* weights, const void* biases,
                                    void* trunk, void* out, int batch, int h, int w, int cin,
                                    int kernels, int res_blocks, int cardinality, int ksize,
                                    int n_dil, const int* dilations, int out_total, int dtype,
                                    long long n_weights, long long n_biases, long long n_trunk,
                                    const int* table, int n_table, const int* device_table,
                                    void* stream) {
  const Dims<kNarrowBranches> d{h, w, cin, kernels, res_blocks, cardinality, ksize, 0,
                                out_total, {}};
  return forward<false>(x, weights, biases, trunk, out, batch, d, n_dil, dilations, dtype,
                        n_weights, n_biases, n_trunk, table, n_table, device_table, stream);
}

// The wide variant (the source note), with fused_subnet_forward's arguments;
// trunk is the wide scratch (fused_subnet.py::trunk_elements), and
// device_table a copy of `table` in device memory with its ring's schedule
// written out, from which the kernel reads the branch tiles and the pieces.
extern "C" int fused_subnet_forward_wide(const void* x, const void* weights, const void* biases,
                                         void* trunk, void* out, int batch, int h, int w,
                                         int cin, int kernels, int res_blocks, int cardinality,
                                         int ksize, int n_dil, const int* dilations,
                                         int out_total, int dtype, long long n_weights,
                                         long long n_biases, long long n_trunk, const int* table,
                                         int n_table, const int* device_table, void* stream) {
  const Dims<kMaxBranches> d{h, w, cin, kernels, res_blocks, cardinality, ksize, 0, out_total,
                             {}};
  return forward<true>(x, weights, biases, trunk, out, batch, d, n_dil, dilations, dtype,
                       n_weights, n_biases, n_trunk, table, n_table, device_table, stream);
}
