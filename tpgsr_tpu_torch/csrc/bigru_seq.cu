// K1: the bidirectional GRU recurrence over a whole sequence, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpgsr_tpu/ops/pallas_gru.py::_gru_seq_kernel
// (launched by _bigru_pallas_impl at pallas_gru.py:95).  The input projection
// xp = x W_ih^T + b_ih stays outside, one cuBLAS addmm (ops/rnn.py), as in the
// JAX wrapper; this kernel runs only the serial recurrence, from h0 = 0:
//
//   hp = h W_hh^T + b_hh;  r = sig(xr + hr);  z = sig(xz + hz);
//   n = tanh(xn + r * hn);  h = (1 - z) n + z h
//
// Layout: xp [N, T, 6H] (forward gates r,z,n then backward gates r,z,n),
// w_t [2, H, 3H] (per direction W_hh transposed: the JAX kernel's [2H, 3H]),
// b_hh [2, 3H], out [N, T, 2H] (forward state in [0, H), backward in [H, 2H)).
//
// What bounds it.  At the flagship's batch of 48 both sweeps have N*T = 49,152:
// over W (N = 768, T = 64) and over H (N = 3,072, T = 16), H = 32.  Each reads
// xp once (37.7 MB) and writes out once (12.6 MB): 15.0 us at 3.35 TB/s,
// against 0.6 GFLOP of recurrent products (9.0 us at 67 TFLOP/s fp32).  The
// first design (one row a thread, xp loaded one step ahead) took 83 us over W
// and 133 us over H on an H100 SXM at 700 W, for four causes:
//   1. each step waited on device memory: xp was fetched one step ahead only;
//   2. each thread held 3H weights for one (row, unit): 154 registers, three
//      blocks an SM, so the sweep over H's 1,536 blocks ran in four waves,
//      each paying the whole chain of T steps;
//   3. the weights' prologue read W_hh [3H, H] down its columns, 32 lines a load;
//   4. one FMA chain 32 deep a gate, and nothing else to fill its latency.
//
// The design, cause by cause.
//   1. A ring of S = 4 slots of xp in shared memory (S = 8 timed within 4 %
//      at both sweeps).  While step t computes, steps t+1 .. t+S-1 are in flight
//      by cp.async.cg, 16 B a lane, one commit group a step (an empty one
//      where there is nothing to load, so the count stays uniform for ragged
//      rows and T < S), and wait_group S-2 before each step.  A slot holds the
//      block's rows times 3H values of T (1,536 B x RPT for every H in fp32,
//      768 B x RPT in bf16).  Each warp
//      copies its own rows, with addresses set once before the loop.
//   2. RPT rows a thread (1, 2 or 4): thread (j, g) owns hidden unit j of rows
//      g*RPT .. g*RPT+RPT-1 and loads its 3H weights once for all of them.  The
//      RPT is chosen in Python (ops/gru_seq.py, launch_config): the smallest
//      one whose grid fits one wave at this kernel's occupancy, which
//      tpgsr_bigru_seq_occupancy reports.  At batch 48, RPT 1 over W and RPT 4
//      over H give 384 blocks each: one wave at three blocks an SM.
//   3. The weights arrive transposed, so the prologue's loads are contiguous
//      across j.
//   4. Each gate's dot product is split into P = 2 partial sums, and a
//      thread's rows run in two groups half a step apart (below), so that
//      each half step pairs FMA chains with the other group's gates.
// A row lies within one warp (H <= 32), so one __syncwarp() a step orders h
// (double-buffered in shared memory) and the ring; the warps of a block run
// unsynchronised.  The backward direction walks t_eff = T - 1 - t through
// strides: no time-flipped copy, and out is written in its final layout.
// fp32 throughout with accurate tanhf (sigmoid through tanhf); only the order
// of the sums differs from the plain version.
//
// Storage type T (float or __nv_bfloat16).  xp and out are T in device memory
// and in the ring; everything else is fp32: W_hh and b_hh (the wrapper hands
// over the bf16-rounded values as fp32 when T is bf16, as the JAX layers cast
// their weights to the activation dtype), the state h in registers and in its
// shared-memory buffers, the sums and the gates.  Each value of xp is widened
// to fp32 where the gates read it, and h is rounded to T only where it is
// stored to out, so that the bf16 instantiation keeps the TPU kernel's fp32
// state (pallas_gru.py:52-65) and halves the bytes.  A 16-byte cp.async moves
// 4 fp32 or 8 bf16 values of a row; a bf16 slot is half the bytes.
//
// Measured (tpgsr_tpu_torch/ablate_k1.py, H100 SXM at 700 W; PERF.md): 36.9 us
// over W and 31.5 us over H.  Over H the FMAs alone take about the 9 us of the
// fp32 peak; the gates' tanhf chains, the out stores and the ring's refill add
// the rest.  Over W, 64 dependent steps of ~1,140 cycles each bind.
//
// -Xptxas -v on sm_90a (registers and dynamic shared memory a block; no
// spills, no stack frame): H = 32: RPT 1 155 (7,168 B), RPT 2 147 (14,336 B),
// RPT 4 168 (28,672 B); H = 16: 89, 98, 133; H = 8: 61, 71, 89.  bf16:
// H = 32: 155 (4,096 B), 160 (8,192 B), 168 (16,384 B); H = 16: 91, 98, 132;
// H = 8: 61, 70, 84.  In bf16 the bytes halve (0.075 ms per SR forward at
// 3.35 TB/s) but the fp32 recurrent products (0.090 ms at 67 TFLOP/s) and
// the step chain bind: alone it takes 4 % less than fp32 (chip_smoke.py,
// H100 SXM at 700 W; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;  // blocks an SM the register budget is held to
constexpr int kStages = 4;     // slots of the xp ring

// sigmoid(x) = tanh(x / 2) / 2 + 1 / 2: one accurate tanhf, no expf and no
// division, within 1e-7 of 1 / (1 + exp(-x)).
__device__ __forceinline__ float sigmoid_f32(float x) { return fmaf(0.5f, tanhf(0.5f * x), 0.5f); }

// The storage type to fp32 and back (round to nearest even, as torch's .to()).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int H, int RPT>
struct Shape {
  static constexpr int kGroups = kThreads / H;           // row groups (threadIdx.y)
  static constexpr int kRows = kGroups * RPT;            // rows of a block
  static constexpr int kSlice = kRows * 3 * H;           // values of xp a step
  static constexpr int kWarpRows = 32 / H * RPT;        // rows of a warp
  static constexpr int kChunk = 16 / sizeof(T);          // values a 16-byte copy
  static constexpr int kRowChunks = 3 * H / kChunk;      // 16-byte chunks a row
  static constexpr int kPassRows = 32 / kRowChunks;      // rows a warp copies at once
  static constexpr int kPasses = (kWarpRows + kPassRows - 1) / kPassRows;
  static constexpr int kPartials = 2;                    // partial sums a gate
  static_assert(H % 8 == 0 && H % kPartials == 0, "H must be a multiple of 8");
};

// The xp ring of T, then the fp32 h buffers (16-byte aligned: a slot is a
// multiple of 16 bytes).
template <typename T, int H, int RPT>
constexpr size_t smem_bytes() {
  using Sh = Shape<T, H, RPT>;
  return sizeof(T) * kStages * Sh::kSlice + sizeof(float) * 2 * Sh::kRows * H;
}

template <typename T, int H, int RPT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bigru_seq_kernel(const T* __restrict__ xp, const float* __restrict__ w_t,
                     const float* __restrict__ b_hh, T* __restrict__ out, int n, int t_len) {
  using Sh = Shape<T, H, RPT>;
  constexpr int P = Sh::kPartials;
  constexpr int S = kStages;
  const int j = threadIdx.x;
  const int g = threadIdx.y;
  const int lane = (g * H + j) % 32;
  const int warp_row0 = (g * H + j) / 32 * Sh::kWarpRows;  // the warp's first local row
  const int dir = blockIdx.y;
  const int row0 = blockIdx.x * Sh::kRows;

  extern __shared__ __align__(16) float smem[];
  T* ring = reinterpret_cast<T*>(smem);                      // [S][kRows][3H]
  float* h_buf = reinterpret_cast<float*>(ring + S * Sh::kSlice);  // [2][kRows][H]

  // Cause 3: w_t[dir][k][gate*H + j] is contiguous across j for a fixed k.
  float wr[H], wz[H], wn[H];
  const float* w = w_t + static_cast<size_t>(dir) * H * 3 * H;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    wr[k] = w[k * 3 * H + j];
    wz[k] = w[k * 3 * H + H + j];
    wn[k] = w[k * 3 * H + 2 * H + j];
  }
  const float* b = b_hh + dir * 3 * H;
  const float br = b[j], bz = b[H + j], bn = b[2 * H + j];

  const size_t x_row = static_cast<size_t>(t_len) * 6 * H;
  const size_t o_row = static_cast<size_t>(t_len) * 2 * H;

  // Cause 1: the copies of step t's slice of the warp's rows into slot t % S.
  // Lane (sub, chunk) copies 16 bytes of rows sub, sub + kPassRows, ...; its
  // addresses are set once here, so a step adds one stride.  Rows beyond n
  // are zero-filled from a valid address.
  const int sub = lane / Sh::kRowChunks;
  const int chunk = lane % Sh::kRowChunks;
  const T* lane_src = xp + static_cast<size_t>(row0 + warp_row0 + sub) * x_row + dir * 3 * H + chunk * Sh::kChunk;
  T* lane_dst = ring + (warp_row0 + sub) * 3 * H + chunk * Sh::kChunk;
  const size_t pass_stride = Sh::kPassRows * x_row;
  unsigned copies = 0, valid = 0;  // bit p: pass p copies a row of the warp / a row below n
#pragma unroll
  for (int p = 0; p < Sh::kPasses; ++p) {
    const int r = sub + p * Sh::kPassRows;
    copies |= static_cast<unsigned>(sub < Sh::kPassRows && r < Sh::kWarpRows) << p;
    valid |= static_cast<unsigned>(row0 + warp_row0 + r < n) << p;
  }
  auto stage = [&](int t) {
    const int t_eff = dir ? t_len - 1 - t : t;
    const T* src = lane_src + static_cast<size_t>(t_eff) * 6 * H;
    T* dst = lane_dst + (t % S) * Sh::kSlice;
#pragma unroll
    for (int p = 0; p < Sh::kPasses; ++p) {
      const bool ok = (valid >> p) & 1u;
      if ((copies >> p) & 1u) cp_async16(dst + p * Sh::kPassRows * 3 * H, ok ? src + p * pass_stride : xp, ok);
    }
  };

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < t_len) stage(t);
    cp_async_commit();
  }

  // Cause 4, and the latency of the gates.  A thread's rows form two groups,
  // A (i < RA) and B (the rest); A runs half a step ahead of B.  Each half
  // step pairs one group's mat-vec (3 * P FMA chains a row, throughput-bound) with
  // the other group's gates (a chain of tanhf, latency-bound), independent
  // work that the compiler interleaves in one basic block.  At RPT = 1, A is
  // empty and the schedule is the plain one: mat-vec, then gates.
  constexpr int RA = RPT / 2;
  float ar[RPT][P], az[RPT][P], an[RPT][P];
  float h[RPT];

  // Row i's three dot products with h of its previous step, from buffer hb.
  auto matvec = [&](const float* hb, int i) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ar[i][p] = p == 0 ? br : 0.f;
      az[i][p] = p == 0 ? bz : 0.f;
      an[i][p] = p == 0 ? bn : 0.f;
    }
#pragma unroll
    for (int k = 0; k < H; k += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hb + (g * RPT + i) * H + k);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = q % P;
        ar[i][p] = fmaf(wr[k + q], hv[q], ar[i][p]);
        az[i][p] = fmaf(wz[k + q], hv[q], az[i][p]);
        an[i][p] = fmaf(wn[k + q], hv[q], an[i][p]);
      }
    }
  };
  // Row i's gates at step t from its sums and the ring's slice xs; h goes to
  // buffer hn and to out.
  auto gates = [&](const T* xs, float* hn, int i, int t) {
    float sr = ar[i][0], sz = az[i][0], sn = an[i][0];
#pragma unroll
    for (int p = 1; p < P; ++p) {
      sr += ar[i][p];
      sz += az[i][p];
      sn += an[i][p];
    }
    const int lr = g * RPT + i;
    const T* x = xs + lr * 3 * H;
    const float rg = sigmoid_f32(to_f32(x[j]) + sr);
    const float zg = sigmoid_f32(to_f32(x[H + j]) + sz);
    const float ng = tanhf(to_f32(x[2 * H + j]) + rg * sn);
    h[i] = (1.0f - zg) * ng + zg * h[i];
    hn[lr * H + j] = h[i];
    const int row = row0 + lr;
    const int t_eff = dir ? t_len - 1 - t : t;
    if (row < n) out[row * o_row + static_cast<size_t>(t_eff) * 2 * H + dir * H + j] = from_f32<T>(h[i]);
  };

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    h[i] = 0.f;
    h_buf[(g * RPT + i) * H + j] = 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RA; ++i) matvec(h_buf, i);  // group A's step 0

  for (int t = 0; t < t_len; ++t) {
    // Step t's group is complete once at most S-2 newer ones are pending.  A
    // row lies within one warp (H <= 32) and each warp copies its own rows, so
    // a warp barrier suffices: it makes the lanes' copies visible and closes
    // step t-1, whose slot the next copy reuses and whose h buffer this step
    // overwrites.  The warps of a block run their chains unsynchronised.
    cp_async_wait<S - 2>();
    __syncwarp();
    if (t + S - 1 < t_len) stage(t + S - 1);
    cp_async_commit();

    const float* hc = h_buf + (t & 1) * Sh::kRows * H;
    float* hn = h_buf + ((t + 1) & 1) * Sh::kRows * H;
    const T* xs = ring + (t % S) * Sh::kSlice;
#pragma unroll
    for (int i = RA; i < RPT; ++i) matvec(hc, i);  // B, step t
#pragma unroll
    for (int i = 0; i < RA; ++i) gates(xs, hn, i, t);  // A, step t
    __syncwarp();
#pragma unroll
    for (int i = 0; i < RA; ++i) matvec(hn, i);  // A, step t + 1 (unused after the last step)
#pragma unroll
    for (int i = RA; i < RPT; ++i) gates(xs, hn, i, t);  // B, step t
  }
  cp_async_wait<0>();
}

// Ops run by dispatch() on the kernel instantiation of (storage type, hidden,
// rpt).  Shared memory stays under the 48 KB a launch gets without opting in.
struct Forward {
  const void* xp;
  const float *w_t, *b_hh;
  void* out;
  int n, t_len;
  cudaStream_t stream;

  template <typename T, int H, int RPT>
  int run() const {
    static_assert(smem_bytes<T, H, RPT>() <= 48 * 1024, "the ring needs an opt-in to more shared memory");
    constexpr int rows = Shape<T, H, RPT>::kRows;
    const dim3 grid((n + rows - 1) / rows, 2);
    const dim3 block(H, kThreads / H);
    bigru_seq_kernel<T, H, RPT><<<grid, block, smem_bytes<T, H, RPT>(), stream>>>(
        static_cast<const T*>(xp), w_t, b_hh, static_cast<T*>(out), n, t_len);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Occupancy {
  int* blocks;

  template <typename T, int H, int RPT>
  int run() const {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, bigru_seq_kernel<T, H, RPT>, kThreads, smem_bytes<T, H, RPT>()));
  }
};

template <typename T, int H, class Op>
int by_rpt(const Op& op, int rpt) {
  switch (rpt) {
    case 1:
      return op.template run<T, H, 1>();
    case 2:
      return op.template run<T, H, 2>();
    case 4:
      return op.template run<T, H, 4>();
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, class Op>
int by_hidden(const Op& op, int hidden, int rpt) {
  switch (hidden) {
    case 8:
      return by_rpt<T, 8>(op, rpt);
    case 16:
      return by_rpt<T, 16>(op, rpt);
    case 32:
      return by_rpt<T, 32>(op, rpt);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16: 0 for float storage, 1 for __nv_bfloat16.
template <class Op>
int dispatch(const Op& op, int bf16, int hidden, int rpt) {
  return bf16 ? by_hidden<__nv_bfloat16>(op, hidden, rpt) : by_hidden<float>(op, hidden, rpt);
}

}  // namespace

// Both return a cudaError_t as int: 0 on success.  xp and out are float, or
// __nv_bfloat16 with bf16 = 1; w_t and b_hh are float either way.
extern "C" int tpgsr_bigru_seq_forward(const void* xp, const float* w_t, const float* b_hh, void* out,
                                       int n, int t_len, int hidden, int rpt, int bf16, void* stream) {
  if (n <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Forward op{xp, w_t, b_hh, out, n, t_len, static_cast<cudaStream_t>(stream)};
  return dispatch(op, bf16, hidden, rpt);
}

// Resident blocks an SM for the instantiation (storage, hidden, rpt), written to *blocks.
extern "C" int tpgsr_bigru_seq_occupancy(int hidden, int rpt, int bf16, int* blocks) {
  const Occupancy op{blocks};
  return dispatch(op, bf16, hidden, rpt);
}
