// K1's backward: BPTT of the bidirectional GRU recurrence, for Hopper (sm_90a).
//
// The backward of the recurrence that tpgsr_tpu/ops/pallas_gru.py::_gru_seq_kernel
// computes (pallas_gru.py:34; the JAX package has no backward kernel and
// differentiates its lax.scan instead).  The forward is csrc/bigru_seq.cu; the
// plain version is ops/rnn.py::bigru_recurrence_backward.  Per row and
// direction, in reverse time, from dh = 0 after the last step:
//
//   hp = W_hh h_{t-1} + b_hh and the gates r, z, n, recomputed from h_{t-1}
//   dh = grad_out_t + dh_next;  dn = dh (1 - z);  dz = dh (h_{t-1} - n)
//   dn^ = dn (1 - n^2);  dr^ = dn^ hn r (1 - r);  dz^ = dz z (1 - z)
//   dxp_t = [dr^, dz^, dn^];  dhp_t = [dr^, dz^, dn^ r]
//   dh_next = dh z + W_hh^T dhp_t
//
// Layout: xp [N, T, 6H] and out [N, T, 2H] as the forward's, w_t [2, H, 3H]
// (W_hh transposed per direction), b_hh [2, 3H], grad_out [N, T, 2H]; writes
// dxp [N, T, 6H], and per direction dhp [2, Np, T, 3H] and h_{t-1}
// [2, Np, T, H] for the rows below N (Np >= N; the wrapper zeroes the rest).
// dW_hh = sum_t dhp_t^T h_{t-1} and db_hh = sum_t dhp_t are one batched GEMM
// and one sum outside (ops/gru_seq.py), as the input projection's gradients
// are: laid out so, the GEMM splits its N*T-long sum into chunks of whole
// rows without a copy.  The backward direction walks t_eff = T-1-t through
// strides, as the forward does.
//
// What bounds it.  At the flagship's batch of 48 both sweeps have N*T = 49,152
// row-steps at H = 32.  It reads xp (37.7 MB), out (12.6 MB) and grad_out
// (12.6 MB) and writes dxp (37.7 MB), dhp (37.7 MB) and h_{t-1} (12.6 MB):
// 151 MB, 45 us at 3.35 TB/s, against 1.2 GFLOP of recurrent products (18 us
// at the fp32 peak).  The chain of T dependent steps needs, each step, the
// row's whole h_{t-1} (the recompute) and its whole dhp_t (W_hh^T dhp_t).
//
// The first design (0.101 / 0.104 ms over W / over H on an H100 SXM at
// 700 W) streamed w_t out of shared memory for W_hh^T dhp_t, about 130
// shared-memory wavefronts a warp a step, and ran the sweep over H in four
// waves.  This one, part by part:
//   1. W_hh^T dhp_t from the registers.  Thread (j, g) owns hidden unit j of
//      its rows and holds row j of W_hh for each gate (3H registers, which the
//      recompute needs anyway).  (W_hh^T dhp)_k = sum_j (W_r[j][k] dr^_j +
//      W_z[j][k] dz^_j + W_n[j][k] (dn^ r)_j), so lane j forms its H-vector
//      of terms with 3H FMAs and a reduce-scatter over the row's H lanes
//      (H - 1 shuffles, log2 H levels, within the row's segment of the warp)
//      leaves column k's sum in lane k.  Lane j holds its weights with the
//      columns permuted, W[j][m ^ P] in slot m with P = j & ~3, so that at the
//      levels over j's high bits every lane keeps slots 0 .. half-1 and sends
//      the rest: no selects there; the last two levels pick by j's low bits.
//      The recompute reads h_{t-1} four columns at a time in the same order.
//      No copy of W_hh in shared memory; only h_{t-1} passes through it, in
//      a buffer a step, so one __syncwarp() a step orders it.
//   2. RPT rows a thread (1, 2 or 4), chosen in Python (ops/gru_seq.py,
//      launch_config, from this kernel's own occupancy): at batch 48, RPT 1
//      over W and RPT 4 over H give 384 blocks, one wave at three an SM.
//   3. Loads D steps ahead (kDepth): with the shared-memory stream gone, the
//      kernel waits on device memory, and a warp with one row has little else
//      in flight.  At RPT 1 its loads run four steps ahead; at RPT 4 one
//      step, with h_{t-1} copied by cp.async, since the registers of three
//      blocks an SM (168 a thread) hold no more.  At the 168-register cap
//      ptxas's allocation moves with small edits of this source: chip_smoke.py
//      checks every instantiation for spills.
// fp32 throughout with accurate tanhf; only the order of the sums differs
// from the plain version.
//
// Storage type T (float or __nv_bfloat16), as in the forward: xp, out,
// grad_out and dxp are T in device memory; W_hh and b_hh arrive as fp32 (the
// bf16-rounded values when T is bf16), and every value is widened to fp32 on
// load, so the gates, dh, the shuffles' sums and dh_next are fp32, and dxp is
// rounded to T only where it is stored.  dhp and h_{t-1}, which feed the
// GEMM for dW_hh, stay fp32 in both instantiations.  In bf16 the recompute
// reads h_{t-1} as out stored it, rounded to bf16, where the forward carried
// it in fp32; the plain version reads out the same way.  At four rows a
// thread h_{t-1} stays in shared memory as T: cp.async copies 4 bytes, so in
// bf16 the even lanes copy two columns each.
//
// Measured (tpgsr_tpu_torch/bench_k1.py and ablate_k1.py --backward, H100 SXM
// at 700 W): 0.0785 ms over W and 0.073 over H, 1.6-1.75x the byte bound.
// Taking out the stores, the recompute or accurate tanhf each saves 10-15 us
// over W, 5-11 us over H; the shuffles 4 us.  -Xptxas -v on sm_90a: H = 32:
// 168 registers at RPT 1, 2 and 4; H = 16: 128, 135, 168; H = 8: 96, 95,
// 126; bf16: H = 32: 168 at every RPT; H = 16: 133, 124, 162; H = 8: 96,
// 90, 126; no spills, no stack frame.  The bf16 instantiations take 6 %
// longer than fp32's alone (chip_smoke.py, H100 SXM at 700 W; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;  // blocks an SM the register budget is held to
constexpr unsigned kFullMask = 0xffffffffu;
// Steps a row's loads run ahead: four at one row a thread, where a warp has
// one row in flight; at more rows a thread the registers hold one.
template <int RPT>
constexpr int kDepth = RPT == 1 ? 4 : 1;
// Whether h_{t-1} reaches shared memory by cp.async (at four rows a thread,
// and at two in bf16, where its registers would spill: the bf16 loads' and
// conversions' registers spilled 16 bytes there) or through a register.
template <typename T, int RPT>
constexpr bool kAsyncH = RPT == 4 || (RPT == 2 && sizeof(T) == 2);
// Buffers of h_{t-1} in shared memory: one a step in flight and the current.
template <typename T, int RPT>
constexpr int kHBuffers = kAsyncH<T, RPT> ? kDepth<RPT> + 1 : 2;
// Their element type: the storage type where cp.async copies out as it is,
// fp32 where h_{t-1} passes through a register (widened there).
template <typename T, int RPT>
using HStore = std::conditional_t<kAsyncH<T, RPT>, T, float>;

// As in the forward: sigmoid(x) = tanh(x / 2) / 2 + 1 / 2.
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

// Four consecutive values from shared memory, widened to fp32: one 16-byte
// load in fp32, one 8-byte load in bf16 (a bf16 is the top half of its fp32).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// 4 bytes from global to shared memory, in flight until a wait_group; zeros
// where !valid (no byte is read then).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float exchange(float x, int lane_mask) {
  return __shfl_xor_sync(kFullMask, x, lane_mask);
}

template <int H, int RPT>
struct Shape {
  static constexpr int kGroups = kThreads / H;  // row groups (threadIdx.y)
  static constexpr int kRows = kGroups * RPT;   // rows of a block
  static constexpr int kGates = 3 * H;
  static_assert(H % 4 == 0 && 32 % H == 0, "H must divide 32 and be a multiple of 4");
};

template <typename T, int H, int RPT>
constexpr size_t smem_bytes() {
  return sizeof(HStore<T, RPT>) * kHBuffers<T, RPT> * Shape<H, RPT>::kRows * H;  // h_{t-1}, [buffers][kRows][H]
}

// The levels of the reduce-scatter over j's bits above the lowest two: slot m
// holds column m ^ P, and lane j keeps the columns whose bit Half equals its
// own, which are slots 0 .. Half-1 for every lane.
template <int N, int Half>
__device__ __forceinline__ void fold_high(float (&v)[N]) {
  if constexpr (Half >= 4) {
#pragma unroll
    for (int m = 0; m < Half; ++m) v[m] += exchange(v[m + Half], Half);
    fold_high<N, Half / 2>(v);
  }
}

// (W_hh^T dhp_t)_j, summed over the row's H lanes (part 1).  Lane j's term
// for slot m is wr[m] dr^ + wz[m] dz^ + wn[m] (dn^ r); the first level folds
// slots m and m + H/2 as they are formed, so that H/2 terms are live at once.
template <int H>
__device__ __forceinline__ float wt_dhp(const float (&wr)[H], const float (&wz)[H], const float (&wn)[H],
                                        float dr, float dz, float dhn, int j) {
  auto term = [&](int m) { return fmaf(wr[m], dr, fmaf(wz[m], dz, wn[m] * dhn)); };
  float v[H / 2];
#pragma unroll
  for (int m = 0; m < H / 2; ++m) v[m] = term(m) + exchange(term(m + H / 2), H / 2);
  fold_high<H / 2, H / 4>(v);
  // v[0..3] now hold columns P .. P+3; lane j keeps P + 2 (j >> 1 & 1), then
  // P + (j & 3).
  const bool b1 = j & 2, b0 = j & 1;
  const float u0 = (b1 ? v[2] : v[0]) + exchange(b1 ? v[0] : v[2], 2);
  const float u1 = (b1 ? v[3] : v[1]) + exchange(b1 ? v[1] : v[3], 2);
  return (b0 ? u1 : u0) + exchange(b0 ? u0 : u1, 1);
}

template <typename T, int H, int RPT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bigru_seq_backward_kernel(const T* __restrict__ xp, const float* __restrict__ w_t,
                              const float* __restrict__ b_hh, const T* __restrict__ out,
                              const T* __restrict__ grad_out, T* __restrict__ dxp,
                              float* __restrict__ dhp, float* __restrict__ h_prev_out, int n, int n_pad,
                              int t_len) {
  using Sh = Shape<H, RPT>;
  using HS = HStore<T, RPT>;
  constexpr int G = Sh::kGates;
  const int j = threadIdx.x;
  const int g = threadIdx.y;
  const int dir = blockIdx.y;
  const int lrow0 = g * RPT;                       // the thread's first row in the block
  const int row0 = blockIdx.x * Sh::kRows + lrow0;  // ... and in the batch
  const int perm = j & ~3;                         // P: the column permutation of the weights
  const int quad = j >> 2;                         // P / 4

  extern __shared__ __align__(16) float smem_f32[];
  HS* smem = reinterpret_cast<HS*>(smem_f32);  // h_{t-1} of the block's rows, [buffers][kRows][H]

  // Row j of W_hh for each gate, slot m holding column m ^ P (part 1).
  float wr[H], wz[H], wn[H];
  const float* w = w_t + static_cast<size_t>(dir) * H * G;
#pragma unroll
  for (int m = 0; m < H; ++m) {
    const int k = m ^ perm;
    wr[m] = w[k * G + j];
    wz[m] = w[k * G + H + j];
    wn[m] = w[k * G + 2 * H + j];
  }
  const float* b = b_hh + dir * G;
  const float br = b[j], bz = b[H + j], bn = b[2 * H + j];

  // Row i of the thread is row0 + i.  Rows beyond n run the loop on zeros
  // (every lane of a warp must reach its shuffles and barriers) and store
  // nothing.  Offsets are 32-bit element counts from the kernel's pointer
  // arguments (the wrapper checks that they fit), so no pointer a row or an
  // array takes registers.
  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) valid |= static_cast<unsigned>(row0 + i < n) << i;
  const int x_row = t_len * 6 * H, o_row = t_len * 2 * H;  // values a row
  const int x0 = row0 * x_row + dir * G + j;                // xp, dxp
  const int o0 = row0 * o_row + dir * H + j;                // out, grad_out
  const int p0 = (dir * n_pad + row0) * t_len;              // dhp, h_prev_out: row-steps
  auto time_of = [&](int s) { return dir ? t_len - 1 - s : s; };  // step s of this direction

  // Each input of row i is loaded D steps ahead (D = kDepth<RPT>).  xp's
  // three gates and grad_out go to registers, each into the one its value
  // has just left once the gates and dh have read it, and so does h_{t-1}
  // (out at the direction's previous step, 0 at its first) once it is in
  // the step's buffer in shared memory, s % 2.  The steps run D at a time,
  // step s from register set (t_len - 1 - s) % D, so that every set's index
  // is known to the compiler.  With kAsyncH, h_{t-1} goes by cp.async
  // straight to the buffer s % (D + 1) instead, one commit group a step.
  constexpr int D = kDepth<RPT>;
  constexpr int NB = kHBuffers<T, RPT>;
  float x_r[D][RPT], x_z[D][RPT], x_n[D][RPT], go[D][RPT], hp[D][RPT], dh_next[RPT];
  auto load_x = [&](int s, int d, int i) {
    const bool ok = ((valid >> i) & 1u) && s >= 0;
    const int x = x0 + i * x_row + time_of(s) * 6 * H;
    x_r[d][i] = ok ? to_f32(xp[x]) : 0.f;
    x_z[d][i] = ok ? to_f32(xp[x + H]) : 0.f;
    x_n[d][i] = ok ? to_f32(xp[x + 2 * H]) : 0.f;
    go[d][i] = ok ? to_f32(grad_out[o0 + i * o_row + time_of(s) * 2 * H]) : 0.f;
  };
  auto h_src = [&](int s, int i) { return out + o0 + i * o_row + time_of(s - 1) * 2 * H; };
  auto load_h = [&](int s, int d, int i) {
    hp[d][i] = ((valid >> i) & 1u) && s > 0 ? to_f32(*h_src(s, i)) : 0.f;
  };
  // 4 bytes a copy: one fp32 column a lane, or two bf16 columns an even lane.
  auto stage_h = [&](int s) {
    HS* hb = smem + (s % NB) * Sh::kRows * H;
    if (sizeof(HS) == 4 || (j & 1) == 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const bool ok = ((valid >> i) & 1u) && s > 0;
        cp_async4(hb + (lrow0 + i) * H + j, ok ? h_src(s, i) : out, ok);
      }
    }
  };
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      load_x(t_len - 1 - d, d, i);
      if constexpr (!kAsyncH<T, RPT>) load_h(t_len - 1 - d, d, i);
    }
    if constexpr (kAsyncH<T, RPT>) {
      if (t_len - 1 - d >= 0) stage_h(t_len - 1 - d);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) dh_next[i] = 0.f;

  for (int s0 = t_len - 1; s0 >= 0; s0 -= D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {  // step s from input set d
      const int s = s0 - d;
      if (s < 0) break;
      const int te = time_of(s);
      HS* hb = smem + (s % NB) * Sh::kRows * H;
      if constexpr (kAsyncH<T, RPT>) {
        // Step s's group is complete once at most D - 1 newer ones are
        // pending; the barrier makes every lane's copy visible and closes the
        // reads of step s+1, whose buffer the copy for step s - D overwrites.
        cp_async_wait<D - 1>();
        __syncwarp();
        if (s - D >= 0) stage_h(s - D);
        cp_async_commit();
      } else {
        // The barrier also closes the reads of step s+1, whose buffer step
        // s-1 overwrites.
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          hb[(lrow0 + i) * H + j] = hp[d][i];
          load_h(s - D, d, i);
        }
        __syncwarp();
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        // The recompute: W_hh h_{t-1} + b_hh for unit j, columns in slot order.
        const HS* hrow = hb + (lrow0 + i) * H;
        float ar[2] = {br, 0.f}, az[2] = {bz, 0.f}, an[2] = {bn, 0.f};
#pragma unroll
        for (int a = 0; a < H / 4; ++a) {
          const float4 h4 = load4(hrow + 4 * (a ^ quad));
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ar[q & 1] = fmaf(wr[4 * a + q], hv[q], ar[q & 1]);
            az[q & 1] = fmaf(wz[4 * a + q], hv[q], az[q & 1]);
            an[q & 1] = fmaf(wn[4 * a + q], hv[q], an[q & 1]);
          }
        }
        const float h_prev = to_f32(hrow[j]);
        const float hn = an[0] + an[1];
        const float rg = sigmoid_f32(x_r[d][i] + (ar[0] + ar[1]));
        const float zg = sigmoid_f32(x_z[d][i] + (az[0] + az[1]));
        const float ng = tanhf(x_n[d][i] + rg * hn);
        const float dh = go[d][i] + dh_next[i];
        load_x(s - D, d, i);

        const float dn_hat = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float dr_hat = dn_hat * hn * rg * (1.0f - rg);
        const float dz_hat = dh * (h_prev - ng) * zg * (1.0f - zg);
        const float dhn_j = dn_hat * rg;
        if ((valid >> i) & 1u) {
          const int x = x0 + i * x_row + te * 6 * H, p = p0 + i * t_len + te;
          dxp[x] = from_f32<T>(dr_hat);
          dxp[x + H] = from_f32<T>(dz_hat);
          dxp[x + 2 * H] = from_f32<T>(dn_hat);
          dhp[p * G + j] = dr_hat;
          dhp[p * G + H + j] = dz_hat;
          dhp[p * G + 2 * H + j] = dhn_j;
          h_prev_out[p * H + j] = h_prev;
        }
        dh_next[i] = fmaf(dh, zg, wt_dhp<H>(wr, wz, wn, dr_hat, dz_hat, dhn_j, j));
      }
    }
  }
}

// Ops run by dispatch() on the kernel instantiation of (storage type, hidden, rpt).
struct Backward {
  const void* xp;
  const float *w_t, *b_hh;
  const void *out, *grad_out;
  void* dxp;
  float *dhp, *h_prev;
  int n, n_pad, t_len;
  cudaStream_t stream;

  template <typename T, int H, int RPT>
  int run() const {
    static_assert(smem_bytes<T, H, RPT>() <= 48 * 1024, "shared memory beyond the default 48 KB needs an opt-in");
    constexpr int rows = Shape<H, RPT>::kRows;
    const dim3 grid((n + rows - 1) / rows, 2);
    const dim3 block(H, kThreads / H);
    bigru_seq_backward_kernel<T, H, RPT><<<grid, block, smem_bytes<T, H, RPT>(), stream>>>(
        static_cast<const T*>(xp), w_t, b_hh, static_cast<const T*>(out), static_cast<const T*>(grad_out),
        static_cast<T*>(dxp), dhp, h_prev, n, n_pad, t_len);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Occupancy {
  int* blocks;

  template <typename T, int H, int RPT>
  int run() const {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, bigru_seq_backward_kernel<T, H, RPT>, kThreads, smem_bytes<T, H, RPT>()));
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

// Both return a cudaError_t as int: 0 on success.  xp, out, grad_out and dxp
// are float, or __nv_bfloat16 with bf16 = 1; w_t, b_hh, dhp and h_prev are
// float either way.
extern "C" int tpgsr_bigru_seq_backward(const void* xp, const float* w_t, const float* b_hh, const void* out,
                                        const void* grad_out, void* dxp, float* dhp, float* h_prev, int n,
                                        int n_pad, int t_len, int hidden, int rpt, int bf16, void* stream) {
  if (n <= 0 || t_len <= 0 || n_pad < n) return static_cast<int>(cudaErrorInvalidValue);
  const Backward op{xp, w_t, b_hh, out, grad_out, dxp, dhp, h_prev, n, n_pad, t_len,
                    static_cast<cudaStream_t>(stream)};
  return dispatch(op, bf16, hidden, rpt);
}

// Resident blocks an SM for the instantiation (storage, hidden, rpt), written to *blocks.
extern "C" int tpgsr_bigru_seq_backward_occupancy(int hidden, int rpt, int bf16, int* blocks) {
  const Occupancy op{blocks};
  return dispatch(op, bf16, hidden, rpt);
}
