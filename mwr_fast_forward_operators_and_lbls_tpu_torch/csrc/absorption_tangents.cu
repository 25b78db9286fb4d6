// K4: total clear/cloudy-sky absorption alpha [Np/km] at up to 32 channels
// with its elementwise partials dalpha/dT and dalpha/drho, each (F, N), for
// the N points of flattened (level x profile) arrays; and, when asked for,
// dalpha/dLWC (F, N), the liquid term at unit content.
//
// Replaces the TPU kernel
//   mwr_fast_forward_operators_and_lbls_tpu/ops/pallas/absorption_kernel.py
//   ::total_absorption_fused_tangents (the body _build_kernel on dual
//   numbers `_D`), reached on the K-matrix path.
// The function is that of ops/absorption/{h2o,o2,n2,liquid}.py, including
// the 1998 dry continuum for R98 and R03 and the clamp of the O2 term at
// zero; there is no O3 term, as on the TPU.  K1 (absorption.cu) computes the
// value alone with the same algebra; ops/cuda/_mirrors.py
// ::absorption_tangents_grouped follows this body in plain torch.
//
// What bounds it on Hopper: arithmetic.  A point reads 16 bytes and writes
// 12 F (16 F with dalpha/dLWC); at 14 channels it evaluates 14 x (15 H2O +
// 49 O2) line shapes and the state of those 64 lines, each quantity with
// its value and two tangents: some 10,600 instructions of the fp32 pipe and
// 500 reciprocals a point and group of 7 channels (parallel/profiling.py,
// `_K4_CODED`).
//
// What the design does about it:
//  * Channel groups on the grid's y axis.  A thread owns one point and one
//    group of at most kGroupMax channels (14 channels: two groups of 7, the
//    K and the V band; the MP-3000A's 22: three of 8 slots, the last with
//    two of padding), so every thread of a block evaluates the same
//    channels and the Clough-cutoff tests stay uniform.  Each group forms
//    its own line state: that repeats the state (81 of the 186 fp32
//    instructions of an O2 line at 7 channels) and doubles the warps, which
//    a body of 80 registers needs to hide its chains of reciprocals and
//    exponentials.
//  * The tangents by hand, not by a generic dual type: what hangs on T
//    alone (300 / T, its powers, the line strengths, the liquid term)
//    carries one tangent, and what is linear in a width carries the width's
//    tangents by one derivative.  A line shape w / (d^2 + w^2) of constant
//    d has the derivative r - 2 L^2 in w (r the reciprocal, L the shape).
//  * One rational per line.  An O2 line's two halves are
//    (k2 + q k3) / (q^2 + k1) in q = d1 (d1 + c) + w^2, as in K1 and K6, and
//    the tangents of q do not depend on the channel (dq = dw^2 - c dnu), so
//    a channel pays 16 instructions and one reciprocal for the value and
//    both tangents.  An H2O line whose halves lie inside the cutoff for the
//    whole group is w (c^2 + 2 q) / (q^2 + w^2 c^2) with its derivative in w
//    from the same reciprocal.  Two O2 lines per reciprocal, as K1 takes
//    them, would cost 11 instructions more for each reciprocal saved, and
//    the fp32 pipe is the one that binds, so each line goes alone.
//  * K1's per-point arithmetic: every power of ti = 300 / T is
//    exp2f(x log2 ti) from one log2f a point, its tangent x ti^x (-1 / T)
//    with -1 / T = -ti / 300, so no powf and no divide per power; the line
//    loops divide by the special-function unit's approximate reciprocal
//    (`rcp_approx`), the state and the per-channel tail keep IEEE
//    arithmetic.
//  * One sum per channel.  The strengths carry 1 / f_line^2 (and the H2O
//    density scale), and everything else that a channel adds is taken over
//    f^2 too, so the O2 lines, then the clamped O2 term, N2, the liquid term
//    and the water continuum, then the H2O lines go into one dual sum per
//    channel (21 registers at 7 channels), multiplied by f^2 once at the end.
//  * What depends on the table or the channels alone is formed once per
//    block in shared memory: each line as a record of 12 floats (three
//    16-byte loads) with s / f_line^2, w300^2, 2 f0, c^2 and the flags that
//    pick a line's form for the block's group; 1 / f^2 and the dry
//    continuum's factor per channel.
//  * The channels are a kernel argument by value (`Channels`), one slot per
//    (group, channel), the last channel repeated into the slots past F.
//  * dalpha/dLWC is the liquid term's -0.06286 f Im[(eps - 1) / (eps + 2)],
//    which the channel loop forms anyway (it hangs on T alone): stored
//    there, not divided out of the LWC-weighted term, so a dry point still
//    gets its derivative.  Without the output the pointer is null and the
//    test a uniform branch.
//  * kThreads a block, at least kBlocksPerSm resident: 720 blocks at the
//    K-matrix shape (256 x 180 points, two groups) fit one wave of
//    kBlocksPerSm x 132 slots, so no SM waits on a tail.
//
// The packed line table's layout is in absorption.cuh.

#include "absorption.cuh"

namespace {

constexpr int kThreads = 128;      // points per block
constexpr int kBlocksPerSm = 6;    // resident blocks per SM aimed for
constexpr int kGroupMax = 8;       // channels a thread evaluates at most
constexpr int kHeaderFloats = 16;  // N_HEADER in ops/cuda/absorption.py
constexpr int kRecord = 12;        // floats of a line's record

// The channel frequencies [GHz] by (group, channel) slot, passed by value.
struct Channels {
  float f[kMaxChannels];
};

// Groups of the nf channels and channels a group: groups of at most
// kGroupMax, as even as they come (ops/cuda/absorption.py::tangent_groups).
__host__ __device__ inline int n_groups(int nf) {
  return (nf + kGroupMax - 1) / kGroupMax;
}
__host__ __device__ inline int group_size(int nf) {
  const int g = n_groups(nf);
  return (nf + g - 1) / g;
}

// Floats of shared memory: the header, the Gauss-Laguerre nodes and
// weights, a record per line, 1 / f^2 and the dry continuum's factor per
// channel of the group.
__host__ __device__ inline int smem_floats(int n_h2o, int n_o2) {
  return kHeaderFloats + 2 * kGlNodes + kRecord * (n_h2o + n_o2)
         + 2 * kGroupMax;
}

// A value and its partials in T and rho.
struct Dual {
  float v, t, r;
};

__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, fmaf(a.t, b.v, a.v * b.t), fmaf(a.r, b.v, a.v * b.r)};
}
__device__ __forceinline__ Dual operator*(float k, Dual a) {
  return {k * a.v, k * a.t, k * a.r};
}
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.t + b.t, a.r + b.r};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.t - b.t, a.r - b.r};
}

// A value and its partial in T: what hangs on the temperature alone.
struct TDual {
  float v, t;
};

// ti^x from l2 = log2(ti) (K1's `pow_ti`) and its partial in T,
// x ti^x dln(ti)/dT with m_t = dln(ti)/dT = -1 / T.
__device__ __forceinline__ TDual pow_ti(float l2, float m_t, float x) {
  const float v = exp2f(x * l2);
  return {v, v * (x * m_t)};
}

// sn (res, res_w w.t, res_w w.r) into acc: a line's strength times its
// shape res, whose derivative in the width w is res_w; aw = sn.v w.
__device__ __forceinline__ void add_line(Dual& acc, Dual sn, float aw_t,
                                         float aw_r, float res, float res_w) {
  acc.v = fmaf(sn.v, res, acc.v);
  acc.t = fmaf(sn.t, res, fmaf(aw_t, res_w, acc.t));
  acc.r = fmaf(sn.r, res, fmaf(aw_r, res_w, acc.r));
}

template <int G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
absorption_tangents_kernel(const float* __restrict__ p,
                           const float* __restrict__ t,
                           const float* __restrict__ rho,
                           const float* __restrict__ lwc, const Channels ch,
                           int nf, const float* __restrict__ tables,
                           Layout lay, int n, float* __restrict__ out,
                           float* __restrict__ out_dt,
                           float* __restrict__ out_dr,
                           float* __restrict__ out_dl) {
  extern __shared__ float4 smem4[];
  float* const hdr = reinterpret_cast<float*>(smem4);
  const float* const gl_x = hdr + kHeaderFloats;
  const float* const gl_w = gl_x + kGlNodes;
  const int nh = lay.n_h2o, no = lay.n_o2;
  const float4* const h2o_rec = smem4 + (kHeaderFloats + 2 * kGlNodes) / 4;
  const float4* const o2_rec = h2o_rec + 3 * nh;
  float* const inv_f2 = hdr + kHeaderFloats + 2 * kGlNodes
                        + kRecord * (nh + no);
  float* const fdep = inv_f2 + kGroupMax;
  const int s0 = blockIdx.y * G;      // the group's first slot

  // ---- per block: the header, the nodes, a record per line, per channel --
  for (int j = threadIdx.x; j < kHeaderFloats; j += blockDim.x)
    hdr[j] = tables[j];
  for (int j = threadIdx.x; j < 2 * kGlNodes; j += blockDim.x)
    hdr[kHeaderFloats + j] = tables[lay.gl + j];
  {
    // the channels' span decides the cutoff tests of a line for the whole
    // group: |f -+ fl| is convex in f
    float f_lo = ch.f[s0], f_hi = ch.f[s0];
#pragma unroll
    for (int c = 1; c < G; ++c) {
      f_lo = fminf(f_lo, ch.f[s0 + c]);
      f_hi = fmaxf(f_hi, ch.f[s0 + c]);
    }
    const float cut = tables[kCutoff];
    for (int l = threadIdx.x; l < nh + no; l += blockDim.x) {
      float* rec = hdr + kHeaderFloats + 2 * kGlNodes + kRecord * l;
      if (l < nh) {
        // fl, s1 / fl^2, b2, w3 | x, ws, xs, w2 | ws2, c^2, merged, qSD
        const float* col = tables + lay.h2o + l;
        const float fl = col[0], w2 = col[7 * nh], ws2 = col[8 * nh];
        const bool sd = (w2 != 0.0f) || (ws2 != 0.0f);
        const bool both = fabsf(f_lo - fl) < cut && fabsf(f_hi - fl) < cut
                          && fabsf(f_lo + fl) < cut && fabsf(f_hi + fl) < cut;
        rec[0] = fl;
        rec[1] = col[1 * nh] / (fl * fl);
        rec[2] = col[2 * nh];
        rec[3] = col[3 * nh];
        rec[4] = col[4 * nh];
        rec[5] = col[5 * nh];
        rec[6] = col[6 * nh];
        rec[7] = w2;
        rec[8] = ws2;
        rec[9] = 4.0f * fl * fl;
        rec[10] = (both && !sd) ? 1.0f : 0.0f;
        rec[11] = sd ? 1.0f : 0.0f;
      } else {
        // f0, s300 / f0^2, be, w300 | y0, y1, g0, g1 | dnu0, dnu1, w300^2,
        // 2 f0
        const float* col = tables + lay.o2 + (l - nh);
        const float f0 = col[0], w300 = col[3 * no];
        rec[0] = f0;
        rec[1] = col[1 * no] / (f0 * f0);
        rec[2] = col[2 * no];
        rec[3] = w300;
        rec[4] = col[4 * no];
        rec[5] = col[5 * no];
        rec[6] = col[6 * no];
        rec[7] = col[7 * no];
        rec[8] = col[8 * no];
        rec[9] = col[9 * no];
        rec[10] = w300 * w300;
        rec[11] = 2.0f * f0;
      }
    }
  }
  if (threadIdx.x < G) {
    const float fc = ch.f[s0 + threadIdx.x];
    const float r = fc / 450.0f;
    inv_f2[threadIdx.x] = 1.0f / (fc * fc);
    fdep[threadIdx.x] =
        tables[kN2Fdep] != 0.0f ? 0.5f + 0.5f / (1.0f + r * r) : 1.0f;
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float f[G];
#pragma unroll
  for (int c = 0; c < G; ++c) f[c] = ch.f[s0 + c];

  // ---- the point ----------------------------------------------------------
  const float pp = p[i], tt = t[i], rr = rho[i];
  const float ti = 300.0f / tt;
  const float m_t = ti * (-1.0f / 300.0f);   // dln(ti)/dT = -1 / T
  const float ti_t = ti * m_t;               // dti/dT
  const float th1 = ti - 1.0f;
  const float l2 = log2f(ti);
  const Dual pvap{rr * tt / 217.0f, rr * (1.0f / 217.0f),
                  tt * (1.0f / 217.0f)};     // vapor partial pressure [hPa]
  const Dual pda{pp - pvap.v, -pvap.t, -pvap.r};  // dry air [hPa]

  // acc: per channel, everything over f^2
  Dual acc[G];
#pragma unroll
  for (int c = 0; c < G; ++c) acc[c] = Dual{0.0f, 0.0f, 0.0f};

  // ---- O2 lines with first- or second-order mixing ------------------------
  const TDual b = pow_ti(l2, m_t, hdr[kO2X]);
  const float hf = hdr[kH2oFactor];
  const Dual den{
      0.001f * (pda.v * b.v + hf * pvap.v * ti),
      0.001f * (fmaf(pda.t, b.v, pda.v * b.t)
                + hf * fmaf(pvap.t, ti, pvap.v * ti_t)),
      0.001f * fmaf(pda.r, b.v, hf * pvap.r * ti)};
  const Dual pe2{den.v * den.v, 2.0f * den.v * den.t, 2.0f * den.v * den.r};
  const Dual ybase = hdr[kMixingBasisP] != 0.0f
                         ? Dual{0.001f * pp * b.v, 0.001f * pp * b.t, 0.0f}
                         : den;
  for (int l = 0; l < no; ++l) {
    const float4 ra = o2_rec[3 * l], rb = o2_rec[3 * l + 1],
                 rc = o2_rec[3 * l + 2];
    const float f0 = ra.x, sf = ra.y, be = ra.z, w300 = ra.w;
    const Dual df = w300 * den;
    const Dual dfsq = rc.z * pe2;
    const float sv = sf * expf(-be * th1);
    const float st = sv * (-be * ti_t);
    const float yy = fmaf(rb.y, th1, rb.x), yy_t = rb.y * ti_t;
    const Dual y{ybase.v * yy, fmaf(ybase.t, yy, ybase.v * yy_t),
                 ybase.r * yy};
    // First-order tables carry g = dnu = 0, which makes these exactly 1 and 0.
    const float gg = fmaf(rb.w, th1, rb.z), gg_t = rb.w * ti_t;
    const Dual gfac{fmaf(pe2.v, gg, 1.0f), fmaf(pe2.t, gg, pe2.v * gg_t),
                    pe2.r * gg};
    const Dual dfg = df * gfac;
    const float nn = fmaf(rc.y, th1, rc.x), nn_t = rc.y * ti_t;
    const Dual dnu{pe2.v * nn, fmaf(pe2.t, nn, pe2.v * nn_t), pe2.r * nn};
    const Dual c2{fmaf(2.0f, dnu.v, rc.w), 2.0f * dnu.t, 2.0f * dnu.r};
    // the merged numerator k2 + q k3 and denominator q^2 + k1 (K1's algebra)
    const Dual dfg_s{sv * dfg.v, fmaf(st, dfg.v, sv * dfg.t), sv * dfg.r};
    const Dual sy{sv * y.v, fmaf(st, y.v, sv * y.t), sv * y.r};
    const Dual yc = sy * c2;
    const Dual c2sq{c2.v * c2.v, 2.0f * c2.v * c2.t, 2.0f * c2.v * c2.r};
    const Dual k1 = dfsq * c2sq;
    const Dual k2 = dfg_s * c2sq - 2.0f * (dfsq * yc);
    const Dual k3 = 2.0f * dfg_s + yc;
    // dq = dfsq' - c dnu' for every channel
    const float q_t = fmaf(-c2.v, dnu.t, dfsq.t);
    const float q_r = fmaf(-c2.v, dnu.r, dfsq.r);
    const float n_t = fmaf(q_t, k3.v, k2.t), n_r = fmaf(q_r, k3.v, k2.r);
    const float q2_t = 2.0f * q_t, q2_r = 2.0f * q_r;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      // from the difference d1, never expanded in f
      const float d1 = (f[c] - f0) - dnu.v;
      const float q = fmaf(d1, d1 + c2.v, dfsq.v);
      const float nv = fmaf(q, k3.v, k2.v);
      const float dv = fmaf(q, q, k1.v);
      const float r = rcp_approx(dv);
      const float s = nv * r;
      acc[c].v += s;
      acc[c].t = fmaf(fmaf(-s, fmaf(q, q2_t, k1.t), fmaf(q, k3.t, n_t)), r,
                      acc[c].t);
      acc[c].r = fmaf(fmaf(-s, fmaf(q, q2_r, k1.r), fmaf(q, k3.r, n_r)), r,
                      acc[c].r);
    }
  }

  // ---- the O2 term, N2, cloud liquid, the water continuum (IEEE) ---------
  {
    const Dual dfnr = hdr[kWb300] * den;
    const float ti_inv = tt / 300.0f;        // 1 / ti
    const float knr_c = hdr[kNonres];
    const Dual k_nr{knr_c * dfnr.v * ti_inv,
                    knr_c * fmaf(dfnr.t, ti_inv, dfnr.v * (1.0f / 300.0f)),
                    knr_c * dfnr.r * ti_inv};
    const Dual dfnr2{dfnr.v * dfnr.v, 2.0f * dfnr.v * dfnr.t,
                     2.0f * dfnr.v * dfnr.r};
    const float ti3 = ti * ti * ti, ti3_t = 3.0f * ti * ti * ti_t;
    const float o2c = hdr[kO2Scale];
    const Dual o2s{o2c * pda.v * ti3, o2c * fmaf(pda.t, ti3, pda.v * ti3_t),
                   o2c * pda.r * ti3};
    const TDual n2t = pow_ti(l2, m_t, hdr[kN2Exp]);
    const float n2c = hdr[kN2Coef];
    const Dual pda2{pda.v * pda.v, 2.0f * pda.v * pda.t,
                    2.0f * pda.v * pda.r};
    const Dual n2k{n2c * pda2.v * n2t.v,
                   n2c * fmaf(pda2.t, n2t.v, pda2.v * n2t.t),
                   n2c * pda2.r * n2t.v};
    const TDual tcf = pow_ti(l2, m_t, hdr[kXcf]);
    const TDual tcs = pow_ti(l2, m_t, hdr[kXcs]);
    const float cf = hdr[kCf], cs = hdr[kCs];
    const Dual con_a{fmaf(cf * tcf.v, pda.v, cs * tcs.v * pvap.v),
                     fmaf(cf * tcf.t, pda.v, cf * tcf.v * pda.t)
                         + fmaf(cs * tcs.t, pvap.v, cs * tcs.v * pvap.t),
                     fmaf(cf * tcf.v, pda.r, cs * tcs.v * pvap.r)};
    const Dual con_b = con_a * pvap;
    // the liquid term hangs on T alone (and linearly on the LWC)
    const float theta1 = 1.0f - ti, theta1_t = -ti_t;
    const float eps0 = 77.66f - 103.3f * theta1;
    const float eps0_t = -103.3f * theta1_t;
    const float eps1 = 0.0671f * eps0, eps1_t = 0.0671f * eps0_t;
    const float inv_fp = 1.0f / (20.1f * expf(7.88f * theta1));
    const float inv_fp_t = -inv_fp * (7.88f * theta1_t);
    const float e01 = eps0 - eps1, e01_t = eps0_t - eps1_t;
    const float e12 = eps1 - 3.52f, e12_t = eps1_t;
    const float wk = -0.06286f * lwc[i];
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const float fc = f[c], f2 = fc * fc;
      // the clamped O2 term over f^2: o2s (lines + k_nr / (f^2 + dfnr^2))
      const float rn = 1.0f / (f2 + dfnr2.v);
      const float nr = k_nr.v * rn;
      const Dual inner{acc[c].v + nr,
                       acc[c].t + fmaf(-nr, dfnr2.t, k_nr.t) * rn,
                       acc[c].r + fmaf(-nr, dfnr2.r, k_nr.r) * rn};
      Dual sum = o2s * inner;
      if (!(sum.v > 0.0f)) sum = Dual{0.0f, 0.0f, 0.0f};
      // N2 over f^2
      sum = sum + fdep[c] * n2k;
      // the liquid term over f^2, from two reciprocals
      const float u = fc * inv_fp, u_t = fc * inv_fp_t;
      const float v = u * (1.0f / 39.8f), v_t = u_t * (1.0f / 39.8f);
      const float ru = 1.0f / fmaf(u, u, 1.0f);
      const float rv = 1.0f / fmaf(v, v, 1.0f);
      const float ru_t = -2.0f * u * u_t * ru * ru;
      const float rv_t = -2.0f * v * v_t * rv * rv;
      const float re = 3.52f + e01 * ru + e12 * rv;
      const float re_t = e01_t * ru + e01 * ru_t + e12_t * rv + e12 * rv_t;
      const float uru = u * ru, vrv = v * rv;
      const float im = -(e01 * uru + e12 * vrv);
      const float im_t = -(e01_t * uru + e01 * fmaf(u_t, ru, u * ru_t)
                           + e12_t * vrv + e12 * fmaf(v_t, rv, v * rv_t));
      const float re2 = re + 2.0f;
      const float dd = re2 * re2 + im * im;
      const float aimag = 3.0f * im / dd;
      const float aimag_t = (3.0f * im_t - aimag * 2.0f * (re2 * re_t
                                                          + im * im_t)) / dd;
      const float lk = wk * fc * inv_f2[c];
      if (out_dl != nullptr && s0 + c < nf)
        out_dl[static_cast<size_t>(s0 + c) * n + i] = -0.06286f * fc * aimag;
      acc[c] = Dual{sum.v + fmaf(lk, aimag, con_b.v),
                    sum.t + fmaf(lk, aimag_t, con_b.t), sum.r + con_b.r};
    }
  }

  // ---- H2O lines: VVW with the Clough cutoff, qSD near half where set ----
  const float cut = hdr[kCutoff];
  const float cut2 = cut * cut;
  const float h_v = 0.3183e-4f * (3.344e16f * rr);   // the density scale
  const float h_r = 0.3183e-4f * 3.344e16f;
  const TDual ti25 = pow_ti(l2, m_t, 2.5f);
  Dual two_base{0.0f, 0.0f, 0.0f};   // 2 sn base over the lines merged below
  for (int l = 0; l < nh; ++l) {
    const float4 ra = h2o_rec[3 * l], rb = h2o_rec[3 * l + 1],
                 rc = h2o_rec[3 * l + 2];
    const float fl = ra.x;
    const TDual tix = pow_ti(l2, m_t, rb.x);
    const TDual tixs = pow_ti(l2, m_t, rb.z);
    const float a = ra.w * tix.v, a_t = ra.w * tix.t;
    const float bw = rb.y * tixs.v, bw_t = rb.y * tixs.t;
    const Dual w{fmaf(a, pda.v, bw * pvap.v),
                 fmaf(a_t, pda.v, a * pda.t) + fmaf(bw_t, pvap.v, bw * pvap.t),
                 fmaf(a, pda.r, bw * pvap.r)};
    const float wsq = w.v * w.v;
    // the strength over fl^2 with the density scale
    const float s = ra.y * ti25.v * expf(ra.z * (1.0f - ti));
    const float s_t = s * m_t * fmaf(-ra.z, ti, 2.5f);
    const Dual sn{s * h_v, s_t * h_v, s * h_r};
    const float rcut = 1.0f / (cut2 + wsq);
    const float bv = w.v * rcut;                // Clough's base
    const float bv_w = fmaf(-2.0f * bv, bv, rcut);
    const float aw_t = sn.v * w.t, aw_r = sn.v * w.r;
    if (rc.z != 0.0f) {
      // both halves as w (c^2 + 2 q) / (q^2 + w^2 c^2) with c = 2 fl; its
      // derivative in w is (c^2 + 2 q + 4 w^2 - S 2 w (c^2 + 2 q)) / D
      const float csq = rc.y, k1 = wsq * csq, w4 = 4.0f * wsq;
      const float tw = 2.0f * w.v;
      add_line(two_base, sn, aw_t, aw_r, 2.0f * bv, 2.0f * bv_w);
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const float q = fmaf(f[c] - fl, f[c] + fl, wsq);
        const float e = fmaf(2.0f, q, csq);
        const float r = rcp_approx(fmaf(q, q, k1));
        const float sh = (w.v * e) * r;
        const float sh_w = fmaf(-sh, tw * e, e + w4) * r;
        add_line(acc[c], sn, aw_t, aw_r, sh, sh_w);
      }
      continue;
    }
    // the halves apart, each under its own cutoff test
    const bool sd = rc.w != 0.0f;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const float d1 = f[c] - fl, d2 = f[c] + fl;
      float res = 0.0f, res_w = 0.0f;
      if (fabsf(d2) < cut) {
        const float r = rcp_approx(fmaf(d2, d2, wsq));
        const float sh = w.v * r;
        res = sh - bv;
        res_w = fmaf(-2.0f * sh, sh, r) - bv_w;
      }
      if (!sd && fabsf(d1) < cut) {
        const float r = rcp_approx(fmaf(d1, d1, wsq));
        const float sh = w.v * r;
        res += sh - bv;
        res_w += fmaf(-2.0f * sh, sh, r) - bv_w;
      }
      add_line(acc[c], sn, aw_t, aw_r, res, res_w);
    }
    if (sd) {
      // the near half of a qSD line: sum_k g_k cr / (cr^2 + d1^2) with
      // cr = c0 + gamma2 x_k; its tangents P dc0 + Q dgamma2 from
      // P = sum_k g_k T'_k and Q = sum_k g_k x_k T'_k
      const float a2 = rb.w * tix.v, a2_t = rb.w * tix.t;
      const float b2 = rc.x * tixs.v, b2_t = rc.x * tixs.t;
      const Dual g2{fmaf(a2, pda.v, b2 * pvap.v),
                    fmaf(a2_t, pda.v, a2 * pda.t)
                        + fmaf(b2_t, pvap.v, b2 * pvap.t),
                    fmaf(a2, pda.r, b2 * pvap.r)};
      const Dual c0 = w - 1.5f * g2;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const float d1 = f[c] - fl;
        if (!(fabsf(d1) < cut)) continue;
        const float ci2 = d1 * d1;
        float vs = 0.0f, ps = 0.0f, qs = 0.0f;
        for (int k = 0; k < kGlNodes; ++k) {
          const float xk = gl_x[k], wk = gl_w[k];
          const float cr = fmaf(g2.v, xk, c0.v);
          const float r = rcp_approx(fmaf(cr, cr, ci2));
          const float sh = cr * r;
          const float wd = wk * fmaf(-2.0f * sh, sh, r);
          vs = fmaf(wk, sh, vs);
          ps += wd;
          qs = fmaf(wd, xk, qs);
        }
        const float res = vs - bv;
        const float res_t = fmaf(ps, c0.t, fmaf(qs, g2.t, -bv_w * w.t));
        const float res_r = fmaf(ps, c0.r, fmaf(qs, g2.r, -bv_w * w.r));
        acc[c].v = fmaf(sn.v, res, acc[c].v);
        acc[c].t = fmaf(sn.t, res, fmaf(sn.v, res_t, acc[c].t));
        acc[c].r = fmaf(sn.r, res, fmaf(sn.v, res_r, acc[c].r));
      }
    }
  }

  // ---- alpha = f^2 (the sum - the merged lines' bases) --------------------
#pragma unroll
  for (int c = 0; c < G; ++c) {
    if (s0 + c >= nf) break;
    const float f2 = f[c] * f[c];
    const size_t j = static_cast<size_t>(s0 + c) * n + i;
    out[j] = f2 * (acc[c].v - two_base.v);
    out_dt[j] = f2 * (acc[c].t - two_base.t);
    out_dr[j] = f2 * (acc[c].r - two_base.r);
  }
}

using TangentsKernel = void (*)(const float*, const float*, const float*,
                                const float*, Channels, int, const float*,
                                Layout, int, float*, float*, float*, float*);

// The instantiation for nf channels (groups of group_size(nf)), or null.
TangentsKernel tangents_kernel(int nf) {
  if (nf < 1 || nf > kMaxChannels) return nullptr;
  switch (group_size(nf)) {
#define MWR_CASE(G_) \
  case G_:           \
    return absorption_tangents_kernel<G_>;
    MWR_CASE(1) MWR_CASE(2) MWR_CASE(3) MWR_CASE(4) MWR_CASE(5) MWR_CASE(6)
    MWR_CASE(7) MWR_CASE(8)
#undef MWR_CASE
  }
  return nullptr;
}

}  // namespace

// alpha, dalpha/dT and dalpha/drho, each (F, N), for the N points of p, t,
// rho, lwc, all float32 on the device, at the nf <= 32 channels of `freqs`,
// an array on the HOST; the table carries no O3 lines.  out_dl, when not
// null, takes dalpha/dLWC (F, N).  Returns the CUDA error of the launch (0
// when it was accepted).
extern "C" int mwr_absorption_tangents_lb(
    const float* p, const float* t, const float* rho, const float* lwc,
    const float* freqs, int nf, const float* tables, int n_h2o, int n_o2,
    int h2o_off, int o2_off, int gl_off, int n, float* out, float* out_dt,
    float* out_dr, float* out_dl, void* stream) {
  const TangentsKernel kernel = tangents_kernel(nf);
  if (kernel == nullptr || n < 1) return cudaErrorInvalidValue;
  const Layout lay{n_h2o, n_o2, 0, h2o_off, o2_off, gl_off, gl_off};
  const int g = n_groups(nf), per = group_size(nf);
  Channels ch{};
  for (int s = 0; s < g * per; ++s) ch.f[s] = freqs[s < nf ? s : nf - 1];
  const size_t smem = sizeof(float) * smem_floats(n_h2o, n_o2);
  const dim3 grid((n + kThreads - 1) / kThreads, g);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, t, rho, lwc, ch, nf, tables, lay, n, out, out_dt, out_dr, out_dl);
  return static_cast<int>(cudaGetLastError());
}

// Warps of K4 resident per SM at nf channels for a table of n_h2o and n_o2
// lines (what the occupancy calculator says for its registers and shared
// memory), or minus the CUDA error.
extern "C" int mwr_absorption_tangents_resident_warps(int nf, int n_h2o,
                                                      int n_o2) {
  const TangentsKernel kernel = tangents_kernel(nf);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kThreads, sizeof(float) * smem_floats(n_h2o, n_o2));
  return err == cudaSuccess ? blocks * (kThreads / 32)
                            : -static_cast<int>(err);
}
