// The spectral planner's whole horizon in one launch (sm_90a).
//
// Replaces the Pallas TPU kernel fused_spectral_horizon / _kernel of
// plasma_control_tpu/ops/pallas/spectral_horizon.py. For each of K candidate
// drive sequences it rolls the shared particle state (x0, v0) H steps through
// the gridless low-mode PIC model (staggered KDK with merged half-kicks,
// Chebyshev harmonic recurrence, per-mode Poisson solve) and writes the
// post-drift field energy of every step: pe (K, H).
//
// What bounds it on the H100: instruction issue along short dependent
// chains. A solve is K*H*N particle-steps; each runs the harmonic recurrence
// once (two chains of Km dependent FMAs), adds the 2*Km mode sums, evaluates
// the field and kicks, ~10*Km operations (19 GFLOP at the twin slice: K=1024,
// H=10, Km=16, N=10000; bound 0.279 ms at 67 TFLOP/s), against a few hundred
// KB of inputs. As compiled that is ~8 instructions per mode and
// particle-step, half of them adds, so the FMA rate the bound assumes is not
// reachable; per step each candidate also waits on three barriers and on
// reads of its cluster peers' shared memory. Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py, PERF.md §6): 0.068 ms per launch at the
// spectral slice (26 % of the bound's rate), 0.848 ms at the twin slice
// (33 %), 3.39 ms at config-4 (31 %), against 0.166, 1.647 and 8.37 ms for
// the previous one-CTA-per-candidate kernel. The design:
//  * one candidate per thread-block cluster of C CTAs (grid K*C, C a runtime
//    launch attribute chosen by ops/kernels/spectral_horizon.py::
//    launch_geometry). CTA r of the cluster owns particles [r*S, min((r+1)*S,
//    N)), S = ceil(N / C), and keeps their state in its own shared memory for
//    all H steps: the base-harmonic phasor (c1, s1) and the staggered velocity
//    vh (12 B per particle, "rot" drift), plus x (16 B, "trig"). C is the
//    smallest power of two whose slice fits 64 KiB, so that three CTAs fit an
//    SM, the rot kernel's register budget (80 registers): C=1 at the spectral
//    slice (N=5000, rot: 60 KB), C=2 at the twin slice (N=10000: 60 KB), C=4
//    at N=20000, C=16 at config-4 (N=100000: 75 KB rot, 100 KB trig), where
//    the old kernel kept the state in HBM. A sweep of C on the card found
//    these fastest: each further split adds a cluster barrier's wait per step
//    for a smaller share of the particles (the twin slice at C=1, 2, 4, 8:
//    1.20, 0.84, 0.98, 1.21 ms);
//  * mode sums: each thread accumulates its particles' 2*Km partial sums in
//    registers; a warp reduce-scatter (2*Km - 1 shuffles for all the values)
//    and one block barrier give the CTA's partial sums, written to slot
//    t mod 2 of its shared memory. After ONE cluster barrier, threads
//    j < 2*Km read that slot from all C CTAs through distributed shared
//    memory (mapa + ld.shared::cluster) and add them in rank order 0..C-1, so
//    every CTA of a cluster holds bitwise the same totals and field
//    coefficients, run after run (no atomics). The double-buffered slot is
//    what lets one cluster barrier per step suffice: slot t mod 2 is next
//    written in step t+2, after every CTA has passed step t+1's barrier, i.e.
//    after it read step t's slot. Warp 0 of rank 0 sums the energy, one mode
//    term per lane;
//  * the field sum_m pc_m cos(m k1 x) + ps_m sin(m k1 x) is evaluated by
//    Clenshaw's recurrence in 2 cos(k1 x) from (c1, s1): two chains of one
//    FMA per mode, the coefficients in registers for the step. The previous
//    kernel reran the harmonic recurrence there into one accumulator;
//  * the per-particle loops run a compile-time number of modes, 8 or 16, with
//    no per-mode guard: guarded updates compiled to predicated code with a
//    register move per update, twice the instructions. Modes Km..7 or Km..15
//    get zero coefficients, whose Clenshaw terms are exact zeros;
//  * Km > 16 (up to 64; spectral_horizon_blocks_kernel, horizon_blocks in
//    spectral_horizon.cuh) runs the same 16-mode body over ceil(Km / 16)
//    blocks of modes, so a thread still keeps 32 partial sums and the state
//    stays 12 or 16 B per particle: block b's sums come from one more pass
//    over the stored phasors per step (the harmonic recurrence rerun from
//    mode 1, adding modes 16b+1 .. 16b+16) and one more cluster reduction
//    (the slots alternate from reduction to reduction); the field pass runs
//    Clenshaw's recurrence through all blocks, their coefficients read from
//    shared memory. The Km <= 16 kernels are untouched by it;
//  * the inputs are read as the caller holds them: x0, v0 with a stride (the
//    plan model's particle subsample), the drive as (K, H, Ka) strided views
//    of the candidates, u_t + u_{t+1} and the zero modes Ka..Km formed here,
//    the step's drive and targets loaded before the particle pass. A call is
//    one launch and no other device op.
// A candidate's state that does not fit C=16 CTAs (N > 308048 rot, 231040
// trig; the million-particle controller's N=1M) lives in a global scratch of
// one row per CTA (template flag GLOBAL; horizon_stream in
// spectral_horizon.cuh), and there HBM traffic, not issue, set the time: the
// shared-memory schedule's drift pass, second sum pass (Km > 16) and field
// pass read or wrote it ~44 B per particle-step, one particle's loads in
// flight per thread, 9.85 ms per launch at the million chunk (K=16, H=10,
// Km=32; 8.5 % of the operations bound). The global path instead fuses step
// t's kick with step t+1's drift and mode sums into ONE pass per step: 12 B
// read and 12 B written per particle-step (none written in the last), all
// 2*Km sums of Km <= 32 in registers from one harmonic recurrence (64 at
// Km=32, two CTAs per SM), the state (c1, s1, vh) for rot, streamed through
// a cp.async ring in shared memory 8 particles per thread ahead, and (x, vh)
// for trig, loaded 4 particles per thread at a time, whose phasor the pass
// recomputes from x. The particle-to-thread map, the accumulation order,
// the reductions and each particle's arithmetic are the shared path's, so
// the energies are bitwise the same as there. The prologue's mode sums at
// the shared x0 are the same for every candidate and are still summed by
// every cluster (1 of H+1 passes, no state traffic): sharing them across
// the clusters of one launch needs either a second device op or a
// handshake between clusters that need not be resident together.
// Sixteen instantiations (drift x placement x energy x Km <= 16 or blocks),
// rot in this file and trig in spectral_horizon_trig.cu, compiled side by
// side; registers per instantiation and spills are on chip_smoke.py's
// [build] lines.
//
// Twin-corrected variant (template flag CORRECTED; the TPU kernel's
// `corrected` path, spectral_horizon.py:198-205, 289-292): with the (H, Km)
// noise-correction targets tc, ts of control/mpc.py::twin_targets, the energy
// of step t is sum_m ((c_m - tc[t,m])^2 + (s_m - ts[t,m])^2) / k_m^2 instead of
// sum_m (c_m^2 + s_m^2) / k_m^2. Only rank 0's energy sum changes: two
// subtractions per mode and step, and 2*H*Km floats read from global memory
// (L2-resident, the same for every candidate).
//
// Semantics follow the TPU kernel term by term: the prologue is an un-merged
// half kick with g_m and u_0; every step uses 2*g_m and pair_t = u_t + u_{t+1}
// (2 u_{H-1} in the last); PE comes from the post-drift, pre-kick mode sums.
// Constants arrive in fp32, rounded from the same float64 values as there.

#include "spectral_horizon.cuh"

int pct_spectral::launch_rot(const Buffers& b, const SpectralParams& p, cudaStream_t stream,
                             int* max_clusters) {
  return launch_placement<true>(b, p, stream, max_clusters);
}

extern "C" {

// x0, v0: (n,) at stride x_st; uc, us: the drive, element (k, t, m < ka)
// at k*u_sk + t*u_sh + m; pe: (k, h). tc, ts: (h, km) targets of the
// twin-corrected energy, both null for the plain energy. scratch: null keeps
// each CTA's slice of the state, (3 + !rot) * 4 * ceil(n / cluster) bytes, in
// shared memory; otherwise a (k * cluster, (2 + rot) * ceil(n / cluster))
// float buffer that holds it in global memory. km <= 64, cluster <= 16.
int pct_spectral_horizon(const float* x0, const float* v0, const float* uc, const float* us,
                         const float* tc, const float* ts, float* pe, float* scratch,
                         SpectralParams p, int rot, cudaStream_t stream) {
  if (!valid(p) || (!tc != !ts)) return static_cast<int>(cudaErrorInvalidValue);
  const Buffers b{x0, v0, uc, us, tc, ts, pe, scratch};
  return rot ? pct_spectral::launch_rot(b, p, stream, nullptr)
             : pct_spectral::launch_trig(b, p, stream, nullptr);
}

// How many clusters of the launch that pct_spectral_horizon would make with
// these arguments can be resident on the card at once (cudaOccupancyMax-
// ActiveClusters); 0 means none fits. Returns a CUDA error code.
int pct_spectral_max_clusters(SpectralParams p, int rot, int global, int corrected,
                              int* max_clusters) {
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  static const float dummy = 0.0f;
  const float* twin = corrected ? &dummy : nullptr;
  const Buffers b{nullptr, nullptr, nullptr, nullptr, twin, twin, nullptr,
                  global ? const_cast<float*>(&dummy) : nullptr};
  return rot ? pct_spectral::launch_rot(b, p, nullptr, max_clusters)
             : pct_spectral::launch_trig(b, p, nullptr, max_clusters);
}

}  // extern "C"
