"""Plain PyTorch reference of one closed-loop MPC control step.

The benchmark judges the program's control step against this file. It is
written from the model's equations and the configuration's fields alone and
imports nothing of the program: every operator (the circulant field solve,
the Fourier actuator basis, the feedback law's Fourier coefficients) is
rebuilt here from the sizes in the configuration and traffic files.

One control step, as the program's ``control_step_fn`` defines it:

1. the plan model: the full state, or its strided particle subsample on a
   coarser plan mesh (``plan_particles`` / ``plan_mesh``);
2. the twin noise-correction targets (``plan_correction="twin"`` with a
   subsample): Wiener shrinkage of each mode's phasor times the zero-drive
   spectral rollout of the plan state;
3. K candidate drive sequences: the nominal plus ``sigma0`` times
   knot-interpolated antithetic unit draws, candidate 0 the nominal itself,
   candidate 1 the phase-conjugate feedback law held over the horizon,
   clamped to the coefficient bounds;
4. their horizon costs: the gridless spectral model (staggered kick-drift-kick
   with merged half-kicks, the carried phasor rotated by the "rot" drift's
   polynomials, or wrapped positions for "trig") or the grid model
   (merged-kick KDK with cloud-in-cell deposit and gather on the plan mesh);
5. the MPPI update (softmax of the costs at ``temperature``), then the
   fidelity guard, which zeroes the action and the nominal when the full
   state's coherent modal energy is below ``fidelity_guard_ratio`` times the
   subsample's injected noise;
6. the first action applied through one Yoshida-4 PIC step (three deposit,
   solve, gather rounds on the full mesh), the energies after it and the
   action's input energy.

``Precision`` sets how it computes: float64 for the reference, and for the
control the nearest precision below the configuration's float32: every
elementwise result rounded to bfloat16, every matrix product in TF32.
Candidates are scored in blocks so that the reference fits beside nothing
else on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

HUGE = 3.4e38  # the cost of a candidate whose cost is not finite
BLOCK_ELEMENTS = 1 << 23  # candidate x particle elements per scored block


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False  # matrix products in TF32 (the control)


REFERENCE = Precision()
CONTROL = Precision(torch.bfloat16, tf32=True)


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def yoshida4():
    """Yoshida's fourth-order drift (c) and kick (d) coefficients."""
    cbrt2 = 2.0 ** (1.0 / 3.0)
    w0, w1 = -cbrt2 / (2.0 - cbrt2), 1.0 / (2.0 - cbrt2)
    return (0.5 * w1, 0.5 * (w0 + w1), 0.5 * (w0 + w1), 0.5 * w1), (w1, w0, w1)


def clamped_dt(dt: float, n_particles: int, length: float) -> float:
    """The step the program takes: dt, at most the CFL-like 2 / sqrt(N / L)."""
    return min(dt, 2.0 / math.sqrt(n_particles / length))


def field_operator(n_mesh: int, length: float) -> np.ndarray:
    """(M, M) real matrix taking n - n0 to E on the periodic mesh: the
    3-point Laplacian inverted (mean mode pinned to zero), then the central
    difference, E = -d/dx phi with phi'' = -(n - n0) ... as circulants."""
    dx = length / n_mesh
    j = np.arange(n_mesh)
    theta = 2.0 * np.pi * j / n_mesh
    lap = (2.0 * np.cos(theta) - 2.0) / dx**2
    inv = np.zeros(n_mesh)
    inv[1:] = 1.0 / lap[1:]
    eig = -(1j * np.sin(theta) / dx) * inv
    col = np.fft.ifft(eig).real
    return col[(j[:, None] - j[None, :]) % n_mesh]


class Model:
    """One mesh (and the actuator on it) at one precision."""

    def __init__(self, n_mesh: int, length: float, n0: float, max_mode: int,
                 endpoint_grid: bool, prec: Precision, device):
        self.m, self.length, self.n0, self.ka = n_mesh, length, n0, max_mode
        self.dx = length / n_mesh
        self.prec, self.device = prec, device
        as_t = lambda a: torch.tensor(a, dtype=prec.dtype, device=device)  # noqa: E731
        self.e_op_t = as_t(field_operator(n_mesh, length).T.copy())
        xm = np.linspace(0.0, length, n_mesh) if endpoint_grid else self.dx * np.arange(n_mesh)
        k = 2.0 * np.pi / length * np.arange(1, max_mode + 1)
        self.basis = as_t(np.concatenate([np.cos(np.outer(xm, k)), np.sin(np.outer(xm, k))], 1).T)
        # the feedback law's spectrum fft(E) / M * 2 at modes 1..Ka as a product
        ph = 2.0 * np.pi * np.outer(np.arange(n_mesh), np.arange(1, max_mode + 1)) / n_mesh
        self.dft = as_t(np.concatenate([np.cos(ph), -np.sin(ph)], 1) * (2.0 / n_mesh))

    def mm(self, a, b):
        """a @ b at the model's precision (TF32 for the control)."""
        if not self.prec.tf32:
            return a @ b
        with _tf32(True):
            return (a.float() @ b.float()).to(self.prec.dtype)

    def _cells(self, x):
        pos = torch.remainder(x, self.length) / self.dx
        j = torch.floor(pos)
        return j.long() % self.m, pos - j

    def deposit(self, x):
        """(..., N) positions -> (..., M) cloud-in-cell density n0 L / N / dx
        times the summed weights."""
        j, f = self._cells(x)
        rows = x.reshape(-1, x.shape[-1]).shape[0]
        base = (torch.arange(rows, device=x.device) * self.m)[:, None]
        jj, ff = j.reshape(rows, -1) + base, f.reshape(rows, -1)
        out = torch.zeros(rows * self.m, dtype=x.dtype, device=x.device)
        out.index_add_(0, jj.reshape(-1), (1.0 - ff).reshape(-1))
        out.index_add_(0, ((jj - base + 1) % self.m + base).reshape(-1), ff.reshape(-1))
        scale = self.n0 * self.length / x.shape[-1] / self.dx
        return (out * scale).reshape(x.shape[:-1] + (self.m,))

    def gather(self, e, x):
        """(..., M) mesh field at (..., N) positions, the deposit's weights."""
        j, f = self._cells(x)
        e = e.expand(x.shape[:-1] + (self.m,))
        left = torch.gather(e, -1, j)
        right = torch.gather(e, -1, (j + 1) % self.m)
        return (1.0 - f) * left + f * right

    def solve(self, dens):
        return self.mm(dens - self.n0, self.e_op_t)

    def drive(self, coeffs):
        """(..., 2 Ka) packed cosine and sine coefficients -> (..., M) field."""
        return self.mm(coeffs, self.basis)

    def field_energy(self, e, n_particles):
        """(1/2) sum(E^2) dx N / L."""
        return 0.5 * torch.sum(e * e, -1) * self.dx * (n_particles / self.length)

    def feedback(self, x):
        """The phase-conjugate law (a, b) = (-Re Ek, +Im Ek) of the field at x."""
        ek = self.mm(self.solve(self.deposit(x)), self.dft)  # [Re Ek, Im Ek]
        return torch.cat([-ek[: self.ka], ek[self.ka:]])


def mode_sums(c1, s1, km):
    """(..., Km) sums over particles of cos(m t), sin(m t), m = 1..Km, by the
    three-term recurrence from the base phasor (c1, s1)."""
    return _harmonic_pass(c1, s1, km, lambda m, cm, sm: (0.0, 0.0))[1:]


def _harmonic_pass(c1, s1, km, coef):
    """Per particle: sums over modes of the per-row (..., Km) coefficients
    (pc, ps) at cos(m t), sin(m t); and the (..., Km) mode sums. ``coef(m,
    C_m, S_m)`` gives mode m's (pc, ps) from its sums."""
    twoc = c1 + c1
    c_pp, s_pp, c_p, s_p = torch.ones_like(c1), torch.zeros_like(s1), c1, s1
    acc, cs, ss = torch.zeros_like(c1), [], []
    for m in range(km):
        if m:
            c_pp, c_p = c_p, twoc * c_p - c_pp
            s_pp, s_p = s_p, twoc * s_p - s_pp
        cm, sm = c_p.sum(-1, keepdim=True), s_p.sum(-1, keepdim=True)
        pc, ps = coef(m, cm, sm)
        acc = acc + pc * c_p + ps * s_p
        cs.append(cm[..., 0])
        ss.append(sm[..., 0])
    return acc, torch.stack(cs, -1), torch.stack(ss, -1)


class Reference:
    """The control step of one configuration and traffic mix."""

    def __init__(self, sim: dict, control: dict, mpc: dict, device, prec: Precision = REFERENCE):
        if sim["interpol"] != "cic" or sim["integrator"] != "yoshida4":
            raise ValueError("the reference holds the cic shape and the Yoshida-4 step")
        unsupported = {"algo": "mppi", "n_grad_iters": 0, "plan_chunk": None,
                       "smooth_noise": 0.0, "terminal_mode": "const"}
        for key, want in unsupported.items():
            if mpc[key] != want:
                raise ValueError(f"the reference holds {key}={want!r}, not {mpc[key]!r}")
        self.sim, self.ctrl, self.mpc, self.prec, self.device = sim, control, mpc, prec, device
        n, m, length = sim["n_particles"], sim["n_mesh"], sim["length"]
        self.n, self.length, self.n0 = n, length, sim["n0"]
        self.dt = clamped_dt(sim["dt"], n, length)
        self.ka = control["max_mode"]
        self.km = max(int(mpc["plan_modes"]), self.ka)
        mk = lambda mesh: Model(mesh, length, self.n0, self.ka, control["endpoint_grid"],  # noqa: E731
                                prec, device)
        self.env = mk(m)
        self.stride, self.n_plan = 1, n
        if mpc["plan_particles"] is not None and mpc["plan_particles"] < n:
            self.stride = max(1, n // mpc["plan_particles"])
            self.n_plan = -(-n // self.stride)
        plan_mesh = mpc["plan_mesh"] if mpc["plan_mesh"] is not None and mpc["plan_mesh"] < m else m
        self.plan_model = self.env if plan_mesh == m else mk(plan_mesh)
        self.plan_dt = clamped_dt(sim["dt"], self.n_plan, length)
        self.frac = min(self.n_plan / n, 1.0) if self.stride > 1 else 1.0
        nref = mpc["cost_pe_nref"]
        self.pe_f = 1.0 if nref is None else float(nref) / self.n_plan
        drift = mpc["spectral_drift"]
        if mpc["plan_kernel"] == "xla":
            drift = "trig"
        self.rot = drift == "rot" or (drift in (None, "auto") and (
            2.0 * math.pi / length) * self.plan_dt * 25.0 <= 0.5)

    def _t(self, a):
        return a.to(device=self.device, dtype=self.prec.dtype)

    # ---- candidate noise --------------------------------------------------
    def noise(self, generator_state: torch.Tensor) -> torch.Tensor:
        """(K, H, D) unit draws of one solve, from the state the solve's
        generator had before it: antithetic knot-interpolated normals."""
        mpc, d = self.mpc, 2 * self.ka
        k, h = mpc["n_candidates"], mpc["horizon"]
        gen = torch.Generator(device=self.device)
        gen.set_state(generator_state)
        rows = (k + 1) // 2 if mpc["antithetic"] and k >= 2 else k
        knots = mpc["n_knots"]
        if knots and 1 <= knots < h:
            eps = self._t(torch.randn((rows, knots, d), generator=gen, dtype=torch.float32,
                                      device=self.device))
            t = torch.linspace(0.0, knots - 1.0, h, dtype=torch.float64)
            i0 = torch.clamp(torch.floor(t).long(), 0, max(knots - 2, 0))
            f = self._t((t - i0)[None, :, None])
            i1 = torch.clamp(i0 + 1, max=knots - 1)
            out = ((1.0 - f) * eps[:, i0] + f * eps[:, i1]) / torch.sqrt((1.0 - f) ** 2 + f * f)
        else:
            out = self._t(torch.randn((rows, h, d), generator=gen, dtype=torch.float32,
                                      device=self.device))
        if rows != k:
            out = torch.cat([out, -out])[:k]
        return out

    # ---- plan ------------------------------------------------------------
    def _guard_ratio(self, x):
        """Coherent modal energy of the full state over the subsample's
        injected noise."""
        km, n, n0 = self.km, self.n, self.n0
        k = (2.0 * math.pi / self.length) * torch.arange(1, km + 1, dtype=torch.float64,
                                                          device=self.device)
        k = self._t(k)
        t = (2.0 * math.pi / self.length) * x
        c, s = mode_sums(torch.cos(t), torch.sin(t), km)
        modal = (n0 * n0 / n) * (c * c + s * s) / (k * k)
        coherent = self.frac * torch.sum(torch.clamp(modal - n0 * n0 / (k * k), min=0.0))
        injected = sum(n0 * n0 * (1.0 - self.frac) / (2.0 * math.pi * m / self.length) ** 2
                       for m in range(1, km + 1))
        return coherent / max(injected, 1e-30)

    def _twin_targets(self, x_full, xp, vp):
        """(tc, ts), each (H, Km): the zero-drive twin's mode-sum trajectory
        of the plan state times each mode's noise fraction 1 - lambda."""
        km, h, dt = self.km, self.mpc["horizon"], self.plan_dt
        c_ang = 2.0 * math.pi / self.length
        t = c_ang * x_full
        cf, sf = mode_sums(torch.cos(t), torch.sin(t), km)
        r = self.n_plan / self.n
        sig2 = torch.clamp(cf * cf + sf * sf - self.n, min=0.0)
        rho = 1.0 - (r * r * sig2) / (r * r * sig2 + self.n_plan * (1.0 - r))
        g = self._g()
        zero = lambda mm, cm, sm: (g[mm] * sm, -(g[mm] * cm))  # noqa: E731
        acc, _, _ = _harmonic_pass(torch.cos(c_ang * xp), torch.sin(c_ang * xp), km, zero)
        vh, x, cs, ss = vp - 0.5 * dt * acc, xp, [], []
        twice = lambda mm, cm, sm: (2.0 * (g[mm] * sm), 2.0 * (-(g[mm] * cm)))  # noqa: E731
        for _ in range(h):
            x = torch.remainder(x + dt * vh, self.length)
            acc, c, s = _harmonic_pass(torch.cos(c_ang * x), torch.sin(c_ang * x), km, twice)
            vh = vh - 0.5 * dt * acc
            cs.append(c)
            ss.append(s)
        return rho * torch.stack(cs), rho * torch.stack(ss)

    def _g(self):
        k = 2.0 * math.pi / self.length * np.arange(1, self.km + 1)
        return [float(v) for v in 2.0 * self.n0 / (self.n_plan * k)]

    def _spectral_pe(self, xp, vp, cand, twin):
        """(K, H) plan-model field energies of the candidates (before the
        nref / n factor): the gridless spectral rollout."""
        km, ka, dt, h = self.km, self.ka, self.plan_dt, cand.shape[1]
        c_ang = 2.0 * math.pi / self.length
        g = self._g()
        kv = 2.0 * math.pi / self.length * np.arange(1, km + 1)
        inv_k2 = [float(v) for v in 1.0 / (kv * kv)]
        pe_scale = self.n0 ** 2 / self.n_plan
        pad = lambda u: torch.nn.functional.pad(u, (0, km - ka))  # noqa: E731
        u_c, u_s = pad(cand[..., :ka]), pad(cand[..., ka:])
        pair_c = torch.cat([u_c[:, 1:], u_c[:, -1:]], 1) + u_c
        pair_s = torch.cat([u_s[:, 1:], u_s[:, -1:]], 1) + u_s
        c0, s0 = torch.cos(c_ang * xp), torch.sin(c_ang * xp)
        out = []
        rows = max(1, BLOCK_ELEMENTS // xp.shape[0])
        for lo in range(0, cand.shape[0], rows):
            sl = slice(lo, lo + rows)
            first = lambda mm, cm, sm: (g[mm] * sm + u_c[sl, 0, mm:mm + 1],  # noqa: E731
                                        -(g[mm] * cm) + u_s[sl, 0, mm:mm + 1])
            acc, _, _ = _harmonic_pass(c0.expand(u_c[sl].shape[0], -1), s0.expand(
                u_c[sl].shape[0], -1), km, first)
            vh = vp - 0.5 * dt * acc
            c1, s1, x = c0.expand_as(vh), s0.expand_as(vh), xp.expand_as(vh)
            pes = []
            for t in range(h):
                if self.rot:
                    d = (c_ang * dt) * vh
                    d2 = d * d
                    cd = 1.0 + d2 * (-0.5 + d2 * (1.0 / 24.0))
                    sd = d * (1.0 + d2 * (-1.0 / 6.0 + d2 * (1.0 / 120.0)))
                    c1, s1 = c1 * cd - s1 * sd, s1 * cd + c1 * sd
                else:
                    x = x + dt * vh
                    x = x - self.length * torch.floor(x / self.length)
                    c1, s1 = torch.cos(c_ang * x), torch.sin(c_ang * x)
                kick = lambda mm, cm, sm, t=t: (  # noqa: E731
                    2.0 * (g[mm] * sm) + pair_c[sl, t, mm:mm + 1],
                    2.0 * (-(g[mm] * cm)) + pair_s[sl, t, mm:mm + 1])
                acc, cs, ss = _harmonic_pass(c1, s1, km, kick)
                if twin is not None:
                    cs, ss = cs - twin[0][t], ss - twin[1][t]
                pes.append(pe_scale * torch.sum((cs * cs + ss * ss) * self._t(
                    torch.tensor(inv_k2, dtype=torch.float64)), -1))
                vh = vh - 0.5 * dt * acc
            out.append(torch.stack(pes, -1))
        return torch.cat(out)

    def _grid_pe(self, xp, vp, cand):
        """(K, H) plan-model field energies of the candidates (before the
        nref / n factor): merged-kick KDK on the plan mesh."""
        pm, dt, h = self.plan_model, self.plan_dt, cand.shape[1]
        u = pm.drive(cand)  # (K, H, M)
        out = []
        rows = max(1, BLOCK_ELEMENTS // xp.shape[0])
        for lo in range(0, cand.shape[0], rows):
            ub = u[lo:lo + rows]
            x = xp.expand(ub.shape[0], -1)
            e = pm.solve(pm.deposit(x))
            vh = vp - 0.5 * dt * pm.gather(e + ub[:, 0], x)
            pes = []
            for t in range(h):
                x = torch.remainder(x + dt * vh, self.length)
                e = pm.solve(pm.deposit(x))
                pes.append(pm.field_energy(e, self.n_plan))
                if t + 1 < h:
                    vh = vh - 0.5 * dt * pm.gather(2.0 * e + ub[:, t] + ub[:, t + 1], x)
            out.append(torch.stack(pes, -1))
        return torch.cat(out)

    def plan(self, x, v, mean, noise):
        """One solve from the full state: {"mu": (H, D) the MPPI nominal
        after the guard, "best": the least candidate cost, "ratio": the
        guard's ratio or None, "mu_unguarded", "cost_scale": the median
        candidate cost's size}."""
        mpc, ctrl = self.mpc, self.ctrl
        x, v, mean, noise = self._t(x), self._t(v), self._t(mean), self._t(noise)
        xp, vp = x[::self.stride], v[::self.stride]
        pm = self.plan_model
        cand = mean[None] + mpc["sigma0"] * noise
        cand[0] = mean
        if mpc["seed_feedback"] and mpc["n_candidates"] >= 2:
            cand[1] = pm.feedback(xp).expand_as(mean)
        cand = torch.clamp(cand, ctrl["coeff_min"], ctrl["coeff_max"])
        twin = None
        if mpc["plan_correction"] == "twin" and self.frac < 1.0:
            twin = self._twin_targets(x, xp, vp)
        if mpc["plan_model"] == "grid":
            pe = self._grid_pe(xp, vp, cand)
        else:
            pe = self._spectral_pe(xp, vp, cand, twin)
        pe = self.pe_f * pe
        ie = torch.sum(cand * cand, -1) * self.length * 0.25
        cost = torch.sum(mpc["w_field"] * pe + mpc["w_input"] * ie, -1)
        if mpc["w_terminal"]:
            cost = cost + mpc["w_terminal"] * pe[:, -1]
        huge = min(HUGE, torch.finfo(cost.dtype).max)
        cost = torch.where(torch.isfinite(cost), cost, torch.full_like(cost, huge))
        best = torch.min(cost)
        w = torch.softmax(-(cost - best) / mpc["temperature"], 0)
        mu = self.plan_model.mm(w[None], cand.reshape(cand.shape[0], -1)).reshape(mean.shape)
        ratio = None
        out = mu
        if mpc["fidelity_guard"] and self.frac < 1.0:
            ratio = float(self._guard_ratio(x))
            if ratio < mpc["fidelity_guard_ratio"]:
                out = torch.zeros_like(mu)
        return {"mu": out, "mu_unguarded": mu, "best": best, "ratio": ratio,
                "cost_scale": torch.median(torch.abs(cost))}

    # ---- environment step -------------------------------------------------
    def env_step(self, x, v, action):
        """The action held over one Yoshida-4 step of the full state:
        (x', v', PE, KE, input energy)."""
        env, dt = self.env, self.dt
        x, v, action = self._t(x), self._t(v), self._t(action)
        e_ext = env.drive(action)
        cs, ds = yoshida4()
        x = x + cs[0] * dt * v
        for c, d in zip(cs[1:], ds):
            e = env.solve(env.deposit(x)) + e_ext
            v = v - d * dt * env.gather(e, x)
            x = x + c * dt * v
        x = torch.remainder(x, self.length)
        pe = env.field_energy(env.solve(env.deposit(x)), self.n)
        ke = 0.5 * torch.sum(v * v)
        ie = torch.sum(action * action) * self.length * 0.25
        return x, v, pe, ke, ie
