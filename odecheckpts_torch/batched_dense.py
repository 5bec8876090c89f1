"""Batched fixed-memory adaptive solver on the DENSE covariance backend
(PyTorch counterpart of ``odecheckpts_tpu.batched_dense``).

The dense backend carries the full (nd, nd) square-root covariance, which
TS1 (first-order linearization, EK1) needs for d > 1: stiff ensembles of
small systems such as the Brusselator at N = 2 (d = 4).  Lanes-last layout
(B = lane axis):

* means ``(nd, B)``, derivative-major (row ``i*d + k`` = derivative i,
  dimension k), factors and gains ``(nd, nd, B)``;
* the IBM transition ``kron(A, I_d)`` applied block-row-wise;
* QRs by the column-list Householder ``batched._qr_r_cols`` at (2nd, 2nd)
  (prediction revert), (nd, d + nd) (correction revert) and (2nd, nd)
  (fixedpoint accumulation).

The state tuple matches ``batched.NUM_STATE`` field for field, with these
shapes; ``batched._state_to_generic`` / ``_generic_to_state`` move the lane
axis for any layout, so they stand for the reference's
``_state_to_generic_dense`` / ``_generic_to_state_dense``
(``batched_dense.py:487-560``), and ``batched.solve_intervals`` runs the
checkpoint loop and the smoothing pass for both drivers.

``StepDense`` is the plain-torch twin of kernel K5; ``kernels.step_dense_interval``
runs a whole checkpoint interval of it as the CUDA kernel
``csrc/step_dense.cu`` and ``kernels.step_dense_attempt`` one attempt
(``csrc/step_dense_attempt.cu``).

Ported configuration: fixedpoint, dynamic calibration, ``ode_order=1``,
``error_unit="qoi"``, TS1 or TS0, ``num_derivatives=4``.  Everything else
raises ``NotImplementedError`` naming ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import torch

from . import batched, ivpsolvers, kernels
from .batched import _const_matmul, _matmul_ll, _qr_r_cols, _tri_solve_upper_ll

SUPPORTED_NU = (4,)  # K5 is instantiated for nu = 4


def _div(x, c):
    """x / c for a Python constant c: divides by a tensor, because torch
    multiplies by the reciprocal of a scalar divisor on CUDA."""
    return x / torch.full_like(x, c)


class StepDense(batched._StepConstants):
    """One lanes-last adaptive attempt of the dense TS1 / TS0 fixedpoint
    solver with dynamic calibration: the twin of K5
    (``odecheckpts_tpu/batched_dense.py:114-484``).

    Constants are Python floats rounded to ``dtype`` once; sums over the
    small axes run in the reference's order.  TS1 takes the Jacobian from
    ``vf.jac`` where the problem has one (the twin of the kernel functor's
    ``jac``); otherwise from one-hot ``torch.func.jvp`` columns, as the
    reference's ``vf_jacs`` does (twin only: the kernels need ``jac``).
    """

    def __init__(self, vf, params, *, nu, d, correction, error_calibration,
                 control=None, dtype=torch.float32):
        super().__init__(nu=nu, d=d, error_calibration=error_calibration,
                         control=control, dtype=dtype)
        self.vf, self.params = vf, params
        self.ts1 = correction == "ts1"
        self.jac = getattr(vf, "jac", None)
        self.four_eps = 4.0 * float(torch.finfo(dtype).eps)
        self.device_functor = getattr(vf, "device_functor", None)
        self.functor_params = batched.functor_params(vf, params)
        n = nu + 1
        self._kron_lq = [[self.lq_rows[i // d][k // d] if i % d == k % d else 0.0
                          for k in range(n * d)] for i in range(n * d)]
        self._kron_cache = {}

    def packed_constants(self):
        """The kernel's constant buffer (layout of ``Consts`` in step_ll.cuh)."""
        return self._pack(max(batched.SUPPORTED_NU) + 1, [
            self.max_lq, self.a_inf_norm, self.sqrt_d, self.kappa, self.neg_n1,
            self.n2, self.safety, self.factor_min, self.factor_max, self.big,
            self.clip,
        ])

    def state_shapes(self, batch):
        """Shapes of the 17 state arrays (layout above ``batched.NUM_STATE``)."""
        nd, b = (self.nu + 1) * self.d, batch
        row, vec, mat = (1, b), (nd, b), (nd, nd, b)
        return [row, vec, mat, mat, vec, mat, row, row, vec, mat, mat, vec, mat,
                row, row, row, row]

    def _kron(self, like):
        """kron(Lq, I_d) as an (nd, nd, 1) tensor and its nonzero mask."""
        key = (like.device, like.dtype)
        if key not in self._kron_cache:
            k = torch.tensor(self._kron_lq, dtype=like.dtype, device=like.device)[:, :, None]
            self._kron_cache[key] = (k, k != 0)
        return self._kron_cache[key]

    def _jacobian(self, u, t):
        """J[r, c] = d f_r / d u_c as (d, d, B)."""
        if self.jac is not None:
            return self.jac(u, t=t, p=self.params)
        cols = []
        for c in range(self.d):
            onehot = torch.zeros_like(u)
            onehot[c] = 1.0
            _, jv = torch.func.jvp(lambda a: self.vf(a, t=t, p=self.params), (u,), (onehot,))
            cols.append(jv)
        return torch.stack(cols, dim=1)

    def _blocks_a(self, x):
        """kron(A, I_d) @ x for an (nd, ..., B) stack."""
        n, d = self.nu + 1, self.d
        out = _const_matmul(self.a_rows, x.reshape((n, d) + x.shape[1:]))
        return out.reshape(x.shape)

    def __call__(self, state, t_next, atol, rtol, dt_max, dt_floor, tiny_scale):
        (t, mean, chol, bwdG, bwd_m, bwd_L, scale, t_prev, mean_prev, chol_prev,
         bwdG_prev, bwd_m_prev, bwd_L_prev, dt_st, errn_prev, nsteps, mle) = state
        nu, d = self.nu, self.d
        n = nu + 1
        nd = n * d
        lq = self.lq_rows

        dt = torch.minimum(torch.maximum(dt_st, dt_floor), dt_max)
        p = self._precond(dt)  # n x (1, B)
        p_inv = [torch.reciprocal(pi) for pi in p]
        prow = torch.repeat_interleave(torch.cat(p, dim=0), d, dim=0)  # (nd, B)
        pinv_row = torch.repeat_interleave(torch.cat(p_inv, dim=0), d, dim=0)
        t_new = t + dt

        # -- extrapolate the mean: m_pred = P (A kron I) P^-1 m
        m_pred = self._blocks_a(mean * pinv_row) * prow

        # -- linearize at the predicted mean
        u_pred = m_pred[:d]
        z = m_pred[d : 2 * d] - self.vf(u_pred, t=t_new[0], p=self.params)
        jac = self._jacobian(u_pred, t_new[0]) if self.ts1 else None

        # -- sigma and the step-control error from the residual model: the
        # rows of H Q_unit^{1/2}, block kk column j:
        #   p_1 Lq[1, kk] [j == r] - p_0 Lq[0, kk] J[r, j]
        zero = torch.zeros_like(p[0])
        hq_rows = []
        for r in range(d):
            entries = []
            for kk in range(n):
                base = p[1] * lq[1][kk]
                for j in range(d):
                    acc = base if j == r else None
                    if self.ts1 and lq[0][kk] != 0.0:
                        term = (p[0] * lq[0][kk]) * jac[r, j][None]
                        acc = -term if acc is None else acc - term
                    entries.append(zero if acc is None else acc)
            hq_rows.append(torch.cat(entries, dim=0))  # (nd, B)
        hq = torch.stack(hq_rows)  # (d, nd, B)
        # joint row normalization of (h_q, z): exactly invariant for sigma
        row_mag = torch.maximum(torch.amax(torch.abs(hq), dim=1, keepdim=True), tiny_scale)
        z_n = z / row_mag[:, 0]
        rs = _qr_r_cols(hq / row_mag, nd, d, self.tiny)  # R_s[i][c] = rs[c][i]
        white = []
        for i in range(d):  # solve R_s^T w = z_n
            acc = z_n[i : i + 1]
            for j in range(i):
                acc = acc - rs[i][j : j + 1] * white[j]
            diag = rs[i][i : i + 1]
            diag = torch.where(torch.abs(diag) > self.tiny, diag, torch.full_like(diag, self.tiny))
            white.append(acc / diag)
        ww = white[0] * white[0]
        for i in range(1, d):
            ww = ww + white[i] * white[i]
        sigma = _div(torch.sqrt(ww), self.sqrt_d)
        err_u = sigma * (p[0] * self.lq_norms[0])
        tol_w = atol + rtol * torch.abs(u_pred)
        q = err_u / tol_w[0:1]
        e2 = q * q
        for r in range(1, d):
            q = err_u / tol_w[r : r + 1]
            e2 = e2 + q * q
        errn = self.kappa * torch.sqrt(_div(e2, 1.0 * d))

        sigma_safe = torch.where(torch.isfinite(sigma), sigma, torch.full_like(sigma, self.big))
        new_scale = torch.clamp(torch.maximum(sigma_safe, tiny_scale), max=self.big)

        # -- extrapolate the covariance (preconditioned, jointly normalized)
        l_bar = torch.clamp(chol * pinv_row[:, None], -self.clip, self.clip)
        mag = torch.maximum(new_scale * self.max_lq, torch.amax(torch.abs(l_bar), dim=(0, 1))[None])
        mag = torch.maximum(mag * self.a_inf_norm, tiny_scale)
        inv_mag = torch.reciprocal(mag)
        l_bar_n = l_bar * inv_mag[None]
        a_l = self._blocks_a(l_bar_n)
        kron, nonzero = self._kron(dt)
        lq_r = torch.where(nonzero, kron * (new_scale * inv_mag)[None], torch.zeros_like(a_l))

        # revert QR of [[ (A Lbar)^T, Lbar^T ], [ Lq^T, 0 ]]: column c < nd is
        # [row c of a_l; row c of lq_r], column nd + c is [row c of l_bar_n; 0]
        cols = torch.cat([torch.cat([a_l, lq_r], dim=1),
                          torch.cat([l_bar_n, torch.zeros_like(l_bar_n)], dim=1)])
        cols = _qr_r_cols(cols, 2 * nd, 2 * nd, self.tiny)  # cols[c][r] = R[r][c]
        r_yy = cols[:nd, :nd].transpose(0, 1)
        r_yx = cols[nd:, :nd].transpose(0, 1)
        g_bar = _tri_solve_upper_ll(r_yy, r_yx, nd).transpose(0, 1)
        l_pred = (cols[:nd, :nd] * mag[None]) * prow[:, None]
        gain = (g_bar * prow[:, None]) * pinv_row[None]
        bwd_L_step = (cols[nd:, nd:] * mag[None]) * prow[:, None]
        bwd_m_step = mean - _matmul_ll(gain, m_pred[:, None], nd)[:, 0]

        # -- TS0 / TS1 correction: one QR revert on (nd, d + nd).  Rows of
        # H L for H = E_1 - J E_0, jointly row-normalized with z
        hl = l_pred[d : 2 * d]
        if self.ts1:
            for c in range(d):
                hl = hl - jac[:, c][:, None] * l_pred[c][None]
        hl_mag = torch.maximum(torch.amax(torch.abs(hl), dim=1, keepdim=True), tiny_scale)
        z_c = z / hl_mag[:, 0]
        lmag = torch.maximum(tiny_scale, torch.amax(torch.abs(l_pred), dim=(0, 1))[None])
        inv_l = torch.reciprocal(lmag)
        cols_c = torch.cat([(hl / hl_mag) * inv_l[None], l_pred * inv_l[None]])
        cols_c = _qr_r_cols(cols_c, nd, d + nd, self.tiny)  # nd - 1 reflections
        x_c = _tri_solve_upper_ll(cols_c[:d, :d].transpose(0, 1),
                                  cols_c[d:, :d].transpose(0, 1), d)  # (d, nd, B)
        delta = x_c[0] * z_c[0:1]
        for r in range(1, d):
            delta = delta + x_c[r] * z_c[r : r + 1]
        mean_cor = m_pred - delta
        # corrected factor: (r_xx * lmag)^T padded with d zero columns
        chol_cor = torch.cat([cols_c[d:, d:] * lmag[None],
                              torch.zeros_like(cols_c[d:, :d])], dim=1)

        # -- fixedpoint accumulation
        bwdG_new = _matmul_ll(bwdG, gain, nd)
        bwd_m_new = _matmul_ll(bwdG, bwd_m_step[:, None], nd)[:, 0] + bwd_m
        mag_g = torch.maximum(tiny_scale, torch.amax(torch.abs(bwdG), dim=(0, 1))[None])
        inv_g = torch.reciprocal(mag_g)
        m1 = _matmul_ll(bwdG * inv_g[None], bwd_L_step, nd)
        bl_g = bwd_L * inv_g[None]
        t3 = torch.maximum(tiny_scale, torch.amax(torch.abs(m1), dim=(0, 1))[None])
        t3 = torch.maximum(t3, torch.amax(torch.abs(bl_g), dim=(0, 1))[None])
        inv3 = torch.reciprocal(t3)
        cols2 = _qr_r_cols(torch.cat([m1 * inv3[None], bl_g * inv3[None]], dim=1),
                           2 * nd, nd, self.tiny)
        bwd_L_new = (cols2[:, :nd] * t3[None]) * mag_g[None]

        # -- PI control
        errn_s = torch.clamp(errn, min=self.tiny)
        factor = self.safety * torch.exp(
            self.neg_n1 * torch.log(errn_s)
            + self.n2 * (torch.log(errn_prev) - torch.log(errn_s))
        )
        factor = torch.where(
            torch.isfinite(factor), factor, torch.full_like(factor, self.factor_min)
        )
        dt_next = torch.minimum(
            dt * torch.clamp(factor, self.factor_min, self.factor_max), dt_max
        )
        dt_stall = self.four_eps * torch.clamp(torch.abs(t), min=1.0)
        frozen = t >= t_next
        accept = ((errn <= 1.0) | (dt <= dt_stall)) & ~frozen
        upd = ~frozen

        def sel(new, old, mask=accept):
            return torch.where(mask, new, old)  # (1, B) broadcasts on the lanes

        return (
            sel(t_new, t),
            sel(mean_cor, mean),
            sel(chol_cor, chol),
            sel(bwdG_new, bwdG),
            sel(bwd_m_new, bwd_m),
            sel(bwd_L_new, bwd_L),
            sel(new_scale, scale),
            sel(t, t_prev),
            sel(mean, mean_prev),
            sel(chol, chol_prev),
            sel(bwdG, bwdG_prev),
            sel(bwd_m, bwd_m_prev),
            sel(bwd_L, bwd_L_prev),
            sel(dt_next, dt_st, mask=upd),
            sel(errn_s, errn_prev),
            sel(nsteps + 1.0, nsteps),  # accepted steps only
            sel(mle + sigma * sigma, mle),
        )


def _check_config(*, strategy, calibration, ode_order, correction, error_unit,
                  num_derivatives):
    batched._check_config(
        strategy=strategy, calibration=calibration, ode_order=ode_order,
        correction=correction, error_unit=error_unit, implementation="dense",
        num_derivatives=num_derivatives, supported_nu=SUPPORTED_NU,
        corrections=("ts0", "ts1"), implementations=("dense",),
    )


def make_step_dense(vf, params, *, nu, d, correction="ts1", strategy="fixedpoint",
                    calibration="dynamic", ode_order=1, error_unit="qoi",
                    error_calibration=None, control=None, dtype=torch.float32):
    """The twin of K5 for ``vf`` (row-wise, see ``problems``); the
    counterpart of ``make_step_dense_ll``."""
    _check_config(strategy=strategy, calibration=calibration, ode_order=ode_order,
                  correction=correction, error_unit=error_unit, num_derivatives=nu)
    if error_calibration is None:
        error_calibration = ivpsolvers.default_error_calibration(correction, error_unit)
    return StepDense(vf, params, nu=nu, d=d, correction=correction,
                     error_calibration=error_calibration, control=control, dtype=dtype)


def solve_save_at_batched_dense(
    vf,
    u0s,
    params,
    *,
    save_at,
    dt0,
    tols,
    num_derivatives=4,
    strategy="fixedpoint",
    calibration="dynamic",
    atol_factor=1e-3,
    engine="cuda-loop",
    hbm_budget="auto",
    ode_order=1,
    correction="ts1",
    error_unit="qoi",
    error_calibration=None,
    max_attempts=100_000,
):
    """Batched fixed-memory adaptive solve on the dense backend
    (``odecheckpts_tpu/batched_dense.py:563-786``).

    Same contract as ``batched.solve_save_at_batched``: ``u0s`` (B, d),
    ``tols`` (B,), returns ``(u_smooth (B, T, d), u_filt (B, T, d),
    num_steps (B, T))``.  ``engine="cuda-loop"`` launches K5's interval form
    once per checkpoint interval, ``engine="cuda"`` K5's attempt form once
    per attempt under the host loop, ``engine="torch"`` runs the twin; the
    kernel engines run the twin on CPU tensors.  The vector field needs a
    device functor for the kernel engines (``problems.brusselator``,
    ``problems.rigid_body``).
    """
    setup = setup_dense(
        vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols,
        num_derivatives=num_derivatives, strategy=strategy, calibration=calibration,
        atol_factor=atol_factor, engine=engine, hbm_budget=hbm_budget, ode_order=ode_order,
        correction=correction, error_unit=error_unit, error_calibration=error_calibration,
    )
    return batched.solve_intervals(
        setup["interval"], setup["step"], setup["state"], setup["rv0"], setup["inputs"],
        strat=setup["strat"], save_at=setup["save_at"], max_attempts=max_attempts)


def setup_dense(vf, u0s, params, *, save_at, dt0, tols, num_derivatives=4,
                strategy="fixedpoint", calibration="dynamic", atol_factor=1e-3,
                engine="cuda-loop", hbm_budget="auto", ode_order=1, correction="ts1",
                error_unit="qoi", error_calibration=None):
    """Everything ``solve_save_at_batched_dense`` builds before its checkpoint
    loop, as a dict: ``interval`` (the engine's interval function), ``step``,
    ``state`` and ``rv0`` (the Taylor init), ``inputs``, ``strat`` and
    ``save_at``.  ``batched.advance_checkpoint`` runs one checkpoint of it."""
    _check_config(strategy=strategy, calibration=calibration, ode_order=ode_order,
                  correction=correction, error_unit=error_unit,
                  num_derivatives=num_derivatives)
    batched._check_engine(engine)
    if isinstance(u0s, tuple):
        (u0s,) = u0s
    b, d = u0s.shape
    dtype, device = u0s.dtype, u0s.device
    nu = num_derivatives
    save_at = torch.as_tensor(save_at, dtype=dtype, device=device)
    # the reference's admission check, called as it calls it (n*d in place of d)
    batched.check_hbm_budget(
        b, (nu + 1) * d, num_derivatives=nu, num_save_at=len(save_at), dtype=dtype,
        budget=hbm_budget, device=device,
    )
    ssm = ivpsolvers.prior_ibm(num_derivatives=nu, ode_shape=(d,), implementation="dense")
    make_corr = ivpsolvers.correction_ts1 if correction == "ts1" else ivpsolvers.correction_ts0
    strat = ivpsolvers.strategy_fixedpoint(ssm, make_corr(error_calibration=error_calibration))
    step = make_step_dense(vf, params, nu=nu, d=d, correction=correction,
                           error_calibration=strat.correction.calibration_factor, dtype=dtype)
    state, rv0, inputs = batched.initial_state(
        vf, u0s, params, save_at=save_at, dt0=dt0, tols=tols, num_derivatives=nu,
        atol_factor=atol_factor, implementation="dense",
    )
    interval = batched.interval_fn(engine, kernels.step_dense_interval,
                                   kernels.step_dense_attempt, kernels.active_ll)
    return {"interval": interval, "step": step, "state": state, "rv0": rv0,
            "inputs": inputs, "strat": strat, "save_at": save_at}
