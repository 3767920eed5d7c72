"""Motion-only pose optimization (visual and visual-inertial).

Port of orbslam3_tpu/optim/pose_only.py: a robust Gauss-Newton from the
motion/IMU prior with per-round chi2 re-gating, and the 15-dof
pose/velocity/bias refinement against the previous keyframe's
preintegration. Jacobians are exact forward-mode derivatives
(torch.func.jacfwd under torch.func.vmap, in place of jax.jacfwd/vmap);
the residuals branch only through torch.where. Each fixed-length lax.scan
is a Python loop. Linear solves use the *_ex variants, which do not wait
for the device to report singular systems.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from orbslam3_tpu_torch.frontend.camera import Camera
from orbslam3_tpu_torch.geometry import quat
from orbslam3_tpu_torch.imu import preintegration as pre
from orbslam3_tpu_torch.optim import robust


def _retract(q, p, xi):
    """Right-multiplicative SE3 update on (q_wb, p_w): rotation last 3."""
    dq = quat.from_axis_angle(xi[..., 3:6])
    return quat.normalize(quat.mul(q, dq)), p + quat.rotate(q, xi[..., 0:3])


def _visual_residual(xi, q0, p0, cam: Camera, Xw, uv, ur):
    """Single-observation stereo reprojection residual (3,). ur < 0 => mono.
    (q0, p0) is the body pose; T_BC from `cam` maps into the camera."""
    q, p = _retract(q0, p0, xi)
    q_wc, p_wc = cam.body_to_cam_pose(q, p)
    Xc = quat.rotate(quat.conj(q_wc), Xw - p_wc)
    z = torch.clamp(Xc[2], min=1e-3)
    u_hat = cam.fx * Xc[0] / z + cam.cx
    v_hat = cam.fy * Xc[1] / z + cam.cy
    ur_hat = u_hat - cam.bf / z
    r_ur = torch.where(ur >= 0, ur - ur_hat, torch.zeros_like(ur_hat))
    return torch.stack([uv[0] - u_hat, uv[1] - v_hat, r_ur])


def visual_residuals(q, p, cam: Camera, mp_w, uv, ur):
    """(N, 3) residuals of all observations at pose (q, p)."""
    zero = torch.zeros(6, dtype=torch.float32, device=q.device)
    return vmap(lambda X, u, r: _visual_residual(zero, q, p, cam, X, u, r))(mp_w, uv, ur)


def visual_residuals_jac(q, p, cam: Camera, mp_w, uv, ur):
    """(r (N, 3), J (N, 3, 6)): residuals and their derivative w.r.t. the
    6-dof retraction at zero."""
    zero = torch.zeros(6, dtype=torch.float32, device=q.device)

    def f(xi, X, u, r):
        res = _visual_residual(xi, q, p, cam, X, u, r)
        return res, res

    J, r = vmap(jacfwd(f, has_aux=True), in_dims=(None, 0, 0, 0))(zero, mp_w, uv, ur)
    return r, J


class PoseOptResult(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor  # (N,) final per-obs chi2


def _solve(H, b):
    return torch.linalg.solve_ex(H, b[..., None])[0][..., 0]


def pose_optimize(q0, p0, cam: Camera, mp_w, uv, ur, octave, valid,
                  rounds: int = 4, iters_per_round: int = 4) -> PoseOptResult:
    """Robust motion-only GN: optimize (q_wb, p_w) against matched points.

    mp_w (N, 3) matched map points; uv (N, 2); ur (N,) right-u or -1;
    octave (N,) int32; valid (N,) bool initial match mask."""
    dev = q0.device
    s2inv = robust.octave_sigma2_inv(octave)
    gates = torch.linspace(2.5, 1.0, rounds, dtype=torch.float32, device=dev)
    delta2 = robust.chi2_gate(ur)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev) * 1e-5

    def chi2_of(q, p):
        r = visual_residuals(q, p, cam, mp_w, uv, ur)
        return torch.sum(r * r, -1) * s2inv

    q, p = q0, p0
    inl = valid.to(torch.float32)
    for rnd in range(rounds):
        for _ in range(iters_per_round):
            r, J = visual_residuals_jac(q, p, cam, mp_w, uv, ur)
            chi2 = torch.sum(r * r, -1) * s2inv
            w = robust.huber_weight(chi2, delta2) * s2inv * inl
            Jw = J * w[:, None, None]
            H = torch.einsum("nij,nik->jk", Jw, J) + eye6
            b = torch.einsum("nij,ni->j", Jw, r)
            q, p = _retract(q, p, -_solve(H, b))
        chi2 = chi2_of(q, p)
        inl = valid.to(torch.float32) * (chi2 <= gates[rnd] * delta2).to(torch.float32)
    chi2 = chi2_of(q, p)
    inliers = inl > 0
    return PoseOptResult(q, p, inliers, torch.sum(inliers, dtype=torch.int32), chi2)


# ---------------------------------------------------------------------------
# pose + velocity + bias refinement against the previous keyframe (VI)
# ---------------------------------------------------------------------------
def _vi_states(x, q0, p0, v0, bg0, ba0):
    """Unpack a 15-dof delta into retracted states."""
    q, p = _retract(q0, p0, x[0:6])
    return q, p, v0 + x[6:9], bg0 + x[9:12], ba0 + x[12:15]


def pose_inertial_optimize(q0, p0, v0, bg0, ba0, cam: Camera, mp_w, uv, ur, octave, valid,
                           preint: pre.PreintState, q_kf, p_kf, v_kf, prior_bg, prior_ba,
                           gravity=None, iters: int = 8, bias_prior_weight: float = 1e4,
                           imu_cap=None):
    """15-dof single-frame refinement: visual + IMU edge to the previous
    keyframe + bias prior. `gravity` is the world-frame gravity vector.
    Returns (q, p, v, bg, ba, inliers, n_inliers)."""
    dev = q0.device
    if gravity is None:
        gravity = pre.gravity(dev)
    s2inv = robust.octave_sigma2_inv(octave)
    cov9 = preint.cov[0:9, 0:9]
    floor = torch.tensor([5e-3**2] * 3 + [0.05**2] * 3 + [0.02**2] * 3,
                         dtype=torch.float32, device=dev)
    cov9 = 0.5 * (cov9 + cov9.T) + torch.diag(floor)
    info9 = torch.linalg.inv_ex(cov9)[0]
    L = torch.linalg.cholesky_ex(info9 + torch.eye(9, device=dev) * 1e-8)[0]
    zero = torch.zeros(15, dtype=torch.float32, device=dev)
    delta2 = robust.chi2_gate(ur)
    validf = valid.to(torch.float32)
    cap = torch.as_tensor(30.0 if imu_cap is None else imu_cap, dtype=torch.float32, device=dev)
    sqrt_w = float(bias_prior_weight) ** 0.5

    q, p, v, bg, ba = q0, p0, v0, bg0, ba0
    for _ in range(iters):
        def vr(x, Xw, uv_i, ur_i, q=q, p=p):
            qq, pp = _retract(q, p, x[0:6])
            r = _visual_residual(torch.zeros(6, dtype=torch.float32, device=dev),
                                 qq, pp, cam, Xw, uv_i, ur_i)
            return r, r

        def ir(x, q=q, p=p, v=v, bg=bg, ba=ba):
            qq, pp, vv, bgg, baa = _vi_states(x, q, p, v, bg, ba)
            r9 = pre.imu_residual(preint, q_kf, v_kf, p_kf, qq, vv, pp, bgg, baa,
                                  gravity_w=gravity)
            rw = L.T @ r9
            nrm = torch.linalg.norm(rw)
            rw = rw * torch.sqrt(torch.clamp(cap / torch.clamp(nrm, min=1e-9), max=1.0))
            return rw, rw

        def br(x, bg=bg, ba=ba):
            r = torch.cat([bg + x[9:12] - prior_bg, ba + x[12:15] - prior_ba]) * sqrt_w
            return r, r

        Jv, rv = vmap(jacfwd(vr, has_aux=True), in_dims=(None, 0, 0, 0))(zero, mp_w, uv, ur)
        chi2 = torch.sum(rv * rv, -1) * s2inv
        w = robust.huber_weight(chi2, delta2) * s2inv * validf
        Jw = Jv * w[:, None, None]
        H = torch.einsum("nij,nik->jk", Jw, Jv)
        b = torch.einsum("nij,ni->j", Jw, rv)
        Ji, ri = jacfwd(ir, has_aux=True)(zero)
        H = H + Ji.T @ Ji
        b = b + Ji.T @ ri
        Jb, rb = jacfwd(br, has_aux=True)(zero)
        H = H + Jb.T @ Jb
        b = b + Jb.T @ rb
        H = H + torch.eye(15, device=dev) * 1e-4
        dx = -_solve(H, b)
        q, p = _retract(q, p, dx[0:6])
        v, bg, ba = v + dx[6:9], bg + dx[9:12], ba + dx[12:15]

    rv = visual_residuals(q, p, cam, mp_w, uv, ur)
    chi2 = torch.sum(rv * rv, -1) * s2inv
    inliers = (validf > 0) & (chi2 <= delta2)
    return q, p, v, bg, ba, inliers, torch.sum(inliers, dtype=torch.int32)
