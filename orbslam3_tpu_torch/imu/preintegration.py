"""IMU preintegration on manifold (Forster et al., TRO 2017).

Port of the parts of orbslam3_tpu/imu/preintegration.py the stereo slice
runs: `PreintState`, `merge`, `integrate_assoc`, `propagate` (with its bias
correction), `imu_residual` and `pad_imu_window`. Deltas are gravity-free;
gravity appears only in `propagate` and the residual. The error-state
ordering of the 15x15 covariance is [dphi, dv, dp, dbg, dba].

`integrate_assoc` composes the per-sample segments with `merge` as a
balanced pairwise tree, one batched `merge` per level (5 levels for the
default 32-sample window). The JAX package's `lax.associative_scan`
reduces the last prefix over the same tree; the two agree to float32
rounding (the parity test holds deltas and covariance to 1e-5 relative).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch.geometry import quat, so3

GRAVITY = (0.0, 0.0, -9.81)


def gravity(device=None):
    return torch.tensor(GRAVITY, dtype=torch.float32, device=device)


class ImuNoise(NamedTuple):
    """Continuous-time noise densities (EuRoC MH defaults)."""

    sigma_g: float = 1.7e-4  # rad/s/sqrt(Hz) gyro white noise
    sigma_a: float = 2.0e-3  # m/s^2/sqrt(Hz) accel white noise
    sigma_bg: float = 1.9e-5  # gyro bias random walk
    sigma_ba: float = 3.0e-3  # accel bias random walk

    @staticmethod
    def default() -> "ImuNoise":
        return ImuNoise()


class PreintState(NamedTuple):
    """Preintegrated IMU measurement between two frames/keyframes."""

    dq: torch.Tensor  # (4,) delta rotation quaternion (body_i -> body_j)
    dv: torch.Tensor  # (3,) delta velocity (gravity-free, body_i frame)
    dp: torch.Tensor  # (3,) delta position (gravity-free, body_i frame)
    dt: torch.Tensor  # () total integration time
    cov: torch.Tensor  # (15, 15) error covariance
    J_r_bg: torch.Tensor  # (3, 3) d(dR)/d(bias_gyro)
    J_v_bg: torch.Tensor  # (3, 3)
    J_v_ba: torch.Tensor  # (3, 3)
    J_p_bg: torch.Tensor  # (3, 3)
    J_p_ba: torch.Tensor  # (3, 3)
    bias_g: torch.Tensor  # (3,) gyro bias used during integration
    bias_a: torch.Tensor  # (3,) accel bias used during integration

    @staticmethod
    def identity(bias_g=None, bias_a=None, device=None) -> "PreintState":
        if device is None and bias_g is not None:
            device = bias_g.device
        z3 = torch.zeros(3, dtype=torch.float32, device=device)
        z33 = torch.zeros((3, 3), dtype=torch.float32, device=device)
        return PreintState(
            dq=quat.identity(device=device), dv=z3, dp=z3.clone(),
            dt=torch.zeros((), dtype=torch.float32, device=device),
            cov=torch.zeros((15, 15), dtype=torch.float32, device=device),
            J_r_bg=z33, J_v_bg=z33.clone(), J_v_ba=z33.clone(), J_p_bg=z33.clone(),
            J_p_ba=z33.clone(),
            bias_g=z3.clone() if bias_g is None else bias_g,
            bias_a=z3.clone() if bias_a is None else bias_a,
        )


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _mT(x):
    return x.transpose(-1, -2)


def bias_corrected_delta(st: PreintState, bias_g, bias_a):
    """First-order bias correction: (dq, dv, dp) for new bias estimates."""
    dbg = bias_g - st.bias_g
    dba = bias_a - st.bias_a
    dq = quat.normalize(quat.mul(st.dq, quat.from_axis_angle(st.J_r_bg @ dbg)))
    dv = st.dv + st.J_v_bg @ dbg + st.J_v_ba @ dba
    dp = st.dp + st.J_p_bg @ dbg + st.J_p_ba @ dba
    return dq, dv, dp


def propagate(st: PreintState, q_wb, v_w, p_w, bias_g=None, bias_a=None, gravity_w=None):
    """Predict state j from state i using the preintegrated deltas."""
    if gravity_w is None:
        gravity_w = gravity(q_wb.device)
    if bias_g is None:
        dq, dv, dp = st.dq, st.dv, st.dp
    else:
        dq, dv, dp = bias_corrected_delta(st, bias_g, bias_a)
    dt = st.dt
    q_j = quat.normalize(quat.mul(q_wb, dq))
    v_j = v_w + gravity_w * dt + quat.rotate(q_wb, dv)
    p_j = p_w + v_w * dt + 0.5 * gravity_w * dt * dt + quat.rotate(q_wb, dp)
    return q_j, v_j, p_j


def imu_residual(st: PreintState, q_i, v_i, p_i, q_j, v_j, p_j, bias_g, bias_a, gravity_w=None):
    """9-D preintegration residual [r_R, r_v, r_p] (Forster eq. 45)."""
    if gravity_w is None:
        gravity_w = gravity(q_i.device)
    dq, dv, dp = bias_corrected_delta(st, bias_g, bias_a)
    dt = st.dt
    qi_inv = quat.conj(q_i)
    r_R = quat.to_axis_angle(quat.mul(quat.conj(dq), quat.mul(qi_inv, q_j)))
    r_v = quat.rotate(qi_inv, v_j - v_i - gravity_w * dt) - dv
    r_p = quat.rotate(qi_inv, p_j - p_i - v_i * dt - 0.5 * gravity_w * dt * dt) - dp
    return torch.cat([r_R, r_v, r_p])


def merge(s1: PreintState, s2: PreintState) -> PreintState:
    """Concatenate two consecutive preintegrations (same bias). Broadcasts
    over a leading batch axis."""
    R1 = quat.to_matrix(s1.dq)
    R2 = quat.to_matrix(s2.dq)
    dt2 = s2.dt[..., None]
    dt2m = s2.dt[..., None, None]

    dq = quat.normalize(quat.mul(s1.dq, s2.dq))
    dv = s1.dv + (R1 @ s2.dv[..., None])[..., 0]
    dp = s1.dp + s1.dv * dt2 + (R1 @ s2.dp[..., None])[..., 0]

    hv = so3.hat(s2.dv)
    hp = so3.hat(s2.dp)
    J_r_bg = _mT(R2) @ s1.J_r_bg + s2.J_r_bg
    J_v_bg = s1.J_v_bg + R1 @ s2.J_v_bg - (R1 @ hv) @ s1.J_r_bg
    J_v_ba = s1.J_v_ba + R1 @ s2.J_v_ba
    J_p_bg = s1.J_p_bg + s1.J_v_bg * dt2m + R1 @ s2.J_p_bg - (R1 @ hp) @ s1.J_r_bg
    J_p_ba = s1.J_p_ba + s1.J_v_ba * dt2m + R1 @ s2.J_p_ba

    lead = R1.shape[:-2]
    I3 = _eye(3, R1).expand(lead + (3, 3))
    A1 = torch.zeros(lead + (15, 15), dtype=R1.dtype, device=R1.device)
    A1[..., 0:3, 0:3] = _mT(R2)
    A1[..., 3:6, 0:3] = -(R1 @ hv)
    A1[..., 3:6, 3:6] = I3
    A1[..., 6:9, 0:3] = -(R1 @ hp)
    A1[..., 6:9, 3:6] = I3 * dt2m
    A1[..., 6:9, 6:9] = I3
    A1[..., 9:15, 9:15] = _eye(6, R1)
    A2 = torch.zeros_like(A1)
    A2[..., 0:3, 0:3] = I3
    A2[..., 3:6, 3:6] = R1
    A2[..., 6:9, 6:9] = R1

    cov = A1 @ s1.cov @ _mT(A1) + A2 @ s2.cov @ _mT(A2)
    cov[..., 9:15, 9:15] = s1.cov[..., 9:15, 9:15] + s2.cov[..., 9:15, 9:15]
    return PreintState(dq=dq, dv=dv, dp=dp, dt=s1.dt + s2.dt, cov=cov,
                       J_r_bg=J_r_bg, J_v_bg=J_v_bg, J_v_ba=J_v_ba,
                       J_p_bg=J_p_bg, J_p_ba=J_p_ba,
                       bias_g=s1.bias_g, bias_a=s1.bias_a)


def _single_step_states(gyro, acc, dts, mask, bias_g, bias_a, noise: ImuNoise):
    """Per-sample atomic PreintStates (batched single-interval integration)."""
    dts = dts * mask.to(torch.float32)
    n = dts.shape[0]
    dev = gyro.device
    w = gyro - bias_g
    a = acc - bias_a
    dt = dts[:, None]
    dtm = dts[:, None, None]
    dt_safe = torch.where(dts > 0, dts, torch.ones_like(dts))
    wdt = w * dt
    dq = quat.from_axis_angle(wdt)
    Jr = so3.right_jacobian(wdt)
    R_mid = so3.exp_matrix(0.5 * wdt)
    Ra_dt = (R_mid @ a[..., None])[..., 0] * dt
    I3 = torch.eye(3, dtype=torch.float32, device=dev).expand(n, 3, 3)

    B = torch.zeros((n, 15, 6), dtype=torch.float32, device=dev)
    B[:, 0:3, 0:3] = Jr * dtm
    B[:, 3:6, 3:6] = I3 * dtm
    B[:, 6:9, 3:6] = 0.5 * I3 * dtm * dtm
    qdiag = torch.tensor([noise.sigma_g**2] * 3 + [noise.sigma_a**2] * 3,
                         dtype=torch.float32, device=dev)
    Q = torch.diag_embed(qdiag / dt_safe[:, None])
    cov = B @ Q @ _mT(B)
    bw = torch.tensor([noise.sigma_bg**2] * 3 + [noise.sigma_ba**2] * 3,
                      dtype=torch.float32, device=dev)
    cov[:, 9:15, 9:15] = cov[:, 9:15, 9:15] + torch.diag_embed(bw) * dtm
    z33 = torch.zeros((n, 3, 3), dtype=torch.float32, device=dev)
    return PreintState(
        dq=dq, dv=Ra_dt, dp=0.5 * Ra_dt * dt, dt=dts, cov=cov,
        J_r_bg=-Jr * dtm, J_v_bg=z33, J_v_ba=-I3 * dtm, J_p_bg=z33.clone(),
        J_p_ba=-0.5 * I3 * dtm * dtm,
        bias_g=bias_g.expand(n, 3), bias_a=bias_a.expand(n, 3),
    )


def integrate_assoc(gyro, acc, dts, mask, bias_g, bias_a, noise: ImuNoise = ImuNoise()):
    """Preintegrate a padded sample window: gyro/acc (N, 3), dts (N,),
    mask (N,) -> PreintState of the whole window."""
    s = _single_step_states(gyro, acc, dts, mask, bias_g, bias_a, noise)
    while s.dt.shape[0] > 1:
        n = s.dt.shape[0]
        m = merge(PreintState(*[f[0: n - 1: 2] for f in s]),
                  PreintState(*[f[1:n:2] for f in s]))
        if n % 2:
            m = PreintState(*[torch.cat([fm, fs[-1:]]) for fm, fs in zip(m, s)])
        s = m
    return PreintState(*[f[0] for f in s])


def pad_imu_window(gyro, acc, dts, n):
    """Right-pad a variable-length host IMU window to the fixed shape:
    (gyro (n,3), acc (n,3), dt (n,), mask (n,)) numpy float32/bool."""
    k = min(len(dts), n)
    g = np.zeros((n, 3), np.float32)
    a = np.zeros((n, 3), np.float32)
    d = np.zeros((n,), np.float32)
    m = np.zeros((n,), bool)
    if k:
        g[:k], a[:k], d[:k], m[:k] = gyro[:k], acc[:k], dts[:k], True
    return g, a, d, m
