"""Faults planted in the program's timed path, to read the check's numbers
on a broken run: `python3 benchmark/run.py ... --fault <name>` and the CPU
tests. Never part of a measurement.

Each fault wraps one function of the program, the way a faulty version of
it would behave. `arm(name)` plants it and returns the function that takes
it out again. A fault is armed when its `when` says: "start" before the
entry point is built, "window" as the measured window opens (after the
warm-up, so a cell whose set-up needs the healthy program still reaches
its window).

* state_unchanged: the step computes its answer but returns the map and
  the tracker's state as they came in;
* half_features: half of each image's feature slots are left out of the
  front end's output;
* answer_altered: every fifth answer's position, from the first after the
  fault is armed, is moved by 1 m where the step produces it (the state is
  untouched);
* gravity_dropped: the IMU initialization (and each refinement) solves
  as usual, but the gravity it hands back is the tracker's value from
  before it, (0, 0, -9.81) in the map's frame;
* ba_wrong_baseline: the keyframe branch's bundle adjustments (local and
  visual-inertial) see a stereo baseline 25% too long, so they move the
  map's points 25% deeper than their disparities say;
* loop_not_applied: the loop closer's correction (LoopCloser._correct:
  pose graph, map points, seam fusion, global BA, inertial refinement)
  runs, and hands back the map it was given, so the loop is counted as
  closed and the drift stays (kf_ate_m's fault).
"""
from __future__ import annotations

import torch


def _state_unchanged(real):
    def step(st, ts, *a, **k):
        _, _, out, flags = real(st, ts, *a, **k)
        return st, ts, out, flags
    return step


def _half_features(real):
    def fe(lefts, rights, cam, cfg):
        featL, *rest = real(lefts, rights, cam, cfg)
        n = featL.valid.shape[-1]
        keep = torch.arange(n, device=featL.valid.device) < n // 2
        return (featL._replace(valid=featL.valid & keep), *rest)
    return fe


def _answer_altered(real):
    calls = [0]

    def step(*a, **k):
        st, ts, out, flags = real(*a, **k)
        calls[0] += 1
        if calls[0] % 5 == 1:
            out = out._replace(p=out.p + 1.0)
        return st, ts, out, flags
    return step


def _gravity_dropped(real):
    def init(*a, **k):
        res = real(*a, **k)
        g = torch.tensor([0.0, 0.0, -9.81], dtype=res.gravity_w.dtype,
                         device=res.gravity_w.device)
        return res._replace(gravity_w=g)
    return init


def _ba_wrong_baseline(real):
    def solve(prob, cam, *a, **k):
        return real(prob, cam._replace(bf=cam.bf * 1.25), *a, **k)
    return solve


def _loop_not_applied(real):
    def correct(self, st, *a, **k):
        real(self, st, *a, **k)
        return st
    return correct


FUSED = "orbslam3_tpu_torch.models.fused"
CLOSER = "orbslam3_tpu_torch.loop.closer"

# name -> (when, [(module, attribute, wrapper)]); an attribute may be a
# class's method, "Class.method"
FAULTS = {
    "state_unchanged": ("window", [(FUSED, "_slam_step_core", _state_unchanged)]),
    "half_features": ("start", [(FUSED, "_frontend_chunk", _half_features)]),
    "answer_altered": ("window", [(FUSED, "_slam_step_core", _answer_altered)]),
    "gravity_dropped": ("start", [(FUSED, "inertial_init", _gravity_dropped)]),
    "ba_wrong_baseline": ("start", [(FUSED, "solve_local_ba", _ba_wrong_baseline),
                                    (FUSED, "solve_vi_ba", _ba_wrong_baseline)]),
    "loop_not_applied": ("window", [(CLOSER, "LoopCloser._correct", _loop_not_applied)]),
}


def when(name: str) -> str:
    return FAULTS[name][0]


def target(mod_name: str, path: str):
    """(the module or class that holds what a fault wraps, its name)."""
    import importlib

    owner = importlib.import_module(mod_name)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


def arm(name: str):
    """Plant the fault; returns the function that takes it out."""
    undo = []
    for mod_name, path, wrap in FAULTS[name][1]:
        owner, attr = target(mod_name, path)
        real = getattr(owner, attr)
        setattr(owner, attr, wrap(real))
        undo.append((owner, attr, real))

    def disarm():
        for owner, attr, real in reversed(undo):
            setattr(owner, attr, real)
    return disarm
