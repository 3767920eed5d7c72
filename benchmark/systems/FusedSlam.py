"""The driver of `FusedSlam` (orbslam3_tpu_torch/models/fused.py): one
session, at the configuration's chunk, fed closed loop
(slambench/systems.py says what a driver does).

The configuration's optional `loop` object switches the loop closer on:

* `vocabulary`: `{"file": "<path from the checkout's root>"}`, read by its
  suffix (`.npz`: loop/vocab.py::load_npz; `.txt`: load_dbow2_text), or
  `{"train": "session", "k": k, "levels": L}`, trained in set-up from the
  first session's own left images as loop/vocab.py::train_world_vocab does
  (world_vocab_corpus, then train_vocabulary);
* `loop_cfg`: LoopConfig fields by name (an unknown name raises);
* `warmup`: FusedSlam's flag: every loop program runs once in set-up.

Without `loop`, FusedSlam is built without a vocabulary.
"""
from __future__ import annotations

import sys
import time

import torch

from orbslam3_tpu_torch.loop import vocab as vb
from orbslam3_tpu_torch.loop.closer import LoopConfig
from orbslam3_tpu_torch.models.fused import FusedSlam
from slambench.manifest import ROOT
from slambench.systems import _kf_rows, _stack, camera, slam_config


def loop_config(d: dict) -> LoopConfig:
    """LoopConfig from the `loop` object's `loop_cfg`: every field by name;
    an unknown name raises."""
    unknown = set(d) - set(LoopConfig._fields)
    if unknown:
        raise KeyError(f"LoopConfig has no field {sorted(unknown)[0]!r}")
    return LoopConfig(**d)


def vocabulary(spec: dict, session, device) -> vb.Vocabulary:
    """The loop closer's vocabulary: read from a file, or trained on the
    session's own left images."""
    if "file" in spec:
        path = ROOT / spec["file"]
        if path.suffix == ".npz":
            return vb.load_npz(str(path))
        if path.suffix == ".txt":
            return vb.load_dbow2_text(str(path))
        raise ValueError(f"a vocabulary file is .npz or .txt, not {path.name}")
    if spec.get("train") != "session":
        raise ValueError(f"unknown vocabulary {spec}")
    t0 = time.perf_counter()
    corpus, doc_ids = vb.world_vocab_corpus(session.frames, device)
    voc = vb.train_vocabulary(corpus, k=spec["k"], levels=spec["levels"], doc_ids=doc_ids)
    print(f"set-up: vocabulary k={spec['k']} L={spec['levels']} trained on {len(corpus)} "
          f"descriptors of {int(doc_ids.max()) + 1} images in {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)
    return voc


class Driver:
    """FusedSlam, one session, at the configuration's chunk; with
    `trace`, the program's span hook on and the driver's own spans
    (`process_frame`, `pose_read`) in the same list."""

    def __init__(self, config: dict, sessions: list, device, trace: bool = False):
        self.cfg = slam_config(config["slam"])
        self.s = sessions[0]
        loop = config.get("loop")
        kw = {}
        if loop is not None:
            kw = dict(vocabulary=vocabulary(loop["vocabulary"], self.s, device),
                      loop_cfg=loop_config(loop.get("loop_cfg", {})),
                      warmup=bool(loop.get("warmup", False)))
        self.slam = FusedSlam(camera(config, self.s.world), self.cfg,
                              service_every=config["service_every"], chunk=config["chunk"],
                              device=device, **kw)
        self.next = 0  # next frame to feed
        self.n_read = 0  # frames whose pose is on the host
        self.called = {}  # frame -> time of its process_frame call
        self.poses = {}  # frame -> (q (4,), p (3,)) as read
        self._seen = 0  # entries of slam.outs read
        self.spans = self.slam.trace_spans(True) if trace else None

    def _stamp(self, name: str, frame: int, t0_ns: int):
        if self.spans is not None:
            self.spans.append((name, frame, t0_ns, time.perf_counter_ns()))

    # ---- the caller's loop
    def remaining(self) -> int:
        return len(self.s.times) - self.next

    def step(self) -> list:
        """Feed one frame; return the frames whose pose reached the host
        with it: [((session, frame), seconds from its call to its pose)]."""
        i = self.next
        self.next += 1
        g, a, d = self.s.imu[i]
        t0 = time.perf_counter_ns()
        self.called[i] = t0
        self.slam.process_frame(self.s.frames[i, 0], self.s.frames[i, 1], g, a, d,
                                float(self.s.times[i]))
        self._stamp("process_frame", i, t0)
        return self._read()

    def _read(self) -> list:
        done = []
        t0 = time.perf_counter_ns()
        for _, out in self.slam.outs[self._seen:]:
            qp = torch.cat((out.q, out.p), dim=-1).cpu().numpy().reshape(-1, 7)
            for row in qp:
                self.poses[self.n_read] = row
                done.append(self.n_read)
                self.n_read += 1
        self._seen = len(self.slam.outs)
        now = time.perf_counter_ns()
        self._stamp("pose_read", self.n_read - 1, t0)
        return [((0, i), 1e-9 * (now - self.called.pop(i))) for i in done]

    def finish(self):
        """Dispatch what is buffered and read it (after the window); with a
        loop closer, end the session as FusedSlam.finalize does: a last
        service round over every keyframe and the closer's in-flight work
        acted on, so that a correction under way when the window closed is
        late, not missing."""
        if self.slam.loop_closer is not None:
            self.slam.finalize()
        else:
            self.slam.flush()
        self._read()

    @property
    def imu_initialized(self) -> bool:
        return self.slam.imu_initialized

    # ---- what the program counts
    def counters(self) -> dict:
        """The step's timers (and the loop closer's `loop.<stage>` ones),
        host syncs, keyframes inserted, Σ FrameOut.n_inliers of the frames
        dispatched, and the loop closer's counts."""
        slam = self.slam
        timing = {k: list(v) for k, v in slam.timing.items()}
        out = {"timing": timing, "host_syncs": slam.host_syncs,
               "keyframes": slam.timing.get("step.kf_insert", [0.0, 0])[1],
               "inliers": int(torch.cat([o.n_inliers.reshape(-1) for _, o in slam.outs]).sum())
               if slam.outs else 0}
        if slam.loop_closer is not None:
            timing.update({k: list(v) for k, v in slam.loop_closer.timing.items()})
            out["loop"] = slam.loop_closer.stats._asdict()
        return out

    # ---- what the check reads, after the window
    def outputs(self) -> dict:
        slam = self.slam
        modes = slam.modes()
        rows = _kf_rows(slam.map)
        return {"sessions": [{"poses": _stack(self.poses, self.n_read),
                              "modes": modes[:self.n_read], "rows": rows}],
                "imu_initialized": slam.imu_initialized,
                "gravity_w": slam.ts.gravity_w.cpu().numpy().astype(float)}

    def close(self):
        self.slam = None
