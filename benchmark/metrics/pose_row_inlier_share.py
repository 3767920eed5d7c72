"""pose_row_inlier_share (%): the tracking solve's useful rows, Σ
FrameOut.n_inliers over the window frames (the driver's `inliers` counter)
over the rows it solves, frames x `cap.n_feat`. Moves tracked_fps: the
solve's cost is per row, inlier or not. Nothing to read where the driver
keeps no such counter."""


def read(run):
    if "inliers" not in run.counters or not run.frames:
        return None
    return 100.0 * run.counters["inliers"] / (run.frames * run.config["slam"]["cap"]["n_feat"])
