"""Live map/trajectory viewer: an in-process HTTP server the browser polls.

Host copy of orbslam3_tpu/viz/live.py over the port's html_view: a
dependency-free standard-library server. The run loop calls
``LiveViewer.publish(map_state, traj, gt)`` every few service rounds (one
throttled read of the device, never one a frame, which would hold the
pipeline at every frame), and any browser pointed at the printed URL
renders the growing map with the canvas renderer of the offline HTML
export.

Usage:
    from orbslam3_tpu_torch.viz.live import LiveViewer
    viewer = LiveViewer()              # prints http://127.0.0.1:<port>
    ...
    viewer.publish(slam.map, traj_ps, gt_ps)   # every N frames
    viewer.close()
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from orbslam3_tpu_torch.viz.html_view import render_page, snapshot_data

_EMPTY = dict(points=[], kf=[], traj=[], gt=[])


class LiveViewer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 poll_ms: int = 1000, max_points: int = 20000,
                 min_interval_s: float = 0.5):
        self._max_points = max_points
        self._min_interval = min_interval_s
        self._last_pub = 0.0
        self._state_json = json.dumps(_EMPTY).encode()
        self._page = render_page(_EMPTY, poll_ms=poll_ms).encode()
        self.n_published = 0
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path.split("?")[0] == "/state.json":
                    body, ctype = viewer._state_json, "application/json"
                elif self.path.split("?")[0] == "/":
                    body, ctype = viewer._page, "text/html; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="orbslam3-live-viewer",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def publish(self, map_state=None, traj=None, gt=None,
                force: bool = False) -> bool:
        """Snapshot current state for the browser; returns False when
        throttled (closer together than min_interval_s)."""
        now = time.monotonic()
        if not force and now - self._last_pub < self._min_interval:
            return False
        self._last_pub = now
        data = snapshot_data(map_state, traj, gt, self._max_points)
        # bytes assignment is atomic; in-flight requests serve the old blob
        self._state_json = json.dumps(data).encode()
        self.n_published += 1
        return True

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
