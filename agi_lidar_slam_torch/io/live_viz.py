"""Live SLAM visualization stream — the rviz analog (a copy of
agi_lidar_slam_tpu/io/live_viz.py; numpy and the standard library only).

Every reference launch file starts rviz next to the engine (A-LOAM
aloam_velodyne_HDL_64.launch:20-23, LIO-SAM launch/include/module_rviz.launch)
to show the registered cloud, the trajectory and TF. The analog here is a
zero-dependency in-process HTTP streamer:

* `VizServer` runs a stdlib `http.server` on a background thread, bound to
  127.0.0.1 unless the caller names another host (the feed has no
  authentication, so it is not exposed to other machines by default);
* the engine loop calls `publish(pose, points)` after each scan — host
  numpy only, decimated;
* browsers connect to `/` for an embedded canvas viewer (top-down world
  view: trajectory polyline + accumulating map scatter, pan/zoom, no
  external assets) and `/stream` for the raw Server-Sent-Events JSON feed
  (one `data:` line per scan).

Wired via the runner's `--live-viz PORT`.
"""

from __future__ import annotations

import http.server
import json
import socketserver
import threading
from collections import deque
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>agi_lidar_slam_torch live</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:12px monospace; }
 #hud { position:fixed; top:8px; left:8px; }
 canvas { display:block; }
</style></head>
<body>
<div id="hud">connecting…</div><canvas id="c"></canvas>
<script>
const cv = document.getElementById('c'), hud = document.getElementById('hud');
const ctx = cv.getContext('2d');
let pts = [], traj = [], scale = 8, cx = 0, cy = 0, drag = null, n = 0;
function resize(){ cv.width = innerWidth; cv.height = innerHeight; draw(); }
addEventListener('resize', resize);
cv.addEventListener('wheel', e => { scale *= Math.exp(-e.deltaY * 0.001); draw(); });
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  cx -= (e.clientX - drag[0]) / scale; cy += (e.clientY - drag[1]) / scale;
  drag = [e.clientX, e.clientY]; draw();
});
function sx(x){ return cv.width/2 + (x - cx) * scale; }
function sy(y){ return cv.height/2 - (y - cy) * scale; }
function draw(){
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  ctx.fillStyle = '#4b8';
  for (const p of pts) ctx.fillRect(sx(p[0]), sy(p[1]), 1.5, 1.5);
  ctx.strokeStyle = '#fa0'; ctx.lineWidth = 2; ctx.beginPath();
  traj.forEach((p, i) => i ? ctx.lineTo(sx(p[0]), sy(p[1]))
                           : ctx.moveTo(sx(p[0]), sy(p[1])));
  ctx.stroke();
  if (traj.length) {
    const p = traj[traj.length - 1];
    ctx.fillStyle = '#f44';
    ctx.beginPath(); ctx.arc(sx(p[0]), sy(p[1]), 4, 0, 7); ctx.fill();
  }
}
const es = new EventSource('/stream');
es.onmessage = ev => {
  const m = JSON.parse(ev.data);
  traj.push(m.pose_t); n++;
  if (m.points) for (const p of m.points) pts.push(p);
  if (pts.length > 400000) pts = pts.slice(pts.length - 400000);
  const p = m.pose_t;
  hud.textContent = `scan ${n}  pose (${p[0].toFixed(2)}, ${p[1].toFixed(2)}, ` +
                    `${p[2].toFixed(2)})  map pts ${pts.length}`;
  if (n === 1) { cx = p[0]; cy = p[1]; }
  draw();
};
es.onerror = () => hud.textContent = 'stream closed';
resize();
</script></body></html>
"""


class VizServer:
    """In-process live viewer. `start()` binds the port; `publish()` is
    called from the engine loop; `stop()` shuts the server down."""

    def __init__(self, port: int = 8333, history: int = 4096,
                 max_points_per_scan: int = 1500, host: str = "127.0.0.1"):
        self.host = host
        self.port = port
        self.max_points = max_points_per_scan
        self._frames: deque = deque(maxlen=history)
        self._cond = threading.Condition()
        self._seq = 0
        self._httpd: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- engine
    def publish(self, pose_t, pose_q=None, points=None) -> None:
        """Queue one scan's pose (3,) [+ quaternion wxyz (4,)] and optional
        (N,3) world-frame points (decimated to max_points_per_scan)."""
        msg = {"pose_t": np.asarray(pose_t, np.float64).round(3).tolist()}
        if pose_q is not None:
            msg["pose_q"] = np.asarray(pose_q, np.float64).round(4).tolist()
        if points is not None:
            p = np.asarray(points, np.float64)
            if len(p) > self.max_points:
                p = p[:: max(1, len(p) // self.max_points)][: self.max_points]
            msg["points"] = p[:, :3].round(2).tolist()
        with self._cond:
            self._seq += 1
            self._frames.append((self._seq, json.dumps(msg)))
            self._cond.notify_all()

    # ---------------------------------------------------------------- server
    def start(self) -> "VizServer":
        viz = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    last = 0
                    try:
                        while True:
                            with viz._cond:
                                viz._cond.wait_for(
                                    lambda: viz._seq > last or viz._httpd is None,
                                    timeout=1.0)
                                if viz._httpd is None:
                                    return
                                fresh = [(s, m) for s, m in viz._frames
                                         if s > last]
                            for s, m in fresh:
                                self.wfile.write(f"data: {m}\n\n".encode())
                                last = s
                            if fresh:
                                self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._httpd = Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        with self._cond:
            self._cond.notify_all()  # release waiting stream handlers
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
