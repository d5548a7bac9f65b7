"""Live scene viewer node — the rviz role, headless.

Copy of ``trajectory_optimization_tpu/bus/viewer.py``.

The reference's primary observability is rviz subscribed to the live graph
(`launch/pointcloud_processor.launch:20`, the seven curated view configs in
`config/*.rviz`): you watch the rewards cloud recolor and the optimized
path move while the optimizer runs. Accelerator hosts are headless, so this node
serves the same live view over HTTP instead of a GL window:

- subscribe to the cloud, rewards-cloud and path topics on the scene bus;
- render the orbiting 3D scene (cloud colored by the reward channel,
  initial vs optimized trajectories) with matplotlib/Agg ON DEMAND;
- let any browser poll ``http://host:port/`` — the served page re-fetches
  the PNG whenever the scene sequence number advances and exposes
  elevation/azimuth sliders, so orbiting the camera works like rviz's.

Renders are cached per (scene seq, view angles): an idle scene costs zero
CPU no matter how many browsers poll, and a busy scene renders at most
once per new message per viewpoint. The node is bus-native — it works
identically under live optimization (`launch_*` presets with
``viewer=True``), bag replay (`launch_play_bag`), and cross-process graphs
(the broker bridges the topics to it like any other node).
"""
from __future__ import annotations

import dataclasses
import io
import json
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from trajectory_optimization_tpu_torch.bus.core import Bus
from trajectory_optimization_tpu_torch.utils.config import ViewerConfig

__all__ = ["ViewerNode"]

_PAGE = """<!doctype html>
<html><head><title>{title}</title>
<style>
 body {{ font-family: sans-serif; background: #111; color: #ddd;
        margin: 1em; }}
 img {{ max-width: 100%; border: 1px solid #333; }}
 .bar {{ margin: 0.5em 0; }}
 label {{ margin-right: 1.5em; }}
</style></head>
<body>
<h3>{title}</h3>
<div class="bar">
 <label>elev <input id="elev" type="range" min="-90" max="90"
   value="35"></label>
 <label>azim <input id="azim" type="range" min="-180" max="180"
   value="-60"></label>
 <span id="stat"></span>
</div>
<img id="scene" src="/scene.png">
<script>
let seq = -1;
function refresh(force) {{
  const e = document.getElementById('elev').value;
  const a = document.getElementById('azim').value;
  fetch('/state.json').then(r => r.json()).then(s => {{
    document.getElementById('stat').textContent =
      'seq ' + s.seq + ' | ' + JSON.stringify(s.counts);
    if (force || s.seq !== seq) {{
      seq = s.seq;
      document.getElementById('scene').src =
        '/scene.png?elev=' + e + '&azim=' + a + '&seq=' + seq;
    }}
  }});
}}
document.getElementById('elev').oninput = () => refresh(true);
document.getElementById('azim').oninput = () => refresh(true);
setInterval(() => refresh(false), 700);
</script>
</body></html>
"""


class ViewerNode:
    """Subscribe to the scene topics and serve a live rendered view.

    Topics (all optional — renders whatever has arrived):
      - ``cfg.pc_topic``: the raw cloud (CloudMsg);
      - ``cfg.pc_topic + "/rewards"``: the optimizer's rewards cloud
        (CloudMsg with a 4th intensity column — colors the scatter);
      - ``cfg.path_topic``: the input path (PathMsg);
      - ``cfg.path_topic + "/optimized"``: the optimizer's output path.
    """

    def __init__(self, bus: Bus, cfg: ViewerConfig = ViewerConfig()):
        self.bus = bus
        self.cfg = cfg
        self._state: Dict[str, object] = {}
        self._counts: Dict[str, int] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self._render_lock = threading.Lock()
        self._cache: Tuple[Optional[Tuple], Optional[bytes]] = (None, None)
        self._subs = []
        for role, topic in (
            ("cloud", cfg.pc_topic),
            ("rewards", cfg.pc_topic + "/rewards"),
            ("path", cfg.path_topic),
            ("optimized", cfg.path_topic + "/optimized"),
        ):
            self._subs.append(
                bus.subscribe(topic, self._make_cb(role), queue_size=1))
        self._httpd = None
        self._http_thread = None
        if cfg.port is not None:
            self._serve(cfg.host, cfg.port)

    # ------------------------------------------------------------------ bus

    def _make_cb(self, role: str):
        def cb(msg):
            with self._lock:
                self._state[role] = msg
                self._counts[role] = self._counts.get(role, 0) + 1
                self._seq += 1

        return cb

    # -------------------------------------------------------------- render

    def render_png(self, elev: float = 35.0, azim: float = -60.0) -> bytes:
        """Render the current scene to PNG bytes (cached per seq+view)."""
        with self._lock:
            key = (self._seq, round(float(elev), 1), round(float(azim), 1))
            state = dict(self._state)
        with self._render_lock:
            ckey, cpng = self._cache
            if ckey == key and cpng is not None:
                return cpng
            png = self._render(state, key[1], key[2])
            self._cache = (key, png)
            return png

    def _render(self, state, elev, azim) -> bytes:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(9.6, 7.2))
        ax = fig.add_subplot(111, projection="3d")
        cloud = state.get("rewards") or state.get("cloud")
        if cloud is not None:
            pts = np.asarray(cloud.points)
            step = max(len(pts) // self.cfg.max_points, 1)
            sub = pts[::step]
            c = sub[:, 3] if sub.shape[1] >= 4 else None
            sc = ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=1, c=c,
                            cmap="viridis")
            if c is not None:
                fig.colorbar(sc, ax=ax, shrink=0.6, label="reward")
        for role, style, label in (("path", "r--", "input path"),
                                   ("optimized", "g-", "optimized")):
            msg = state.get(role)
            if msg is not None:
                p = np.asarray(msg.positions)
                ax.plot(p[:, 0], p[:, 1], p[:, 2], style, label=label,
                        linewidth=2)
        if state.get("path") is not None or state.get("optimized") is not None:
            ax.legend(loc="upper right")
        if not state:
            ax.text2D(0.5, 0.5, "waiting for messages…",
                      transform=ax.transAxes, ha="center")
        ax.view_init(elev=elev, azim=azim)
        ax.set_xlabel("x [m]"), ax.set_ylabel("y [m]"), ax.set_zlabel("z [m]")
        fig.tight_layout()
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=85)
        plt.close(fig)
        return buf.getvalue()

    # ---------------------------------------------------------------- http

    def _serve(self, host: str, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        node = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep the bus process quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    u = urlparse(self.path)
                    if u.path == "/":
                        self._send(200, "text/html", _PAGE.format(
                            title=node.cfg.title).encode())
                    elif u.path == "/scene.png":
                        q = parse_qs(u.query)
                        elev = float(q.get("elev", ["35"])[0])
                        azim = float(q.get("azim", ["-60"])[0])
                        self._send(200, "image/png",
                                   node.render_png(elev, azim))
                    elif u.path == "/state.json":
                        with node._lock:
                            body = json.dumps({
                                "seq": node._seq,
                                "counts": node._counts,
                            }).encode()
                        self._send(200, "application/json", body)
                    else:
                        self._send(404, "text/plain", b"not found")
                except BrokenPipeError:
                    pass  # browser navigated away mid-response

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="viewer-http")
        self._http_thread.start()

    @property
    def url(self) -> str:
        if self._httpd is None:
            return ""
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for s in self._subs:
            try:
                s.unsubscribe()
            except AttributeError:
                pass
        self._subs = []
