"""Nearest-neighbors HTTP server.

Reference capability: deeplearning4j-nearestneighbors-parent's
nearestneighbor-server module (SURVEY.md §2.7 — "VPTree search + a small
REST server module"). A stdlib ThreadingHTTPServer replaces the
reference's Play/vertx stack; endpoints mirror the reference's JSON API:

    POST /knn      {"ndarray": [...point...], "k": 5}
    POST /knnnew   {"ndarray": [...new point...], "k": 5}  (same here:
                   the reference distinguishes indexed vs new points)
    GET  /status

Counterpart of ``deeplearning4j_tpu/clustering/server.py`` over the
port's VPTree (host numpy; the same answers, the same JSON).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def _json(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.server.nn
        if self.path == "/status":
            self._json(200, {"status": "ok",
                             "numPoints": int(srv.points.shape[0]),
                             "dim": int(srv.points.shape[1])})
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        srv = self.server.nn
        if self.path not in ("/knn", "/knnnew"):
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            k = int(req.get("k", 1))
            point = np.asarray(req["ndarray"], np.float32)
            results = srv.query(point, k)
            self._json(200, {"results": results})
        except Exception as e:  # noqa: BLE001 — surface as JSON error
            self._json(400, {"error": str(e)})


class NearestNeighborsServer:
    """Serve k-NN queries over a VPTree-indexed point set."""

    def __init__(self, points, labels=None, distance="euclidean"):
        from deeplearning4j_tpu_torch.clustering.vptree import VPTree

        self.points = np.asarray(points, np.float32)
        self.labels = list(labels) if labels is not None else None
        self.tree = VPTree(self.points, distance=distance)
        self._httpd = None
        self._thread = None
        self.port = None

    def query(self, point, k):
        idxs, dists = self.tree.search(point, k)
        out = []
        for i, d in zip(idxs, dists):
            row = {"index": int(i), "distance": float(d)}
            if self.labels is not None:
                row["label"] = self.labels[int(i)]
            out.append(row)
        return out

    def start(self, port=9200):
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.nn = self
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="dl4j:serving:clustering")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            # serve_forever returns after shutdown(); join so stop()
            # means stopped and worker errors can't outlive the server
            if self._thread is not None:
                self._thread.join(timeout=5.0)
            self._thread = None
        return self
