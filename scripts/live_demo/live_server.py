#!/usr/bin/env python3
"""Live view of a running noise acquisition
(reference scripts/live_demo/: websocket live-view fed by Get_noise's
push_queue).

Pure-stdlib implementation: an HTTP server serves index.html and a
Server-Sent-Events stream of per-channel magnitudes while Get_noise runs in
a background thread pushing packets into a queue.
"""

import argparse
import http.server
import json
import os
import queue
import sys
import threading

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
import gpu_sdr.pyusrp as u  # noqa: E402

DATA_QUEUE: "queue.Queue" = queue.Queue()
HERE = os.path.dirname(os.path.abspath(__file__))


class Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            with open(os.path.join(HERE, "index.html"), "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/stream":
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                while True:
                    try:
                        meta, data = DATA_QUEUE.get(timeout=1.0)
                    except queue.Empty:
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                        continue
                    ch = max(1, meta.channels)
                    rows = len(data) // ch
                    mags = np.abs(
                        data[:rows * ch].reshape(rows, ch)).mean(axis=0)
                    msg = json.dumps({
                        "packet": meta.packet_number,
                        "mags": [float(m) for m in mags]})
                    self.wfile.write(f"data: {msg}\n\n".encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                return
        else:
            self.send_error(404)


def main():
    parser = argparse.ArgumentParser(description="Live noise viewer.")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--rate", "-r", type=float, default=1)
    parser.add_argument("--tones", "-T", nargs="+", default=["0.1", "0.2"])
    parser.add_argument("--time", "-t", type=float, default=30)
    parser.add_argument("--decimation", "-d", type=int, default=100)
    args = parser.parse_args()

    class Q:  # adapt engine (meta, (rows, ch)) packets to the SSE thread
        def put(self, item):
            meta, data = item
            DATA_QUEUE.put((meta, np.asarray(data).reshape(-1)))

    def acquire():
        u.Connect()
        u.Get_noise([float(t) * 1e6 for t in args.tones],
                    measure_t=args.time, rate=args.rate * 1e6,
                    decimation=args.decimation, RF=0,
                    output_filename="live_noise", push_queue=Q())

    threading.Thread(target=acquire, daemon=True).start()
    srv = http.server.ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    print(f"live view on http://localhost:{args.port}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
