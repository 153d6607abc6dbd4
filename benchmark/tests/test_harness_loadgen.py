"""The load generator is an open loop that times each request from when it
was due: behind a server that answers one request at a time, the queue's
wait is in the latency, the send times stay on schedule, and an unanswered
request is missing."""

import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from harness_util import ROOT
from benchmark.harness import serve

LOADGEN = os.path.join(ROOT, "benchmark", "harness", "loadgen.py")


class _Slow(BaseHTTPRequestHandler):
    delay = 0.05

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(self.delay)
        body = json.dumps({"predictions": [{"probabilities": {"a": 0.5}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _drive(tmp, offsets, port, grace=5.0):
    plan = {"port": port, "offsets": offsets, "texts": ["x"] * len(offsets),
            "images": [0] * len(offsets), "payloads": ["AA=="], "threads": 16,
            "grace_s": grace, "lead_s": 0.2}
    p, o = os.path.join(tmp, "plan.json"), os.path.join(tmp, "out.json")
    json.dump(plan, open(p, "w"))
    proc = subprocess.run([sys.executable, LOADGEN, p, o], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "t0" in json.loads(proc.stdout.splitlines()[0])
    return json.load(open(o))


def test_latency_counts_the_queue(tmp_path):
    srv = HTTPServer(("127.0.0.1", 0), _Slow)  # one request at a time
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        # 10 requests due together: the k-th waits for k earlier ones
        t = _drive(str(tmp_path), [0.0] * 10, srv.server_address[1])
    finally:
        srv.shutdown()
        srv.server_close()
    lat = serve.latencies_ms(t, 5.0)
    sent_late = np.asarray(t["sent"]) - np.asarray(t["due"])
    assert sent_late.max() < 0.1  # sent on time, whatever is in flight
    assert sorted(lat)[-1] >= 10 * 50 * 0.9  # the last waited for the other nine
    assert serve.p95(lat) == sorted(lat)[9]


def test_unanswered_is_missing(tmp_path):
    t = _drive(str(tmp_path), [0.0, 0.1], port=9, grace=0.5)  # nothing listens
    assert t["done"] == [None, None] and t["status"] == [0, 0]
    lat = serve.latencies_ms(t, 0.5)
    assert (lat >= 0.4 * 1e3).all()
    assert np.isnan(serve.probabilities(t, ["a"])).all()
