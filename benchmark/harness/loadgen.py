"""Open-loop load generator for the endpoint, run as a child process of the
benchmark with the standard library alone (no torch), so that its clients
share no interpreter lock with the server:

    python loadgen.py PLAN.json OUT.json

The plan gives the server's port, each request's due offset (s), text and
image (an index into the base64 payloads), the number of client threads and
the seconds to wait for answers after the last due time. The generator
prints ``{"t0": <time.time() of offset 0>}`` on standard output once its
bodies are built, sends every request at its due time whatever is still in
flight, and writes each request's due, sent and done offsets, status and
response body to OUT.json. A request still unanswered at the deadline, or
answered with an error, has ``done`` null or a status other than 200."""

from __future__ import annotations

import http.client
import json
import queue
import sys
import threading
import time


def main(plan_path: str, out_path: str) -> int:
    with open(plan_path) as f:
        plan = json.load(f)
    payloads = plan["payloads"]
    bodies = [json.dumps({"instances": [{"text": t, "image": payloads[i]}]}).encode()
              for t, i in zip(plan["texts"], plan["images"])]
    due = plan["offsets"]
    n = len(bodies)
    sent = [None] * n
    done = [None] * n
    status = [0] * n
    answer = [""] * n
    deadline_s = float(due[-1]) + float(plan["grace_s"]) if n else 0.0
    todo: "queue.Queue[int]" = queue.Queue()
    start = time.perf_counter() + float(plan.get("lead_s", 0.5))
    t0_wall = time.time() + (start - time.perf_counter())

    def client():
        while True:
            i = todo.get()
            if i < 0:
                return
            sent[i] = time.perf_counter() - start
            timeout = max(deadline_s - sent[i], 0.1)
            try:
                conn = http.client.HTTPConnection("127.0.0.1", int(plan["port"]),
                                                  timeout=timeout)
                conn.request("POST", "/invocations", body=bodies[i],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                conn.close()
                status[i] = resp.status
                answer[i] = data.decode("utf-8", "replace")
                done[i] = time.perf_counter() - start
            except (OSError, http.client.HTTPException) as e:
                answer[i] = f"{type(e).__name__}: {e}"

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(int(plan["threads"]))]
    for t in threads:
        t.start()
    print(json.dumps({"t0": t0_wall}), flush=True)
    for i in range(n):
        wait = start + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        todo.put(i)
    for _ in threads:
        todo.put(-1)
    for t in threads:
        t.join(timeout=max(start + deadline_s - time.perf_counter(), 0.0) + 5.0)
    with open(out_path, "w") as f:
        json.dump({"due": due, "sent": sent, "done": done, "status": status,
                   "answer": answer}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
