"""The open-loop client of the served cells, run in a process of its own
so that it shares no interpreter with the service.

It reads one JSON object on stdin: `url`, `timeout_s` and `requests`, a
list of {"id", "due_s", "path", "payload"}; starts its clock; sends each
request from a thread of its own at its due time, whatever is still in
flight (an open loop); and writes one JSON object on stdout: per request
its due, sent and done times from the clock's start, the HTTP status (0
when the request failed without one) and the response body in base64.

The request building follows the port's `tools/bench_serving.py::_post`:
a JSON body with `Content-Type: application/json` to POST /generate on
the service's socket."""

from __future__ import annotations

import base64
import json
import sys
import threading
import time
import urllib.error
import urllib.request


def _post(url: str, path: str, payload: dict, timeout: float) -> tuple:
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""
    except (urllib.error.URLError, OSError):
        return 0, b""


def main() -> int:
    spec = json.loads(sys.stdin.read())
    url, timeout = spec["url"], float(spec["timeout_s"])
    out = []
    lock = threading.Lock()
    t0 = time.perf_counter()

    def send(req: dict) -> None:
        sent = time.perf_counter() - t0
        status, body = _post(url, req["path"], req["payload"], timeout)
        done = time.perf_counter() - t0
        with lock:
            out.append({"id": req["id"], "due_s": req["due_s"],
                        "sent_s": sent, "done_s": done, "status": status,
                        "body": base64.b64encode(body).decode()})

    threads = []
    for req in sorted(spec["requests"], key=lambda q: q["due_s"]):
        wait = req["due_s"] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=send, args=(req,), daemon=True)
        th.start()
        threads.append(th)
    deadline = time.perf_counter() + timeout
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    with lock:
        json.dump({"results": list(out)}, sys.stdout)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
