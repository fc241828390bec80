"""Concurrent serving load test (port of `ecgmm_tpu/tools/serve_hammer.py`).

Hits a running serving endpoint with N client threads posting the same
multipart request for a fixed duration and reports requests/s and
latency percentiles, or, with --soak, also the server's own histogram
percentiles, its error delta and its RSS and device-memory gauges at the
start, middle and end. The request's photo is the committed fixture
`serve/fixtures/strip.jpg`: the JAX hammer's body, the synthetic cohort's
first strip (250x2500) saved as JPEG by Pillow.

    python -m ecgmm_torch.serve.api --synthetic --port 8080 &
    python -m ecgmm_torch.tools.serve_hammer --port 8080 --clients 8 \\
        --seconds 20 --heatmap-format cam
"""

from __future__ import annotations

import argparse
import json
import math
import os
import threading
import time
import urllib.request
from typing import List

from ecgmm_torch.serve.wire import ENDPOINT, encode_multipart

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "serve", "fixtures")
STRIP_JPEG = os.path.join(FIXTURES, "strip.jpg")


def request_body(heatmap_format: str = "png", photo: str = STRIP_JPEG,
                 questionnaire=None):
    """(multipart body, Content-Type) of one upload of `photo`."""
    with open(photo, "rb") as f:
        jpeg = f.read()
    fields = {
        "file": (os.path.basename(photo), jpeg),
        "questionnaire": (None, json.dumps(
            questionnaire or {"age": 66, "weight": 72}).encode()),
    }
    if heatmap_format != "png":
        fields["heatmap_format"] = (None, heatmap_format.encode())
    return encode_multipart(fields)


def _post(url, body, ctype, timeout=600) -> bytes:
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def percentile(sorted_values, p: float) -> float:
    """Nearest rank: the ceil(p * n)-th smallest value."""
    if not sorted_values:
        return 0.0
    n = len(sorted_values)
    return sorted_values[min(n - 1, max(0, math.ceil(p * n) - 1))]


def hammer(url: str, clients: int, seconds: float,
           heatmap_format: str = "png", on_response=None,
           photo: str = STRIP_JPEG) -> dict:
    """`clients` threads post the request (an upload of `photo`) back to
    back for `seconds` (after one warm-up request). on_response(bytes),
    if given, sees every response body (chip_smoke.py checks each against
    the contract)."""
    body, ctype = request_body(heatmap_format, photo)
    latencies: List[float] = []
    errors = [0]
    lock = threading.Lock()
    stop_at = [0.0]

    def worker():
        while time.perf_counter() < stop_at[0]:
            t0 = time.perf_counter()
            try:
                out = _post(url, body, ctype)
                dt = time.perf_counter() - t0
                if on_response is not None:
                    on_response(out)
                with lock:
                    latencies.append(dt)
            except Exception:  # counted; the load goes on
                with lock:
                    errors[0] += 1

    _post(url, body, ctype)  # warm-up, outside the timed window
    stop_at[0] = time.perf_counter() + seconds
    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    lat = sorted(latencies)
    return {
        "clients": clients,
        "heatmap_format": heatmap_format,
        "requests": len(lat),
        "errors": errors[0],
        "seconds": wall,
        "req_per_sec": len(lat) / wall,
        "latency_median_ms": percentile(lat, 0.5) * 1e3,
        "latency_p90_ms": percentile(lat, 0.9) * 1e3,
        "latency_p99_ms": percentile(lat, 0.99) * 1e3,
    }


# -- sustained soak ---------------------------------------------------------

def _scrape_metrics(base_url: str) -> dict:
    """The server's /metrics exposition as a flat dict: counters and
    gauges by name, histogram buckets as {'bucket_<le>': cumulative}."""
    with urllib.request.urlopen(base_url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, _, value = line.rpartition(" ")
        if "_bucket{le=" in name:
            le = name.split('le="')[1].split('"')[0]
            out[f"bucket_{le}"] = float(value)
        else:
            out[name] = float(value)
    return out


def _hist_percentile(m0: dict, m1: dict, q: float) -> float:
    """q-quantile (seconds) of the latency histogram's change between two
    scrapes, linearly interpolated within the bucket."""
    les, counts = [], []
    for k, v1 in m1.items():
        if k.startswith("bucket_"):
            le = k[len("bucket_"):]
            les.append(float("inf") if le == "+Inf" else float(le))
            counts.append(v1 - m0.get(k, 0.0))
    order = sorted(range(len(les)), key=lambda i: les[i])
    les = [les[i] for i in order]
    counts = [counts[i] for i in order]  # cumulative
    total = counts[-1]
    if total <= 0:
        return 0.0
    target = q * total
    prev_le, prev_c = 0.0, 0.0
    for le, c in zip(les, counts):
        if c >= target:
            if le == float("inf"):
                return prev_le
            span = c - prev_c
            frac = (target - prev_c) / span if span > 0 else 1.0
            return prev_le + frac * (le - prev_le)
        prev_le, prev_c = le, c
    return les[-2] if len(les) > 1 else 0.0


def soak(base_url: str, url: str, clients: int, seconds: float,
         heatmap_format: str = "png", min_requests: int = 0) -> dict:
    """Sustained load: hammer for `seconds` (extended until `min_requests`
    have completed), scraping /metrics at the start, the midpoint and the
    end. Reports the server histogram's p50/p90/p99 over the soak, the
    client-side percentiles, the server's error delta and the RSS and
    device-memory gauges at the three scrapes."""
    m_start = _scrape_metrics(base_url)
    mid: dict = {}
    timer = threading.Timer(seconds / 2,
                            lambda: mid.update(_scrape_metrics(base_url)))
    timer.daemon = True
    timer.start()
    res = hammer(url, clients, seconds, heatmap_format)
    while res["requests"] < min_requests:
        extra = hammer(url, clients, seconds / 4, heatmap_format)
        for k in ("requests", "errors"):
            res[k] += extra[k]
    timer.cancel()
    m_end = _scrape_metrics(base_url)

    def tri(key):
        return [m.get(key) for m in (m_start, mid, m_end)]

    return {
        **res,
        "soak_seconds": seconds,
        "server_hist_p50_ms": 1e3 * _hist_percentile(m_start, m_end, 0.5),
        "server_hist_p90_ms": 1e3 * _hist_percentile(m_start, m_end, 0.9),
        "server_hist_p99_ms": 1e3 * _hist_percentile(m_start, m_end, 0.99),
        "server_errors_delta": (
            m_end.get("ecgmm_request_errors_total", 0)
            - m_start.get("ecgmm_request_errors_total", 0)
        ),
        "rss_bytes_start_mid_end": tri("ecgmm_process_rss_bytes"),
        "live_buffer_bytes_start_mid_end": tri("ecgmm_live_buffer_bytes"),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--heatmap-format", default="png", choices=("png", "cam"))
    p.add_argument("--photo", default=STRIP_JPEG,
                   help="hammer only, not --soak: the uploaded file "
                        "(default the JPEG strip; "
                        "serve/fixtures/strip_q80.webp is the same strip "
                        "as WebP)")
    p.add_argument("--soak", action="store_true",
                   help="scrape /metrics at start/mid/end and report the "
                        "server histogram's percentiles, the error delta "
                        "and the memory gauges")
    p.add_argument("--min-requests", type=int, default=0,
                   help="soak only: keep hammering until at least this "
                        "many requests completed")
    args = p.parse_args(argv)
    base = f"http://{args.host}:{args.port}"
    url = base + ENDPOINT
    if args.soak:
        out = soak(base, url, args.clients, args.seconds,
                   args.heatmap_format, args.min_requests)
    else:
        out = hammer(url, args.clients, args.seconds, args.heatmap_format,
                     photo=args.photo)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
