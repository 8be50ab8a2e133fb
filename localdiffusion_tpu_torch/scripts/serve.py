"""HTTP serving entry: the dynamic-batching translation service.  Port of
`scripts/serve.py`.

    python -m localdiffusion_tpu_torch.scripts.serve --config mri256_bf16 \
        --params-npz results/mri_synth256_ema.npz [--detector patchcore|seg|manual|none] \
        [--host 127.0.0.1] [--port 8800] [--batch-size 8] [--max-wait-ms 50] \
        [--dtype float32|bfloat16] [--device cpu]

Protocol (stdlib HTTP, JSON bodies), the JAX script's:
  POST /v1/translate   {"image": nested list, H x W or H x W x C,
                        "mask": optional, H x W or H x W x 1}
                     → {"pred": [...], "branched": bool, "latency_s": f}
                       or 400 {"error": "..."}
  GET  /healthz        → {"ok": true}
  GET  /stats          → the server's counters (batches, fill, latencies)
  anything else        → 404 {"error": "not found"}

`--config` names a builder of `config.CONFIGS` or a `.json`/`.yaml` file
(`config.load_config`) and takes the test CLI's overrides (`--detector`,
`--memory-bank`, `--feature-source`, ...).  The weights are a slim npz,
`--params-npz`, required: the JAX script's `--milestone` (an Orbax
directory) and `--allow-random-init` (serve random weights when none
load) are not carried, since the port reads npz snapshots only and has no
random-init route (`factory.load_params`).  Before it binds, the server
runs each chain once (`InferenceServer.start(warmup=True)`); `--port 0`
binds a free port, and the bound address is printed.
"""

from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from localdiffusion_tpu_torch.factory import build_pipeline
from localdiffusion_tpu_torch.scripts.test import add_config_args, configure
from localdiffusion_tpu_torch.serving import InferenceServer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(ap, config_default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8800, help="0 binds a free port")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_handler(server, channels):
    """The request handler over `server` (`submit`, `snapshot_stats`) for
    images of `channels` channels."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet access log
            pass

        def do_GET(self):
            if self.path == "/healthz":
                return self._send(200, {"ok": True})
            if self.path == "/stats":
                return self._send(200, server.snapshot_stats())
            return self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/translate":
                return self._send(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                img = np.asarray(req["image"], np.float32)
                if img.ndim == 2:
                    img = img[..., None]
                if img.shape[-1] != channels:
                    raise ValueError(f"expected {channels} channel(s), got {img.shape}")
                mask = req.get("mask")
                if mask is not None:
                    mask = np.asarray(mask, np.float32)
                    if mask.ndim == 2:
                        mask = mask[..., None]
                out = server.submit(img, mask=mask).result(timeout=600)
                return self._send(200, {
                    "pred": np.asarray(out["pred"], np.float32).tolist(),
                    "branched": out["branched"],
                    "latency_s": out["latency_s"],
                })
            except Exception as e:  # the request's fault or the chain's: the client hears it
                return self._send(400, {"error": str(e)})

    return Handler


def build_server(args):
    """(HTTP server bound to `args.host`:`args.port`, the started and warmed
    `InferenceServer`): the pipeline of `args` (`configure` then
    `factory.build_pipeline`), warmed up before the socket is bound.  The
    caller runs `serve_forever` and, at the end, `shutdown`,
    `server_close` and the server's `stop`."""
    pipe = build_pipeline(configure(args), args.params_npz, device=args.device)
    srv = InferenceServer(pipe, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms)
    print("warming up the serving chains...", flush=True)
    t0 = time.perf_counter()
    srv.start(warmup=True)
    print(f"warm-up {time.perf_counter() - t0:.2f}s", flush=True)
    try:
        httpd = ThreadingHTTPServer((args.host, args.port),
                                    make_handler(srv, pipe.gd.model_cfg.channels))
    except OSError:
        srv.stop()
        raise
    return httpd, srv


def main(argv=None) -> None:
    args = parse_args(argv)
    httpd, srv = build_server(args)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} "
          f"(batch {args.batch_size}, wait {args.max_wait_ms} ms)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


if __name__ == "__main__":
    main()
