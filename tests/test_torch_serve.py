"""The serving front end: the port's `scripts/serve.py` against the JAX
script's, and a real port server on the CPU.

The two scripts' request handlers (`make_handler`) are driven over loopback
HTTP with the same stub server and the same requests; status codes and
bodies must be byte for byte the same.  Then the port's server, built by
`build_server` on a narrow configuration (dim 8, 8px, T=4, f32, the manual
detector) and warmed up: each served `pred` equals `pipe.translate` of the
same padded batch with that batch's noise, bit for bit (the JSON float
round trip is exact), and the warm-up leaves the first batch's output and
the stats as they are without it.
"""

import dataclasses
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import Future
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.pipeline import batch_seed
from localdiffusion_tpu_torch.scripts import serve as port_serve
from localdiffusion_tpu_torch.serving import InferenceServer
from localdiffusion_tpu_torch.utils.params_io import save_params_npz
from test_torch_support import small_model_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import serve as jax_serve  # noqa: E402

S, T, BATCH = 8, 4, 2


class StubServer:
    """`submit` and `snapshot_stats` of a server: the prediction is the
    image doubled, branched when a mask came, a fixed latency."""

    def __init__(self):
        self.seen = []

    def submit(self, img, mask=None):
        self.seen.append((img.shape, None if mask is None else mask.shape))
        fut = Future()
        fut.set_result({"pred": img * 2.0, "branched": mask is not None, "latency_s": 0.25})
        return fut

    def snapshot_stats(self):
        return {"requests": len(self.seen), "batches": 1, "latency_mean_s": 0.5}


class Http:
    """An HTTP server over `handler` on a free loopback port, in a thread."""

    def __init__(self, handler):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def call(self, path, body=None):
        """(status, body bytes) of a GET, or a POST of `body` (bytes)."""
        req = urllib.request.Request(self.url + path, data=body, method="POST" if body is not None
                                     else "GET")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()


def _post(image, mask=None):
    body = {"image": np.asarray(image).tolist()}
    if mask is not None:
        body["mask"] = np.asarray(mask).tolist()
    return json.dumps(body).encode()


def test_handlers_answer_alike():
    rng = np.random.default_rng(0)
    img2 = rng.uniform(0, 2, (4, 4)).astype(np.float32)
    img3 = rng.uniform(0, 2, (4, 4, 1)).astype(np.float32)
    mask2 = (rng.uniform(size=(4, 4)) > 0.5).astype(np.float32)
    requests = [
        ("/v1/translate", _post(img2)),
        ("/v1/translate", _post(img3)),
        ("/v1/translate", _post(img2, mask2)),
        ("/v1/translate", _post(img3, mask2[..., None])),
        ("/v1/translate", _post(rng.uniform(0, 2, (4, 4, 3)))),  # channel mismatch
        ("/v1/translate", b"{not json"),
        ("/v1/translate", json.dumps({"mask": [[1.0]]}).encode()),  # no image
        ("/v1/other", _post(img2)),
        ("/healthz", None),
        ("/stats", None),
        ("/other", None),
    ]
    answers, seen = [], []
    for module in (jax_serve, port_serve):
        stub = StubServer()
        with Http(module.make_handler(stub, 1)) as http:
            answers.append([http.call(path, body) for path, body in requests])
        seen.append(stub.seen)
    assert answers[0] == answers[1]
    assert seen[0] == seen[1] == [((4, 4, 1), None)] * 2 + [((4, 4, 1), (4, 4, 1))] * 2
    codes = [code for code, _ in answers[1]]
    assert codes == [200] * 4 + [400] * 3 + [404, 200, 200, 404]
    assert json.loads(answers[1][4][1]) == {"error": "expected 1 channel(s), got (4, 4, 3)"}
    out = json.loads(answers[1][0][1])
    np.testing.assert_array_equal(np.asarray(out["pred"], np.float32), img2[..., None] * 2.0)


def _narrow_cfg():
    base = tcfg.flagship_config()
    return base.replace(
        model=small_model_cfg(),
        diffusion=dataclasses.replace(base.diffusion, image_size=S, timesteps=T),
        ood=dataclasses.replace(base.ood, manual_mask_cols=3, mask_dilate=0))


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """The narrow configuration and its seeded weights as an npz."""
    npz = str(tmp_path_factory.mktemp("serve") / "narrow.npz")
    cfg = _narrow_cfg()
    with torch.random.fork_rng():
        torch.manual_seed(3)
        save_params_npz(npz, build_gd(cfg, device="cpu").model.state_dict(), dtype=np.float32)
    return cfg, npz


def test_served_pred_is_the_batch_translation(narrow, monkeypatch):
    cfg, npz = narrow
    monkeypatch.setitem(tcfg.CONFIGS, "narrow_serve", lambda: cfg)
    args = port_serve.parse_args(["--config", "narrow_serve", "--params-npz", npz, "--port", "0",
                                  "--batch-size", str(BATCH), "--max-wait-ms", "5",
                                  "--device", "cpu"])
    httpd, srv = port_serve.build_server(args)
    pipe = srv.pipe
    rng = np.random.default_rng(1)
    lr = rng.uniform(0, 2, (3, S, S, 1)).astype(np.float32)
    half = np.ones((S, S, 1), np.float32)
    half[:, :4] = 0.0
    reqs = [(lr[0], np.ones((S, S), np.float32)), (lr[1], half), (lr[2], None)]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        outs = []
        for img, mask in reqs:  # one at a time: batch i holds request i, padded
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/v1/translate", data=_post(img[..., 0], mask)), timeout=300) as r:
                outs.append(json.loads(r.read()))
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        bad = urllib.request.Request(url + "/v1/translate",
                                     data=_post(np.zeros((S, S, 3), np.float32)))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert [o["branched"] for o in outs] == [False, True, True]
    assert stats["requests"] == 3 and stats["batches"] == 3
    assert stats["plain_dispatches"] == 1 and stats["branched_dispatches"] == 2
    assert stats["padded_slots"] == 3
    manual = pipe.detect(np.repeat(lr[2:3], BATCH, axis=0))[0]
    for i, ((img, mask), out) in enumerate(zip(reqs, outs)):
        m = manual[:1] if mask is None else mask.reshape(1, S, S, 1)
        want = pipe.translate(np.repeat(img[None], BATCH, axis=0), noise=batch_seed(0, i),
                              mask=np.repeat(m, BATCH, axis=0))["pred"][0]
        np.testing.assert_array_equal(np.asarray(out["pred"], np.float32), want)


def test_warmup_changes_no_batch(narrow):
    """start(warmup=True) runs the plain and the branched chain once each,
    with batch 0's noise, and leaves the batch index and stats alone: the
    first batch's output and the stats equal a cold server's."""
    from localdiffusion_tpu_torch.factory import build_pipeline

    cfg, npz = narrow
    pipe = build_pipeline(cfg, npz, device="cpu", verbose=False)
    masks = []
    translate = pipe.translate

    def counted(lr, **kw):
        masks.append(np.asarray(kw["mask"]))
        return translate(lr, **kw)

    pipe.translate = counted
    lr = np.random.default_rng(2).uniform(0, 2, (S, S, 1)).astype(np.float32)
    results = []
    for warm in (True, False):
        masks.clear()
        srv = InferenceServer(pipe, batch_size=BATCH, max_wait_ms=5)
        srv.start(warmup=warm)
        try:
            warm_masks = list(masks)
            out = srv.submit(lr).result(timeout=300)
        finally:
            srv.stop()
        stats = srv.snapshot_stats()
        results.append((out, {k: v for k, v in stats.items() if "latency" not in k}))
        if warm:
            assert len(warm_masks) == 2  # the plain chain, then the branched
            assert np.all(warm_masks[0] == 1.0)
            assert np.all(warm_masks[1][:, :, : S // 2] == 0.5)
            assert np.all(warm_masks[1][:, :, S // 2:] == 1.0)
    (warm_out, warm_stats), (cold_out, cold_stats) = results
    np.testing.assert_array_equal(warm_out["pred"], cold_out["pred"])
    assert warm_out["branched"] == cold_out["branched"] is True
    assert warm_stats == cold_stats
    assert cold_stats["requests"] == 1 and cold_stats["batches"] == 1
