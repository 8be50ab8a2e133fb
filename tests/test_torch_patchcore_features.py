"""Port parity: `scripts.eval_patchcore_features` against the JAX script.

The denoiser feature source (the shipped `results/mri_synth256_ema.npz`,
the same weights in both packages) at 64px (`mri64`, the JAX script's
`configs/mri_synthetic.yaml`), one refit on 2 normal brains, 2 tumour
brains (one batch shape, so JAX compiles its taps once), two refinement
settings and a residual dilation; the JAX package's k-center projection
(PRNGKey(seed)) handed to the port.  The
JSON is the JAX script's: the same keys, every IoU within 1e-6 and every
fired count equal.  64px, because at 256px k-center ties part the two
banks (ROADMAP queue 3).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from localdiffusion_tpu_torch.ood import patchcore as TP
from localdiffusion_tpu_torch.scripts import eval_patchcore_features as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import eval_patchcore_features as jax_script  # noqa: E402

FLAGS = ["--sources", "denoiser", "--refits", "1", "--normals", "2", "--tests", "2",
         "--batch", "2", "--feature-npz", os.path.join(ROOT, "results", "mri_synth256_ema.npz"),
         "--hi-fracs", "0.5,0.7", "--refine-dilate", "0,2"]


def _jax_projection(d, proj_dim=128, seed=0):
    """The k-center projection the JAX package draws from PRNGKey(seed)."""
    return torch.as_tensor(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), (d, proj_dim), dtype=jnp.float32)
        / jnp.sqrt(jnp.asarray(proj_dim, jnp.float32))))


def test_eval_patchcore_features_matches_the_jax_script(tmp_path, monkeypatch):
    monkeypatch.setattr(TP, "random_projection", _jax_projection)
    got = port.main(["--config", "mri64", "--device", "cpu", "--out",
                     str(tmp_path / "port.json")] + FLAGS)
    monkeypatch.setattr(sys, "argv", ["eval_patchcore_features.py", "--config",
                                      os.path.join(ROOT, "configs", "mri_synthetic.yaml"),
                                      "--out", str(tmp_path / "jax.json")] + FLAGS)
    jax_script.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))
    assert set(got) == set(want) == {"denoiser"}
    g, w = got["denoiser"], want["denoiser"]
    assert g["dilate"] == w["dilate"]
    assert set(g["agg"]) == set(w["agg"])
    for gr, wr in zip(g["refits"], w["refits"]):
        assert set(gr) == set(wr)
        for k in wr:
            if k.endswith("_fired"):
                assert gr[k] == wr[k], k
            else:
                np.testing.assert_allclose(gr[k], wr[k], atol=1e-6, err_msg=k)
    assert np.isfinite(g["agg"]["iou"]["mean"])
