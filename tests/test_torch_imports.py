"""The port imports nothing of JAX, flax, optax, Orbax, YAML, scikit-learn,
pandas or the JAX package.

A subprocess blocks those modules (an entry of None in sys.modules makes
their import fail) and imports every module of the port and chip_smoke;
another runs, at 32px on the CPU, the branches that import lazily: the seg
detector from the shipped npz, the seg-encoder and WRN50-2 sources, and the
classifier gate's WRN last resort; a third runs the evaluation entry
points at 16px (the shipped denoiser, T=3): `factory.load_params` and
`build_pipeline`, `run`, and the test, margin and gated-quality CLIs; a
fourth the MNIST reader on idx files it writes, the training CLI at 16px on
a self-conditioned model with random Fourier features, a step in each mode,
and its EMA npz back through `factory.load_params`; a fifth the serving,
volume and aux CLIs at 16px: `scripts.serve`'s server answering one
request, `convert_mha` and `translate_volume` on a MetaImage volume,
`train_seg`, `train_mnist_cls` and `eval_translation`; a sixth the parallel
and I/O layer: the patch tiling and stitch, the streaming loader through
`device_prefetch` under `profile_trace`, the native kernels and the
reference converter's CLI (the patch demo and `eval_patchcore_features`
are imported by the first; their runs are held against JAX in their own
tests); a seventh `config.load_config` on builder names and `.json`
dumps, and its error naming PyYAML on a `.yaml` path.  The package and
each subpackage export the JAX subpackages' names, or name in their
docstrings the object that does a missing name's work.
"""

import importlib


import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "sklearn", "pandas",
                 "localdiffusion_tpu"):
        sys.modules[name] = None
    import localdiffusion_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    print(" ".join(names))
    """
)

BRANCHES = textwrap.dedent(
    """
    import dataclasses, sys
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "sklearn",
                 "localdiffusion_tpu"):
        sys.modules[name] = None
    import numpy as np
    from localdiffusion_tpu_torch import config as C
    from localdiffusion_tpu_torch.factory import build_classifier_gate, build_frontend
    from localdiffusion_tpu_torch.ood.features import make_feature_source

    def at32(cfg, **ood):
        return cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, image_size=32),
                           ood=dataclasses.replace(cfg.ood, input_size=32, **ood))

    x = np.random.default_rng(0).uniform(0, 2, (4, 32, 32, 1)).astype(np.float32)
    seg = at32(C.mri256_bf16_config(), seg_model_path="results/seg256_params.npz")
    fe, _ = build_frontend(seg, device="cpu", verbose=False)
    assert fe.detect(x)[1].shape == (4, 32, 32, 1)
    for source, layers in (("seg_encoder", ("down2", "down3")), ("wrn", ("layer1",))):
        src = make_feature_source(at32(seg, feature_source=source, layers=("layer1",)),
                                  device="cpu", verbose=False)
        assert tuple(src.apply(__import__("torch").as_tensor(
            x if source != "wrn" else x.repeat(3, -1)))) == layers
    gated = at32(C.mri256_gated_config(), detector="seg", memory_bank_path=None,
                 classifier_threshold=1.0)
    gate = build_classifier_gate(gated, calibration_pairs=[(x[i:i + 1], i % 2) for i in range(4)],
                                 device="cpu", verbose=False)
    print(type(gate.classifier.patchcore.source).__name__)
    """
)

ENTRY_POINTS = textwrap.dedent(
    """
    import dataclasses, sys, tempfile
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "sklearn",
                 "localdiffusion_tpu", "scripts"):
        sys.modules[name] = None
    import numpy as np
    from localdiffusion_tpu_torch import config as C
    from localdiffusion_tpu_torch.factory import build_pipeline, load_params
    from localdiffusion_tpu_torch.scripts import eval_gated_quality, eval_margins, test

    NPZ = "results/mri_synth256_ema.npz"

    def tiny(base, **ood):
        return base.replace(
            diffusion=dataclasses.replace(base.diffusion, image_size=16, timesteps=3,
                                          sampling_timesteps=None),
            ood=dataclasses.replace(base.ood, input_size=16, **ood),
            train=dataclasses.replace(base.train, compute_dtype="float32"))

    C.CONFIGS["tiny"] = lambda: tiny(C.mri256_config())
    C.CONFIGS["tiny_gated"] = lambda: tiny(C.mri256_gated_config())
    manual = tiny(C.mri256_config(), detector="manual", manual_mask_cols=4)
    assert load_params(manual, params_npz=NPZ, device="cpu", verbose=False).image_size == 16
    pipe = build_pipeline(manual, params_npz=NPZ, device="cpu", verbose=False)
    x = np.ones((2, 16, 16, 1), np.float32)
    assert pipe.run([(x, x)], noise=1, verbose=False)["pred_all"].shape == (2, 16, 16, 1)
    with tempfile.TemporaryDirectory() as d:
        common = ["--params-npz", NPZ, "--images", "2", "--batch", "2", "--bank-images", "2",
                  "--work-dir", d, "--device", "cpu"]
        m = eval_margins.main(["--config", "tiny", "--variants", "plain,denoiser,gtd",
                               "--samplers", "ddpm"] + common)
        g = eval_gated_quality.main(["--config", "tiny_gated", "--bank-normals", "2",
                                     "--calib", "2"] + common)
    t = test.main(["--config", "tiny", "--detector", "manual", "--params-npz", NPZ,
                   "--max-images", "2", "--device", "cpu"])
    print(len(m["variants"]), len(g["variants"]["gated"]["fusion_time"]),
          t["pred_all"].shape[0])
    """
)

TRAIN = textwrap.dedent(
    """
    import dataclasses, os, sys, tempfile
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "sklearn",
                 "localdiffusion_tpu", "scripts"):
        sys.modules[name] = None
    from localdiffusion_tpu_torch import config as C
    from localdiffusion_tpu_torch.factory import load_params
    from localdiffusion_tpu_torch.scripts import train

    base = C.mri256_config()
    C.CONFIGS["tiny"] = lambda: base.replace(
        model=dataclasses.replace(base.model, dim=8, dim_mults=(1, 2), full_attn=(False, True),
                                  cond_encoder_depth="auto", resnet_block_groups=4,
                                  attn_heads=2, attn_dim_head=8),
        diffusion=dataclasses.replace(base.diffusion, image_size=16, timesteps=3,
                                      sampling_timesteps=None),
        train=dataclasses.replace(base.train, compute_dtype="float32", batch_size=128))
    C.CONFIGS["tiny_sc"] = lambda: C.CONFIGS["tiny"]().replace(
        model=dataclasses.replace(C.CONFIGS["tiny"]().model, self_condition=True,
                                  random_fourier_features=True))
    with tempfile.TemporaryDirectory() as d:
        import gzip, struct
        import numpy as np
        from localdiffusion_tpu_torch.data import datasets, synthetic
        imgs, labels = synthetic.synthetic_digits(64, seed=1)
        for name, arr in (("images-idx3-ubyte", imgs), ("labels-idx1-ubyte.gz", labels)):
            arr = arr.astype(np.uint8)
            head = struct.pack(">BBBB", 0, 0, 8, arr.ndim) + struct.pack(
                ">" + "I" * arr.ndim, *arr.shape)
            with (gzip.open if name.endswith(".gz") else open)(
                    os.path.join(d, "t10k-" + name), "wb") as f:
                f.write(head + arr.tobytes())
        mn = C.mnist_8to5_config()
        mn = mn.replace(data=dataclasses.replace(
            mn.data, mnist_path=os.path.join(d, "t10k-images-idx3-ubyte"),
            mnist_labels_path=os.path.join(d, "t10k-labels-idx1-ubyte")))
        hr, lr, seg = datasets.test_arrays(mn, 4)
        assert hr.shape == (4, 28, 28, 1) and seg is None
        out = train.main(["--config", "tiny_sc", "--steps", "1", "--step-mode", "batch",
                          "--results", os.path.join(d, "sc"), "--device", "cpu"])
        print("TRAINED", "self_cond", out["step"])
        for mode in ("resident", "epoch", "batch"):
            npz = os.path.join(d, mode + ".npz")
            out = train.main(["--config", "tiny", "--steps", "1", "--step-mode", mode,
                              "--results", os.path.join(d, mode), "--export-npz", npz,
                              "--device", "cpu"])
            load_params(C.CONFIGS["tiny"](), params_npz=npz, device="cpu", verbose=False)
            print("TRAINED", mode, out["step"])
    """
)

CLIS = textwrap.dedent(
    """
    import dataclasses, json, os, sys, tempfile, threading, urllib.request
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "sklearn", "pandas",
                 "localdiffusion_tpu", "scripts"):
        sys.modules[name] = None
    import numpy as np
    from localdiffusion_tpu_torch import config as C
    from localdiffusion_tpu_torch.data.mha import save_mha
    from localdiffusion_tpu_torch.scripts import (
        convert_mha, eval_translation, serve, train_mnist_cls, train_seg, translate_volume)

    NPZ = "results/mri_synth256_ema.npz"
    base = C.mri256_config()
    C.CONFIGS["tiny"] = lambda: base.replace(
        diffusion=dataclasses.replace(base.diffusion, image_size=16, timesteps=3,
                                      sampling_timesteps=None),
        ood=dataclasses.replace(base.ood, detector="manual", input_size=16, manual_mask_cols=4),
        train=dataclasses.replace(base.train, compute_dtype="float32"))
    httpd, srv = serve.build_server(serve.parse_args(
        ["--config", "tiny", "--params-npz", NPZ, "--port", "0", "--batch-size", "1",
         "--device", "cpu"]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    body = json.dumps({"image": np.ones((16, 16)).tolist()}).encode()
    url = "http://127.0.0.1:%d/v1/translate" % httpd.server_address[1]
    with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=120) as r:
        out = json.loads(r.read())
    httpd.shutdown(); httpd.server_close(); srv.stop()
    print("SERVED", np.asarray(out["pred"]).shape, out["branched"])
    with tempfile.TemporaryDirectory() as d:
        vol = os.path.join(d, "vol.mha")
        save_mha(vol, np.random.default_rng(0).uniform(0, 3000, (2, 16, 16)).astype(np.float32))
        convert_mha.main([vol, "--out-dir", d])
        r = translate_volume.main(["--config", "tiny", "--t1", vol, "--flair",
                                   os.path.join(d, "vol.npy"), "--params-npz", NPZ,
                                   "--batch", "2", "--out", os.path.join(d, "p.npy"),
                                   "--device", "cpu"])
        print("VOLUME", r["pred_volume"].shape)
        seg = train_seg.main(["--epochs", "1", "--size", "16", "--batch", "64", "--out",
                              os.path.join(d, "seg.npz"), "--device", "cpu"])
        cls = train_mnist_cls.main(["--epochs", "1", "--batch", "256", "--out",
                                    os.path.join(d, "cls.npz"), "--mnist-path", "absent",
                                    "--device", "cpu"])
        np.save(os.path.join(d, "pred.npy"), np.ones((3, 28, 28, 1), np.float32))
        ev = eval_translation.main(["--pred", os.path.join(d, "pred.npy"), "--cls",
                                    cls["out"], "--device", "cpu"])
        print("AUX", len(seg["logs"]), len(cls["logs"]), sum(ev["hist"].values()))
    """
)

PARALLEL_IO = textwrap.dedent(
    """
    import os, sys, tempfile
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "sklearn", "pandas",
                 "localdiffusion_tpu", "scripts"):
        sys.modules[name] = None
    import numpy as np
    import torch
    from localdiffusion_tpu_torch import config as C, native
    from localdiffusion_tpu_torch.data.stream import StreamLoader, device_prefetch
    from localdiffusion_tpu_torch.models.unet import UNet
    from localdiffusion_tpu_torch.parallel import patch
    from localdiffusion_tpu_torch.scripts import convert_reference_ckpt
    from localdiffusion_tpu_torch.utils.logging import profile_trace
    from localdiffusion_tpu_torch.utils.reference_ckpt import reference_state_dict
    from localdiffusion_tpu_torch.utils.params_io import params_to_jax

    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as d:
        img = torch.rand(1, 40, 40, 1)
        grid = patch.plan_patches(40, 40, 16, 4)
        back = patch.stitch_patches(patch.extract_patches(img, grid), grid, 1, 4)
        print("PATCH", grid.num_patches, bool(torch.allclose(back, img)))
        x = np.arange(12, dtype=np.float32).reshape(6, 2)
        ld = StreamLoader([lambda: (x[:4],), lambda: (x[4:],)], [4, 2], batch_size=4)
        with profile_trace(os.path.join(d, "trace")):
            print("STREAM", [tuple(b[0].shape) for b in device_prefetch(ld.epoch_batches(0),
                                                                        device="cpu")])
        print("TRACE", os.path.exists(os.path.join(d, "trace", "trace.json")))
        print("NATIVE", native.have_native())
        cfg = C.ModelConfig(dim=8, cond_encoder_depth="deep")
        ref = reference_state_dict(params_to_jax(UNet(cfg).state_dict()), cfg)
        sd = {f"model.{k}": torch.as_tensor(v) for k, v in ref.items()}
        torch.save({"step": 7, "model": sd, "ema": {}}, os.path.join(d, "ref.pt"))
        conv = convert_reference_ckpt.main([os.path.join(d, "ref.pt"), "--out",
                                            os.path.join(d, "ref"), "--dim", "8"])
        print("CONVERTED", conv["step"], len(conv["params"]), conv["ema"])
    """
)

CONFIGS = textwrap.dedent(
    """
    import os, sys, tempfile
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "localdiffusion_tpu"):
        sys.modules[name] = None
    import localdiffusion_tpu_torch as pkg
    from localdiffusion_tpu_torch import config as C
    with tempfile.TemporaryDirectory() as d:
        for name, build in sorted(C.CONFIGS.items()):
            path = os.path.join(d, name + ".json")
            build().save_json(path)
            assert pkg.load_config(path) == C.load_config(name) == build(), name
        with open(os.path.join(d, "c.yml"), "w") as f:
            f.write("{}")
        for path in ("configs/mri_synthetic_256_bf16.yaml", os.path.join(d, "c.yml")):
            try:
                C.load_config(path)
            except ImportError as e:
                print("YAML", "PyYAML" in str(e))
        try:
            C.flagship_config().save_yaml(os.path.join(d, "c.yaml"))
        except ImportError as e:
            print("YAML", "PyYAML" in str(e))
    print("CONFIGS", len(C.CONFIGS), "yaml" in sys.modules and sys.modules["yaml"] is None)
    """
)

# modules the port must have (a rename or a lost file shows here)
REQUIRED = {
    "localdiffusion_tpu_torch.ops.attention",
    "localdiffusion_tpu_torch.ops.linear_attention",
    "localdiffusion_tpu_torch.ops.groupnorm",
    "localdiffusion_tpu_torch.config",
    "localdiffusion_tpu_torch.diffusion.sampler",
    "localdiffusion_tpu_torch.pipeline",
    "localdiffusion_tpu_torch.utils.params_io",
    "localdiffusion_tpu_torch.utils.precision",
    "localdiffusion_tpu_torch.ops.resnet_block",
    "localdiffusion_tpu_torch.models.blocks",
    "localdiffusion_tpu_torch.models.unet",
    "localdiffusion_tpu_torch.diffusion.gaussian",
    "localdiffusion_tpu_torch.serving",
    "localdiffusion_tpu_torch.factory",
    "localdiffusion_tpu_torch.data.synthetic",
    "localdiffusion_tpu_torch.ops.resize",
    "localdiffusion_tpu_torch.ood.thresholds",
    "localdiffusion_tpu_torch.ood.patchcore",
    "localdiffusion_tpu_torch.ood.features",
    "localdiffusion_tpu_torch.ood.frontend",
    "localdiffusion_tpu_torch.ood.bank",
    "localdiffusion_tpu_torch.ood.classifier",
    "localdiffusion_tpu_torch.ood.wide_resnet",
    "localdiffusion_tpu_torch.models.seg_unet",
    "localdiffusion_tpu_torch.scripts.test",
    "localdiffusion_tpu_torch.scripts.eval_margins",
    "localdiffusion_tpu_torch.scripts.eval_gated_quality",
    "localdiffusion_tpu_torch.ops.autograd",
    "localdiffusion_tpu_torch.train.trainer",
    "localdiffusion_tpu_torch.data.loader",
    "localdiffusion_tpu_torch.utils.logging",
    "localdiffusion_tpu_torch.scripts.train",
    "localdiffusion_tpu_torch.data.mnist",
    "localdiffusion_tpu_torch.data.mvtec",
    "localdiffusion_tpu_torch.data.brats",
    "localdiffusion_tpu_torch.data.mha",
    "localdiffusion_tpu_torch.data.folder",
    "localdiffusion_tpu_torch.data.datasets",
    "localdiffusion_tpu_torch.scripts.serve",
    "localdiffusion_tpu_torch.scripts.translate_volume",
    "localdiffusion_tpu_torch.scripts.convert_mha",
    "localdiffusion_tpu_torch.scripts.train_seg",
    "localdiffusion_tpu_torch.scripts.train_mnist_cls",
    "localdiffusion_tpu_torch.scripts.eval_translation",
    "localdiffusion_tpu_torch.models.simple_cnn",
    "localdiffusion_tpu_torch.parallel.patch",
    "localdiffusion_tpu_torch.parallel.mesh",
    "localdiffusion_tpu_torch.parallel.fsdp",
    "localdiffusion_tpu_torch.parallel.multihost",
    "localdiffusion_tpu_torch.data.stream",
    "localdiffusion_tpu_torch.utils.reference_ckpt",
    "localdiffusion_tpu_torch.native",
    "localdiffusion_tpu_torch.scripts.patch_demo",
    "localdiffusion_tpu_torch.scripts.convert_reference_ckpt",
    "localdiffusion_tpu_torch.scripts.eval_patchcore_features",
}


def test_port_imports_without_jax_flax_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 26 and REQUIRED <= names, sorted(names)


def test_new_branches_run_without_jax_flax_orbax_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", BRANCHES], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["WRNFeatureSource"]


def test_entry_points_run_without_jax_flax_orbax_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", ENTRY_POINTS], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-3:] == ["5", "2", "2"]


def test_train_cli_runs_without_jax_flax_optax_orbax_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr
    done = [ln.split()[1:] for ln in proc.stdout.splitlines() if ln.startswith("TRAINED")]
    assert done == [["self_cond", "1"], ["resident", "1"], ["epoch", "1"], ["batch", "1"]]


def test_serving_volume_and_aux_clis_run_without_jax_flax_optax_orbax_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", CLIS], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr
    got = [ln for ln in proc.stdout.splitlines() if ln.split()[0] in ("SERVED", "VOLUME", "AUX")]
    assert got == ["SERVED (16, 16, 1) True", "VOLUME (2, 16, 16, 1)", "AUX 1 1 3"]


def test_parallel_and_io_layer_runs_without_jax_flax_optax_orbax_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", PARALLEL_IO], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr
    got = [ln for ln in proc.stdout.splitlines()
           if ln.split()[0] in ("PATCH", "STREAM", "TRACE", "NATIVE", "CONVERTED")]
    assert got == ["PATCH 9 True", "STREAM [(4, 2), (2, 2)]", "TRACE True", "NATIVE True",
                   "CONVERTED 7 334 None"], proc.stdout


def test_blocked_module_really_fails():
    """The blocking works: the JAX package itself cannot import under it."""
    script = "import sys\nsys.modules['jax'] = None\nimport localdiffusion_tpu.ops.attention\n"
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode != 0 and "jax" in proc.stderr.splitlines()[-1]


def test_load_config_reads_builders_and_json_without_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", CONFIGS], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:-1] == ["YAML True"] * 3 + ["CONFIGS 12 True"]


# the JAX subpackages' exports whose work another object of the port does,
# each named in the port subpackage's docstring: {package: {name: the port
# objects, as attribute paths from the subpackage}}
EXPORT_COUNTERPARTS = {
    "ood": {"convert_torch_state_dict": ["wide_resnet.load_torchvision_state_dict"]},
    "models": {"encode_cond": ["UNet.encode_cond"]},
    "parallel": {"tree_shardings": ["fsdp.shard_model", "fsdp.load_full"],
                 "state_shardings": ["fsdp.shard_model", "fsdp.load_full"],
                 "put_tree_sharded": ["fsdp.shard_model", "fsdp.load_full"]},
}


def _jax_exports(package: str) -> list:
    """The names `localdiffusion_tpu/<package>/__init__.py` imports, read
    from its source (importing it would import JAX)."""
    import ast

    path = os.path.join(ROOT, "localdiffusion_tpu", *package.split(".")[1:], "__init__.py")
    tree = ast.parse(open(path).read())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


def test_every_jax_export_has_a_counterpart():
    for sub in ("", ".ood", ".models", ".ops", ".utils", ".parallel", ".data"):
        port = importlib.import_module("localdiffusion_tpu_torch" + sub)
        mapped = EXPORT_COUNTERPARTS.get(sub[1:], {})
        names = _jax_exports("localdiffusion_tpu" + sub)
        assert names, sub
        for name in names:
            if name in mapped:
                assert not hasattr(port, name), (sub, name)
                assert name in port.__doc__, (sub, name)
                for path in mapped[name]:
                    obj = port
                    if not hasattr(obj, path.split(".")[0]):  # a module of the subpackage
                        obj = importlib.import_module(f"{port.__name__}.{path.split('.')[0]}")
                        path = ".".join(path.split(".")[1:])
                    for part in path.split("."):
                        obj = getattr(obj, part)
                    assert callable(obj), (sub, name, path)
                    assert path.split(".")[-1] in port.__doc__, (sub, name, path)
            else:
                assert hasattr(port, name), f"localdiffusion_tpu_torch{sub} lacks {name}"
        assert set(mapped) <= set(names), sub
