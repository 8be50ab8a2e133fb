"""The port imports nothing of JAX, flax, YAML or the JAX package.

A subprocess blocks those modules (an entry of None in sys.modules makes
their import fail) and imports every module of the port and chip_smoke.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "yaml", "localdiffusion_tpu"):
        sys.modules[name] = None
    import localdiffusion_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    print(" ".join(names))
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
}


def test_port_imports_without_jax_flax_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 24 and REQUIRED <= names, sorted(names)


def test_blocked_module_really_fails():
    """The blocking works: the JAX package itself cannot import under it."""
    script = "import sys\nsys.modules['jax'] = None\nimport localdiffusion_tpu.ops.attention\n"
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode != 0 and "jax" in proc.stderr.splitlines()[-1]
