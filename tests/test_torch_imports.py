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
    print(len(names))
    """
)


def test_port_imports_without_jax_flax_yaml():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15  # every module was found


def test_blocked_module_really_fails():
    """The blocking works: the JAX package itself cannot import under it."""
    script = "import sys\nsys.modules['jax'] = None\nimport localdiffusion_tpu.ops.attention\n"
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode != 0 and "jax" in proc.stderr.splitlines()[-1]
