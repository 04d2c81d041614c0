"""The port imports neither JAX, nor the JAX package, nor h5py: in a fresh
interpreter, every module of music_generator_tpu_torch is imported (no
kernel is built: kernels build inside the calls that launch them), and
none of those packages may be loaded afterwards."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import music_generator_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from music_generator_tpu_torch.ops import _build
assert not _build._loaded, "a kernel was loaded on import"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "music_generator_tpu",
                                    "h5py"))
print(len(names), "modules")
print("loaded:", bad)
sys.exit(1 if bad else 0)
"""


def test_the_port_imports_no_jax_no_jax_package_no_h5py():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 40, proc.stdout
