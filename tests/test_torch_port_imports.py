"""PyTorch port: nothing of it imports JAX, flax, optax, orbax, sklearn
or the JAX package. A subprocess whose import system refuses those names
(a `sys.meta_path` finder placed first) imports every module of
`surel_plus_tpu_torch`, then `chip_smoke`; the card's machine has none of
them but torch's own dependencies."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn",
           "surel_plus_tpu")

GUARD = r"""
import importlib, pkgutil, sys

BLOCKED = {blocked!r}


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{{name}} is refused")
        return None


sys.meta_path.insert(0, Refuse())
import surel_plus_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    surel_plus_tpu_torch.__path__, "surel_plus_tpu_torch.")]
assert {{"surel_plus_tpu_torch.ops.prng",
         "surel_plus_tpu_torch.ops.kernels.threefry",
         "surel_plus_tpu_torch.ops.special",
         "surel_plus_tpu_torch.models.init"}} <= set(names), names
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(len(names))
"""


def test_the_port_imports_nothing_of_jax():
    code = GUARD.format(blocked=BLOCKED)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 52


def test_the_guard_refuses_what_it_blocks():
    code = GUARD.format(blocked=BLOCKED).replace(
        "import surel_plus_tpu_torch\n", "import sklearn\n", 1)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "sklearn is refused" in out.stderr
