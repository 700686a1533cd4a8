"""Every module of the PyTorch port imports without JAX.

Runs in a fresh interpreter (the test process has jax loaded already): walk
the package, import each module, then check that neither JAX nor the JAX
package, nor a library missing on the GPU machine, was pulled in.
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import importlib, pkgutil, sys
import image_segmentation_lab_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) > 20, names
new = ("models.backbones.mit", "models.decode_heads.segformer_head",
       "models.decode_heads.psp_head", "models.decode_heads.uper_head",
       "ops.pooling", "models.backbones.swin", "models.backbones.convnext",
       "models.backbones.beit", "models.backbones.mae",
       "models.necks.featurepyramid", "core.optimizers.paramwise")
missing = [m for m in new if pkg.__name__ + "." + m not in names]
assert not missing, missing
forbidden = ("jax", "flax", "optax", "orbax", "image_segmentation_lab_tpu",
             "tools", "yaml", "cv2", "PIL", "matplotlib", "triton")
loaded = sorted(m for m in forbidden if m in sys.modules)
assert not loaded, loaded
print("ok", len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
