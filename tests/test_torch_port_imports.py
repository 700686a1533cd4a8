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
       "models.necks.featurepyramid", "core.optimizers.paramwise",
       "models.decode_heads.maskformer_head",
       "models.decode_heads.mask2former_head", "ops.matching",
       "ops.point_sample", "core.evaluation.panoptic",
       "core.evaluation.instances", "core.evaluation.instance_ap",
       "models.necks.mla_neck", "models.necks.multilevel_neck",
       "models.necks.fpn", "models.decode_heads.setr_mla_head",
       "models.decode_heads.dpt_head",
       "models.decode_heads.segmenter_mask_head",
       "models.decode_heads.fpn_head", "models.backbones.twins",
       "models.backbones.poolformer", "models.backbones.ddrnet",
       "models.backbones.pidnet", "models.backbones.mscan",
       "models.decode_heads.ddr_head", "models.decode_heads.pid_head",
       "models.decode_heads.ham_head", "models.losses.ohem_cross_entropy",
       "models.losses.boundary_loss",
       "models.utils.depthwise_separable_conv_module",
       "models.utils.non_local", "models.utils.self_attention_block",
       "models.decode_heads.sep_aspp_head", "models.decode_heads.nl_head",
       "models.decode_heads.dnl_head", "models.decode_heads.gc_head",
       "models.decode_heads.cc_head", "models.decode_heads.da_head",
       "models.decode_heads.ann_head", "models.decode_heads.isa_head",
       "models.decode_heads.ema_head", "models.decode_heads.psa_head")
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
