"""Which ``configs/network`` configs the port builds.

Every config file is built through the port's registry on the ``meta``
device (shapes only, no memory): the configs the port claims build, and
every other one stops at a ``KeyError`` that names the module the port
does not have yet (``ROADMAP.md`` Queue 1).
"""

from pathlib import Path

import torch

from image_segmentation_lab_tpu_torch.core.fileio import load_python_config
from image_segmentation_lab_tpu_torch.models.builder import build_segmentor

ROOT = Path(__file__).resolve().parents[1]
CLAIMED = {
    "ann/ann_r50-d8", "beit/upernet_beit-b", "ccnet/ccnet_r50-d8",
    "danet/danet_r50-d8", "ddrnet/ddrnet_23-slim",
    "deeplabv3/deeplabv3_r50-d8", "deeplabv3/deeplabv3plus_r50-d8",
    "dnlnet/dnl_r50-d8", "emanet/emanet_r50-d8", "gcnet/gcnet_r50-d8",
    "isanet/isanet_r50-d8", "nonlocal_net/nonlocal_r50-d8",
    "psanet/psanet_r50-d8", "dpt/dpt_vit-s", "fcn/fcn_r18_synthetic",
    "mae/upernet_mae-b", "maskformer/mask2former_r50",
    "maskformer/mask2former_swin-t", "maskformer/maskformer_r50",
    "pidnet/pidnet-s", "poolformer/fpn_poolformer_s12",
    "pspnet/pspnet_r50-d8", "pspnet/pspnet_r50-v1d-d8",
    "segformer/segformer_mit-b0", "segformer/segformer_mit-b2",
    "segformer/segformer_mit_tiny_synthetic", "segmenter/segmenter_vit-s",
    "segnext/segnext_mscan-t", "setr/setr_mla_vit-s", "setr/setr_pup_vit-s",
    "twins/twins_pcpvt-s_upernet", "twins/twins_svt-s_upernet",
    "upernet/upernet_convnext-t", "upernet/upernet_mit-b0",
    "upernet/upernet_r50", "upernet/upernet_swin-t-w8",
    "upernet/upernet_swin-t", "upernet/upernet_vit-b_mln"}


def test_the_claimed_configs_build_and_the_others_name_what_is_missing():
    built, missing = set(), {}
    for path in sorted((ROOT / "configs/network").glob("*/*.py")):
        name = str(path.relative_to(ROOT / "configs/network"))[:-3]
        network = load_python_config(str(path))["model"]
        try:
            with torch.device("meta"):
                build_segmentor(network)
            built.add(name)
        except KeyError as err:
            missing[name] = str(err)
    assert len(CLAIMED) == 38
    assert built == CLAIMED
    assert len(built) + len(missing) == 61
    for name, message in missing.items():
        assert "is not registered in registry" in message, (name, message)
