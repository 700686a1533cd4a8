"""The environment record written into every checkpoint's metadata (the
port's counterpart of ``tools/logger/metadata.py``): platform, Python,
the command line, and torch's, CUDA's and cuDNN's versions with the
devices."""

from __future__ import annotations

import platform
import sys

import torch


def get_environment_info() -> dict:
    info = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "argv": " ".join(sys.argv),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cudnn": (torch.backends.cudnn.version()
                  if torch.backends.cudnn.is_available() else None),
    }
    if torch.cuda.is_available():
        info["devices"] = [f"cuda:{torch.cuda.get_device_name(i)}"
                           for i in range(torch.cuda.device_count())]
    else:
        info["devices"] = ["cpu"]
    info["device_count"] = len(info["devices"])
    return info


if __name__ == "__main__":
    for k, v in get_environment_info().items():
        print(f"{k}: {v}")
