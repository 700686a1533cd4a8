"""How far the flagship's bf16 backbone and ASPP gradients sit from the JAX
package's, relative to their norm, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_port_bf16_gradient_noise.py

One bf16 train step of ``tiny_flagship_train_cfg`` at 64² in each package
from the same weights (``test_torch_port_amp.bf16_step``), for two sets of
weights: the tests' random ones, and the same with every residual block's
last BatchNorm gain scaled to 0.1, nearer a trained model's.  Prints, per
set, the median, 90th percentile and largest relative (Frobenius)
distance of the port's bf16 gradient from JAX's over the backbone and ASPP
tensors, and the median distance of the port's float32 gradient from
JAX's bf16 one.  The tests hold these tensors to a tighter bound only if
the median falls under 0.25 at the scaled gains.
"""

import sys
from pathlib import Path

import jax
import numpy as np

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]
import test_torch_port_amp as amp  # noqa: E402

HEADS = ("backbone", "decode_head.aspp", "decode_head.image_pool",
         "decode_head.bottleneck")


def scaled_residual_gains(variables, scale):
    """``variables`` with each residual block's last BN gain times
    ``scale`` (``bn2`` of a BasicBlock)."""
    def leaf(path, x):
        keys = [str(getattr(p, "key", p)) for p in path]
        if (keys[:2] == ["params", "backbone"] and keys[2].startswith("layer")
                and keys[-2:] == ["bn2", "weight"]):
            return np.asarray(x) * scale
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def distances(scale):
    jm, variables = amp.jax_case("deeplabv3")
    if scale is not None:
        variables = scaled_residual_gains(variables, scale)
    case = amp.jax_case
    amp.jax_case = lambda name: (jm, variables)
    try:
        step = amp.bf16_step("deeplabv3")
    finally:
        amp.jax_case = case
    return np.array([step["distance"](name) for name in step["ref_grads"]
                     if name.startswith(HEADS)])


def main():
    for scale in (None, 0.1):
        d = distances(scale)
        print(f"residual gains x{scale or 1}: {len(d)} tensors, bf16 "
              f"distance median {np.median(d[:, 0]):.3f}, p90 "
              f"{np.quantile(d[:, 0], 0.9):.3f}, max {d[:, 0].max():.3f}; "
              f"float32 median {np.median(d[:, 1]):.3f}")


if __name__ == "__main__":
    main()
