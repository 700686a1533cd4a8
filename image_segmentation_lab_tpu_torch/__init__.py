"""image_segmentation_lab_tpu_torch — PyTorch + CUDA port of the segmentation lab.

The port mirrors the module layout of ``image_segmentation_lab_tpu`` (the JAX
reference, which stays unchanged) so each module has a counterpart under the
same relative path.  Conventions:

* NCHW tensors at every module API; masks are ``(N, H, W)`` integers;
* ``nn.Module``s whose submodule names follow the JAX parameter-tree paths,
  so ``bridge.py`` loads a JAX checkpoint with a generic walker;
* explicit ``device`` arguments and ``torch.Generator``s for initialisation;
* float32 compute with TF32 off, or the bf16 policy of a schedule's
  ``amp=True`` (``core/mixed_precision``);
* every hand-written CUDA kernel sits beside its plain PyTorch version, which
  runs only for tensors that lie on the CPU.

The package never imports jax.
"""

__version__ = "0.1.0"
