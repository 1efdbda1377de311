"""happypose_tpu_torch — the PyTorch/CUDA port of `happypose_tpu`.

The module layout mirrors the JAX package: the counterpart of
`happypose_tpu/X/y.py` is `happypose_tpu_torch/X/y.py`, and each ported
function is held against its JAX reference by `tests/test_torch_*.py`.

- ``lib3d``:     SE(3)/rotation/camera/crop math on tensors.
- ``meshes``:    procedural meshes + the padded mesh database.
- ``ops``:       the rasterizer (hand-written CUDA kernel + plain PyTorch
                 version), crop-resize matmuls, segment ops.
- ``csrc``:      CUDA sources and their nvcc build.
- ``models``:    ResNet34, WideResNet18/34, the render-and-compare pose
                 predictor and the FCOS + YOLACT-mask detector.
- ``datasets``:  the detector's input crop (`crop_resize_to_aspect`).
- ``inference``: the MegaPose and CosyPose single-view pipelines and the
                 detector wrapper.
- ``utils``:     named models and the Flax -> PyTorch weight bridge.

This package imports neither `jax` nor `happypose_tpu`.
"""

__version__ = "0.1.0"
