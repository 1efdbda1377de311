"""happypose_tpu_torch — the PyTorch/CUDA port of `happypose_tpu`.

The module layout mirrors the JAX package: the counterpart of
`happypose_tpu/X/y.py` is `happypose_tpu_torch/X/y.py`, and each ported
function is held against its JAX reference by `tests/test_torch_*.py`.

- ``lib3d``:     SE(3)/rotation/camera/crop math on tensors.
- ``meshes``:    mesh file IO (PLY, OBJ), procedural meshes and textures,
                 the padded mesh database.
- ``ops``:       the rasterizer (hand-written CUDA kernel + plain PyTorch
                 version), the scene renderer, crop-resize matmuls, segment
                 ops.
- ``csrc``:      CUDA sources and their nvcc build; the native PLY decoder
                 and its g++ build.
- ``models``:    ResNet34, WideResNet18/34, the render-and-compare pose
                 predictor and the FCOS + YOLACT-mask detector.
- ``datasets``:  BOP object and scene datasets with their writers, tar
                 shards, other object-dataset layouts, samplers, the name
                 registry, the augmentations, the synthetic scene sampler
                 and recorder, the pose-training datasets (split, stream).
- ``inference``: the MegaPose and CosyPose single-view pipelines, the depth
                 refiners and the detector wrapper.
- ``evaluation``: pose-error and BOP19 meters, the prediction runner,
                 BOP csv / COCO json exports, the detection meter.
- ``training``:  the pose and detector losses, the hypothesis samplers,
                 synthetic batches, the optimizer and the train step on
                 one device.
- ``visualization``: overlays and glTF scene export.
- ``scripts``:   the example, evaluation, recording, training and
                 kernel-bench CLIs.
- ``utils``:     named models, run directories and training checkpoints,
                 the Flax -> PyTorch weight bridge, the PNG codec, seeds,
                 profiling, prefetch, timers, logging, config overrides.

This package imports neither `jax` nor `happypose_tpu`.
"""

__version__ = "0.1.0"
