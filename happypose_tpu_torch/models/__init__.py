"""Models: the ResNet34 and WideResNet backbones, the render-and-compare pose
predictor and the FCOS detector."""
