"""Models: the ResNet34 backbone and the render-and-compare pose predictor."""
