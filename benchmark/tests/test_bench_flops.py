"""The FLOP counter against the published totals (multiply-accumulates of
one 1000-class forward): ResNet34 at 224x224 3.6 G (He et al. 2016),
ResNet50 4.1 G (ibid.), EfficientNet-B3 at 300x300 1.8 G and B0 at 224x224
0.39 G (Tan & Le 2019)."""

import pytest

from benchmark import flops


@pytest.mark.parametrize("name,macs,size", [
    ("resnet34", 3.6e9, 224), ("resnet50", 4.1e9, 224), ("efficientnet_b3", 1.8e9, 300)])
def test_published_totals(name, macs, size):
    assert flops.forward_flops(name, 3, size, size, 1000) / 2 == pytest.approx(macs, rel=0.03)


def test_efficientnet_b0():
    assert flops.efficientnet_macs(1.0, 1.0, 3, 224, 224, 1000) == pytest.approx(0.39e9, rel=0.03)


def test_megapose_forward():
    """ResNet34 on the 9 input channels at 240x320: 1.53 x the 224x224 trunk
    plus the stem's 6 extra channels."""
    f = flops.forward_flops("resnet34", 9, 240, 320, 9)
    stem_extra = 2 * 6 * 64 * 49 * 120 * 160
    assert f - stem_extra == pytest.approx(2 * 3.664e9 * (240 * 320) / 224**2, rel=0.02)
