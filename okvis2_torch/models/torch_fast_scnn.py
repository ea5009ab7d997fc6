"""The public Fast-SCNN checkpoint's layout, as a torch module.

A copy of ``okvis2_tpu/models/torch_fast_scnn.py``: the reference exports
a cityscapes-pretrained Fast-SCNN (``get_fast_scnn('citys',
pretrained=True)``, the reference's cnn/demo.py:31-76) and runs it through
LibTorch (okvis_cv/src/Frame.cpp:46-147). ``build_torch_fast_scnn`` states
that model with the SAME ``state_dict`` keys as the public checkpoint
(``learning_to_downsample.conv.conv.0.weight``, ...; 19 classes), which
``import_torch_fast_scnn.py`` converts into the port's ``FastSCNN``
(whose modules keep the Flax names). With random weights it stands in for
the checkpoint, which is not in the repo, in the importer's tests and on
the card.
"""

from __future__ import annotations


def build_torch_fast_scnn(num_classes: int = 19):
    """Returns a torch.nn.Module whose state_dict keys match the public
    Fast-SCNN checkpoint layout."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    class _ConvBNReLU(nn.Module):
        def __init__(self, in_ch, out_ch, k=3, stride=1):
            super().__init__()
            self.conv = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, k, stride, (k - 1) // 2,
                          bias=False),
                nn.BatchNorm2d(out_ch),
                nn.ReLU(True),
            )

        def forward(self, x):
            return self.conv(x)

    class _DSConv(nn.Module):
        def __init__(self, dw_ch, out_ch, stride=1):
            super().__init__()
            self.conv = nn.Sequential(
                nn.Conv2d(dw_ch, dw_ch, 3, stride, 1, groups=dw_ch,
                          bias=False),
                nn.BatchNorm2d(dw_ch),
                nn.ReLU(True),
                nn.Conv2d(dw_ch, out_ch, 1, bias=False),
                nn.BatchNorm2d(out_ch),
                nn.ReLU(True),
            )

        def forward(self, x):
            return self.conv(x)

    class _DWConv(nn.Module):
        def __init__(self, dw_ch, out_ch, stride=1):
            super().__init__()
            self.conv = nn.Sequential(
                nn.Conv2d(dw_ch, out_ch, 3, stride, 1, groups=dw_ch,
                          bias=False),
                nn.BatchNorm2d(out_ch),
                nn.ReLU(True),
            )

        def forward(self, x):
            return self.conv(x)

    class LinearBottleneck(nn.Module):
        def __init__(self, in_ch, out_ch, t=6, stride=2):
            super().__init__()
            self.use_shortcut = stride == 1 and in_ch == out_ch
            self.block = nn.Sequential(
                _ConvBNReLU(in_ch, in_ch * t, 1),
                _DWConv(in_ch * t, in_ch * t, stride),
                nn.Conv2d(in_ch * t, out_ch, 1, bias=False),
                nn.BatchNorm2d(out_ch),
            )

        def forward(self, x):
            out = self.block(x)
            if self.use_shortcut:
                out = x + out
            return out

    class PyramidPooling(nn.Module):
        def __init__(self, in_ch, out_ch):
            super().__init__()
            inter = in_ch // 4
            self.conv1 = _ConvBNReLU(in_ch, inter, 1)
            self.conv2 = _ConvBNReLU(in_ch, inter, 1)
            self.conv3 = _ConvBNReLU(in_ch, inter, 1)
            self.conv4 = _ConvBNReLU(in_ch, inter, 1)
            self.out = _ConvBNReLU(in_ch * 2, out_ch, 1)

        def forward(self, x):
            size = x.size()[2:]

            def up(y):
                return F.interpolate(y, size, mode="bilinear",
                                     align_corners=True)

            f1 = up(self.conv1(F.adaptive_avg_pool2d(x, 1)))
            f2 = up(self.conv2(F.adaptive_avg_pool2d(x, 2)))
            f3 = up(self.conv3(F.adaptive_avg_pool2d(x, 3)))
            f4 = up(self.conv4(F.adaptive_avg_pool2d(x, 6)))
            return self.out(torch.cat([x, f1, f2, f3, f4], dim=1))

    class LearningToDownsample(nn.Module):
        def __init__(self, ch1=32, ch2=48, out_ch=64):
            super().__init__()
            self.conv = _ConvBNReLU(3, ch1, 3, 2)
            self.dsconv1 = _DSConv(ch1, ch2, 2)
            self.dsconv2 = _DSConv(ch2, out_ch, 2)

        def forward(self, x):
            return self.dsconv2(self.dsconv1(self.conv(x)))

    class GlobalFeatureExtractor(nn.Module):
        def __init__(self, in_ch=64, block_ch=(64, 96, 128), out_ch=128,
                     t=6, num_blocks=(3, 3, 3)):
            super().__init__()

            def layer(inp, out, n, stride):
                mods = [LinearBottleneck(inp, out, t, stride)]
                mods += [LinearBottleneck(out, out, t, 1)
                         for _ in range(n - 1)]
                return nn.Sequential(*mods)

            self.bottleneck1 = layer(in_ch, block_ch[0], num_blocks[0], 2)
            self.bottleneck2 = layer(block_ch[0], block_ch[1],
                                     num_blocks[1], 2)
            self.bottleneck3 = layer(block_ch[1], block_ch[2],
                                     num_blocks[2], 1)
            self.ppm = PyramidPooling(block_ch[2], out_ch)

        def forward(self, x):
            return self.ppm(
                self.bottleneck3(self.bottleneck2(self.bottleneck1(x)))
            )

    class FeatureFusionModule(nn.Module):
        def __init__(self, higher_ch, lower_ch, out_ch):
            super().__init__()
            self.dwconv = _DWConv(lower_ch, out_ch, 1)
            self.conv_lower_res = nn.Sequential(
                nn.Conv2d(out_ch, out_ch, 1),
                nn.BatchNorm2d(out_ch),
            )
            self.conv_higher_res = nn.Sequential(
                nn.Conv2d(higher_ch, out_ch, 1),
                nn.BatchNorm2d(out_ch),
            )
            self.relu = nn.ReLU(True)

        def forward(self, higher, lower):
            lower = F.interpolate(
                lower, higher.size()[2:], mode="bilinear",
                align_corners=True,
            )
            lower = self.conv_lower_res(self.dwconv(lower))
            higher = self.conv_higher_res(higher)
            return self.relu(higher + lower)

    class Classifier(nn.Module):
        def __init__(self, ch, num_classes, stride=1):
            super().__init__()
            self.dsconv1 = _DSConv(ch, ch, stride)
            self.dsconv2 = _DSConv(ch, ch, stride)
            self.conv = nn.Sequential(
                nn.Dropout(0.1),
                nn.Conv2d(ch, num_classes, 1),
            )

        def forward(self, x):
            return self.conv(self.dsconv2(self.dsconv1(x)))

    class FastSCNNTorch(nn.Module):
        def __init__(self):
            super().__init__()
            self.learning_to_downsample = LearningToDownsample()
            self.global_feature_extractor = GlobalFeatureExtractor()
            self.feature_fusion = FeatureFusionModule(64, 128, 128)
            self.classifier = Classifier(128, num_classes)

        def forward(self, x):
            size = x.size()[2:]
            higher = self.learning_to_downsample(x)
            g = self.global_feature_extractor(higher)
            f = self.feature_fusion(higher, g)
            out = self.classifier(f)
            return F.interpolate(out, size, mode="bilinear",
                                 align_corners=True)

    return FastSCNNTorch()
