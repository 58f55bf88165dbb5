"""Paper's own evaluation models (Table 2): ResNet-18, ResNet-152,
WideResNet-50-2 on CIFAR-10 [He+16; Zagoruyko&Komodakis 16].

The paper's primary pruning config is channel keep-rate 0.5 (§5.1.5).
``prune_targets``: "channel" and "filter" are aliases — both select the
cross-layer COUPLED mask classes (models/cnn.py coupling graph: a pruned
filter IS a pruned input channel of every consumer, so the two sets are
one decision under physical reconfiguration); "shape" adds the
projection-only S_s composite rules per conv.
"""
from .base import ArchConfig, ConsensusSpec, register


def resnet18() -> ArchConfig:
    return ArchConfig(
        name="resnet18", family="cnn",
        cnn_blocks=(2, 2, 2, 2), cnn_widths=(64, 128, 256, 512),
        cnn_bottleneck=False, img_size=32, n_classes=10,
        prune_targets=("channel",),
        consensus=ConsensusSpec(granularity="chip"),
    )


def resnet152() -> ArchConfig:
    return ArchConfig(
        name="resnet152", family="cnn",
        cnn_blocks=(3, 8, 36, 3), cnn_widths=(64, 128, 256, 512),
        cnn_bottleneck=True, img_size=32, n_classes=10,
        prune_targets=("channel",),
        consensus=ConsensusSpec(granularity="chip"),
    )


def wideresnet50_2() -> ArchConfig:
    return ArchConfig(
        name="wideresnet50-2", family="cnn",
        cnn_blocks=(3, 4, 6, 3), cnn_widths=(64, 128, 256, 512),
        cnn_bottleneck=True, cnn_width_mult=2, img_size=32, n_classes=10,
        prune_targets=("channel",),
        consensus=ConsensusSpec(granularity="chip"),
    )


def _smoke() -> ArchConfig:
    return ArchConfig(
        name="resnet-smoke", family="cnn",
        cnn_blocks=(1, 1), cnn_widths=(16, 32),
        cnn_bottleneck=False, img_size=16, n_classes=10,
        prune_targets=("channel", "filter", "shape"),
        consensus=ConsensusSpec(granularity="chip"),
    )


def _smoke_bottleneck() -> ArchConfig:
    # bottleneck smoke: exercises the separate-stem coupling class (stage 0
    # opens with a projection shortcut) and the cmid != stream-width split
    return ArchConfig(
        name="resnet-smoke-bottleneck", family="cnn",
        cnn_blocks=(1, 1), cnn_widths=(16, 16),
        cnn_bottleneck=True, img_size=16, n_classes=10,
        prune_targets=("channel", "filter"),
        consensus=ConsensusSpec(granularity="chip"),
    )


register("resnet18", resnet18, _smoke)
register("resnet152", resnet152, _smoke_bottleneck)
register("wideresnet50-2", wideresnet50_2, _smoke_bottleneck)
