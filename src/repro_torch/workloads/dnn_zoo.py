"""The paper's workloads (Table 6), defined from public architectures.

Target workloads:    BERT [5], ResNet-50 [8], RetinaNet [25] (non-backbone
                     layers), U-Net [36].
Training workloads:  AlexNet [20], ResNeXt-50-32x4d [51], VGG-16 [41],
                     DeepBench [30] (OCR + face-recognition GEMMs).

All layer shapes are the standard published configurations (ImageNet-224
for CNNs, sequence length 512 for BERT-base).  Batch size 1, as in
single-inference EDP studies.
"""
from __future__ import annotations

from ..core.problem import Layer, Workload, dedupe_layers

# ---------------------------------------------------------------------------
# Target workloads
# ---------------------------------------------------------------------------

def resnet50() -> Workload:
    layers = [Layer.conv(3, 64, 7, 112, stride=2, name="conv1")]
    # (in, mid, out, spatial, blocks, first_stride)
    stages = [
        (64, 64, 256, 56, 3, 1),
        (256, 128, 512, 28, 4, 2),
        (512, 256, 1024, 14, 6, 2),
        (1024, 512, 2048, 7, 3, 2),
    ]
    for (cin, mid, cout, hw, blocks, stride) in stages:
        # first block (projection shortcut + stride)
        layers += [
            Layer.conv(cin, mid, 1, hw, stride=stride, name="reduce"),
            Layer.conv(mid, mid, 3, hw, name="spatial"),
            Layer.conv(mid, cout, 1, hw, name="expand"),
            Layer.conv(cin, cout, 1, hw, stride=stride, name="proj"),
        ]
        for _ in range(blocks - 1):
            layers += [
                Layer.conv(cout, mid, 1, hw, name="reduce"),
                Layer.conv(mid, mid, 3, hw, name="spatial"),
                Layer.conv(mid, cout, 1, hw, name="expand"),
            ]
    layers.append(Layer.matmul(1, 1000, 2048, name="fc"))
    wl = dedupe_layers(layers)
    return Workload(layers=wl.layers, name="resnet50")


def bert() -> Workload:
    """BERT-base, seq 512: 12 layers x (QKV, scores, context, out,
    FFN up, FFN down); per-head GEMMs carry head x layer repeats."""
    seq, d, heads, layers_n, dff = 512, 768, 12, 12, 3072
    hd = d // heads
    layers = [
        Layer.matmul(seq, 3 * d, d, repeat=layers_n, name="qkv"),
        Layer.matmul(seq, seq, hd, repeat=layers_n * heads, name="score"),
        Layer.matmul(seq, hd, seq, repeat=layers_n * heads, name="context"),
        Layer.matmul(seq, d, d, repeat=layers_n, name="attn_out"),
        Layer.matmul(seq, dff, d, repeat=layers_n, name="ffn_up"),
        Layer.matmul(seq, d, dff, repeat=layers_n, name="ffn_down"),
    ]
    return Workload(layers=tuple(layers), name="bert")


def unet() -> Workload:
    """2D U-Net, 256x256 input, channel widths 64..1024."""
    layers = []
    widths = [64, 128, 256, 512]
    res = [256, 128, 64, 32]
    cin = 3
    for w, r in zip(widths, res):          # contracting path
        layers.append(Layer.conv(cin, w, 3, r, name=f"down{w}a"))
        layers.append(Layer.conv(w, w, 3, r, name=f"down{w}b"))
        cin = w
    layers.append(Layer.conv(512, 1024, 3, 16, name="bottom_a"))
    layers.append(Layer.conv(1024, 1024, 3, 16, name="bottom_b"))
    up_in = 1024
    for w, r in zip(reversed(widths), reversed(res)):   # expanding path
        layers.append(Layer.conv(up_in, w, 2, r, name=f"upconv{w}"))
        layers.append(Layer.conv(2 * w, w, 3, r, name=f"up{w}a"))
        layers.append(Layer.conv(w, w, 3, r, name=f"up{w}b"))
        up_in = w
    layers.append(Layer.conv(64, 2, 1, 256, name="head"))
    wl = dedupe_layers(layers)
    return Workload(layers=wl.layers, name="unet")


def retinanet() -> Workload:
    """RetinaNet FPN + heads (non-ResNet-backbone layers, per Table 6),
    224 input => P3..P7 spatial 28,14,7,4,2."""
    layers = [
        Layer.conv(512, 256, 1, 28, name="lat_c3"),
        Layer.conv(1024, 256, 1, 14, name="lat_c4"),
        Layer.conv(2048, 256, 1, 7, name="lat_c5"),
        Layer.conv(256, 256, 3, 28, name="smooth_p3"),
        Layer.conv(256, 256, 3, 14, name="smooth_p4"),
        Layer.conv(256, 256, 3, 7, name="smooth_p5"),
        Layer.conv(2048, 256, 3, 4, stride=2, name="p6"),
        Layer.conv(256, 256, 3, 2, stride=2, name="p7"),
    ]
    for hw in (28, 14, 7, 4, 2):
        layers.append(Layer.conv(256, 256, 3, hw, repeat=8,
                                 name=f"head{hw}"))      # 4 cls + 4 box
        layers.append(Layer.conv(256, 720, 3, hw, name=f"cls{hw}"))  # 9x80
        layers.append(Layer.conv(256, 36, 3, hw, name=f"box{hw}"))   # 9x4
    wl = dedupe_layers(layers)
    return Workload(layers=wl.layers, name="retinanet")


# ---------------------------------------------------------------------------
# Training workloads (for the DNN residual model, Sec. 4.7/6.5)
# ---------------------------------------------------------------------------

def alexnet() -> Workload:
    layers = [
        Layer.conv(3, 64, 11, 55, stride=4, name="c1"),
        Layer.conv(64, 192, 5, 27, name="c2"),
        Layer.conv(192, 384, 3, 13, name="c3"),
        Layer.conv(384, 256, 3, 13, name="c4"),
        Layer.conv(256, 256, 3, 13, name="c5"),
        Layer.matmul(1, 4096, 9216, name="fc6"),
        Layer.matmul(1, 4096, 4096, name="fc7"),
        Layer.matmul(1, 1000, 4096, name="fc8"),
    ]
    return Workload(layers=tuple(layers), name="alexnet")


def vgg16() -> Workload:
    spec = [(3, 64, 224), (64, 64, 224), (64, 128, 112), (128, 128, 112),
            (128, 256, 56), (256, 256, 56), (256, 256, 56),
            (256, 512, 28), (512, 512, 28), (512, 512, 28),
            (512, 512, 14), (512, 512, 14), (512, 512, 14)]
    layers = [Layer.conv(i, o, 3, r, name=f"c{n}")
              for n, (i, o, r) in enumerate(spec)]
    layers += [Layer.matmul(1, 4096, 25088, name="fc1"),
               Layer.matmul(1, 4096, 4096, name="fc2"),
               Layer.matmul(1, 1000, 4096, name="fc3")]
    wl = dedupe_layers(layers)
    return Workload(layers=wl.layers, name="vgg16")


def resnext50() -> Workload:
    """ResNeXt-50 32x4d: grouped 3x3 convs expressed per group (C/32,
    K/32) with 32x repeats."""
    layers = [Layer.conv(3, 64, 7, 112, stride=2, name="conv1")]
    stages = [
        (64, 128, 256, 56, 3, 1),
        (256, 256, 512, 28, 4, 2),
        (512, 512, 1024, 14, 6, 2),
        (1024, 1024, 2048, 7, 3, 2),
    ]
    for (cin, mid, cout, hw, blocks, stride) in stages:
        layers += [
            Layer.conv(cin, mid, 1, hw, stride=stride, name="reduce"),
            Layer.conv(mid // 32, mid // 32, 3, hw, repeat=32,
                       name="grouped"),
            Layer.conv(mid, cout, 1, hw, name="expand"),
            Layer.conv(cin, cout, 1, hw, stride=stride, name="proj"),
        ]
        for _ in range(blocks - 1):
            layers += [
                Layer.conv(cout, mid, 1, hw, name="reduce"),
                Layer.conv(mid // 32, mid // 32, 3, hw, repeat=32,
                           name="grouped"),
                Layer.conv(mid, cout, 1, hw, name="expand"),
            ]
    layers.append(Layer.matmul(1, 1000, 2048, name="fc"))
    wl = dedupe_layers(layers)
    return Workload(layers=wl.layers, name="resnext50")


def deepbench() -> Workload:
    """DeepBench OCR and face-recognition GEMMs (public kernel list)."""
    gemms = [
        (5124, 700, 2048, "ocr1"),
        (35, 700, 2048, "ocr2"),
        (5124, 700, 2560, "ocr3"),
        (35, 700, 2560, "ocr4"),
        (7680, 1500, 2560, "face1"),
        (3072, 1500, 1024, "face2"),
        (7680, 2560, 2560, "face3"),
        (3072, 1024, 1024, "face4"),
    ]
    layers = [Layer.matmul(m, n, k, name=nm) for (m, n, k, nm) in gemms]
    return Workload(layers=tuple(layers), name="deepbench")


TARGET_WORKLOADS = {
    "bert": bert,
    "resnet50": resnet50,
    "retinanet": retinanet,
    "unet": unet,
}

TRAINING_WORKLOADS = {
    "alexnet": alexnet,
    "resnext50": resnext50,
    "vgg16": vgg16,
    "deepbench": deepbench,
}


def get_workload(name: str) -> Workload:
    if name in TARGET_WORKLOADS:
        return TARGET_WORKLOADS[name]()
    if name in TRAINING_WORKLOADS:
        return TRAINING_WORKLOADS[name]()
    raise KeyError(name)
