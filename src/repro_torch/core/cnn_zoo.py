"""Analytic op-graph generator for the paper's 15 CNN model set (§III, M).

Each model is a layer-spec list; ``build_ops(model, batch, pix)`` walks it and
emits per-op work records ``(op_name, flops, bytes, params)`` including the
backward pass and optimizer ops — the TF-Profiler-style measurement plane the
simulator turns into latencies. Op names intentionally mirror TensorFlow's
(Conv2D, Conv2DBackpropFilter, Relu6, FusedBatchNormV3, ...) because PROFET's
name-clustering heuristic operates on exactly these strings.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

# --------------------------------------------------------------------------
# layer spec DSL
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Conv:
    cout: int
    k: int = 3
    stride: int = 1
    depthwise: bool = False
    act: str = "Relu"        # Relu | Relu6 | Tanh | ""
    bn: bool = False
    repeat: int = 1


@dataclasses.dataclass(frozen=True)
class Pool:
    k: int = 2
    kind: str = "Max"        # Max | Avg


@dataclasses.dataclass(frozen=True)
class FC:
    out: int
    act: str = "Relu"
    dropout: bool = False


@dataclasses.dataclass(frozen=True)
class Residual:
    """Marks a residual Add over the last `span` conv layers' output."""
    span: int = 2


@dataclasses.dataclass(frozen=True)
class Branch:
    """Inception-style parallel branches, concatenated (ConcatV2)."""
    branches: Tuple[Tuple[Conv, ...], ...]


@dataclasses.dataclass(frozen=True)
class LRN:
    pass


def _vgg(blocks: Sequence[Tuple[int, int]]) -> List:
    spec: List = []
    for n, c in blocks:
        spec.append(Conv(c, 3, repeat=n))
        spec.append(Pool())
    spec += [FC(4096, dropout=True), FC(4096, dropout=True), FC(1000, act="")]
    return spec


def _resnet_basic(stages: Sequence[Tuple[int, int]], stem=64) -> List:
    spec: List = [Conv(stem, 7, stride=2, bn=True), Pool()]
    for n, c in stages:
        for i in range(n):
            stride = 2 if (i == 0 and c != stem) else 1
            spec += [Conv(c, 3, stride=stride, bn=True),
                     Conv(c, 3, bn=True, act=""), Residual(2)]
    spec += [Pool(kind="Avg"), FC(1000, act="")]
    return spec


def _resnet_bottleneck(stages: Sequence[Tuple[int, int]]) -> List:
    spec: List = [Conv(64, 7, stride=2, bn=True), Pool()]
    for n, c in stages:
        for i in range(n):
            stride = 2 if (i == 0 and c != 64) else 1
            spec += [Conv(c, 1, stride=stride, bn=True),
                     Conv(c, 3, bn=True),
                     Conv(4 * c, 1, bn=True, act=""), Residual(3)]
    spec += [Pool(kind="Avg"), FC(1000, act="")]
    return spec


def _mobilenet_v2() -> List:
    spec: List = [Conv(32, 3, stride=2, bn=True, act="Relu6")]
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    cin = 32
    for t, c, n, s in cfg:
        for i in range(n):
            stride = s if i == 0 else 1
            spec += [Conv(cin * t, 1, bn=True, act="Relu6"),
                     Conv(cin * t, 3, stride=stride, depthwise=True, bn=True,
                          act="Relu6"),
                     Conv(c, 1, bn=True, act="")]
            if stride == 1 and cin == c:
                spec.append(Residual(3))
            cin = c
    spec += [Conv(1280, 1, bn=True, act="Relu6"), Pool(kind="Avg"),
             FC(1000, act="")]
    return spec


def _inception_block(c: int) -> Branch:
    return Branch((
        (Conv(c, 1, bn=True),),
        (Conv(c, 1, bn=True), Conv(c, 3, bn=True)),
        (Conv(c // 2, 1, bn=True), Conv(c // 2, 5, bn=True)),
        (Conv(c // 2, 1, bn=True),),
    ))


def _inception_v3() -> List:
    spec: List = [Conv(32, 3, stride=2, bn=True), Conv(64, 3, bn=True), Pool()]
    for c in (64, 64, 96):
        spec.append(_inception_block(c))
    spec.append(Pool())
    for c in (128, 128, 160, 192):
        spec.append(_inception_block(c))
    spec.append(Pool())
    for c in (256, 320):
        spec.append(_inception_block(c))
    spec += [Pool(kind="Avg"), FC(1000, act="")]
    return spec


def _inception_resnet_v2() -> List:
    spec: List = [Conv(32, 3, stride=2, bn=True), Conv(64, 3, bn=True), Pool()]
    for c in (64, 96, 96):
        spec += [_inception_block(c), Conv(4 * c, 1, bn=True, act=""),
                 Residual(1)]
    spec.append(Pool())
    for c in (128, 160, 192, 192):
        spec += [_inception_block(c), Conv(4 * c, 1, bn=True, act=""),
                 Residual(1)]
    spec += [Pool(kind="Avg"), FC(1000, act="")]
    return spec


MODELS: Dict[str, List] = {
    "LeNet5": [Conv(6, 5, act="Tanh"), Pool(kind="Avg"),
               Conv(16, 5, act="Tanh"), Pool(kind="Avg"),
               FC(120, act="Tanh"), FC(84, act="Tanh"), FC(10, act="")],
    "MNIST_CNN": [Conv(32, 3), Conv(64, 3), Pool(),
                  FC(128, dropout=True), FC(10, act="")],
    "CIFAR10_CNN": [Conv(32, 3, repeat=2), Pool(), Conv(64, 3, repeat=2),
                    Pool(), FC(256, dropout=True), FC(10, act="")],
    "AlexNet": [Conv(96, 11, stride=4), LRN(), Pool(),
                Conv(256, 5), LRN(), Pool(),
                Conv(384, 3), Conv(384, 3), Conv(256, 3), Pool(),
                FC(4096, dropout=True), FC(4096, dropout=True),
                FC(1000, act="")],
    "VGG11": _vgg([(1, 64), (1, 128), (2, 256), (2, 512), (2, 512)]),
    "VGG13": _vgg([(2, 64), (2, 128), (2, 256), (2, 512), (2, 512)]),
    "VGG16": _vgg([(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]),
    "VGG19": _vgg([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]),
    "ResNetSmall": [Conv(16, 3, bn=True)] + sum(
        ([Conv(c, 3, bn=True), Conv(c, 3, bn=True, act=""), Residual(2)]
         for c in (16, 16, 16, 32, 32, 32, 64, 64, 64)), []) +
        [Pool(kind="Avg"), FC(10, act="")],
    "ResNet18": _resnet_basic([(2, 64), (2, 128), (2, 256), (2, 512)]),
    "ResNet34": _resnet_basic([(3, 64), (4, 128), (6, 256), (3, 512)]),
    "ResNet50": _resnet_bottleneck([(3, 64), (4, 128), (6, 256), (3, 512)]),
    "MobileNetV2": _mobilenet_v2(),
    "InceptionV3": _inception_v3(),
    "InceptionResNetV2": _inception_resnet_v2(),
}

MODEL_NAMES = tuple(MODELS)


# --------------------------------------------------------------------------
# op-graph generation
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Op:
    name: str
    flops: float
    bytes: float
    params: float = 0.0


def _conv_ops(ops: List[Op], spec: Conv, B: int, h: int, w: int,
              cin: int) -> Tuple[int, int, int]:
    for _ in range(spec.repeat):
        ho = max(1, math.ceil(h / spec.stride))
        wo = max(1, math.ceil(w / spec.stride))
        if spec.depthwise:
            flops = 2.0 * B * ho * wo * spec.k ** 2 * cin
            nparams = spec.k ** 2 * cin
            name = "DepthwiseConv2dNative"
            bwd = [("DepthwiseConv2dNativeBackpropInput", flops),
                   ("DepthwiseConv2dNativeBackpropFilter", flops)]
            cout = cin
        else:
            cout = spec.cout
            flops = 2.0 * B * ho * wo * spec.k ** 2 * cin * cout
            nparams = spec.k ** 2 * cin * cout
            name = "Conv2D"
            bwd = [("Conv2DBackpropInput", flops),
                   ("Conv2DBackpropFilter", flops)]
        act_in = 4.0 * B * h * w * cin
        act_out = 4.0 * B * ho * wo * cout
        ops.append(Op(name, flops, act_in + act_out + 4 * nparams, nparams))
        for bname, bflops in bwd:
            ops.append(Op(bname, bflops, act_in + act_out + 4 * nparams,
                          nparams))
        elems = B * ho * wo * cout
        ops.append(Op("BiasAdd", elems, 8.0 * elems, cout))
        ops.append(Op("BiasAddGrad", elems, 8.0 * elems, cout))
        if spec.bn:
            ops.append(Op("FusedBatchNormV3", 4.0 * elems, 12.0 * elems,
                          2 * cout))
            ops.append(Op("FusedBatchNormGradV3", 6.0 * elems, 16.0 * elems,
                          2 * cout))
        if spec.act:
            ops.append(Op(spec.act, elems, 8.0 * elems))
            ops.append(Op(f"{spec.act}Grad", elems, 12.0 * elems))
        h, w, cin = ho, wo, cout
    return h, w, cin


def build_ops(model: str, batch: int, pix: int) -> List[Op]:
    """Forward+backward+optimizer op list for one training step."""
    spec_list = MODELS[model]
    B, h, w, cin = batch, pix, pix, 3
    ops: List[Op] = [
        Op("IteratorGetNext", 0.0, 4.0 * B * pix * pix * 3),
        Op("Cast", B * pix * pix * 3, 8.0 * B * pix * pix * 3),
    ]
    out_stack: List[Tuple[int, int, int]] = []
    for spec in spec_list:
        if isinstance(spec, Conv):
            h, w, cin = _conv_ops(ops, spec, B, h, w, cin)
            out_stack.append((h, w, cin))
        elif isinstance(spec, Pool):
            ho, wo = max(1, h // spec.k), max(1, w // spec.k)
            elems = B * ho * wo * cin
            ops.append(Op(f"{spec.kind}Pool", spec.k ** 2 * elems,
                          4.0 * (B * h * w * cin + elems)))
            ops.append(Op(f"{spec.kind}PoolGrad", spec.k ** 2 * elems,
                          8.0 * (B * h * w * cin + elems)))
            h, w = ho, wo
        elif isinstance(spec, FC):
            fan_in = h * w * cin if out_stack or h > 1 else cin
            fan_in = h * w * cin
            flops = 2.0 * B * fan_in * spec.out
            nparams = fan_in * spec.out
            ops.append(Op("MatMul", 3.0 * flops,          # fwd + 2 bwd matmuls
                          3 * (4.0 * B * (fan_in + spec.out) + 4.0 * nparams),
                          nparams))
            ops.append(Op("BiasAdd", B * spec.out, 8.0 * B * spec.out, spec.out))
            ops.append(Op("BiasAddGrad", B * spec.out, 8.0 * B * spec.out))
            if spec.act:
                ops.append(Op(spec.act, B * spec.out, 8.0 * B * spec.out))
                ops.append(Op(f"{spec.act}Grad", B * spec.out, 12.0 * B * spec.out))
            if spec.dropout:
                ops.append(Op("RandomUniform", B * spec.out, 4.0 * B * spec.out))
                ops.append(Op("Mul", B * spec.out, 12.0 * B * spec.out))
            h, w, cin = 1, 1, spec.out
        elif isinstance(spec, Residual):
            elems = B * h * w * cin
            ops.append(Op("AddV2", elems, 12.0 * elems))
        elif isinstance(spec, Branch):
            h0, w0, c0 = h, w, cin
            couts = []
            for branch in spec.branches:
                bh, bw, bc = h0, w0, c0
                for conv in branch:
                    bh, bw, bc = _conv_ops(ops, conv, B, bh, bw, bc)
                couts.append(bc)
            cin = sum(couts)
            h, w = bh, bw
            elems = B * h * w * cin
            ops.append(Op("ConcatV2", 0.0, 8.0 * elems))
        elif isinstance(spec, LRN):
            elems = B * h * w * cin
            ops.append(Op("LRN", 6.0 * elems, 8.0 * elems))
            ops.append(Op("LRNGrad", 8.0 * elems, 12.0 * elems))

    # loss + optimizer (SGD-style updates, as the paper's workloads)
    nclass = cin
    ops.append(Op("Softmax", 4.0 * B * nclass, 8.0 * B * nclass))
    ops.append(Op("ArgMax", B * nclass, 4.0 * B * nclass))
    ops.append(Op("SparseSoftmaxCrossEntropyWithLogits", 6.0 * B * nclass,
                  8.0 * B * nclass))
    total_params = sum(o.params for o in ops)
    ops.append(Op("AssignSubVariableOp", total_params, 8.0 * total_params))
    ops.append(Op("AssignAddVariableOp", B, 8.0 * B))
    ops.append(Op("Sum", B, 4.0 * B))
    ops.append(Op("Mean", B, 4.0 * B))
    return ops


def model_params(model: str) -> float:
    return sum(o.params for o in build_ops(model, 1, 64))


def peak_activation_bytes(model: str, batch: int, pix: int) -> float:
    """Rough peak memory (sum of fwd activations) for feasibility filtering."""
    return sum(o.bytes for o in build_ops(model, batch, pix)
               if "Conv2D" == o.name or o.name == "MatMul") * 0.5
