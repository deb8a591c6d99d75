"""ResNet model family built on the fluid layer surface.

Counterpart of ``paddle_tpu/models/resnet.py``: ``conv2d`` + ``batch_norm``
+ residual shortcuts, the same layers in the same order, so the program
holds the same ops under the same names as the JAX package's. With
``data_format="NHWC"`` every conv, batch norm and pool runs channels-last,
and under ``FLAGS_use_pallas_conv=all`` the 44 convs of ResNet-50 whose
Cin is a multiple of 128 run the hand-written implicit-GEMM kernel K5
(``ops/cuda/conv.py``); the 3-channel stem and the 64-channel convs stay
on cuDNN.
"""
from __future__ import annotations

from .. import layers


def _conv_bn(x, num_filters, filter_size, stride=1, act=None, is_test=False,
             data_format="NCHW"):
    conv = layers.conv2d(
        x,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2,
        act=None,
        bias_attr=False,
        data_format=data_format,
    )
    return layers.batch_norm(conv, act=act, is_test=is_test,
                             data_layout=data_format)


def _shortcut(x, ch_out, stride, is_test=False, data_format="NCHW"):
    ch_in = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    if ch_in != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride, is_test=is_test,
                        data_format=data_format)
    return x


def _bottleneck(x, num_filters, stride, is_test=False, data_format="NCHW"):
    conv0 = _conv_bn(x, num_filters, 1, act="relu", is_test=is_test,
                     data_format=data_format)
    conv1 = _conv_bn(conv0, num_filters, 3, stride, act="relu",
                     is_test=is_test, data_format=data_format)
    conv2 = _conv_bn(conv1, num_filters * 4, 1, act=None, is_test=is_test,
                     data_format=data_format)
    short = _shortcut(x, num_filters * 4, stride, is_test=is_test,
                      data_format=data_format)
    return layers.relu(layers.elementwise_add(short, conv2))


def _basic_block(x, num_filters, stride, is_test=False, data_format="NCHW"):
    conv0 = _conv_bn(x, num_filters, 3, stride, act="relu", is_test=is_test,
                     data_format=data_format)
    conv1 = _conv_bn(conv0, num_filters, 3, act=None, is_test=is_test,
                     data_format=data_format)
    short = _shortcut(x, num_filters, stride, is_test=is_test,
                      data_format=data_format)
    return layers.relu(layers.elementwise_add(short, conv1))


_DEPTH_CFG = {
    18: (_basic_block, [2, 2, 2, 2]),
    34: (_basic_block, [3, 4, 6, 3]),
    50: (_bottleneck, [3, 4, 6, 3]),
    101: (_bottleneck, [3, 4, 23, 3]),
    152: (_bottleneck, [3, 8, 36, 3]),
}


def resnet(input, class_dim=1000, depth=50, is_test=False,
           data_format="NCHW"):
    """ImageNet-layout ResNet. ``input`` is NCHW [N, 3, H, W] or, with
    ``data_format="NHWC"``, channels-last [N, H, W, 3]."""
    block_fn, counts = _DEPTH_CFG[depth]
    x = _conv_bn(input, 64, 7, stride=2, act="relu", is_test=is_test,
                 data_format=data_format)
    x = layers.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                      pool_padding=1, data_format=data_format)
    for stage, n_blocks in enumerate(counts):
        for i in range(n_blocks):
            stride = 2 if i == 0 and stage > 0 else 1
            x = block_fn(x, 64 * (2 ** stage), stride, is_test=is_test,
                         data_format=data_format)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True,
                      data_format=data_format)
    return layers.fc(x, class_dim, act="softmax")


def resnet50(input, class_dim=1000, is_test=False, data_format="NCHW"):
    return resnet(input, class_dim, 50, is_test, data_format)


def resnet_cifar(input, class_dim=10, n=3, is_test=False):
    """CIFAR-layout ResNet (6n+2 layers; n=3 -> ResNet-20)."""
    x = _conv_bn(input, 16, 3, act="relu", is_test=is_test)
    for stage in range(3):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            x = _basic_block(x, 16 * (2 ** stage), stride, is_test=is_test)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(x, class_dim, act="softmax")


def build_resnet_train(batch, image_size=224, class_dim=1000, depth=50,
                       data_format="NHWC", learning_rate=0.1, momentum=0.9,
                       seed=0, use_bf16=False):
    """(main, startup, loss) of bench.py's ResNet training script
    (``_build_resnet50``, bench.py:43-65): images and int64 labels, the
    ResNet, the mean cross entropy of its softmax, and
    ``MomentumOptimizer(learning_rate, momentum).minimize``, built under
    fresh names; ``seed`` is the startup program's random seed (0 draws
    one per op from the executor). ``use_bf16`` wraps the optimizer in
    ``contrib.mixed_precision.decorate``, as bench.py runs the script by
    default (``_build_resnet50``'s own default is False): the convs and the fc
    product in bfloat16, batch norm and the loss in float32, float32
    master parameters."""
    import paddle_tpu_torch as fluid

    img_shape = ([batch, 3, image_size, image_size] if data_format == "NCHW"
                 else [batch, image_size, image_size, 3])
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data(name="img", shape=img_shape, dtype="float32")
        label = fluid.data(name="label", shape=[batch, 1], dtype="int64")
        pred = resnet(img, class_dim, depth, data_format=data_format)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        opt = fluid.optimizer.MomentumOptimizer(
            learning_rate=learning_rate, momentum=momentum)
        if use_bf16:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def random_batch(rng, batch, image_size=224, class_dim=1000,
                 data_format="NHWC"):
    """Seeded images in [0, 1) and labels (numpy ``RandomState``), as
    bench.py feeds them."""
    shape = ((batch, 3, image_size, image_size) if data_format == "NCHW"
             else (batch, image_size, image_size, 3))
    return {"img": rng.rand(*shape).astype("float32"),
            "label": rng.randint(0, class_dim, (batch, 1)).astype("int64")}
