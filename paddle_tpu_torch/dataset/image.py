"""Image transform utilities (reference python/paddle/dataset/image.py).

numpy/PIL implementations of the reference's cv2-based helpers; same
semantics (HWC uint8 in, CHW float32 out of simple_transform).
"""
from __future__ import annotations

import numpy as np

__all__ = ["resize_short", "center_crop", "random_crop", "left_right_flip",
           "simple_transform", "to_chw", "load_image_bytes", "load_image"]


def _to_pil(im):
    from PIL import Image

    if im.dtype != np.uint8:
        im = np.clip(im, 0, 255).astype(np.uint8)
    return Image.fromarray(im)


def resize_short(im, size):
    """Scale so the SHORT side equals size (reference resize_short)."""
    h, w = im.shape[:2]
    if h > w:
        new_w, new_h = size, int(round(h * size / float(w)))
    else:
        new_w, new_h = int(round(w * size / float(h))), size
    pil = _to_pil(im).resize((new_w, new_h))
    return np.asarray(pil)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im, size, is_color=True, rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    h_start = int(rng.randint(0, h - size + 1))
    w_start = int(rng.randint(0, w - size + 1))
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def simple_transform(im, resize_size, crop_size, is_train=True,
                     is_color=True, mean=None, rng=None):
    """resize_short -> (random|center) crop -> maybe flip -> CHW float32
    (reference simple_transform)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if (rng or np.random).randint(0, 2) == 0:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.array(mean, dtype="float32")
        if mean.ndim == 1:
            mean = mean[:, None, None]
        im -= mean
    else:
        im /= 255.0
    return im


def load_image_bytes(data, is_color=True):
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(path, is_color=True):
    with open(path, "rb") as f:
        return load_image_bytes(f.read(), is_color)
