"""Tile a batch of images into one grid image (counterpart of
baselines_tpu/core/tile_images.py, after baselines/common/tile_images.py:1-23), for the
host pools' ``render``."""

from __future__ import annotations

import numpy as np


def tile_images(img_nhwc):
    """(N, h, w, c) -> (H*h, W*w, c) with N <= H*W, the grid roughly square and the
    cells past N black."""
    img_nhwc = np.asarray(img_nhwc)
    N, h, w, c = img_nhwc.shape
    H = int(np.ceil(np.sqrt(N)))
    W = int(np.ceil(float(N) / H))
    img_nhwc = np.array(list(img_nhwc) + [img_nhwc[0] * 0 for _ in range(N, H * W)])
    img_HWhwc = img_nhwc.reshape(H, W, h, w, c)
    img_HhWwc = img_HWhwc.transpose(0, 2, 1, 3, 4)
    return img_HhWwc.reshape(H * h, W * w, c)
