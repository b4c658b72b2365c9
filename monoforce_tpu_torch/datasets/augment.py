"""Image augmentation with post-homography bookkeeping.

Own copy of ``monoforce_tpu/datasets/augment.py``; ``vis`` takes
``denormalize_img`` and the ImageNet statistics from here.

Reference parity: sample_augmentation / img_transform
(reference: monoforce/src/monoforce/models/terrain_encoder/utils.py:52-133).
The (post_rot, post_tran) pair records the pixel-space affine map applied to
the image so the lift step can undo it (get_geometry); the bookkeeping below
follows the same resize -> crop -> flip -> rotate composition in numpy.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

__all__ = [
    "sample_augmentation", "img_transform", "normalize_img",
    "denormalize_img", "resize_img", "IMG_MEAN", "IMG_STD",
]

IMG_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _rot2(angle_rad: float) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return np.array([[c, s], [-s, c]], dtype=np.float32)


def sample_augmentation(lss_cfg, is_train: bool = False,
                        rng: np.random.Generator | None = None):
    """Sample (resize, resize_dims, crop, flip, rotate) for one image."""
    rng = rng or np.random.default_rng()
    aug = lss_cfg["data_aug_conf"]
    H, W = aug["H"], aug["W"]
    fH, fW = aug["final_dim"]
    if is_train:
        resize = rng.uniform(*aug["resize_lim"])
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - rng.uniform(*aug["bot_pct_lim"])) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        flip = bool(aug["rand_flip"]) and bool(rng.integers(0, 2))
        rotate = float(rng.uniform(*aug["rot_lim"]))
    else:
        resize = max(fH / H, fW / W)
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - np.mean(aug["bot_pct_lim"])) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        flip, rotate = False, 0.0
    crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
    return resize, (newW, newH), crop, flip, rotate


def img_transform(img: Image.Image, post_rot: np.ndarray, post_tran: np.ndarray,
                  resize: float, resize_dims, crop, flip: bool, rotate: float):
    """Apply the augmentation to a PIL image and update the 2D affine map."""
    img = img.resize(resize_dims)
    img = img.crop(crop)
    if flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    img = img.rotate(rotate)

    post_rot = post_rot * resize
    post_tran = post_tran - np.asarray(crop[:2], dtype=np.float32)
    if flip:
        A = np.array([[-1, 0], [0, 1]], dtype=np.float32)
        b = np.array([crop[2] - crop[0], 0], dtype=np.float32)
        post_rot = A @ post_rot
        post_tran = A @ post_tran + b
    A = _rot2(rotate / 180.0 * np.pi)
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]], dtype=np.float32) / 2
    b = A @ (-b) + b
    post_rot = A @ post_rot
    post_tran = A @ post_tran + b
    return img, post_rot, post_tran


def normalize_img(img: Image.Image) -> np.ndarray:
    """PIL -> (3, H, W) float32, ImageNet-normalized."""
    arr = np.asarray(img, dtype=np.float32)[..., :3] / 255.0
    arr = (arr - IMG_MEAN) / IMG_STD
    return arr.transpose(2, 0, 1)


def denormalize_img(chw: np.ndarray) -> np.ndarray:
    """(3, H, W) normalized -> (H, W, 3) uint8."""
    arr = np.asarray(chw)[:3].transpose(1, 2, 0) * IMG_STD + IMG_MEAN
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8)


def resize_img(img: Image.Image, size: int = 512) -> Image.Image:
    """Resize the shorter side to ``size`` (bicubic), keeping aspect.

    Long-edge rounding TRUNCATES (``int(size * long / short)``) to match the
    reference's ``torchvision.transforms.Resize(512, BICUBIC)`` exactly
    (reference terrain_encoder/utils.py:107; torchvision computes the long
    edge the same way) — the real-data head-to-head tests compare resized
    pixels bit-for-bit."""
    w, h = img.size
    if h <= w:
        new_h, new_w = size, int(size * w / h)
    else:
        new_w, new_h = size, int(size * h / w)
    if (w, h) == (new_w, new_h):
        return img
    return img.resize((new_w, new_h), Image.BICUBIC)
