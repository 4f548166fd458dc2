"""SimCLR two-view augmentation on the device, counterpart of
``ntxent_tpu/training/augment.py``.

The recipe of the JAX package, batched: random resized crop (bilinear),
horizontal flip, colour jitter with p 0.8 (brightness, contrast about the
luma mean, saturation, YIQ hue rotation, clip to [0, 1]), grayscale with
p 0.2, separable Gaussian blur with p 0.5. Images are (B, H, W, C) in
[0, 1], as in the JAX package.

Every random parameter is a (B,) tensor drawn from an explicit
``torch.Generator`` on the images' device (``view_params``); there is no
Python loop over images. A rank of a data-parallel run draws them for the
whole global batch and applies its rows' share, so it sees the views one
process would make. The deterministic transforms take those parameters as
arguments (``resized_crop``, ``color_jitter``, ``gaussian_blur``, ...),
which is how the tests hold each one to its JAX function at the JAX
draws: the two frameworks' random streams cannot match.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["adjust_hue", "adjust_saturation", "apply_view",
           "augment_batch_pair", "augment_views", "blur_kernel_size",
           "color_jitter", "gaussian_blur", "grayscale", "resized_crop",
           "scale_and_translate_weights", "view_params"]

_RGB_TO_Y = (0.299, 0.587, 0.114)
_YIQ_FROM_RGB = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.322],
                          [0.211, -0.523, 0.312]], np.float32)
_RGB_FROM_YIQ = np.linalg.inv(_YIQ_FROM_RGB).astype(np.float32)
_F32_EPS = float(np.finfo(np.float32).eps)


def _luma(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W) luma (the JAX package's tensordot)."""
    return images @ torch.tensor(_RGB_TO_Y, dtype=images.dtype,
                                 device=images.device)


def scale_and_translate_weights(in_size: int, out_size: int,
                                scale: torch.Tensor,
                                translation: torch.Tensor) -> torch.Tensor:
    """(B, in_size, out_size) bilinear resampling weights of
    ``jax.image.scale_and_translate`` (``compute_weight_mat``, antialias
    on): output pixel i samples the input at ``(i + 0.5 - t) / s - 0.5``
    (half-pixel centres), triangle kernel widened by ``max(1/s, 1)``,
    columns normalized to sum 1, samples outside the input zeroed."""
    dev, dt = scale.device, scale.dtype
    inv = (1.0 / scale)[:, None]
    sample = ((torch.arange(out_size, dtype=dt, device=dev) + 0.5) * inv
              - translation[:, None] * inv - 0.5)                # (B, out)
    kscale = torch.clamp(inv, min=1.0)[:, :, None]
    x = torch.abs(sample[:, None, :] - torch.arange(
        in_size, dtype=dt, device=dev)[None, :, None]) / kscale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, 0.0)


def resized_crop(images: torch.Tensor, area: torch.Tensor,
                 log_ratio: torch.Tensor, u_x: torch.Tensor,
                 u_y: torch.Tensor) -> torch.Tensor:
    """Crop a box of relative ``area`` and aspect ``exp(log_ratio)`` whose
    corner sits at ``u_y``/``u_x`` in [0, 1) of the free range, and resize
    it back to (H, W) bilinearly (``random_resized_crop`` at fixed
    draws). The scale is >= 1, so the resize only interpolates."""
    _, h, w, _ = images.shape
    aspect = torch.exp(log_ratio)
    crop_h = torch.clamp(torch.sqrt(area / aspect) * h, 1.0, float(h))
    crop_w = torch.clamp(torch.sqrt(area * aspect) * w, 1.0, float(w))
    y0 = u_y * (h - crop_h)
    x0 = u_x * (w - crop_w)
    sy, sx = h / crop_h, w / crop_w
    wy = scale_and_translate_weights(h, h, sy, -y0 * sy)   # (B, H, H')
    wx = scale_and_translate_weights(w, w, sx, -x0 * sx)   # (B, W, W')
    x = images.permute(0, 3, 1, 2)                         # (B, C, H, W)
    out = wy.transpose(1, 2)[:, None] @ x @ wx[:, None]    # (B, C, H', W')
    return out.permute(0, 2, 3, 1)


def adjust_saturation(images: torch.Tensor,
                      factor: torch.Tensor) -> torch.Tensor:
    gray = _luma(images)[..., None]
    return gray + factor[:, None, None, None] * (images - gray)


def adjust_hue(images: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Rotate chroma in YIQ space by ``delta`` radians, per image."""
    dev, dt = images.device, images.dtype
    yiq = images @ torch.from_numpy(_YIQ_FROM_RGB.T).to(dev, dt)
    cos, sin = torch.cos(delta), torch.sin(delta)
    one, zero = torch.ones_like(delta), torch.zeros_like(delta)
    rot = torch.stack([torch.stack([one, zero, zero], -1),
                       torch.stack([zero, cos, -sin], -1),
                       torch.stack([zero, sin, cos], -1)], -2)  # (B, 3, 3)
    yiq = yiq @ rot.transpose(1, 2)[:, None]
    return yiq @ torch.from_numpy(_RGB_FROM_YIQ.T).to(dev, dt)


def color_jitter(images: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor, saturation: torch.Tensor,
                 hue: torch.Tensor) -> torch.Tensor:
    """SimCLR colour jitter at fixed factors: brightness scale, contrast
    about the per-image luma mean, saturation, hue rotation by
    ``hue * 2 * pi`` radians (``hue`` in [-0.2, 0.2] at strength 1), clip."""
    images = images * brightness[:, None, None, None]
    mean = _luma(images).mean(dim=(1, 2))[:, None, None, None]
    images = mean + (images - mean) * contrast[:, None, None, None]
    images = adjust_saturation(images, saturation)
    images = adjust_hue(images, hue * 2 * math.pi)
    return torch.clamp(images, 0.0, 1.0)


def grayscale(images: torch.Tensor) -> torch.Tensor:
    return _luma(images)[..., None].expand(images.shape)


def blur_kernel_size(height: int) -> int:
    """~10% of the image height, odd, at least 3."""
    return max(3, (height // 10) | 1)


def gaussian_blur(images: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur, one sigma per image, zero "SAME" padding,
    ``blur_kernel_size(H)`` taps."""
    b, h, w, c = images.shape
    r = blur_kernel_size(h) // 2
    xs = torch.arange(-r, r + 1, dtype=images.dtype, device=images.device)
    kern = torch.exp(-0.5 * (xs[None, :] / sigma[:, None]) ** 2)
    kern = kern / kern.sum(dim=1, keepdim=True)               # (B, K)
    weight = kern.repeat_interleave(c, dim=0)                  # (B*C, K)
    x = images.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.conv2d(x, weight[:, None, :, None], padding=(r, 0), groups=b * c)
    x = F.conv2d(x, weight[:, None, None, :], padding=(0, r), groups=b * c)
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _where(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(flag[:, None, None, None], a, b)


def view_params(batch: int, generator: torch.Generator,
                device=None) -> dict[str, torch.Tensor]:
    """The random parameters of one SimCLR view of each of ``batch``
    images (strength 1, blur on): (batch,) tensors drawn from
    ``generator`` in a fixed order."""

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=device)

    def bernoulli(p: float) -> torch.Tensor:
        return torch.rand(batch, generator=generator, device=device) < p

    # a dict display evaluates in order: this is the order of the draws
    return {"area": uniform(0.08, 1.0),
            "log_ratio": uniform(math.log(3 / 4), math.log(4 / 3)),
            "u_x": uniform(0.0, 1.0), "u_y": uniform(0.0, 1.0),
            "flip": bernoulli(0.5),
            "brightness": uniform(0.2, 1.8), "contrast": uniform(0.2, 1.8),
            "saturation": uniform(0.2, 1.8), "hue": uniform(-0.2, 0.2),
            "jitter": bernoulli(0.8), "gray": bernoulli(0.2),
            "blur": bernoulli(0.5), "sigma": uniform(0.1, 2.0)}


def apply_view(images: torch.Tensor,
               p: dict[str, torch.Tensor]) -> torch.Tensor:
    """One view of each image at the parameters ``p`` (``view_params``)."""
    images = resized_crop(images, p["area"], p["log_ratio"], p["u_x"],
                          p["u_y"])
    images = _where(p["flip"], images.flip(2), images)
    jittered = color_jitter(images, p["brightness"], p["contrast"],
                            p["saturation"], p["hue"])
    images = _where(p["jitter"], jittered, images)
    images = _where(p["gray"], grayscale(images), images)
    return _where(p["blur"], gaussian_blur(images, p["sigma"]), images)


def augment_views(images: torch.Tensor, generator: torch.Generator,
                  total: int | None = None, offset: int = 0) -> torch.Tensor:
    """One SimCLR view of each image. ``images`` may be rows ``offset ...``
    of a batch of ``total`` images: the parameters are drawn for the whole
    batch and the rows' share is applied, so a shard of the batch gets
    exactly the views the whole batch would."""
    b = images.shape[0]
    p = view_params(b if total is None else total, generator, images.device)
    return apply_view(images, {k: v[offset:offset + b] for k, v in p.items()})


def augment_batch_pair(images: torch.Tensor, generator: torch.Generator,
                       total: int | None = None, offset: int = 0):
    """Two independent views of a batch (B, H, W, C) in [0, 1] (or of rows
    ``offset ...`` of a batch of ``total``, see ``augment_views``)."""
    return (augment_views(images, generator, total, offset),
            augment_views(images, generator, total, offset))
