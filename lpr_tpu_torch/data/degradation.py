"""Classical LR degradation synthesis on the device, batched (counterpart of
``lpr_tpu/data/degradation.py``).

The chain per image: a random motion kernel (a straight streak or a random
walk, 7-13 px), applied with probability ``p_motion``; a lighting mask
(ambient, parallel or spotlight) scaling the HSV value with probability
``p_lighting``; a glare blob with probability ``p_glare``; a Gaussian blur;
a bicubic shrink by ``scale``; Gaussian noise; a bilinear resize to
``lr_hw``.

Every stochastic step is split in two.  :meth:`LPDegradation.sample` draws
a batch's random values from a ``torch.Generator`` into a
:class:`Draws` record (kernel sizes, angles, walk deltas, the lighting
choice, the branch uniforms, sigma, the noise level and the noise tensor);
:meth:`LPDegradation.apply` is deterministic given that record.  So the
same draws give the same LR batch on the card and on the CPU, and a test
can feed the JAX package's own draws to the application.  JAX's PRNG
stream itself is not reproduced.

The batch is processed at once: a different kernel per image is one
grouped convolution with the batch folded into the channels, and the
``lax.cond`` / ``lax.switch`` branches of the JAX code are all computed and
selected with ``torch.where``, as ``vmap`` computes them there.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lpr_tpu_torch.ops import image as im

Tensor = torch.Tensor
KMAX = 13            # largest motion-kernel support (reference range 7..13)
WALK_STEPS = 10      # random-walk deltas drawn per kernel
BLUR_RADIUS = 10     # static radius of the Gaussian blur


@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    gaussian_sigma_range: Tuple[float, float] = (1.5, 3.0)
    noise_level_range: Tuple[float, float] = (0.01, 0.02)
    motion_kernel_size_range: Tuple[int, int] = (7, 13)
    brightness_weight_range: Tuple[float, float] = (0.3, 0.5)
    lr_hw: Tuple[int, int] = (32, 192)
    scale: float = 0.35
    p_motion: float = 0.7
    p_lighting: float = 0.3
    # a compact highlight over ~one character; 0 keeps the classical chain
    p_glare: float = 0.0
    glare_radius_range: Tuple[float, float] = (0.35, 0.60)  # x plate height
    glare_alpha_range: Tuple[float, float] = (0.55, 0.95)


@dataclasses.dataclass
class Draws:
    """One batch's random values, each with the batch as its first
    dimension.  The motion kernel's values serve the branch that
    ``line`` picks: a straight streak (``size``, ``angle``, ``length``) or
    a random walk (``size``, ``n_steps``, ``angle0`` in degrees, ``deltas``
    (B, 10, 2) in [0, 1)).  ``*_u`` are the branch uniforms compared with
    the configuration's probabilities.  ``light_choice`` is 0 ambient, 1
    parallel, 2 spotlight.  ``noise`` is the unit normal noise at the
    shrunk size."""

    line: Tensor
    size: Tensor
    angle: Tensor
    length: Tensor
    n_steps: Tensor
    angle0: Tensor
    deltas: Tensor
    motion_u: Tensor
    light_choice: Tensor
    intensity: Tensor
    horiz: Tensor
    flip: Tensor
    spot_x: Tensor
    spot_y: Tensor
    light_u: Tensor
    glare_u: Tensor
    glare_x: Tensor
    glare_y: Tensor
    glare_r: Tensor
    glare_alpha: Tensor
    sigma: Tensor
    noise_level: Tensor
    noise: Tensor

    def to(self, device) -> "Draws":
        return Draws(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


def _uniform(g: torch.Generator, n: int, lo: float, hi: float,
             shape=()) -> Tensor:
    u = torch.rand((n, *shape), generator=g, device=g.device)
    return lo + u * (hi - lo)


def _randint(g: torch.Generator, n: int, lo: int, hi: int) -> Tensor:
    """Integers in [lo, hi)."""
    return torch.randint(lo, hi, (n,), generator=g, device=g.device)


def _scatter_max(idx: Tensor, ok: Tensor) -> Tensor:
    """(B, KMAX, KMAX) kernels holding 1 where any valid point lands:
    ``zeros.at[y, x].max(ok)``, repeated indices included.  Invalid points
    go to index 0 with the value 0, which leaves the kernel as it is."""
    vals = ok.to(torch.float32)
    flat = torch.zeros((idx.shape[0], KMAX * KMAX), dtype=torch.float32,
                       device=idx.device)
    flat = flat.scatter_reduce(1, torch.where(ok, idx, 0), vals, "amax")
    return flat.reshape(-1, KMAX, KMAX)


def line_kernel(size: Tensor, angle: Tensor, length: Tensor) -> Tensor:
    """Straight motion streaks (``_line_kernel``), (B, KMAX, KMAX),
    unnormalised: points center + (cos, sin)(angle) * t for t < length."""
    t = torch.arange(KMAX, dtype=torch.float32, device=size.device)
    center = (size // 2).to(torch.float32)[:, None]
    x = (center + torch.cos(angle)[:, None] * t).to(torch.int32)
    y = (center + torch.sin(angle)[:, None] * t).to(torch.int32)
    s = size[:, None]
    ok = (t < length[:, None]) & (x >= 0) & (x < s) & (y >= 0) & (y < s)
    return _scatter_max((y * KMAX + x).long(), ok)


def walk_kernel(size: Tensor, n_steps: Tensor, angle0: Tensor,
                deltas: Tensor) -> Tensor:
    """Random-walk motion kernels (``_walk_kernel``), (B, KMAX, KMAX),
    unnormalised: from the centre, each step turns by deltas[:, 0] * 60 -
    30 degrees and moves deltas[:, 1] + 1 px; the first ``n_steps`` steps
    inside the support are marked."""
    center = (size // 2).to(torch.float32)
    x, y, ang = center, center, angle0
    xs, ys = [center], [center]
    for i in range(deltas.shape[1]):
        ang = torch.remainder(ang + (deltas[:, i, 0] * 60.0 - 30.0), 360.0)
        rad = torch.deg2rad(ang)
        step = deltas[:, i, 1] + 1.0
        x = x + torch.cos(rad) * step
        y = y + torch.sin(rad) * step
        xs.append(x)
        ys.append(y)
    xs, ys = torch.stack(xs, 1), torch.stack(ys, 1)
    idx = torch.arange(xs.shape[1], device=xs.device)
    s = size.to(torch.float32)[:, None]
    ok = ((idx[None] <= n_steps[:, None]) & (xs >= 0) & (xs < s)
          & (ys >= 0) & (ys < s))
    flat = ys.to(torch.int32) * KMAX + xs.to(torch.int32)
    return _scatter_max(flat.long(), ok)


def motion_kernel(d: Draws) -> Tensor:
    """The normalised motion kernels (``motion_kernel``), (B, KMAX, KMAX):
    the streak where ``d.line``, else the walk, divided by its sum."""
    kern = torch.where(d.line[:, None, None],
                       line_kernel(d.size, d.angle, d.length),
                       walk_kernel(d.size, d.n_steps, d.angle0, d.deltas))
    s = kern.sum(dim=(1, 2), keepdim=True)
    return torch.where(s > 0, kern / torch.clamp_min(s, 1e-8), kern)


def _grouped(x: Tensor, w: Tensor) -> Tensor:
    """Per-image, per-channel cross-correlation of (B, C, H, W) with
    (B, kh, kw) kernels, valid padding: one grouped convolution with the
    batch folded into the channels."""
    b, c, h, wd = x.shape
    kern = w[:, None].expand(b, c, *w.shape[1:]).reshape(b * c, 1,
                                                          *w.shape[1:])
    y = F.conv2d(x.reshape(1, b * c, h, wd), kern.to(x.dtype),
                 groups=b * c)
    return y.reshape(b, c, *y.shape[2:])


def _batched(img: Tensor, kern: Tensor):
    if img.dim() == 3:
        return img[None], kern[None], True
    return img, kern, False


def apply_kernel(img: Tensor, kern: Tensor) -> Tensor:
    """Each image (B, H, W, C) filtered by its own kernel (B, kh, kw),
    per channel, reflect border (numpy's ``reflect``: the edge is not
    repeated), as cv2.filter2D; one unbatched (H, W, C) image with one
    (kh, kw) kernel is taken too."""
    img, kern, single = _batched(img, kern)
    kh, kw = int(kern.shape[1]), int(kern.shape[2])
    x = F.pad(img.permute(0, 3, 1, 2),
              (kw // 2, kw // 2, kh // 2, kh // 2), mode="reflect")
    out = _grouped(x, kern).permute(0, 2, 3, 1)
    return out[0] if single else out


def gaussian_kernel_1d(sigma: Tensor, radius: int = BLUR_RADIUS) -> Tensor:
    """Normalised Gaussian taps (..., 2 * radius + 1) of each ``sigma``
    (...), at a static radius."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    g = torch.exp(-(x ** 2) / (2.0 * sigma[..., None] ** 2))
    return g / g.sum(dim=-1, keepdim=True)


def gaussian_blur(img: Tensor, sigma: Tensor,
                  radius: int = BLUR_RADIUS) -> Tensor:
    """Separable Gaussian blur of each image (B, H, W, C) with its own
    sigma (B,), vertical then horizontal, reflect border; one unbatched
    image with a scalar sigma is taken too."""
    single = img.dim() == 3
    if single:
        img, sigma = img[None], sigma.reshape(1)
    g = gaussian_kernel_1d(sigma, radius)
    x = img.permute(0, 3, 1, 2)
    x = _grouped(F.pad(x, (0, 0, radius, radius), mode="reflect"),
                 g[:, :, None])
    x = _grouped(F.pad(x, (radius, radius, 0, 0), mode="reflect"),
                 g[:, None, :])
    out = x.permute(0, 2, 3, 1)
    return out[0] if single else out


def lighting_mask(d: Draws, hw: Tuple[int, int]) -> Tensor:
    """Each image's lighting mask (``lighting_mask``), (B, H, W): ambient
    (the intensity everywhere), parallel (a Gaussian falloff from one edge,
    horizontal or vertical, flipped or not) or a spotlight at (spot_y,
    spot_x), picked by ``d.light_choice``."""
    h, w = hw
    dev = d.intensity.device
    b = d.intensity.shape[0]
    ambient = d.intensity[:, None, None].expand(b, h, w)
    dx = torch.arange(w, dtype=torch.float32, device=dev)
    dx = torch.where(d.flip[:, None], w - 1 - dx, dx)
    mx = torch.exp(-(dx ** 2) / (w / 1.5) ** 2)
    dy = torch.arange(h, dtype=torch.float32, device=dev)
    dy = torch.where(d.flip[:, None], h - 1 - dy, dy)
    my = torch.exp(-(dy ** 2) / (h / 1.5) ** 2)
    parallel = torch.where(d.horiz[:, None, None], mx[:, None, :].expand(
        b, h, w), my[:, :, None].expand(b, h, w))
    ii = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    jj = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    d2 = ((ii - d.spot_y.to(torch.float32)[:, None, None]) ** 2
          + (jj - d.spot_x.to(torch.float32)[:, None, None]) ** 2)
    spot = torch.exp(-d2 / (max(h, w) / 1.5) ** 2)
    c = d.light_choice[:, None, None]
    return torch.where(c == 0, ambient, torch.where(c == 1, parallel, spot))


def glare_blob(img: Tensor, x0: Tensor, y0: Tensor, r: Tensor,
               alpha: Tensor) -> Tensor:
    """Screen a super-Gaussian highlight exp(-(d^2)^2) of radius r and
    strength alpha at (y0, x0) over each image (B, H, W, C)
    (``glare_blob``): it saturates the strokes it covers."""
    _, h, w, _ = img.shape
    dev = img.device
    ii = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    jj = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    d2 = (((ii - y0[:, None, None]) ** 2 + (jj - x0[:, None, None]) ** 2)
          / (r * r)[:, None, None])
    blob = alpha[:, None, None] * torch.exp(-(d2 * d2))
    return torch.clamp(img + blob[..., None] * (1.0 - img), 0.0, 1.0)


def _pick(u: Tensor, p: float, a: Tensor, b: Tensor) -> Tensor:
    """a where u < p, else b, per image."""
    return torch.where((u < p)[:, None, None, None], a, b)


class LPDegradation:
    """Batched stochastic degradation: HR [0, 1] RGB (B, H, W, 3) -> LR
    (B, *lr_hw, 3)."""

    def __init__(self, cfg: DegradationConfig = DegradationConfig(),
                 hr_hw: Tuple[int, int] = (64, 384)):
        self.cfg = cfg
        self.hr_hw = tuple(hr_hw)

    def shrunk_hw(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        """The size after the bicubic shrink, where the noise is added."""
        return (max(int(hw[0] * self.cfg.scale), 1),
                max(int(hw[1] * self.cfg.scale), 1))

    def sample(self, g: torch.Generator, n: int,
               hw: Optional[Tuple[int, int]] = None) -> Draws:
        """n images' draws from ``g``, on ``g``'s device, with the JAX
        package's distributions; ``hw`` is the HR size (default
        ``hr_hw``)."""
        cfg = self.cfg
        h, w = self.hr_hw if hw is None else hw
        dh, dw = self.shrunk_hw((h, w))
        lo, hi = cfg.motion_kernel_size_range
        size = _randint(g, n, lo, hi + 1)
        gr, ar = cfg.glare_radius_range, cfg.glare_alpha_range
        return Draws(
            line=torch.rand(n, generator=g, device=g.device) > 0.5,
            size=size,
            angle=_uniform(g, n, 0.0, 2 * math.pi),
            length=_uniform(g, n, 1.0, 2.0) * (size / 4.0),
            n_steps=_randint(g, n, 5, 11),
            angle0=_uniform(g, n, 0.0, 360.0),
            deltas=_uniform(g, n, 0.0, 1.0, (WALK_STEPS, 2)),
            motion_u=_uniform(g, n, 0.0, 1.0),
            light_choice=_randint(g, n, 0, 3),
            intensity=_uniform(g, n, *cfg.brightness_weight_range),
            horiz=_uniform(g, n, 0.0, 1.0) < 0.5,
            flip=_uniform(g, n, 0.0, 1.0) < 0.5,
            spot_x=_randint(g, n, 0, w),
            spot_y=_randint(g, n, 0, h),
            light_u=_uniform(g, n, 0.0, 1.0),
            glare_u=_uniform(g, n, 0.0, 1.0),
            glare_x=_uniform(g, n, 0.08 * w, 0.92 * w),
            glare_y=_uniform(g, n, 0.25 * h, 0.75 * h),
            glare_r=_uniform(g, n, *gr) * h,
            glare_alpha=_uniform(g, n, *ar),
            sigma=_uniform(g, n, *cfg.gaussian_sigma_range),
            noise_level=_uniform(g, n, *cfg.noise_level_range),
            noise=torch.randn((n, dh, dw, 3), generator=g, device=g.device),
        )

    def apply(self, d: Draws, hr: Tensor) -> Tensor:
        """The chain on HR images (B, H, W, 3) float32 with the draws
        ``d`` (on ``hr``'s device): deterministic."""
        cfg = self.cfg
        img = hr
        blurred = torch.clamp(apply_kernel(img, motion_kernel(d)), 0.0, 1.0)
        img = _pick(d.motion_u, cfg.p_motion, blurred, img)
        lit = im.hsv_value_scale(img, lighting_mask(d, img.shape[1:3]))
        img = _pick(d.light_u, cfg.p_lighting, lit, img)
        if cfg.p_glare > 0.0:
            glared = glare_blob(img, d.glare_x, d.glare_y, d.glare_r,
                                d.glare_alpha)
            img = _pick(d.glare_u, cfg.p_glare, glared, img)
        img = torch.clamp(gaussian_blur(img, d.sigma), 0.0, 1.0)
        img = torch.clamp(im.resize_bicubic(img, self.shrunk_hw(
            img.shape[1:3])), 0.0, 1.0)
        img = img + d.noise_level[:, None, None, None] * d.noise
        img = torch.clamp(img, 0.0, 1.0)
        return torch.clamp(im.resize_bilinear(img, cfg.lr_hw), 0.0, 1.0)

    def __call__(self, g: torch.Generator, hr: Tensor) -> Tensor:
        """Sample then apply: ``g`` must live on ``hr``'s device."""
        return self.apply(self.sample(g, hr.shape[0], hr.shape[1:3]), hr)


def load_estimated_kernels(folder: str,
                           kernel_hw: Tuple[int, int] = (11, 11)
                           ) -> np.ndarray:
    """Every array of every .mat file in ``folder`` (sorted), resized to
    ``kernel_hw`` as ``jax.image.resize(..., "linear")`` resizes
    (antialiased when shrinking).  Returns (N, kh, kw) float32."""
    from scipy.io import loadmat

    out = []
    for f in sorted(os.listdir(folder)):
        if not f.endswith(".mat"):
            continue
        for k, v in loadmat(os.path.join(folder, f)).items():
            if k.startswith("__") or not isinstance(v, np.ndarray):
                continue
            arr = torch.from_numpy(np.asarray(v, np.float32))[..., None]
            out.append(im.resize_bilinear(arr, kernel_hw)[..., 0].numpy())
    return np.stack(out) if out else np.zeros((0, *kernel_hw), np.float32)


def apply_estimated_kernel(g: torch.Generator, img: Tensor,
                           kernels: Tensor) -> Tensor:
    """Each image (B, H, W, C) filtered by an estimated kernel drawn
    uniformly from ``kernels`` (N, kh, kw), clipped to [0, 1]."""
    i = _randint(g, img.shape[0], 0, kernels.shape[0]).to(kernels.device)
    return torch.clamp(apply_kernel(img, kernels[i]), 0.0, 1.0)
