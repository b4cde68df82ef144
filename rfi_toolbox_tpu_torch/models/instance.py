"""SOLOLite: dense instance segmentation of RFI events, in PyTorch.

Counterpart of ``rfi_toolbox_tpu/models/instance.py`` (``SOLOLite``,
``instance_masks_from_outputs``, ``assign_targets``, ``solo_loss``,
``matrix_nms``, ``solo_decode``). Every step is a conv or a matrix
product:

- an FPN-lite backbone (4 stages of conv + GroupNorm + ReLU, max-pools,
  a top-down path to H/4), or the 2 x 2 space-to-depth stem;
- a category head: an S x S grid of per-cell class logits;
- a kernel head: an S x S grid of E-dimensional dynamic mask kernels;
- a mask-feature head: one (H/4, W/4, E) map;
- candidate masks: one product of the S² kernels with the mask features.

Layouts are the JAX package's: images NHWC (B, H, W, 3), the outputs
``cate_logits`` (B, S, S, classes), ``kernels`` (B, S, S, E) and
``mask_feats`` (B, H/4, W/4, E); instance masks (B, M, H, W). The model
runs its convs channels-last.

Resizes follow ``jax.image.resize``: ``"bilinear"``/``"linear"`` is a
triangle kernel, stretched by the factor when it downsamples (the
antialiasing of the grid head's 32² -> S² and of the soft ground truth
at 1/2 resolution) and plain bilinear when it upsamples, each applied as
a product with JAX's own weight matrix along each axis (deterministic on
the card, where a gather-and-atomics backward would not be);
``"nearest"`` samples ``floor((i + 0.5) * in / out)``, torch's
``nearest-exact``.

The decode is batched: :func:`solo_decode` takes the outputs of a batch
and returns per-image results with a leading batch axis, each image's
the JAX function's. Weights convert from and to Flax with
:mod:`.convert` (``sololite_from_flax``, ``sololite_to_flax``).
"""

import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.functional import all_reduce_partial
from .unet import GROUP_NORM_EPS, Conv2d, GroupNorm, _at_least_f32, space_to_depth

__all__ = [
    "SOLOLite",
    "instance_masks_from_outputs",
    "assign_targets",
    "solo_loss",
    "matrix_nms",
    "solo_decode",
    "resize",
]

CATE_BIAS_INIT = -4.6  # the category head's focal-loss prior, log(0.01 / 0.99)
IN_CHANNELS = 3  # [gradient, log_amp, phase]


@functools.cache
def _resize_weights(n_in, n_out, device):
    """(n_out, n_in) float32 weights of ``jax.image.resize``'s linear
    kernel along one axis (``compute_weight_mat`` with antialiasing, in
    float32 as JAX computes it)."""
    f32 = np.float32
    inv = 1.0 / (n_out / n_in)  # a Python float in JAX too, then float32
    inv_scale, kernel_scale = f32(inv), f32(max(inv, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=f32)[None, :]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - x)
    total = w.sum(axis=1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[:, None], w, f32(0)).astype(f32)
    return torch.from_numpy(w).to(device)


def resize(x, size):
    """``jax.image.resize(..., method="linear")`` of the last two axes of
    ``x`` (..., H, W) to ``size`` (h, w): antialiased when it shrinks an
    axis. An axis of unchanged length is left alone, as JAX leaves it."""
    h, w = size
    if x.shape[-2] != h:
        x = _resize_weights(x.shape[-2], h, x.device).to(x.dtype) @ x
    if x.shape[-1] != w:
        x = x @ _resize_weights(x.shape[-1], w, x.device).to(x.dtype).T
    return x


def _f32(x):
    """``x`` in float32, or float64 if it is (a reference in float64)."""
    return x.to(_at_least_f32(x.dtype))


class _ConvBlock(nn.Module):
    """3x3 conv (no bias) -> GroupNorm (``min(8, features)`` groups, Flax's
    eps) -> ReLU, on NCHW."""

    def __init__(self, in_channels, features):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 3, padding=1, bias=False)
        self.norm = GroupNorm(min(8, features), features, eps=GROUP_NORM_EPS)

    def forward(self, x):
        return torch.relu(self.norm(self.conv(x)))


class SOLOLite(nn.Module):
    """Dense instance segmentation head (float32; float64 after
    ``.double()``, as a reference).

    Args mirror the Flax module's:
        num_classes: instance categories (6 = the RFI event types).
        grid_size: S (S² candidate instances an image).
        embed_dim: E, the dynamic kernels' length.
        features: the backbone's base width f.
        space_to_depth: the 2 x 2-packed stem (two half-resolution blocks
            at 2f in place of the full-resolution stage).

    ``blocks[i]`` and ``convs[j]`` are the Flax module's ``_ConvBlock_i``
    and ``Conv_j``, numbered in the order Flax creates them: blocks 0-3
    the backbone, 4 the top-down merge, 5 the mask-feature block, 6-7 the
    grid blocks; convs 0-1 the FPN's 1x1 lateral convs, 2 the mask
    embedding (1x1), 3 the category head and 4 the kernel head (3x3).
    ``forward`` takes NHWC images and returns the dict of NHWC outputs.
    """

    def __init__(self, num_classes=6, grid_size=16, embed_dim=32, features=32,
                 space_to_depth=False):
        super().__init__()
        self.num_classes = int(num_classes)
        self.grid_size = int(grid_size)
        self.embed_dim = int(embed_dim)
        self.features = f = int(features)
        self.space_to_depth = bool(space_to_depth)
        if self.space_to_depth:
            stem = [_ConvBlock(4 * IN_CHANNELS, 2 * f), _ConvBlock(2 * f, 2 * f)]
        else:
            stem = [_ConvBlock(IN_CHANNELS, f), _ConvBlock(f, 2 * f)]
        self.blocks = nn.ModuleList(stem + [
            _ConvBlock(2 * f, 4 * f), _ConvBlock(4 * f, 8 * f),  # c3, c4
            _ConvBlock(4 * f, 4 * f),                            # p3
            _ConvBlock(4 * f, 4 * f),                            # mask features
            _ConvBlock(4 * f, 4 * f), _ConvBlock(4 * f, 4 * f),  # grid
        ])
        self.convs = nn.ModuleList([
            Conv2d(8 * f, 4 * f, 1), Conv2d(4 * f, 4 * f, 1),
            Conv2d(4 * f, self.embed_dim, 1),
            Conv2d(4 * f, self.num_classes, 3, padding=1),
            Conv2d(4 * f, self.embed_dim, 3, padding=1),
        ])
        cate = self.convs[3]
        cate.bias_init = CATE_BIAS_INIT  # read by unet.flax_init_
        with torch.no_grad():
            cate.bias.fill_(CATE_BIAS_INIT)

    def forward(self, x):
        """x (B, H, W, 3) float32 -> dict of ``cate_logits`` (B, S, S,
        classes), ``kernels`` (B, S, S, E), ``mask_feats`` (B, H/4, W/4, E)."""
        b, c = self.blocks, self.convs
        x = x.permute(0, 3, 1, 2)  # channels-last NCHW view
        if self.space_to_depth:
            c2 = b[1](b[0](space_to_depth(x)))
        else:
            c2 = b[1](F.max_pool2d(b[0](x), 2))
        c3 = b[2](F.max_pool2d(c2, 2))
        c4 = b[3](F.max_pool2d(c3, 2))
        p4_up = F.interpolate(c[0](c4), size=c3.shape[-2:], mode="nearest-exact")
        p3 = b[4](c[1](c3) + p4_up)
        mask_feats = c[2](b[5](p3))
        g = b[7](b[6](resize(p3, (self.grid_size, self.grid_size))))
        outs = {"cate_logits": c[3](g), "kernels": c[4](g), "mask_feats": mask_feats}
        return {k: v.permute(0, 2, 3, 1) for k, v in outs.items()}


def instance_masks_from_outputs(outputs):
    """All S² candidate mask logits of each image with one product:
    (B, S, S, E) x (B, h, w, E) -> (B, S², h, w)."""
    kernels, feats = outputs["kernels"], outputs["mask_feats"]
    b, s, _, e = kernels.shape
    return torch.einsum("bke,bhwe->bkhw", kernels.reshape(b, s * s, e), feats)


# ---------------------------------------------------------------------------
# target assignment
# ---------------------------------------------------------------------------
@torch.no_grad()
def assign_targets(inst_masks, inst_classes, inst_valid, grid_size, num_classes,
                   center_frac=0.2):
    """Centre-region assignment of ground-truth instances to grid cells.

    Each valid instance claims the cells whose centres lie within its
    centre region (its bounding box scaled by ``center_frac`` around its
    centroid, at least half a cell each way); the smallest-area instance
    wins a contested cell. Ties take the first index, as ``jnp.argmax``
    and ``jnp.argmin`` do.

    Args:
        inst_masks: (B, M, H, W) bool or float instance masks.
        inst_classes: (B, M) int class ids.
        inst_valid: (B, M) bool.

    Returns:
        ``cate_target`` (B, S, S) int32, ``num_classes`` for background;
        ``mask_target_idx`` (B, S, S) int32 index into M, or -1.
    """
    b, m, h, w = inst_masks.shape
    dev = inst_masks.device
    masks = inst_masks.to(torch.float32)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    area = masks.sum(dim=(2, 3)).clamp_min(1e-6)                     # (B, M)
    cy = (masks * ys[:, None]).sum(dim=(2, 3)) / area
    cx = (masks * xs).sum(dim=(2, 3)) / area
    any_y = masks.amax(dim=3)                                        # (B, M, H)
    any_x = masks.amax(dim=2)                                        # (B, M, W)
    y0 = any_y.argmax(dim=2).to(torch.float32)
    y1 = (h - 1 - any_y.flip(2).argmax(dim=2)).to(torch.float32)
    x0 = any_x.argmax(dim=2).to(torch.float32)
    x1 = (w - 1 - any_x.flip(2).argmax(dim=2)).to(torch.float32)
    half_h = torch.clamp_min((y1 - y0) * center_frac / 2, h / grid_size / 2)
    half_w = torch.clamp_min((x1 - x0) * center_frac / 2, w / grid_size / 2)

    s = grid_size
    gy = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) * (h / s)
    gx = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) * (w / s)
    in_y = (gy - cy[..., None]).abs() <= half_h[..., None]          # (B, M, S)
    in_x = (gx - cx[..., None]).abs() <= half_w[..., None]
    valid = inst_valid.to(torch.bool)[..., None, None]
    claims = in_y[..., :, None] & in_x[..., None, :] & valid         # (B, M, S, S)

    inf = torch.tensor(float("inf"), device=dev)
    area_key = torch.where(valid, area[..., None, None], inf)
    key = torch.where(claims, area_key, inf)
    winner = key.argmin(dim=1)                                       # (B, S, S)
    has_winner = torch.isfinite(key.amin(dim=1))
    cls = torch.gather(inst_classes.to(torch.int64), 1, winner.reshape(b, -1))
    cate_target = torch.where(has_winner, cls.reshape(b, s, s), num_classes)
    mask_target_idx = torch.where(has_winner, winner, -1)
    return cate_target.to(torch.int32), mask_target_idx.to(torch.int32)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _focal_loss(logits, targets_onehot, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(logits)
    ce = (logits.clamp_min(0) - logits * targets_onehot
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    alpha_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    return alpha_t * ((1 - p_t) ** gamma) * ce


def solo_loss(outputs, inst_masks, inst_classes, inst_valid, mask_weight=3.0,
              mask_loss_stride=2, max_positive_cells=16, group=None):
    """Focal category loss + ``mask_weight`` x Dice mask loss on the
    positive cells.

    Args:
        outputs: the SOLOLite forward dict.
        inst_masks: (B, M, H, W) ground-truth instance masks.
        inst_classes, inst_valid: (B, M).
        mask_loss_stride: the Dice term's resolution, H / stride: the mask
            logits are resized there bilinearly, and the ground truth
            soft-downsampled (antialiased 'linear'), so that 1-pixel
            strips still supervise.
        max_positive_cells: the Dice term takes the first P positive
            cells of each image (a stable sort of the cells by
            positivity) and builds only their masks; None takes all S².
        group: a process group whose ranks each hold some rows of one
            batch: the focal and Dice sums and the positive counts are
            all-reduced over it (the sums' backward the identity), so the
            loss is the whole batch's, as JAX's over a sharded batch.

    Returns:
        ``(total, {"cate_loss", "mask_loss", "dropped_mask_cells"})``, 0-d
        tensors; ``dropped_mask_cells`` counts the positive cells past
        the cap, which get no mask gradient.
    """
    cate_logits = _f32(outputs["cate_logits"])
    b, s, _, num_classes = cate_logits.shape
    cate_t, mask_idx = assign_targets(inst_masks, inst_classes, inst_valid, s,
                                      num_classes)
    onehot = F.one_hot(cate_t.long(), num_classes + 1)[..., :num_classes].to(cate_logits.dtype)
    focal_sum = _focal_loss(cate_logits, onehot).sum()
    cate_count = (cate_t < num_classes).sum()

    k = s * s
    flat_idx = mask_idx.reshape(b, k)
    total_positive = (flat_idx >= 0).sum()
    feats = _f32(outputs["mask_feats"])
    if max_positive_cells is not None and max_positive_cells < k:
        p = int(max_positive_cells)
        order = torch.argsort((flat_idx < 0).to(torch.int32), dim=1, stable=True)
        sel = order[:, :p]                                           # (B, P)
        flat_idx = torch.gather(flat_idx, 1, sel)
        kernels = _f32(outputs["kernels"]).reshape(b, k, -1)
        kern = torch.gather(kernels, 1, sel[..., None].expand(-1, -1, kernels.shape[-1]))
        mask_logits = torch.einsum("bpe,bhwe->bphw", kern, feats)
    else:
        mask_logits = instance_masks_from_outputs(
            {"kernels": _f32(outputs["kernels"]), "mask_feats": feats})
    gh, gw = inst_masks.shape[2], inst_masks.shape[3]
    th, tw = gh // mask_loss_stride, gw // mask_loss_stride
    mask_logits = resize(mask_logits, (th, tw))
    gt = resize(inst_masks.to(mask_logits.dtype), (th, tw))
    positive = flat_idx >= 0
    gather_idx = flat_idx.clamp_min(0).long()
    gt_per_cell = gt[torch.arange(b, device=gt.device)[:, None], gather_idx]
    probs = torch.sigmoid(mask_logits)
    inter = (probs * gt_per_cell).sum(dim=(2, 3))
    denom = probs.sum(dim=(2, 3)) + gt_per_cell.sum(dim=(2, 3))
    dice = 1.0 - (2 * inter + 1.0) / (denom + 1.0)
    dice_sum = (dice * positive).sum()
    counts = torch.stack([cate_count, positive.sum(), total_positive])
    if group is not None:
        focal_sum, dice_sum = all_reduce_partial(torch.stack([focal_sum, dice_sum]), group)
        dist.all_reduce(counts, group=group)
    cate_count, n_positive, total_positive = counts
    cate_loss = focal_sum / cate_count.clamp_min(1)
    mask_loss = dice_sum / n_positive.clamp_min(1)

    total = cate_loss + mask_weight * mask_loss
    dropped = (total_positive - n_positive).to(torch.int32)
    return total, {"cate_loss": cate_loss, "mask_loss": mask_loss,
                   "dropped_mask_cells": dropped}


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------
def matrix_nms(masks, scores, classes, sigma=2.0):
    """Matrix NMS (SOLOv2 eq. 4, compensated): each score decays by the
    minimum, over its suppressors j (same class, higher score), of
    ``exp(-sigma * (iou_ij² - c_j²))``, where ``c_j`` is the largest IoU
    that j itself suffers from its own suppressors.

    Args:
        masks: (..., K, h, w) bool masks.
        scores: (..., K) confidences.
        classes: (..., K) class ids.

    Returns the decayed scores (..., K).
    """
    k = masks.shape[-3]
    flat = masks.reshape(*masks.shape[:-3], k, -1).to(torch.float32)
    inter = flat @ flat.transpose(-1, -2)
    areas = flat.sum(dim=-1)
    union = areas[..., :, None] + areas[..., None, :] - inter
    iou = inter / union.clamp_min(1e-6)
    same_class = classes[..., :, None] == classes[..., None, :]
    higher = scores[..., None, :] > scores[..., :, None]   # [i, j]: j outranks i
    sup = same_class & higher                               # j may suppress i
    suffered = torch.where(sup, iou, 0.0).amax(dim=-1)
    decay = torch.where(sup, torch.exp(-sigma * (iou ** 2 - suffered[..., None, :] ** 2)),
                        1.0).amin(dim=-1)
    return scores * decay.clamp_max(1.0)


def solo_decode(outputs, score_thresh=0.3, mask_thresh=0.5, nms_sigma=2.0, out_size=None):
    """Decode a batch of outputs into scored candidates, every S² of them
    (filter by score on the host).

    Args:
        outputs: the SOLOLite forward dict of a batch (leading axis B).
        score_thresh: candidates below score 0 and take no part in NMS.
        mask_thresh: the sigmoid cut of the mask logits.
        out_size: optional (H, W): the mask logits are bilinearly
            upsampled there before the cut (the mask head runs at 1/4).

    Returns ``{"masks": (B, S², h, w) bool, "scores": (B, S²),
    "classes": (B, S²)}``; image i's entries are the JAX ``solo_decode``
    of image i's outputs.
    """
    cate = torch.sigmoid(_f32(outputs["cate_logits"]))
    b, s, _, num_classes = cate.shape
    scores2d = cate.reshape(b, s * s, num_classes)
    classes = scores2d.argmax(dim=-1)
    scores = scores2d.amax(dim=-1)
    mask_logits = instance_masks_from_outputs(outputs)
    if out_size is not None:
        mask_logits = resize(mask_logits, tuple(out_size))
    masks = torch.sigmoid(mask_logits) > mask_thresh
    active = scores >= score_thresh
    scores = torch.where(active, scores, 0.0)
    scores = matrix_nms(masks & active[..., None, None], scores, classes, sigma=nms_sigma)
    return {"masks": masks, "scores": scores, "classes": classes}
