"""The segmentation UNet, its loss and its optimiser, in plain PyTorch.

The published model (``rfi_toolbox_tpu/models/unet.py``, Flax): ``depth``
encoder stages of (3x3 conv, norm, ReLU) x 2 with ``f * 2**i`` features
and a 2x2 max-pool, a bottleneck DoubleConv of ``f * 2**depth``, decoder
stages of a 2x2 stride-2 transposed conv, ``[up, skip]`` concatenated and
a DoubleConv, and a 1x1 head. BatchNorm (eps 1e-5) normalises by the
batch statistics (biased variance) in training and by the running ones
in evaluation; its 3x3 convs carry no bias. Parameters are named as the
program names them, so that the benchmark can hand both sides the same
weights: ``encoders.{i}.block.conv1.weight``, ``...norm1.weight``,
``bottleneck...``, ``decoders.{i}.up.weight``, ``head.weight``.

The loss is BCE-with-logits plus soft Dice (smooth 1) over the batch;
the optimiser clips the gradients to global norm 1 (``g / norm * 1``
where the norm is not below 1) and takes AdamW (b1 0.9, b2 0.999, eps
1e-8 outside the square root, decoupled weight decay scaled by the
learning rate).

Everything runs in float32 with TF32 off. ``q`` rounds each conv's
operands (the control).
"""

import json
import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _double(prefix, cin, c):
    return {f"{prefix}.conv1.weight": (c, cin, 3, 3), f"{prefix}.norm1.weight": (c,),
            f"{prefix}.norm1.bias": (c,), f"{prefix}.conv2.weight": (c, c, 3, 3),
            f"{prefix}.norm2.weight": (c,), f"{prefix}.norm2.bias": (c,)}


def param_shapes(f, depth=4, in_ch=3, out_ch=1):
    """Name -> shape of every parameter, in the program's order."""
    shapes, c = {}, in_ch
    for i in range(depth):
        shapes.update(_double(f"encoders.{i}.block", c, f * 2 ** i))
        c = f * 2 ** i
    shapes.update(_double("bottleneck", c, f * 2 ** depth))
    c = f * 2 ** depth
    for i in range(depth):
        co = f * 2 ** (depth - 1 - i)
        shapes[f"decoders.{i}.up.weight"] = (c, co, 2, 2)
        shapes[f"decoders.{i}.up.bias"] = (co,)
        shapes.update(_double(f"decoders.{i}.block", 2 * co, co))
        c = co
    shapes["head.weight"] = (out_ch, c, 1, 1)
    shapes["head.bias"] = (out_ch,)
    return shapes


def init_params(shapes, generator, device):
    """Flax's initial values, drawn on ``device`` in one call: conv
    kernels ``lecun_normal`` (a normal truncated at two standard
    deviations, std ``sqrt(1 / fan_in) / 0.8796``), biases 0, norm scales
    1 and shifts 0. Returns name -> float32 tensor."""
    kernels = {n: s for n, s in shapes.items() if len(s) == 4}
    total = sum(math.prod(s) for s in kernels.values())
    draw = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    params, at = {}, 0
    for name, shape in shapes.items():
        if name in kernels:
            n = math.prod(shape)
            fan_in = (shape[0] if ".up." in name else shape[1]) * shape[2] * shape[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            params[name] = draw[at:at + n].view(shape) * std
            at += n
        elif name.endswith("norm1.weight") or name.endswith("norm2.weight"):
            params[name] = torch.ones(shape, device=device)
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


def load_snapshot(path):
    """A published ``.npz`` snapshot (Flax variables: HWIO kernels, the
    transposed conv's kernel applied mirrored) -> (params, running
    statistics, metadata), named as :func:`param_shapes` names them."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__metadata__")).decode()) if "__metadata__" in flat else {}
    p = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    s = {k[len("batch_stats/"):]: v for k, v in flat.items() if k.startswith("batch_stats/")}
    depth = sum(k.startswith("Encoder_") and k.endswith("Conv_0/kernel") for k in p)
    params, stats = {}, {}

    def double(dst, src):
        for i in (1, 2):
            params[f"{dst}.conv{i}.weight"] = p[f"{src}/Conv_{i - 1}/kernel"].transpose(3, 2, 0, 1)
            params[f"{dst}.norm{i}.weight"] = p[f"{src}/BatchNorm_{i - 1}/scale"]
            params[f"{dst}.norm{i}.bias"] = p[f"{src}/BatchNorm_{i - 1}/bias"]
            stats[f"{dst}.norm{i}.mean"] = s[f"{src}/BatchNorm_{i - 1}/mean"]
            stats[f"{dst}.norm{i}.var"] = s[f"{src}/BatchNorm_{i - 1}/var"]

    for i in range(depth):
        double(f"encoders.{i}.block", f"Encoder_{i}/DoubleConv_0")
    double("bottleneck", "DoubleConv_0")
    for i in range(depth):
        up = p[f"Decoder_{i}/ConvTranspose_0/kernel"][::-1, ::-1]
        params[f"decoders.{i}.up.weight"] = up.transpose(2, 3, 0, 1)
        params[f"decoders.{i}.up.bias"] = p[f"Decoder_{i}/ConvTranspose_0/bias"]
        double(f"decoders.{i}.block", f"Decoder_{i}/DoubleConv_0")
    params["head.weight"] = p["Conv_0/kernel"].transpose(3, 2, 0, 1)
    params["head.bias"] = p["Conv_0/bias"]
    as_t = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in d.items()}
    return as_t(params), as_t(stats), meta


def forward(params, x, depth=4, stats=None, q=None):
    """(N, 3, H, W) float32 -> (N, H, W) logits. ``stats`` None: training
    BatchNorm (batch statistics); else the running ``mean``/``var``."""
    q = q or (lambda t: t)

    def norm(h, name):
        w, b = params[name + ".weight"], params[name + ".bias"]
        if stats is None:
            return F.batch_norm(h, None, None, w, b, True, 0.0, BN_EPS)
        return F.batch_norm(h, stats[name + ".mean"], stats[name + ".var"], w, b, False, 0.0, BN_EPS)

    def double(h, prefix):
        for i in (1, 2):
            h = F.conv2d(q(h), q(params[f"{prefix}.conv{i}.weight"]), padding=1)
            h = torch.relu(norm(h, f"{prefix}.norm{i}"))
        return h

    skips = []
    for i in range(depth):
        s = double(x, f"encoders.{i}.block")
        skips.append(s)
        x = F.max_pool2d(s, 2)
    x = double(x, "bottleneck")
    for i in range(depth):
        up = F.conv_transpose2d(q(x), q(params[f"decoders.{i}.up.weight"]),
                                params[f"decoders.{i}.up.bias"], stride=2)
        x = double(torch.cat([up, skips[depth - 1 - i]], dim=1), f"decoders.{i}.block")
    return F.conv2d(q(x), q(params["head.weight"]), params["head.bias"])[:, 0]


def loss_fn(logits, labels):
    """BCE-with-logits + soft Dice (smooth 1), float32."""
    x, y = logits.float(), labels.float()
    bce = (x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()
    p = torch.sigmoid(x).reshape(-1)
    t = y.reshape(-1)
    return bce + 1.0 - (2.0 * (p * t).sum() + 1.0) / (p.sum() + t.sum() + 1.0)


class AdamW:
    """Clip to global norm ``clip``, then AdamW, on a dict of tensors."""

    def __init__(self, params, lr=1e-4, weight_decay=1e-5, clip=1.0):
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads):
        """Update ``params`` in place; returns the clipped gradients."""
        self.t += 1
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0 if norm < self.clip else float(self.clip / norm)
        clipped = {k: g * scale for k, g in grads.items()}
        c1, c2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        for k, g in clipped.items():
            self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[k].mul_(B2).add_(g * g, alpha=1 - B2)
            update = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + ADAM_EPS)
            params[k].sub_(self.lr * (update + self.wd * params[k]))
        return clipped


def train_steps(params, images, labels, steps, batch, q=None):
    """``steps`` training steps on consecutive batches of (N, p, p, 3)
    images and (N, p, p) labels, from ``params`` (copied). Returns
    (losses, the first step's clipped gradients, the parameters after the
    last step)."""
    params = {k: v.detach().clone().float() for k, v in params.items()}
    opt = AdamW(params)
    losses, first = [], None
    for s in range(steps):
        x = images[s * batch:(s + 1) * batch].permute(0, 3, 1, 2).contiguous()
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(forward(leaves, x, q=q), labels[s * batch:(s + 1) * batch])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        clipped = opt.step(params, grads)
        losses.append(float(loss.detach()))
        first = clipped if first is None else first
    return losses, first, params
