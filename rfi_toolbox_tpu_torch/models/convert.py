"""Flax UNet snapshots -> the port's UNet weights.

``load_params`` reads the ``.npz`` inference snapshots that
``rfi_toolbox_tpu.train.export_params`` writes (``pretrained/*.npz``) with
numpy alone. ``params_from_flax`` turns the nested Flax parameter and
batch-statistics dicts into a ``state_dict`` for
:class:`rfi_toolbox_tpu_torch.models.unet.UNet`:

- conv kernels go from HWIO to OIHW;
- the transposed-conv kernel is mirrored (``kernel[::-1, ::-1]``), as the
  Flax ``ConvTranspose2x2`` applies it, then goes to (Cin, Cout, 2, 2);
- BatchNorm/GroupNorm ``scale``/``bias`` become ``weight``/``bias``, and
  the batch statistics ``mean``/``var`` the running buffers.
"""

import json

import numpy as np
import torch

__all__ = ["load_params", "params_from_flax", "unet_from_snapshot"]


def load_params(path):
    """Load an ``export_params`` snapshot.

    Returns ``(params, batch_stats, metadata)``: the first two as nested
    dicts of numpy arrays keyed like the Flax variables, the last as the
    snapshot's JSON metadata.
    """
    params, stats, metadata = {}, {}, {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if key == "__metadata__":
                metadata = json.loads(bytes(z[key]).decode())
                continue
            root, _, rest = key.partition("/")
            tree = {"params": params, "batch_stats": stats}.get(root)
            if tree is None:
                continue
            *parents, leaf = rest.split("/")
            for p in parents:
                tree = tree.setdefault(p, {})
            tree[leaf] = z[key]
    return params, stats, metadata


def _conv(dst, prefix, p):
    dst[prefix + ".weight"] = np.transpose(p["kernel"], (3, 2, 0, 1))
    if "bias" in p:
        dst[prefix + ".bias"] = p["bias"]


def _double_conv(dst, prefix, p, s):
    for i in (0, 1):
        _conv(dst, f"{prefix}.conv{i + 1}", p[f"Conv_{i}"])
        norm = f"{prefix}.norm{i + 1}"
        for kind in ("BatchNorm", "GroupNorm"):
            q = p.get(f"{kind}_{i}")
            if q is None:
                continue
            dst[norm + ".weight"] = q["scale"]
            dst[norm + ".bias"] = q["bias"]
            if kind == "BatchNorm":
                st = s[f"BatchNorm_{i}"]
                dst[norm + ".running_mean"] = st["mean"]
                dst[norm + ".running_var"] = st["var"]
                dst[norm + ".num_batches_tracked"] = np.zeros((), np.int64)


def params_from_flax(params, batch_stats, model):
    """Flax UNet variables -> ``state_dict`` for ``model``.

    Args:
        params / batch_stats: nested dicts of arrays (``batch_stats`` may
            be empty for GroupNorm or norm-free models).
        model: the port's :class:`UNet` of the same architecture; its keys
            are checked against the converted ones.
    """
    stats = batch_stats or {}
    sd = {}
    for i in range(len(model.encoders)):
        name = f"Encoder_{i}"
        _double_conv(sd, f"encoders.{i}.block", params[name]["DoubleConv_0"],
                     stats.get(name, {}).get("DoubleConv_0", {}))
    _double_conv(sd, "bottleneck", params["DoubleConv_0"],
                 stats.get("DoubleConv_0", {}))
    for i in range(len(model.decoders)):
        name = f"Decoder_{i}"
        up = params[name]["ConvTranspose_0"]
        sd[f"decoders.{i}.up.weight"] = np.transpose(
            up["kernel"][::-1, ::-1], (2, 3, 0, 1))
        sd[f"decoders.{i}.up.bias"] = up["bias"]
        _double_conv(sd, f"decoders.{i}.block", params[name]["DoubleConv_0"],
                     stats.get(name, {}).get("DoubleConv_0", {}))
    _conv(sd, "head", params["Conv_0"])

    want = set(model.state_dict())
    if set(sd) != want:
        raise ValueError(
            "snapshot does not match the model: missing "
            f"{sorted(want - set(sd))}, unexpected {sorted(set(sd) - want)}"
        )
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def unet_from_snapshot(path):
    """Build the port's UNet for an ``export_params`` snapshot and load its
    weights. The architecture comes from the metadata (``init_features``,
    ``norm``, ``space_to_depth``) and the input channels from the first
    conv kernel.

    Returns ``(model, metadata)``; the model is on the CPU in eval mode.
    """
    from .unet import UNet

    params, stats, meta = load_params(path)
    s2d = bool(meta.get("space_to_depth", False))
    first = params["Encoder_0"]["DoubleConv_0"]["Conv_0"]["kernel"]
    cfg = {
        "in_channels": first.shape[2] // (4 if s2d else 1),
        "init_features": int(meta.get("init_features", 32)),
        "norm": meta.get("norm", "batch"),
        "space_to_depth": s2d,
    }
    model = UNet(**cfg)
    model.load_state_dict(params_from_flax(params, stats, model))
    return model.eval(), meta
