"""Flax snapshots <-> the port's UNet and SOLOLite weights.

``load_params`` reads the ``.npz`` inference snapshots that
``rfi_toolbox_tpu.train.export_params`` writes (``pretrained/*.npz``) with
numpy alone, and ``save_params`` writes them. ``params_from_flax`` turns
the nested Flax parameter and batch-statistics dicts into a
``state_dict`` for :class:`rfi_toolbox_tpu_torch.models.unet.UNet`, and
``params_to_flax`` turns a model back into them, exactly (the port's
``export_params`` writes them); ``sololite_from_flax`` and
``sololite_to_flax`` do the same for
:class:`rfi_toolbox_tpu_torch.models.instance.SOLOLite`, whose Flax
modules ``_ConvBlock_i`` and ``Conv_j`` are its ``blocks[i]`` and
``convs[j]``:

- conv kernels go from HWIO to OIHW;
- the transposed-conv kernel is mirrored (``kernel[::-1, ::-1]``), as the
  Flax ``ConvTranspose2x2`` applies it, then goes to (Cin, Cout, 2, 2);
- BatchNorm/GroupNorm ``scale``/``bias`` become ``weight``/``bias``, and
  the batch statistics ``mean``/``var`` the running buffers.
"""

import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["load_params", "save_params", "params_from_flax", "params_to_flax",
           "unet_from_snapshot", "sololite_from_flax", "sololite_to_flax",
           "sololite_from_snapshot"]


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


def save_params(path, params, batch_stats=None, metadata=None):
    """Write the snapshot :func:`load_params` reads, as the JAX
    ``export_params`` writes it: ``params/...`` and ``batch_stats/...``
    arrays keyed by the Flax variable paths, and ``__metadata__`` (JSON),
    compressed. Returns ``path``."""
    arrays = {}

    def flatten(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(f"{prefix}/{k}", v)
            else:
                arrays[f"{prefix}/{k}"] = np.asarray(v)

    flatten("params", params)
    flatten("batch_stats", batch_stats or {})
    arrays["__metadata__"] = np.bytes_(json.dumps(metadata or {}).encode())
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def _checked(sd, model):
    """``sd`` as torch tensors, after checking its keys against ``model``'s."""
    want = set(model.state_dict())
    if set(sd) != want:
        raise ValueError(
            "snapshot does not match the model: missing "
            f"{sorted(want - set(sd))}, unexpected {sorted(set(sd) - want)}"
        )
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


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
    return _checked(sd, model)


def _conv_to(sd, prefix):
    p = {"kernel": np.transpose(sd[prefix + ".weight"], (2, 3, 1, 0))}
    if prefix + ".bias" in sd:
        p["bias"] = sd[prefix + ".bias"]
    return p


def _double_conv_to(sd, prefix, norm):
    p, s = {}, {}
    for i in (0, 1):
        p[f"Conv_{i}"] = _conv_to(sd, f"{prefix}.conv{i + 1}")
        bn = f"{prefix}.norm{i + 1}"
        if norm == "none":
            continue
        kind = "BatchNorm" if norm == "batch" else "GroupNorm"
        p[f"{kind}_{i}"] = {"scale": sd[bn + ".weight"], "bias": sd[bn + ".bias"]}
        if norm == "batch":
            s[f"BatchNorm_{i}"] = {"mean": sd[bn + ".running_mean"],
                                   "var": sd[bn + ".running_var"]}
    return p, s


def params_to_flax(model):
    """The port's UNet -> ``(params, batch_stats)``, nested dicts of
    float32 numpy arrays keyed as the Flax UNet's variables: the inverse of
    :func:`params_from_flax` (conv kernels OIHW -> HWIO, the transposed
    conv's kernel mirrored back, BatchNorm's running statistics under
    ``batch_stats``). ``batch_stats`` is empty without BatchNorm."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    params, stats = {}, {}

    def put(name, prefix):
        p, s = _double_conv_to(sd, prefix, model.norm)
        params[name] = {"DoubleConv_0": p}
        if s:
            stats[name] = {"DoubleConv_0": s}

    for i in range(len(model.encoders)):
        put(f"Encoder_{i}", f"encoders.{i}.block")
    p, s = _double_conv_to(sd, "bottleneck", model.norm)
    params["DoubleConv_0"] = p
    if s:
        stats["DoubleConv_0"] = s
    for i in range(len(model.decoders)):
        put(f"Decoder_{i}", f"decoders.{i}.block")
        up = sd[f"decoders.{i}.up.weight"]  # (Cin, Cout, 2, 2)
        params[f"Decoder_{i}"]["ConvTranspose_0"] = {
            "kernel": np.ascontiguousarray(np.transpose(up, (2, 3, 0, 1))[::-1, ::-1]),
            "bias": sd[f"decoders.{i}.up.bias"],
        }
    params["Conv_0"] = _conv_to(sd, "head")
    return params, stats


def unet_from_snapshot(path, model=None):
    """Load an ``export_params`` snapshot into ``model``, or into the
    port's UNet that the snapshot describes: the depth from its
    ``Encoder_i`` keys, the input channels and ``init_features`` from the
    first conv kernel, ``norm`` and ``space_to_depth`` from its metadata.

    Returns ``(model, metadata)``; a model built here is on the CPU in
    eval mode.
    """
    from .unet import UNet

    params, stats, meta = load_params(path)
    if model is None:
        s2d = bool(meta.get("space_to_depth", False))
        first = params["Encoder_0"]["DoubleConv_0"]["Conv_0"]["kernel"]
        encoders = sum(k.startswith("Encoder_") for k in params)
        model = UNet(
            in_channels=first.shape[2] // (4 if s2d else 1),
            init_features=first.shape[3] // (2 if s2d else 1),
            depth=encoders + (1 if s2d else 0),
            norm=meta.get("norm", "batch"),
            space_to_depth=s2d,
        ).eval()
    model.load_state_dict(params_from_flax(params, stats, model))
    return model, meta


def sololite_from_flax(params, model):
    """Flax SOLOLite parameters (nested dicts of arrays) -> ``state_dict``
    for the port's :class:`SOLOLite` ``model`` of the same architecture
    (checked by its keys). SOLOLite has no batch statistics."""
    sd = {}
    for i in range(len(model.blocks)):
        p = params[f"_ConvBlock_{i}"]
        _conv(sd, f"blocks.{i}.conv", p["Conv_0"])
        sd[f"blocks.{i}.norm.weight"] = p["GroupNorm_0"]["scale"]
        sd[f"blocks.{i}.norm.bias"] = p["GroupNorm_0"]["bias"]
    for j in range(len(model.convs)):
        _conv(sd, f"convs.{j}", params[f"Conv_{j}"])
    return _checked(sd, model)


def sololite_to_flax(model):
    """The port's SOLOLite -> Flax parameters, nested dicts of float32
    numpy arrays: the inverse of :func:`sololite_from_flax`."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    params = {}
    for i in range(len(model.blocks)):
        params[f"_ConvBlock_{i}"] = {
            "Conv_0": _conv_to(sd, f"blocks.{i}.conv"),
            "GroupNorm_0": {"scale": sd[f"blocks.{i}.norm.weight"],
                            "bias": sd[f"blocks.{i}.norm.bias"]},
        }
    for j in range(len(model.convs)):
        params[f"Conv_{j}"] = _conv_to(sd, f"convs.{j}")
    return params


def sololite_from_snapshot(path):
    """Load a SOLOLite snapshot (``InstanceTrainer.save`` of either
    package, e.g. ``pretrained/sololite_synthetic.npz``) into the port's
    SOLOLite that its metadata describes. Returns ``(model, metadata)``;
    the model is on the CPU in eval mode."""
    from .instance import SOLOLite

    params, _, meta = load_params(path)
    model = SOLOLite(num_classes=meta["num_classes"], grid_size=meta["grid_size"],
                     embed_dim=meta["embed_dim"], features=meta["features"],
                     space_to_depth=bool(meta.get("space_to_depth", False))).eval()
    model.load_state_dict(sololite_from_flax(params, model))
    return model, meta
