"""CLI ``visualize_rfi_data``: interactive dataset + prediction viewer.

Counterpart of ``rfi_toolbox_tpu/visualization/visualize.py`` (the
reference's Bokeh dashboard, visualization/visualize.py:18-88): a slider
over sampled dataset items showing the 4 input channels, the
ground-truth mask and (optionally) a model's predicted mask; or a static
matplotlib PNG grid (``--static_png``). Bokeh and matplotlib are optional
and imported only by the functions that draw. The items are made and the
model runs on the card unless ``--device cpu`` is given; without a card
the command raises.

    python -m rfi_toolbox_tpu_torch.visualization.visualize \
        --dataset_dir rfi_dataset/val --model_path model.npz --static_png grid.png
"""

import argparse
import random

import numpy as np

from ..data import RFIMaskDataset
from ..models import create_model, load_params, params_from_flax
from ..train import Trainer, create_train_state
from ..utils.device import resolve_device

__all__ = ["main", "create_interactive_viewer", "save_static_grid"]


def _load_samples(dataset_dir, num_samples, seed, device=None):
    """``num_samples`` items drawn by ``random.seed(seed)`` (the JAX
    order), as host arrays (input (C, F, T), mask (1, F, T))."""
    ds = RFIMaskDataset(dataset_dir, device=device)
    random.seed(seed)
    indices = random.sample(range(len(ds)), min(num_samples, len(ds)))
    return [tuple(t.cpu().numpy() for t in ds[i]) for i in sorted(indices)]


def _predictor(model_path, in_channels, model_type, init_features, shape,
               device=None):
    """``predict(x)``: the model's (F, T) float mask of one (C, F, T)
    item, or None without a model. ``shape`` is an image's (H, W, C); the
    UNet takes its C (``in_channels`` is accepted for the JAX signature).
    An ``.npz`` snapshot's metadata wins over the defaults (as in
    evaluate_rfi_model and ``CompiledPredictor.from_snapshot``); any other
    path is a ``.pt`` checkpoint of the port's ``Trainer``."""
    del in_channels
    if model_path is None:
        return None
    device = resolve_device(device)
    if str(model_path).endswith(".npz"):
        params, batch_stats, meta = load_params(model_path)
        model = create_model(
            model_type,
            in_channels=shape[-1],
            init_features=meta.get("init_features", init_features),
            norm=meta.get("norm", "batch"),
            space_to_depth=bool(meta.get("space_to_depth", False)),
        )
        model.load_state_dict(params_from_flax(params, batch_stats, model))
        trainer = Trainer(model, device=device)
        trainer.state = create_train_state(model, seed=None, device=device)
    else:
        model = create_model(model_type, in_channels=shape[-1],
                             init_features=init_features)
        trainer = Trainer(model, device=device)
        trainer.restore(model_path)

    def predict(x):  # x: (C, F, T)
        img = np.transpose(x, (1, 2, 0))[None]
        return trainer.predict(img)[0].cpu().numpy().astype(float)

    return predict


def create_interactive_viewer(dataset_dir, model_path=None, in_channels=8,
                              num_samples=100, seed=42, model_type="unet",
                              init_features=32, device=None):
    """Bokeh layout (column of slider + image grid)."""
    from bokeh.layouts import column, row
    from bokeh.models import ColumnDataSource, Slider
    from bokeh.palettes import Gray256, Viridis256
    from bokeh.plotting import figure

    samples = _load_samples(dataset_dir, num_samples, seed, device)
    x0, m0 = samples[0]
    predict = _predictor(model_path, in_channels, model_type, init_features,
                         (x0.shape[1], x0.shape[2], x0.shape[0]), device)

    source = ColumnDataSource(
        data={f"input_ch{i}": [x0[2 * i]] for i in range(4)}
        | {"mask": [m0[0]], "prediction": [np.zeros_like(m0[0])]}
    )
    h, w = m0[0].shape

    def plot(key, title, palette=Viridis256):
        # glyphs bind to the shared source so slider updates re-render
        p = figure(width=250, height=250, title=title,
                   x_range=(0, w), y_range=(0, h))
        p.image(image=key, source=source, x=0, y=0, dw=w, dh=h,
                palette=palette)
        return p

    plots = [plot(f"input_ch{i}", f"Input pol{i} Re") for i in range(4)]
    plot_mask = plot("mask", "Ground Truth Mask", Gray256)
    plot_pred = plot("prediction", "Model Prediction", Gray256)

    slider = Slider(start=0, end=len(samples) - 1, value=0, step=1,
                    title="Sample Index")

    def update(attr, old, new):
        x, m = samples[new]
        data = {f"input_ch{i}": [x[2 * i]] for i in range(4)}
        data["mask"] = [m[0]]
        data["prediction"] = [
            predict(x) if predict is not None else np.zeros_like(m[0])
        ]
        source.data = data

    slider.on_change("value", update)
    update(None, None, 0)
    return column(slider, row(plots[0], plots[1]), row(plots[2], plots[3]),
                  row(plot_mask, plot_pred))


def save_static_grid(dataset_dir, output_path, model_path=None,
                     in_channels=8, num_samples=4, seed=42,
                     model_type="unet", init_features=32, device=None):
    """Matplotlib fallback: a PNG grid of samples/masks/predictions."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    samples = _load_samples(dataset_dir, num_samples, seed, device)
    x0, _ = samples[0]
    predict = _predictor(model_path, in_channels, model_type, init_features,
                         (x0.shape[1], x0.shape[2], x0.shape[0]), device)
    cols = 3 if predict is not None else 2
    fig, axes = plt.subplots(len(samples), cols,
                             figsize=(3 * cols, 3 * len(samples)),
                             squeeze=False)
    for r, (x, m) in enumerate(samples):
        axes[r][0].imshow(np.abs(x[0]), aspect="auto")
        axes[r][0].set_title("pol0 amplitude")
        axes[r][1].imshow(m[0], aspect="auto", cmap="gray")
        axes[r][1].set_title("ground truth")
        if predict is not None:
            axes[r][2].imshow(predict(x), aspect="auto", cmap="gray")
            axes[r][2].set_title("prediction")
    fig.tight_layout()
    fig.savefig(output_path, dpi=100)
    plt.close(fig)
    return output_path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Interactive visualization of RFI data and predictions."
    )
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' runs on the CPU; default the CUDA card "
                        "(raises without one)")
    parser.add_argument("--in_channels", type=int, default=8)
    parser.add_argument("--num_samples", type=int, default=100)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--model_type", type=str, default="unet")
    parser.add_argument("--init_features", type=int, default=32)
    parser.add_argument("--static_png", type=str, default=None,
                        help="Write a static PNG instead of the Bokeh app")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)

    if args.static_png:
        out = save_static_grid(args.dataset_dir, args.static_png,
                               args.model_path, args.in_channels,
                               min(args.num_samples, 8), args.seed,
                               args.model_type, args.init_features, device)
        print(f"Wrote {out}")
        return

    try:
        from bokeh.plotting import show
    except ImportError:
        print("Bokeh not available; use --static_png for a matplotlib grid.")
        return
    dashboard = create_interactive_viewer(
        args.dataset_dir, args.model_path, args.in_channels,
        args.num_samples, args.seed, args.model_type, args.init_features,
        device,
    )
    show(dashboard)


if __name__ == "__main__":
    main()
