"""The port's ``visualize_rfi_data`` on the CPU: the static PNG grid
(matplotlib), the Bokeh viewer against an in-memory stand-in of the Bokeh
API it uses (Bokeh is not installed here; ``tests/test_visualize.py``
builds the same stand-in for the JAX viewer), and ``_predictor``'s masks
against the JAX ``_predictor``'s on the same ``.npz`` (within 1e-5, as
floats), plus its ``.pt`` path against ``Trainer.predict``.
"""

import sys
import types

import jax
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.models import UNet as FlaxUNet
from rfi_toolbox_tpu.train import export_params as jax_export_params
from rfi_toolbox_tpu.visualization.visualize import _predictor as jax_predictor
from rfi_toolbox_tpu_torch.cli.generate_dataset import main as generate_main
from rfi_toolbox_tpu_torch.data import RFIMaskDataset
from rfi_toolbox_tpu_torch.models import UNet
from rfi_toolbox_tpu_torch.train import Trainer
from rfi_toolbox_tpu_torch.visualization import visualize

SIDE = 32


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("viz")
    generate_main(["--samples_training", "3", "--samples_validation", "1",
                   "--output_dir", str(out), "--time_bins", str(SIDE),
                   "--frequency_bins", str(SIDE), "--seed", "3", "--batch_size", "2",
                   "--device", "cpu"])
    return out / "train"


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A JAX UNet of width 4 on 8 channels, exported by JAX."""
    path = tmp_path_factory.mktemp("viz_snap") / "unet4.npz"
    model = FlaxUNet(init_features=4)
    v = model.init(jax.random.key(1), np.zeros((1, SIDE, SIDE, 8), np.float32), train=False)
    jax_export_params(v["params"], path, batch_stats=v["batch_stats"],
                      metadata={"init_features": 4})
    return path


def test_predictor_matches_jax(dataset, snapshot):
    shape = (SIDE, SIDE, 8)
    want_fn = jax_predictor(str(snapshot), 8, "unet", 32, shape)
    got_fn = visualize._predictor(str(snapshot), 8, "unet", 32, shape, device="cpu")
    ds = RFIMaskDataset(str(dataset), device="cpu")
    flagged = 0
    for i in range(len(ds)):
        x = ds[i][0].numpy()
        got, want = got_fn(x), want_fn(x)
        assert got.shape == want.shape == (SIDE, SIDE) and got.dtype == np.float64
        assert np.abs(got - want).max() <= 1e-5
        flagged += got.sum()
    assert 0 < flagged < len(ds) * SIDE * SIDE  # masks neither empty nor full
    assert visualize._predictor(None, 8, "unet", 32, shape) is None


def test_predictor_of_a_checkpoint_equals_trainer_predict(dataset, tmp_path):
    model = UNet(in_channels=8, init_features=4)
    trainer = Trainer(model, checkpoint_dir=tmp_path, seed=3, device="cpu")
    trainer.state = trainer._init_state()
    path = trainer.save_checkpoint("unet4", epoch=0, loss=0.0)
    x = RFIMaskDataset(str(dataset), device="cpu")[1][0].numpy()
    got = visualize._predictor(str(path), 8, "unet", 4, (SIDE, SIDE, 8), device="cpu")(x)
    want = trainer.predict(np.transpose(x, (1, 2, 0))[None])[0].numpy()
    assert np.array_equal(got, want.astype(float))


def test_static_png(dataset, snapshot, tmp_path):
    pytest.importorskip("matplotlib")
    out = visualize.save_static_grid(str(dataset), str(tmp_path / "grid.png"),
                                     num_samples=2, device="cpu")
    assert out == str(tmp_path / "grid.png") and (tmp_path / "grid.png").stat().st_size > 1000
    with_model = visualize.save_static_grid(str(dataset), str(tmp_path / "pred.png"),
                                            model_path=str(snapshot), num_samples=2,
                                            device="cpu")
    assert (tmp_path / "pred.png").stat().st_size > (tmp_path / "grid.png").stat().st_size
    assert with_model.endswith("pred.png")


def test_main_static_png_and_no_bokeh(dataset, tmp_path, capsys, monkeypatch):
    pytest.importorskip("matplotlib")
    visualize.main(["--dataset_dir", str(dataset), "--static_png", str(tmp_path / "m.png"),
                    "--num_samples", "2", "--device", "cpu"])
    assert capsys.readouterr().out.strip() == f"Wrote {tmp_path / 'm.png'}"
    monkeypatch.setitem(sys.modules, "bokeh.plotting", None)  # import fails
    visualize.main(["--dataset_dir", str(dataset), "--device", "cpu"])
    assert "Bokeh not available" in capsys.readouterr().out


# -- a stand-in for the Bokeh API the viewer touches ----------------------------------------


class _ColumnDataSource:
    def __init__(self, data=None):
        self.data = dict(data or {})


class _Slider:
    def __init__(self, start, end, value, step, title):
        self.start, self.end, self.value, self.step, self.title = start, end, value, step, title
        self.callbacks = []

    def on_change(self, attr, cb):
        assert attr == "value"
        self.callbacks.append(cb)

    def set_value(self, new):
        old, self.value = self.value, new
        for cb in self.callbacks:
            cb("value", old, new)


class _Figure:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.images = []

    def image(self, image=None, source=None, **kwargs):
        assert image in source.data, f"glyph key {image!r} not in source"
        self.images.append((image, source, kwargs))


class _Container:
    def __init__(self, *children):
        self.children = list(children)


def _install_bokeh_stub(monkeypatch):
    modules = {name: types.ModuleType(name) for name in (
        "bokeh", "bokeh.layouts", "bokeh.models", "bokeh.palettes", "bokeh.plotting")}
    modules["bokeh.layouts"].column = modules["bokeh.layouts"].row = _Container
    modules["bokeh.models"].ColumnDataSource = _ColumnDataSource
    modules["bokeh.models"].Slider = _Slider
    modules["bokeh.palettes"].Gray256 = ["#000000", "#ffffff"]
    modules["bokeh.palettes"].Viridis256 = ["#440154", "#fde725"]
    modules["bokeh.plotting"].figure = _Figure
    for name, mod in modules.items():
        monkeypatch.setitem(sys.modules, name, mod)


def _find(node, cls):
    found, stack = [], [node]
    while stack:
        n = stack.pop()
        if isinstance(n, cls):
            found.append(n)
        stack.extend(getattr(n, "children", []))
    return found


def test_viewer_builds_and_the_slider_updates(dataset, snapshot, monkeypatch):
    _install_bokeh_stub(monkeypatch)
    layout = visualize.create_interactive_viewer(str(dataset), model_path=str(snapshot),
                                                 num_samples=3, seed=0, device="cpu")
    (slider,) = _find(layout, _Slider)
    figures = _find(layout, _Figure)
    assert len(figures) == 6 and (slider.start, slider.end) == (0, 2)
    sources = {id(src) for fig in figures for (_, src, _) in fig.images}
    assert len(sources) == 1
    source = figures[0].images[0][1]
    ds = RFIMaskDataset(str(dataset), device="cpu")
    predict = visualize._predictor(str(snapshot), 8, "unet", 32, (SIDE, SIDE, 8), device="cpu")
    for index in (2, 0):
        slider.set_value(index)
        x, m = (t.numpy() for t in ds[index])  # 3 of 3 items: index order
        assert np.array_equal(source.data["input_ch1"][0], x[2])
        assert np.array_equal(source.data["mask"][0], m[0])
        assert np.array_equal(source.data["prediction"][0], predict(x))
    assert torch.is_tensor(ds[0][0])  # the dataset's items; the viewer got numpy
