"""The predictor's forward by route: the channels-last K6a forward
(``models/nhwc_forward.py``) and the channels-last K7 forward
(``models/nhwc_groupnorm.py``) against the model's own eager forward, on
the CPU, where ``conv3x3_call`` and ``double_conv_gn_relu`` run their
plain versions.

A folded BatchNorm UNet (and any float32 ``norm="none"`` ReLU UNet without
space-to-depth or a final sigmoid) takes ``"k6a_nhwc"``; a float32
``norm="group"`` ReLU UNet without them takes ``"k7_nhwc"``; every other
model keeps the eager forward bit for bit. The masks still come from
``CompiledPredictor.logits``, which the benchmark wraps, and each
forward of either route is one ``predict.nhwc`` span inside
``predict.logits``."""

from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from rfi_toolbox_tpu_torch.models import UNet, UNetDifferentActivation, UNetOverfit
from rfi_toolbox_tpu_torch.models import nhwc_forward, nhwc_groupnorm
from rfi_toolbox_tpu_torch.serving import CompiledPredictor
from rfi_toolbox_tpu_torch.utils.profiling import recording

PRETRAINED = Path(__file__).resolve().parents[1] / "pretrained"
SNAPSHOT = PRETRAINED / "unet16_synthetic.npz"
GN_SNAPSHOT = PRETRAINED / "unet24gn_coherent8ch.npz"  # the flagship coherent model
HW = 32
LOGITS_ATOL = 1e-5


@torch.no_grad()
def _bn_unet(features, **kwargs):
    """A seeded BatchNorm UNet in eval mode whose norms do something."""
    gen = torch.Generator().manual_seed(features)
    model = UNet(init_features=features, norm="batch", **kwargs)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.uniform_(-0.3, 0.3, generator=gen)
    return model.eval()


@torch.no_grad()
def _gn_unet(features, in_channels=8, **kwargs):
    """A seeded GroupNorm UNet whose norms' scales and biases are not 1
    and 0, so that every parameter enters the comparison."""
    gen = torch.Generator().manual_seed(features)
    model = UNet(in_channels=in_channels, init_features=features, norm="group", **kwargs)
    for m in model.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.uniform_(-0.3, 0.3, generator=gen)
    return model.eval()


def _predictor(source, **kwargs):
    """The UNet16 as the shipped snapshot is built (3 channels, 16
    features, BatchNorm), with seeded weights, or the snapshot itself; a
    seeded 8-channel GroupNorm UNet8, or the flagship GroupNorm UNet24
    snapshot at a small side."""
    channels = 8 if source.startswith("gn_") else 3
    kwargs = {"input_shape": (HW, HW, channels), "batch_size": 2, "device": "cpu", **kwargs}
    if source == "snapshot":
        return CompiledPredictor.from_snapshot(SNAPSHOT, **kwargs)
    if source == "gn_snapshot":
        return CompiledPredictor.from_snapshot(GN_SNAPSHOT, **kwargs)
    if source == "gn_unet8":
        return CompiledPredictor(_gn_unet(8), **kwargs)
    return CompiledPredictor(_bn_unet(16), **kwargs)


def _images(n, channels=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, HW, HW, channels), generator=gen)


def _eager(pred):
    """The predictor's model's own forward, as the eager route runs it."""

    def logits(x):
        with torch.inference_mode():
            return pred.model(x.permute(0, 3, 1, 2))[:, 0]

    return logits


def _eager_probs(pred, images):
    fwd = _eager(pred)
    if not pred.tta:
        return torch.sigmoid(fwd(images))
    dims = [(), (1,), (2,), (1, 2)]
    return sum(torch.sigmoid(fwd(images.flip(d))).flip(d) for d in dims) / 4


def _logits_match_eager(pred, images):
    """``pred``'s masks of 3 images at batch 2: a full chunk and a
    zero-padded one, 4B each with TTA; every forward's logits within 1e-5
    of the eager ones, the masks equal wherever the eager probability is
    clear of the cut."""
    tta = pred.tta
    sizes, gaps = [], []

    def logits(x):
        got = CompiledPredictor.logits(pred, x)
        sizes.append(x.shape[0])
        gaps.append(float((got - _eager(pred)(x)).abs().max()))
        return got

    pred.logits = logits
    masks = pred(images)
    del pred.logits
    assert sizes == ([8, 8] if tta else [2, 2])
    assert max(gaps) <= LOGITS_ATOL
    probs = _eager_probs(pred, images)
    differ = masks != (probs > pred.threshold)
    assert not (differ & ((probs - pred.threshold).abs() > LOGITS_ATOL)).any()


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("source", ["bn_unet16", "snapshot"])
def test_route_logits_match_eager(source, tta):
    pred = _predictor(source, tta=tta)
    assert pred.folded and pred.route == "k6a_nhwc"
    _logits_match_eager(pred, _images(3))


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("source", ["gn_unet8", "gn_snapshot"])
def test_k7_route_logits_match_eager(source, tta):
    """The same for the GroupNorm route: a seeded 8-channel UNet8 whose
    norms' scales and biases are not 1 and 0, and the flagship coherent
    UNet24 snapshot, both on 8-channel images."""
    pred = _predictor(source, tta=tta)
    assert not pred.folded and pred.route == "k7_nhwc"
    _logits_match_eager(pred, _images(3, channels=8))


ROUTES = {
    "batch_folded": (lambda: _bn_unet(4), {}, "k6a_nhwc"),
    "none_relu": (lambda: UNet(init_features=4, norm="none"), {}, "k6a_nhwc"),
    "batch_unfolded": (lambda: _bn_unet(4), {"fold_norm": False}, "eager"),
    "group": (lambda: UNet(init_features=4, norm="group"), {}, "k7_nhwc"),
    "group_bfloat16": (lambda: UNet(init_features=4, norm="group", dtype=torch.bfloat16), {},
                       "eager"),
    "group_space_to_depth": (lambda: UNet(init_features=4, norm="group", space_to_depth=True),
                             {}, "eager"),
    "leaky_relu": (lambda: UNetDifferentActivation(init_features=4, norm="none",
                                                   activation=F.leaky_relu), {}, "eager"),
    "space_to_depth": (lambda: _bn_unet(4, space_to_depth=True), {}, "eager"),
    "overfit": (lambda: UNetOverfit(init_features=4, depth=2, norm="none"), {}, "eager"),
    "bfloat16": (lambda: _bn_unet(4, dtype=torch.bfloat16), {}, "eager"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_follows_the_model(name):
    """The route by the model's structure; the eager route is the model's
    own forward, bit for bit, and opens no ``predict.nhwc`` span."""
    make, kwargs, want = ROUTES[name]
    torch.manual_seed(0)
    pred = CompiledPredictor(make(), input_shape=(HW, HW, 3), batch_size=2, device="cpu",
                             **kwargs)
    assert pred.route == want
    x = _images(2)
    with recording() as rec:
        got = pred.logits(x)
    eager = _eager(pred)(x)
    assert got.shape == (2, HW, HW) and got.dtype == torch.float32
    if want != "eager":
        assert [s.name for s in rec.spans] == ["predict.logits", "predict.nhwc"]
        torch.testing.assert_close(got, eager, rtol=0, atol=LOGITS_ATOL)
    else:
        assert [s.name for s in rec.spans] == ["predict.logits"]
        assert torch.equal(got, eager)


@pytest.mark.parametrize("tta", [False, True])
def test_masks_come_from_logits(tta):
    """``_mask`` goes through ``self.logits``: replacing it on the
    instance changes the masks, and removing the replacement brings the
    route's masks back."""
    pred = _predictor("bn_unet16", tta=tta)
    images = _images(3)
    before = pred(images)
    pred.logits = lambda x: torch.full(x.shape[:3], 5.0)
    assert pred(images).all()
    pred.logits = lambda x: torch.full(x.shape[:3], -5.0)
    assert not pred(images).any()
    del pred.logits
    assert torch.equal(pred(images), before)


@pytest.mark.parametrize("tta", [False, True])
def test_one_nhwc_span_per_forward(tta):
    pred = _predictor("bn_unet16", tta=tta)
    with recording() as rec:
        pred(_images(3))
    names = [s.name for s in rec.spans]
    assert names == ["predict"] + ["predict.logits", "predict.nhwc"] * 2
    root = rec.spans[0]
    for outer, inner in zip(rec.spans[1::2], rec.spans[2::2]):
        assert inner.tag == outer.tag == root.tag
        assert outer.start <= inner.start <= inner.end <= outer.end <= root.end


def test_route_runs_each_conv3x3_on_k6a(monkeypatch):
    """18 calls of K6a's wrapper a forward of the UNet16, each with the
    bias and the ReLU, on contiguous float32 NHWC input and the same HWIO
    weights in every forward (prepared once, not per call)."""
    calls = []
    real = nhwc_forward.conv3x3_call

    def counting(x, w, b=None, relu=False):
        calls.append((tuple(x.shape), tuple(w.shape), w.data_ptr(), b is not None, relu,
                      x.is_contiguous() and w.is_contiguous(), x.dtype, w.dtype))
        return real(x, w, b, relu)

    monkeypatch.setattr(nhwc_forward, "conv3x3_call", counting)
    pred = _predictor("bn_unet16")
    pred(_images(4))
    assert len(calls) == 2 * 18
    assert calls[:18] == calls[18:]
    for x_shape, w_shape, _, bias, relu, contiguous, x_dtype, w_dtype in calls:
        assert w_shape[:3] == (3, 3, x_shape[3]) and bias and relu and contiguous
        assert x_dtype == w_dtype == torch.float32
    assert [w[3] for _, w, *_ in calls[:18:2]] == [16, 32, 64, 128, 256, 128, 64, 32, 16]


def test_route_takes_the_weights_once(monkeypatch):
    """The route prepares its weights at construction, each tensor once
    (18 convs and 4 up-convs with their biases, the head's weight and
    bias), and no forward prepares any again."""
    copies = []
    real = nhwc_forward._copy

    def counting(t):
        copies.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(nhwc_forward, "_copy", counting)
    pred = _predictor("bn_unet16")
    assert len(copies) == 2 * 18 + 2 * 4 + 2
    x = _images(2)
    first = pred.logits(x)
    assert torch.equal(pred.logits(x), first)
    assert len(copies) == 2 * 18 + 2 * 4 + 2
    with pytest.raises(ValueError, match="NHWCForward takes"):
        nhwc_forward.NHWCForward(UNet(init_features=4, norm="group"))


def test_k7_route_runs_each_double_conv_on_k7(monkeypatch):
    """9 calls of K7's wrapper a forward of the GroupNorm UNet8 (4
    encoders, the bottleneck, 4 decoders) and none of K6a's, on contiguous
    float32 NHWC input, the same HWIO weights and GroupNorm parameters in
    every forward (prepared once, not per call) and the module's groups
    and eps; one ``predict.nhwc`` span inside each ``predict.logits``."""
    calls, k6a = [], []
    real = nhwc_groupnorm.double_conv_gn_relu

    def counting(x, w1, g1, b1, w2, g2, b2, num_groups=8, eps=1e-6):
        params = (w1, g1, b1, w2, g2, b2)
        calls.append((tuple(x.shape), tuple(w1.shape), tuple(w2.shape),
                      tuple(p.data_ptr() for p in params), num_groups, eps,
                      x.is_contiguous() and all(p.is_contiguous() for p in params),
                      {x.dtype} | {p.dtype for p in params}))
        return real(x, *params, num_groups=num_groups, eps=eps)

    monkeypatch.setattr(nhwc_groupnorm, "double_conv_gn_relu", counting)
    monkeypatch.setattr(nhwc_forward, "conv3x3_call", lambda *a, **k: k6a.append(a))
    pred = _predictor("gn_unet8")
    with recording() as rec:
        pred(_images(4, channels=8))
    assert len(calls) == 2 * 9 and not k6a
    assert calls[:9] == calls[9:]
    widths = [8, 16, 32, 64, 128, 64, 32, 16, 8]
    for (x_shape, w1, w2, _, groups, eps, contiguous, dtypes), co in zip(calls, widths):
        assert w1 == (3, 3, x_shape[3], co) and w2 == (3, 3, co, co)
        assert groups == 8 and eps == 1e-6 and contiguous and dtypes == {torch.float32}
    assert [s.name for s in rec.spans] == ["predict"] + ["predict.logits", "predict.nhwc"] * 2
    for outer, inner in zip(rec.spans[1::2], rec.spans[2::2]):
        assert outer.start <= inner.start <= inner.end <= outer.end


def test_k7_route_takes_the_weights_once(monkeypatch):
    """The GroupNorm route prepares its weights at construction, each
    tensor once (9 DoubleConvs' two convs and two GroupNorms' scales and
    biases, 4 up-convs with their biases, the head's weight and bias), and
    no forward prepares any again."""
    copies = []
    real = nhwc_forward._copy

    def counting(t):
        copies.append(tuple(t.shape))
        return real(t)

    for module in (nhwc_forward, nhwc_groupnorm):
        monkeypatch.setattr(module, "_copy", counting)
    pred = _predictor("gn_unet8")
    want = 9 * (2 + 4) + 2 * 4 + 2
    assert len(copies) == want
    x = _images(2, channels=8)
    first = pred.logits(x)
    assert torch.equal(pred.logits(x), first)
    assert len(copies) == want
    with pytest.raises(ValueError, match="GroupNormNHWCForward takes"):
        nhwc_groupnorm.GroupNormNHWCForward(_bn_unet(4))
